"""The SSD chunk kernels against other checkouts, in turns on one card.

    python tools/ssd_ab.py PARENT [OTHER ...]

runs PARENT, each OTHER, this tree, this tree, each OTHER, PARENT. Each
turn is a process of its own (every checkout's package is ``repro_torch``)
with that checkout's ``src`` first on the path, measured with this tree's
``chip_smoke`` helpers. A turn prints the card's name and power limit;
both chunk kernels' device time a call by CUDA graph at hymba-1.5b's
train shape (B=2 x 512, bf16, chunks of 256) and by launch, and the plain
loops' (``ref.py``, eager, CUDA events) on the same inputs; the SSD and
mLSTM kernels' ``ptxas -v`` lines; and a hash of the mLSTM kernels'
outputs at xlstm-125m's train shape (equal hashes: the same bits). The
turns of PARENT and this tree also run hymba-1.5b's 1,024-token prefill (4
lanes, CUDA events, the first a warm-up), one profiled train step of 2 x
512 (``chip_smoke.profile_steps``, with the SSD kernels' device ms a step)
and its train driver (``chip_smoke.family_train``).
"""

import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def turn(tree: str, tag: str, full: bool) -> None:
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as CS
    import repro_torch
    from repro_torch.kernels import ref, ssd_scan as ss, xlstm_scan as xs

    assert repro_torch.__file__.startswith(os.path.abspath(tree)), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    args, _ = CS.ssd_inputs(0, torch.bfloat16, 2, 512, False)
    y, h, saved = ss.ssd_fwd(*args, chunk=256, save=True)
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    fwd = lambda: ss.ssd_fwd(*args, chunk=256, save=True)  # noqa: E731
    bwd = lambda: ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=256)  # noqa: E731
    res = {"fwd_ms": CS.graph_ms(fwd, 20), "bwd_ms": CS.graph_ms(bwd, 20),
           "fwd_split": CS.graph_split_ms(fwd, 5), "bwd_split": CS.graph_split_ms(bwd, 5),
           "plain_fwd_ms": CS.cuda_ms(lambda: ref.ref_ssd_fwd_saved(*args, 256), 3),
           "plain_bwd_ms": CS.cuda_ms(lambda: ref.ref_ssd_bwd(*args[:4], saved, dy, dh, 256), 3)}
    print("AB", tag, card, json.dumps(res), flush=True)
    for kernel, line in CS.ptxas_lines():
        if kernel.startswith(("ssd_fwd", "ssd_bwd", "mlstm_")):
            print("PTXAS", tag, kernel, line, flush=True)
    margs, _ = CS.xl_inputs(0, torch.bfloat16, 2, 512)
    out = xs.mlstm_fwd(*margs, save=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    cots = [torch.randn(t.shape, generator=g, device="cuda").to(t.dtype) for t in out[:4]]
    grads = xs.mlstm_bwd(*margs[:5], out[4], *cots)
    blobs = [t.detach().contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
             .cpu().numpy().tobytes() for t in (*out[:4], *out[4], *grads)]
    print("MLSTM", tag, hashlib.sha256(b"".join(blobs)).hexdigest()[:16], flush=True)
    if not full:
        return

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("hymba_1_5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen, dtype=torch.int32,
                           device="cuda")
    pre = []
    with torch.no_grad():
        for _ in range(4):
            cache = init_cache(cfg, 4, 1024 + 8, device="cuda")
            pre.append(round(CS._events_ms(lambda: prefill(params, tokens, cfg, cache))[1], 3))
    print("AB", tag, "prefill ms (events; the first a warm-up)", pre, flush=True)
    del params, cache
    tr = Trainer(cfg, OptConfig(lr=1e-5, warmup_steps=5, total_steps=8), seed=0)
    batches = iter([synth_batch(0, i, 2, 512, cfg.vocab_size) for i in range(8)])
    tr.fit(batches, 2)
    steps = 3
    avgs = CS.profile_steps(lambda: tr.fit(batches, 1), steps, f"{tag}: hymba-1.5b train step")
    ssd = {}
    for e in avgs:
        m = re.search(r"(ssd_\w+_kernel)", e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            k = m.group(1)
            ssd[k] = ssd.get(k, 0.0) + CS._self_device_us(e) / 1e3 / steps
    print("PROF", tag, "SSD kernels ms/step", json.dumps(ssd), flush=True)
    del tr
    torch.cuda.empty_cache()
    CS.family_train(card, "hymba_1_5b")


def main(others: list) -> None:
    order = [others[0], *others[1:], ".", ".", *others[1:][::-1], others[0]]
    for tree in order:
        tag = "this" if tree == "." else os.path.basename(os.path.normpath(tree))
        full = tree in (".", others[0])
        cmd = [sys.executable, __file__, "--turn", os.path.abspath(tree), tag]
        subprocess.run(cmd + (["--full"] if full else []), cwd=ROOT, check=True, timeout=900)


if __name__ == "__main__":
    if sys.argv[1] == "--turn":
        turn(sys.argv[2], sys.argv[3], "--full" in sys.argv)
    else:
        main(sys.argv[1:])
