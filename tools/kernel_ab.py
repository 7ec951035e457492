"""Kernels of the port against other checkouts, in turns on one card.

    python tools/kernel_ab.py [--what ssd|cache] PARENT [OTHER ...]

runs PARENT, each OTHER, this tree, this tree, each OTHER, PARENT. Each
turn is a process of its own (every checkout's package is ``repro_torch``)
with that checkout's ``src`` first on the path, measured with this tree's
``chip_smoke`` helpers. A turn prints the card's name and power limit
(``nvidia-smi``), then what ``--what`` names (``ssd`` by default):

``ssd``: both SSD chunk kernels' device time a call by CUDA graph at
hymba-1.5b's train shape (B=2 x 512, bf16, chunks of 256) and by launch,
and the plain loops' (``ref.py``, eager, CUDA events) on the same inputs;
the SSD and mLSTM kernels' ``ptxas -v`` lines; and a hash of the mLSTM
kernels' outputs at xlstm-125m's train shape (equal hashes: the same
bits). The turns of PARENT and this tree also run hymba-1.5b's 1,024-token
prefill (4 lanes, CUDA events, the first a warm-up), one profiled train
step of 2 x 512 (``chip_smoke.profile_steps``, with the SSD kernels'
device ms a step) and its train driver (``chip_smoke.family_train``).

``cache``: the cache attention kernel at llava-next's prefill (B 2, S
2,944 over a ring of 2,976, H/KV 32/8, hd 128, bf16) and the SSD decode
step at phase 3's shape (4 lanes of hymba-1.5b, the strided views of one
position), each by CUDA graph and by launch (``graph_split_ms``), SDPA on
the same attention, the flash kernel as phase 3 times it (B 1, H/KV 32/4,
hd 128, S = T = 512 causal), and their ``ptxas -v`` lines. The turns of
PARENT and this tree also run llava-next-mistral-7b's prefill of 2,880 patch
embeddings + 64 tokens (B 2; CUDA events, the first a warm-up; then one
under ``torch.profiler``: device busy and wall) and hymba-1.5b's decode
step (B 4 after a 1,024-token prefill; 16 steps by CUDA events, then one
under the profiler: its ``cudaLaunchKernel`` count, device busy and wall).
"""

import hashlib
import json
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(tree: str):
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as CS
    import repro_torch

    assert repro_torch.__file__.startswith(os.path.abspath(tree)), repro_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return torch, CS, smi.splitlines()[0]


def ssd_turn(tree: str, tag: str, full: bool) -> None:
    torch, CS, card = _load(tree)
    from repro_torch.kernels import ref, ssd_scan as ss, xlstm_scan as xs

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


def _profiled(torch, CS, step, what: str) -> dict:
    """One call of ``step`` under ``chip_smoke.profile_steps``: its wall
    and device busy (ms) and its ``cudaLaunchKernel`` count."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avgs = CS.profile_steps(step, 1, what)
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(CS._self_device_us(e) for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    return {"busy_ms": round(busy, 4), "wall_ms_profiled": round(wall, 3),
            "cudaLaunchKernel": launches}


def cache_turn(tree: str, tag: str, full: bool) -> None:
    torch, CS, card = _load(tree)
    from repro_torch.kernels import cache_attention as ca, flash_attention as fa, ssd_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, T, H, KV, hd = 2, CS.LLAVA_EXTRA + CS.LLAVA_PROMPT, 2976, 32, 8, 128
    q, k, v, q_pos, k_pos = CS.ring_inputs(gen, torch.bfloat16, B, S, T, H, KV, hd)
    attn = lambda: ca.cache_attention(q, k, v, q_pos, k_pos)  # noqa: E731
    qs, ks, vs = CS._sdpa_heads(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), H, KV)
    mask = CS.ring_mask(q_pos, k_pos)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _, (xt, bt, ct, lat) = CS.ssd_inputs(0, torch.bfloat16, 4, 8, False)
    st = torch.randn(4, *xt.shape[1:], bt.shape[-1], generator=gen, device="cuda") * 0.1
    dec = lambda: ss.decode(xt, bt, ct, lat, st)  # noqa: E731
    fq = torch.randn(1, 32, 512, 128, generator=gen, device="cuda").to(torch.bfloat16)
    fk, fv = (torch.randn(1, 4, 512, 128, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    res = {"flash_ms": CS.graph_ms(lambda: fa.flash_attention(fq, fk, fv, causal=True), 20),"cache_ms": CS.graph_ms(attn, 20), "cache_split": CS.graph_split_ms(attn, 5),
           "sdpa_ms": CS.graph_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True), 20),
           "decode_ms": CS.graph_ms(dec, 20), "decode_split": CS.graph_split_ms(dec, 5)}
    print("AB", tag, card, json.dumps(res), flush=True)
    for kernel, line in CS.ptxas_lines():
        if kernel.startswith(("cache_", "ssd_decode", "flash_bf16")):
            print("PTXAS", tag, kernel, line, flush=True)
    del q, k, v, qs, ks, vs, mask
    if not full:
        return

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models.frontends import vision_patch_embeds

    cfg = get_config("llava_next")
    params = init_params(cfg, gen, "cuda")
    extra = vision_patch_embeds(cfg, B, CS.LLAVA_EXTRA, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (B, CS.LLAVA_PROMPT), generator=gen,
                           dtype=torch.int32, device="cuda")
    ring = S + CS.LLAVA_STEPS

    def llava():
        return prefill(params, tokens, cfg, init_cache(cfg, B, ring, device="cuda"),
                       extra_embeds=extra)

    with torch.no_grad():
        walls = [round(CS._events_ms(llava)[1], 3) for _ in range(4)]
        before = ca.launches
        prof = _profiled(torch, CS, llava, f"{tag}: llava-next prefill")
    print("AB", tag, "llava prefill", json.dumps({
        "ms_events_first_warm": walls, **prof, "cache_launches": ca.launches - before}),
        flush=True)
    del params, extra
    torch.cuda.empty_cache()

    cfg = get_config("hymba_1_5b")
    params = init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024 + 20), generator=gen, dtype=torch.int32,
                           device="cuda")
    with torch.no_grad():
        _, cache = prefill(params, tokens[:, :1024], cfg, init_cache(cfg, 4, 1024 + 20,
                                                                      device="cuda"))
        steps = []
        for i in range(16):
            (_, cache), ms = CS._events_ms(
                lambda: decode_step(params, tokens[:, 1024 + i:1025 + i], cfg, cache))
            steps.append(round(ms, 3))
        before = ss.launches["ssd_decode"]
        prof = _profiled(torch, CS, lambda: decode_step(params, tokens[:, -1:], cfg, cache),
                         f"{tag}: hymba-1.5b decode step x 4 lanes")
    print("AB", tag, "hymba decode step", json.dumps({
        "ms_events": steps, **prof, "ssd_decode_launches": ss.launches["ssd_decode"] - before}),
        flush=True)


TURNS = {"ssd": ssd_turn, "cache": cache_turn}


def main(what: str, others: list) -> None:
    order = [others[0], *others[1:], ".", ".", *others[1:][::-1], others[0]]
    for tree in order:
        tag = "this" if tree == "." else os.path.basename(os.path.normpath(tree))
        full = tree in (".", others[0])
        cmd = [sys.executable, __file__, "--turn", what, os.path.abspath(tree), tag]
        subprocess.run(cmd + (["--full"] if full else []), cwd=ROOT, check=True, timeout=900)


if __name__ == "__main__":
    if sys.argv[1] == "--turn":
        TURNS[sys.argv[2]](sys.argv[3], sys.argv[4], "--full" in sys.argv)
    else:
        argv = sys.argv[1:]
        what = "ssd"
        if argv[0] == "--what":
            what, argv = argv[1], argv[2:]
        main(what, argv)
