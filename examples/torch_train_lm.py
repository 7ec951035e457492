"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps with checkpoint/restart through the full stack (CMP
pipeline, async checkpointer, straggler tracking). ``examples/train_lm.py``
on ``repro_torch``, on the card unless ``--device cpu``.

Full run (the deliverable configuration: xlstm-125m at its published size,
float32; its time loops are Python loops, so a step is bound by the host):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 300

CI-scale smoke of the same driver:
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --scale 0.25 --batch 4 --seq 64
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, "src")

from repro_torch.configs import get_config                # noqa: E402
from repro_torch.data.pipeline import DataPipeline        # noqa: E402
from repro_torch.models import param_count                # noqa: E402
from repro_torch.training.optimizer import OptConfig      # noqa: E402
from repro_torch.training.train_loop import Trainer       # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="width multiplier on the ~100M base config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu "
                           "to run on the CPU")

    # ~100M-class config: xlstm-125m at full published size.
    cfg = get_config("xlstm-125m")
    if args.scale != 1.0:
        d = max(64, int(cfg.d_model * args.scale) // 16 * 16)
        cfg = dataclasses.replace(cfg, d_model=d, head_dim=d // cfg.num_heads,
                                  ssm_head_dim=d // cfg.ssm_heads,
                                  num_layers=max(2, int(cfg.num_layers * args.scale) // 2 * 2))
    cfg = dataclasses.replace(cfg, dtype="float32", remat=False)

    opt = OptConfig(lr=6e-4, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps)
    pipe = DataPipeline(batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
                        num_producers=2, window=32)
    tr = Trainer(cfg, opt, ckpt_dir=args.ckpt_dir, ckpt_every=50, device=args.device)
    if tr.try_restore(pipe):
        print(f"resumed from step {tr.step}")
    print(f"model: {cfg.name} ({param_count(tr.params):,} params), "
          f"{args.steps} steps of {args.batch}x{args.seq}")
    done = 0
    while done < args.steps:
        n = min(10, args.steps - done)
        tr.fit(iter(pipe), n, data_pipe=pipe)
        done += n
        print(f"step {tr.step:4d}  loss {tr.history[-1]:.4f}")
    pipe.close()
    if tr.async_ckpt:
        tr.async_ckpt.close()
    print(f"final: {tr.history[0]:.4f} -> {tr.history[-1]:.4f} "
          f"(stragglers={tr.stragglers})")


if __name__ == "__main__":
    main()
