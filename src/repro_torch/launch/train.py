"""Training driver: CMP data pipeline -> fault-tolerant Trainer, in torch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 50 --batch 8 --seq 128 [--ckpt-dir ckpt/] [--resume]

The same flags as the JAX package's driver, plus ``--device`` (``cuda``,
the default, or ``cpu``). The model trains on one device; the checkpoint is
the JAX package's format, so ``--resume`` continues from a directory either
package wrote.
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--producers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (custom model size)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default: cuda)")
    return ap


def main(argv=None) -> dict:
    """Run the driver on ``argv`` (the command line when None). Returns the
    run's parameter count, per-step losses and step seconds, and the
    trainer's final step."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import param_count
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.d_model or args.layers:
        pat = len(cfg.block_pattern)
        cfg = dataclasses.replace(
            cfg,
            d_model=args.d_model or cfg.d_model,
            num_layers=(args.layers or cfg.num_layers) // pat * pat,
            d_ff=(args.d_model or cfg.d_model) * 4 if cfg.d_ff else 0,
            head_dim=(args.d_model or cfg.d_model) // cfg.num_heads,
        )
    opt = OptConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                    total_steps=args.steps,
                    moment_dtype=cfg.optimizer_state_dtype)
    pipe = DataPipeline(batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
                        num_producers=args.producers, window=64)
    tr = Trainer(cfg, opt, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 device=args.device)
    n_params = param_count(tr.params)
    print(f"[train] {cfg.name}: {n_params:,} params, "
          f"{args.steps} steps of {args.batch}x{args.seq}")
    if args.resume and tr.try_restore(pipe):
        print(f"[train] resumed from step {tr.step}")

    t0 = time.time()
    it = iter(pipe)
    done = 0
    try:
        while done < args.steps:
            chunk = min(10, args.steps - done)
            tr.fit(it, chunk, data_pipe=pipe)
            done += chunk
            dt = time.time() - t0
            print(f"[train] step {tr.step}  loss {tr.history[-1]:.4f}  "
                  f"({dt/done:.2f}s/step, stragglers={tr.stragglers})")
    finally:
        pipe.close()
        if tr.async_ckpt:
            tr.async_ckpt.close()
    print(f"[train] done: loss {tr.history[0]:.4f} -> {tr.history[-1]:.4f}")
    return {"params": n_params, "losses": list(tr.history),
            "step_seconds": list(tr.step_times), "steps": tr.step}


if __name__ == "__main__":
    main()
