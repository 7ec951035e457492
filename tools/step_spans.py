"""A benchmark cell with the engine's step spans on: where the serving
step's host time goes, and what the device does meanwhile.

    python tools/step_spans.py --workload <cell> --seed <n> --seconds <s>
                               [--slice <s>] [--spans 0|1] [--out PATH]

from the root of a checkout, on a CUDA device (``--device cpu`` runs the
small smoke cells of ``port_bench.smoke`` instead: ``--workload
smoke.yi-6b``). It sets a cell up as ``port_bench/run.py`` does (the same
weights, traffic, fabric and closed loop) but with the flight recorder
attached (``FabricConfig(obs=ObsConfig(trace_rate=0.0))``; ``--spans 0``
leaves it off), runs the window, then ``--slice`` seconds under
``torch.profiler`` (default: the cell's ``trace_slice_s``; 0 skips it).
It judges nothing. The last line of standard output is one JSON object:
the window's ``gen_tok_s`` and ``steps``, and with spans the recorder's
readings over the window (``port_bench.spans.step_metrics``:
``admit_ms_per_step``, ``decode_enqueue_ms``, ``host_reads_per_step``, and
each span's milliseconds, count and reads a step), and from the slice
``idle_share`` (``profiled.reduce``), the three idle shares under
``engine.admit``, ``engine.decode`` and the rest
(``port_bench.spans.idle_by_span``) with the idle seconds by innermost
span, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def build_fabric(cell, pc, params, fwd, device, spans: bool):
    """``port_bench.harness.build_fabric``, with the obs plane on when
    ``spans``: no lifecycle sampling, so the rings hold the step spans."""
    from repro_torch.fabric.config import FabricConfig
    from repro_torch.fabric.session import Fabric
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.engine import EngineReplicaGroup

    e = cell.engine
    geometry = dict(max_batch=e["max_batch"], page_size=e["page_size"],
                    num_pages=e["num_pages"], max_seq=e["max_seq"])
    config = FabricConfig(arch=cell.cfg["arch"], smoke=cell.port_cfg is not None,
                          kv_window=e["kv_window"], device_admission=True,
                          obs=ObsConfig(trace_rate=0.0) if spans else None, **geometry)
    group = EngineReplicaGroup(pc, params, num_replicas=1, window=e["kv_window"],
                               forward_fn=fwd, device_admission=True, device=device,
                               **geometry)
    return Fabric(config, group=group, model_cfg=pc, params=params, device=device)


def profile(loop, seconds: float, cuda: bool):
    """``Loop.profile``'s slice, reduced by ``profiled.reduce`` and by
    ``spans.idle_by_span``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from port_bench import profiled, spans

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    loop.fwd.ranges = True
    with torch_profile(activities=acts) as prof:
        t = loop.clock()
        while True:
            with record_function(profiled.STEP):
                loop.step()
            if loop.clock() - t >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
    loop.fwd.ranges = False
    return profiled.reduce(prof), spans.idle_by_span(prof)


def run(cell, seed: int, seconds: float, *, spans: bool = True, slice_s=None,
        device="cuda", clock=time.perf_counter, t_start=None) -> dict:
    import torch

    from port_bench import files, harness, traffic, weights
    from port_bench import spans as span_reader

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pc = cell.port_cfg if cell.port_cfg is not None else harness.port_config(cell.cfg)
    if cuda:
        from repro_torch.kernels import _build

        _build.lib()
    params = weights.make_weights(cell.cfg, seed, device)
    fwd = harness.Forward(pc)
    fabric = build_fabric(cell, pc, params, fwd, device, spans)
    loop = harness.Loop(fabric, traffic.ClosedLoop(cell.mix, cell.cfg["vocab_size"], seed),
                        fwd, clock)
    loop.ramp()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    hub = fabric.obs
    before = hub.totals() if hub is not None else None
    loop.window(seconds, sample_kv=False)
    after = hub.totals() if hub is not None else None
    obs = loop.observations()
    out = {"workload": cell.name, "seed": seed, "spans": spans, "setup_s": setup_s,
           "window_s": obs["window_s"], "steps": len(obs["steps"]),
           "gen_tok_s": files.load_module("metrics", "gen_tok_s").read(obs),
           "window": span_reader.step_metrics(before, after)}
    slice_s = cell.trace_slice_s if slice_s is None else slice_s
    if slice_s > 0:
        prof, idle = profile(loop, slice_s, cuda)
        out["idle_share"] = 100.0 * (1.0 - prof["busy_s"] / prof["slice_s"])
        out["slice_s"], out["busy_s"] = prof["slice_s"], prof["busy_s"]
        out.update(span_reader.idle_shares(idle))
        out["idle_by_span"] = idle
        out["slice"] = span_reader.step_metrics(after, hub.totals()) if hub else None
    fabric.close(final_checkpoint=False)
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--slice", type=float, default=None)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append the JSON line to OUT")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from port_bench import files, harness, smoke

    if args.workload.startswith("smoke."):
        cell = smoke.cell(args.workload[len("smoke."):])
    else:
        cell = harness.load_cell(args.workload, files.benchmark(ROOT))
    out = run(cell, args.seed, args.seconds, spans=bool(args.spans), slice_s=args.slice,
              device=args.device, t_start=T_START)
    if args.device != "cpu":
        out["card"] = card()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
