#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from: for each seed, one
run of the cell (a window of ``--seconds``), the program's widest gap
against the plain reference, and with ``--control`` the gap of the control,
the reference computed in float8 at the same positions. All seeds in one
process, one JSON line each on standard output.

    python3 port_bench/calibrate.py --workload <cell> --seconds 8 --seeds 1 2 3 [--control]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch

    from port_bench import files, harness

    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, files.benchmark(ROOT))
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, control=args.control)
        line = {"workload": args.workload, "seed": seed, "correct": r["correct"],
                **(r["readings"] or {}),
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
