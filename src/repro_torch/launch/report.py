"""Assemble the EXPERIMENTS.md roofline tables from reports/dryrun/*.json.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir reports/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load(dirname):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def table(rows, mesh):
    out = [
        "| arch | shape | status | compute | memory | collective | dominant "
        "| flops/chip | bytes/chip | wire/chip | useful FLOPs | params |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    rows = [r for r in rows if r.get("mesh") == mesh]
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9)))
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | skip (full-attn, "
                       f"DESIGN.md §4) | — | — | — | — | — | — | — | — |")
            continue
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | — | — | — | — "
                       f"| — | — | — | — |")
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {fmt_s(t['compute_s'])} "
            f"| {fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} "
            f"| **{t['dominant']}** | {t['flops_per_chip']:.2e} "
            f"| {fmt_b(t['bytes_per_chip'])} | {fmt_b(t['wire_bytes_per_chip'])} "
            f"| {t['useful_flops_ratio']:.2f} | {t['n_params']/1e9:.2f}B |")
    return "\n".join(out)


def summarize(rows, mesh):
    ok = [r for r in rows if r.get("mesh") == mesh and r.get("ok") and not r.get("skipped")]
    skip = [r for r in rows if r.get("mesh") == mesh and r.get("skipped")]
    fail = [r for r in rows if r.get("mesh") == mesh and not r.get("ok")]
    return f"{len(ok)} compiled, {len(skip)} documented skips, {len(fail)} failures"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun")
    args = ap.parse_args()
    rows = load(args.dir)
    for mesh in ("pod16x16", "pod2x16x16"):
        print(f"\n### Mesh {mesh} — {summarize(rows, mesh)}\n")
        print(table(rows, mesh))


if __name__ == "__main__":
    main()
