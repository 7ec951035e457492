"""The engine's step spans, read two ways: the recorder's running totals
over a window (``step_metrics``), and the device's idle time in a profiled
slice put down to the span open over it (``idle_by_span``).

With a flight recorder attached to the fabric (``FabricConfig(obs=
ObsConfig(trace_rate=0.0))``) every ``Fabric.step`` records ``fabric.step``
> ``engine.step`` > its phases, and while ``torch.profiler`` records each
span is also a ``repro.<span>`` range on the profiler's timeline. Without
spans (no recorder, or a program that has none) both functions return
``None``.

The device's busy time is the union of the same device intervals that
``profiled.reduce`` takes, over the same slice (the first ``pb.step``
range's start to the last one's end), so the three idle shares (under
``engine.admit``, under ``engine.decode``, and every other instant)
partition its ``idle_share``.
"""

from __future__ import annotations

from typing import Optional

import torch

from port_bench import profiled

# the program's names (repro_torch.obs.recorder), spelt out here so this
# module loads against a program that has no spans
PREFIX = "repro."  # the profiler range of span s is PREFIX + s
ADMIT, DECODE = "engine.admit", "engine.decode"
# the engine's spans: engine.step and every phase inside it
ENGINE = ("engine.step", "engine.admit", "admit.ring", "admit.prefill",
          "engine.grow", "engine.decode", "engine.read", "engine.retire")
HOST_READS = "host_reads"


def step_metrics(before: dict, after: dict) -> Optional[dict]:
    """The window's metrics from two readings of ``MetricsHub.totals()``
    (its start and end): ``admit_ms_per_step`` (``engine.admit`` seconds
    over the window's engine steps), ``decode_enqueue_ms`` (``engine.decode``
    seconds over its count: the host's time to issue one decode forward),
    ``host_reads_per_step`` (the reads made inside the engine's spans over
    its steps); and each span's seconds and reads a step."""
    if before is None or after is None:
        return None

    def diff(key, k):
        return after[key].get(k, 0) - before[key].get(k, 0)

    steps = diff("span_n", "engine.step")
    if steps <= 0:
        return None
    reads = {k[1]: diff("span_counters", k) for k in after["span_counters"]
             if k[0] == HOST_READS}
    n_dec = diff("span_n", DECODE)
    return {
        "steps": steps,
        "admit_ms_per_step": 1e3 * diff("span_s", ADMIT) / steps,
        "decode_enqueue_ms": 1e3 * diff("span_s", DECODE) / n_dec if n_dec else None,
        "host_reads_per_step": sum(v for k, v in reads.items() if k in ENGINE) / steps,
        "span_ms_per_step": {k: 1e3 * diff("span_s", k) / steps for k in after["span_s"]},
        "span_n_per_step": {k: diff("span_n", k) / steps for k in after["span_n"]},
        "reads_per_step": {str(k): v / steps for k, v in reads.items()},
    }


def idle_by_span(prof) -> Optional[dict]:
    """The slice's idle device time put down to the ``repro.*`` ranges:
    ``admit_s`` under ``engine.admit`` (its ring call and prefills
    included), ``decode_s`` under ``engine.decode``, ``other_s`` every
    other idle instant (grow, read, retire, fabric, outside any span), and
    ``innermost``, each idle second by the innermost range open over it
    (``"outside"`` where none is)."""
    cuda = torch.autograd.DeviceType.CUDA
    steps, dev, ranges = [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != cuda and e.name.startswith(PREFIX):
            ranges.append((s, t, e.name[len(PREFIX):]))
            continue
        # the same filter as profiled.reduce
        if e.name.startswith("pb.") or getattr(e, "is_user_annotation", False):
            if e.device_type != cuda and e.name == profiled.STEP:
                steps.append((s, t))
            continue
        if e.device_type == cuda:
            dev.append((s, t))
    if not ranges or not steps:
        return None
    lo, hi = min(s for s, _ in steps), max(t for _, t in steps)
    busy = profiled._merge([(max(s, lo), min(t, hi)) for s, t in dev if min(t, hi) > max(s, lo)])
    idle, prev = [], lo
    for s, t in busy:
        if s > prev:
            idle.append((prev, s))
        prev = t
    if hi > prev:
        idle.append((prev, hi))
    # elementary segments between range ends; in each, the open ranges
    points = sorted({lo, hi, *(x for s, t, _ in ranges for x in (s, t) if lo < x < hi)})
    ranges.sort()
    out = {"slice_s": (hi - lo) * 1e-6, "idle_s": sum(t - s for s, t in idle) * 1e-6,
           "admit_s": 0.0, "decode_s": 0.0, "other_s": 0.0, "innermost": {}}
    i, j, open_ = 0, 0, []
    for a, b in zip(points, points[1:]):
        while i < len(ranges) and ranges[i][0] <= a:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] > a]
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        us, k = 0.0, j
        while k < len(idle) and idle[k][0] < b:
            us += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
        if us <= 0:
            continue
        names = {r[2] for r in open_}
        key = "admit_s" if ADMIT in names else "decode_s" if DECODE in names else "other_s"
        out[key] += us * 1e-6
        inner = max(open_, key=lambda r: (r[0], -r[1]))[2] if open_ else "outside"
        out["innermost"][inner] = out["innermost"].get(inner, 0.0) + us * 1e-6
    return out


def idle_shares(spans: Optional[dict]) -> dict:
    """``idle_admit_share``, ``idle_decode_share``, ``idle_other_share``
    (% of the slice) from ``idle_by_span``; empty without spans."""
    if not spans:
        return {}
    return {f"idle_{k}_share": 100.0 * spans[f"{k}_s"] / spans["slice_s"]
            for k in ("admit", "decode", "other")}
