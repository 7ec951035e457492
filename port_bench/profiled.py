"""Reduces the traced run's ``torch.profiler`` slice to the numbers the
per-layer readers and the result line take: the slice's length, the
device's busy time (the union of every device operation's interval, copies
and sets included), kernel time by name, launches a decode call, the
expert products' device time, the longest device operations and idle gaps.
All times come from the profiler's one timeline (microseconds)."""

from __future__ import annotations

import bisect
from collections import defaultdict
import torch

STEP = "pb.step"  # the harness's record_function label around Fabric.step
# its label around each decode forward call (the engine's one call over
# every lane a step)
DECODE = "pb.decode"
# the profiler's own host events: not what the program was doing
PROFILER = ("Activity Buffer Request",)
# host calls that launch one kernel each (the CUDA runtime's and cu* API's)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _device_us(evt) -> float:
    """Device time of the kernels an op launched (its children's included)."""
    return getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, top: int = 10) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, steps, decodes, launches = [], [], [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("pb.") or getattr(e, "is_user_annotation", False):
            if e.device_type != cuda and e.name == STEP:
                steps.append((s, t))
            elif e.device_type != cuda and e.name == DECODE:
                decodes.append((s, t))
            continue
        if e.device_type == cuda:
            dev.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
            if e.name in LAUNCHES:
                launches.append(s)
    steps.sort()
    if not steps:
        raise RuntimeError("the profiled slice holds no step")
    lo, hi = steps[0][0], steps[-1][1]
    by_name = defaultdict(float)
    iv = []
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by_name[name] += (t - s) * 1e-6
            iv.append((s, t))
    busy = _merge(iv)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = t
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    idle = []
    for length, s, t in gaps[:top]:
        mid = 0.5 * (s + t)
        inner = [h for h in host if h[0] <= mid <= h[1] and h[2] not in PROFILER]
        name = max(inner, key=lambda h: (h[0], -h[1]))[2] if inner else "host: no op"
        idle.append([name, length * 1e-6])
    launches.sort()
    n_launch = sum(bisect.bisect_right(launches, t) - bisect.bisect_left(launches, s)
                   for s, t in decodes)
    bmm_us = sum(_device_us(a) for a in prof.key_averages() if a.key == "aten::bmm")
    return {
        "slice_s": (hi - lo) * 1e-6,
        "busy_s": busy_s,
        "kernel_s": dict(by_name),
        "decode_calls": len(decodes),
        "launches_per_decode_step": n_launch / len(decodes) if decodes else None,
        "bmm_s": bmm_us * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": idle,
    }


def kernel_s(profile: dict, *needles: str) -> float:
    """Device seconds of the kernels whose names hold any of ``needles``."""
    return sum(v for k, v in profile["kernel_s"].items() if any(n in k for n in needles))
