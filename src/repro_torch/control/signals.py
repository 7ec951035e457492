"""Typed signal views for the control loop (signals → decision → actions).

``read_signals(fabric)`` condenses everything the controller is allowed to
see into one frozen :class:`ControlSignals`: per-class depth/weight/SLO
headroom from the fabric's versioned ``stats_view()``, live policy weights
from the scheduler, and the pending-depth trend across the obs plane's
rolling gauge window (``Fabric.obs.window()``). The fabric argument is
duck-typed — this package never imports ``repro_torch.fabric``, mirroring how
``repro_torch.obs`` stays import-light.

Two depth signals with different jobs:

  * ``pending`` / ``backlog_per_replica`` come from the live queue-class
    counters — the *responsive* signal the deadband acts on.
  * ``admit_p99_ms`` / ``headroom_ms`` come from the reservoir latency
    window — the *conformance record*. The reservoir is cumulative, so a
    past breach lingers after the queue drains; the controller therefore
    treats a breach as load only while backlog is also elevated (see
    ``Controller._overloaded``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClassSignal:
    """One queue class as the controller sees it."""

    name: str
    pending: int
    weight: float          # live policy weight (possibly already nudged)
    base_weight: float     # the weight declared in the ClassSpec
    priority: int
    slo_target_ms: Optional[float]
    admit_p99_ms: Optional[float]
    headroom_ms: Optional[float]  # target - p99; negative = target missed


@dataclasses.dataclass(frozen=True)
class ControlSignals:
    """Everything one decision tick reads, frozen at read time."""

    step: int
    num_replicas: int
    max_replicas: int
    num_hosts: int
    transport_kind: str    # "local" | "sim"
    policy: str            # "strict" | "wfq" | "fifo"
    pending_total: int
    backlog_per_replica: float
    pending_trend: Optional[float]  # Δ pending across the obs gauge window
    delivered_total: int   # cumulative deliveries (rate = Δ across ticks)
    capacity_per_step: float  # fleet drain budget per step at current size
    classes: Tuple[ClassSignal, ...]

    def cls(self, name: str) -> ClassSignal:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)


def read_signals(fabric) -> ControlSignals:
    """Snapshot the control inputs from a live fabric (duck-typed)."""
    view = fabric.stats_view()
    cfg = fabric.config
    base = {spec.name: spec for spec in cfg.classes}
    sched = fabric.replica_set.scheduler

    classes = []
    pending_total = 0
    delivered_total = 0
    for name, cs in sorted(view.classes.items()):
        qc = sched.by_name.get(name)
        slo = view.slo.get(name)
        spec = base.get(name)
        pending_total += cs.pending
        delivered_total += cs.delivered
        classes.append(ClassSignal(
            name=name,
            pending=cs.pending,
            weight=float(qc.weight) if qc is not None else 1.0,
            base_weight=float(spec.weight) if spec is not None else 1.0,
            priority=int(qc.priority) if qc is not None else 0,
            slo_target_ms=slo.target_ms if slo is not None else None,
            admit_p99_ms=slo.admit_p99_ms if slo is not None else None,
            headroom_ms=slo.headroom_ms if slo is not None else None,
        ))

    # Pending trend across the rolling gauge window: positive = the
    # backlog grew over the window even if the instantaneous depth looks
    # tolerable. None until the obs plane has sampled at least twice.
    trend: Optional[float] = None
    hub = getattr(fabric, "obs", None)
    if hub is not None:
        window = hub.window()
        if len(window) >= 2:
            first = window[0][1].get("pending")
            last = window[-1][1].get("pending")
            if first is not None and last is not None:
                trend = float(last) - float(first)

    # Fleet drain budget per step: scheduler-only fabrics drain drain_k
    # per replica per step; serving fabrics are lane-bound (max_batch is
    # the fabric-wide lane budget, re-split across replicas on resize).
    if getattr(fabric, "serving", False):
        capacity = float(cfg.max_batch)
    else:
        capacity = float(cfg.drain_k * view.num_replicas)

    return ControlSignals(
        step=view.step,
        num_replicas=view.num_replicas,
        max_replicas=cfg.max_replicas,
        num_hosts=fabric.transport.num_hosts,
        transport_kind=cfg.transport,
        policy=cfg.policy,
        pending_total=pending_total,
        backlog_per_replica=pending_total / max(1, view.num_replicas),
        pending_trend=trend,
        delivered_total=delivered_total,
        capacity_per_step=capacity,
        classes=tuple(classes),
    )
