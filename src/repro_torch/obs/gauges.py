"""CMP protection gauges, sampled from existing domain counters
(DESIGN.md §13).

Everything here is a read-only sweep over state the fabric already
maintains for correctness — the domain cycle clocks (``cycle`` −
``deque_cycle`` vs. the protection window W), the reclaim diagnostics,
the node-pool allocation counter, the device-ring depth properties and
the transport counters. A gauge sweep adds zero atomics and zero hot-path
work; like every diagnostic read in this repo it is approximate under
races and exact when quiesced.
"""

from __future__ import annotations

from typing import List


def sample_cmp_shard(q) -> dict:
    """One CMP shard's protection-domain view: window occupancy (how full
    the bounded protection window actually runs — the quantity
    bounded-memory designs argue about), reclaim progress/stall counters,
    and node-pool recycling."""
    cycle = q.cycle.load()
    dc = q.deque_cycle.load()
    occ = max(0, cycle - dc)
    return {
        "cycle": cycle,
        "deque_cycle": dc,
        "window": q.window,
        "occupancy": occ,
        "occupancy_frac": occ / q.window if q.window else 0.0,
        "pool_allocated": q.pool.allocated,
        **q.stats,  # enq_retries / deq_scans / reclaimed / reclaim_passes
                    # / reclaim_contended / rescued
    }


def sample_class_shards(qc) -> dict:
    """Per-class roll-up over its CMP shards: worst-case window occupancy
    (the shard closest to its protection bound), summed reclaim/rescue
    counters."""
    shards = [sample_cmp_shard(q) for q in qc.shards.queues]
    agg = {
        "class": qc.name,
        "num_shards": len(shards),
        "occupancy_frac_max": max((s["occupancy_frac"] for s in shards),
                                  default=0.0),
        "occupancy_total": sum(s["occupancy"] for s in shards),
        "pool_allocated": sum(s["pool_allocated"] for s in shards),
    }
    for key in ("enq_retries", "deq_scans", "reclaimed", "reclaim_passes",
                "reclaim_contended", "rescued"):
        agg[key] = sum(s.get(key, 0) for s in shards)
    return agg


def sample_admission_ring(ring) -> dict:
    """Device-admission ring depth + kernel-call amortization counters."""
    return {
        "capacity": ring.capacity,
        "pending": ring.pending,
        "buffered": ring.buffered,
        "room": ring.room,
        **ring.stats,  # steps / kernel_calls / pushed / claimed / rejected
    }


def sample_transport(transport, hub=None) -> dict:
    """Transport counters + (when a hub is attached) per-host RTT
    percentiles from the hub's histograms. Retries/drops are the
    transport's own counters — the retry half of the RTT/retry story."""
    out = dict(transport.stats())
    if hub is not None:
        out["rtt_ms"] = {
            host: {
                "p50": None if (p := w.percentile(50)) is None else p * 1e3,
                "p99": None if (p := w.percentile(99)) is None else p * 1e3,
                "count": w.count,
            }
            for host, w in sorted(hub.rtt.items())}
    return out


def sample_fabric_gauges(replica_set, engines=(), hub=None) -> dict:
    """One full gauge sweep over a fabric: per-class CMP protection view,
    per-engine admission-ring depth, transport RTT/retry. This is the dict
    the :class:`~repro_torch.obs.hub.MetricsHub` appends to its rolling window."""
    sched = replica_set.scheduler
    act = getattr(sched, "active", None)
    # Tenant fabrics track an active-class set: sweep only classes that
    # currently hold work, so the gauge cost is O(active), not O(declared)
    # — a 10k-tenant grid with 100 hot groups samples ~300 classes, not
    # 30k. Without active tracking (act is None) sweep everything.
    classes = (sched.classes if act is None
               else [sched.by_name[n] for n in act.names()])
    out: dict = {
        "classes": {qc.name: sample_class_shards(qc) for qc in classes},
        "transport": sample_transport(replica_set.transport, hub),
        "pending": replica_set.pending(),
    }
    rings = {}
    for eng in engines:
        ring = getattr(eng, "_dev_admit", None)
        if ring is not None:
            rings[eng.sched.rid] = sample_admission_ring(ring)
    if rings:
        out["admission_rings"] = rings
    return out


def flatten_gauges(sample: dict, prefix: str = "obs") -> List[tuple]:
    """Flatten a gauge sweep into ``(dotted.key, value)`` pairs of plain
    numbers — the Prometheus exporter's input."""
    out: List[tuple] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            out.append((path, node))

    walk(sample, prefix)
    return out
