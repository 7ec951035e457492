"""Exporters for the observability plane (DESIGN.md §13).

Three output formats, all built from the same flight-recorder event tuples
and gauge sweeps:

  * :func:`perfetto_trace` — Chrome/Perfetto ``trace.json`` (the Trace
    Event Format): each traced envelope becomes a chain of complete
    ("ph":"X") slices, one per lifecycle stage, whose duration is the time
    since the previous stage — so the trace viewer shows exactly where an
    envelope's time went (window wait vs. shard hop vs. steal vs. lane).
    Control events render as instants ("ph":"i"). Step spans render as
    nested complete slices of their own duration, a request's
    ``admit.prefill`` in its chain's category. pid = host, tid = replica.
  * :func:`prometheus_text` — Prometheus text exposition (``# HELP`` /
    ``# TYPE`` + samples) over the fabric stats dict and a gauge sweep.
  * :func:`append_jsonl_snapshot` — periodic JSONL snapshots (one JSON
    object per line, raw latency reservoirs stripped) into ``reports/``.

Plus :func:`stage_breakdown`, the measured per-stage latency table the
obs bench reports (where do the p99 milliseconds actually go?).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.obs.recorder import CONTROL_EVENTS, LIFECYCLE_STAGES, SPAN
from repro_torch.sched.stats import _interp_percentile

_STAGE_ORDER = {s: i for i, s in enumerate(LIFECYCLE_STAGES)}


def _spans(events: List[tuple]) -> Dict[tuple, List[tuple]]:
    """Group lifecycle events by (cls, seq) and time-order each chain."""
    chains: Dict[tuple, List[tuple]] = {}
    for ev in events:
        if ev[1] in _STAGE_ORDER:
            chains.setdefault((ev[2], ev[3]), []).append(ev)
    for chain in chains.values():
        # same-timestamp stages (producer emits three in one clock read)
        # tie-break on lifecycle order so spans never go negative
        chain.sort(key=lambda ev: (ev[0], _STAGE_ORDER[ev[1]]))
    return chains


def perfetto_trace(events: List[tuple], *, path: Optional[str] = None
                   ) -> dict:
    """Flight-recorder events -> a Chrome/Perfetto Trace Event Format dict
    (written to ``path`` when given). Timestamps are microseconds relative
    to the earliest recorded event."""
    if events:
        t0 = min(ev[0] for ev in events)
    else:
        t0 = 0.0
    us = lambda t: (t - t0) * 1e6  # noqa: E731
    out: List[dict] = []
    for (cls, seq), chain in sorted(_spans(events).items()):
        prev_t = chain[0][0]
        for t, stage, _, _, rid, host, arg in chain:
            ev = {"name": stage, "ph": "X", "cat": cls,
                  "ts": round(us(prev_t), 3),
                  "dur": round((t - prev_t) * 1e6, 3),
                  "pid": host, "tid": rid,
                  "args": {"cls": cls, "seq": seq}}
            if arg is not None:
                ev["args"]["detail"] = arg
            out.append(ev)
            prev_t = t
    for t, stage, cls, seq, rid, host, arg in events:
        if stage in CONTROL_EVENTS:
            out.append({"name": stage, "ph": "i", "s": "t", "cat": cls,
                        "ts": round(us(t), 3), "pid": host, "tid": rid,
                        "args": {"cls": cls, "seq": seq, "detail": arg}})
        elif stage == SPAN:
            # both ends rounded alike, so a child never pokes out of its
            # parent
            ts, end = round(us(t), 3), round(us(arg.end), 3)
            args = {"sid": arg.sid, "parent": arg.parent}
            if cls is not None:
                args.update(cls=cls, seq=seq)
            if arg.uid is not None:
                args["uid"] = arg.uid
            out.append({"name": arg.name, "ph": "X",
                        "cat": SPAN if cls is None else cls,
                        "ts": ts, "dur": round(end - ts, 3),
                        "pid": host, "tid": rid, "args": args})
    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def stage_breakdown(events: List[tuple]) -> Dict[str, dict]:
    """Per-stage latency table from the traced envelopes: for each adjacent
    lifecycle stage pair actually observed, the p50/p99/mean milliseconds
    spent *reaching* the later stage. The first measured answer to "where
    do the p99 admission milliseconds come from?"."""
    deltas: Dict[str, List[float]] = {}
    for chain in _spans(events).values():
        for (t0, s0, *_), (t1, s1, *_) in zip(chain, chain[1:]):
            deltas.setdefault(f"{s0}->{s1}", []).append(t1 - t0)
    out: Dict[str, dict] = {}
    for key, ds in sorted(deltas.items()):
        ds.sort()
        out[key] = {
            "n": len(ds),
            "p50_ms": _interp_percentile(ds, 50) * 1e3,
            "p99_ms": _interp_percentile(ds, 99) * 1e3,
            "mean_ms": sum(ds) / len(ds) * 1e3,
        }
    return out


def format_class_lines(stats, prefix: str = "[stats]") -> List[str]:
    """One compact human-readable line per class from the fabric stats —
    a :class:`~repro_torch.fabric.stats.StatsView` or its ``to_json()`` dict —
    the serve.py ``--stats-interval`` heartbeat format."""
    if hasattr(stats, "to_json"):
        stats = stats.to_json()
    out = []
    for name, cs in sorted(stats.get("classes", {}).items()):
        slo = stats.get("slo", {}).get(name, {})
        p50, p99 = cs.get("admit_p50_ms"), cs.get("admit_p99_ms")
        fmt = lambda v: "-" if v is None else f"{v:.2f}"  # noqa: E731
        line = (f"{prefix} class {name}: submitted={cs.get('submitted', 0)} "
                f"delivered={cs.get('delivered', 0)} "
                f"rejected={cs.get('rejected', 0)} "
                f"requeued={cs.get('requeued', 0)} "
                f"pending={cs.get('pending', 0)} "
                f"p50_ms={fmt(p50)} p99_ms={fmt(p99)}")
        if slo.get("target_ms") is not None:
            line += f" slo_ok={slo.get('ok')}"
        out.append(line)
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_COUNTER_KEYS = {
    "submitted", "rejected", "delivered", "requeued", "gap_waits",
    "enq_retries", "deq_scans", "reclaimed", "reclaim_passes",
    "reclaim_contended", "rescued", "steals", "stolen_cycles",
    "empty_drains", "remote_msgs", "remote_bytes", "drops", "delayed",
    "reordered", "retransmits", "remote_claims", "fetches", "publishes",
    "kernel_calls", "pushed", "claimed", "steps", "dropped", "count",
    "pool_allocated", "shed",
}


def _prom_name(key: str) -> str:
    return "repro_" + key.replace(".", "_").replace("-", "_")


def prometheus_text(stats, gauges: Optional[dict] = None) -> str:
    """Fabric stats (+ optional gauge sweep) -> Prometheus text exposition.

    ``stats`` is a :class:`~repro_torch.fabric.stats.StatsView` or its
    ``to_json()`` dict. Per-class series carry a ``{cls="..."}`` label;
    everything else flattens to dotted metric names. Counters (monotone
    totals) are typed ``counter``, the rest ``gauge``.
    """
    from repro_torch.obs.gauges import flatten_gauges

    if hasattr(stats, "to_json"):
        stats = stats.to_json()

    series: List[tuple] = []  # (name, labels, value, prom_type)

    def add(path: str, value, labels: str = "") -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        typ = "counter" if path.split(".")[-1] in _COUNTER_KEYS else "gauge"
        series.append((_prom_name(path), labels, value, typ))

    for name, cs in stats.get("classes", {}).items():
        label = f'{{cls="{name}"}}'
        for key, val in cs.items():
            if key in ("class", "name", "shard_depths", "latency_samples"):
                continue
            typ = "counter" if key in _COUNTER_KEYS else "gauge"
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                series.append((_prom_name(f"class_{key}"), label, val, typ))
    for name, slo in stats.get("slo", {}).items():
        label = f'{{cls="{name}"}}'
        for key in ("target_ms", "admit_p99_ms", "headroom_ms"):
            val = slo.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                series.append((_prom_name(f"slo_{key}"), label, val, "gauge"))
    for key, val in stats.get("transport", {}).items():
        if key == "rtt_ms" and isinstance(val, dict):
            # per-dest-host RTT percentiles from the obs hub (the wire
            # transport and rtt-injected sim both feed record_rtt)
            for host, pct in val.items():
                if not isinstance(pct, dict):
                    continue
                for q in ("p50", "p99"):
                    v = pct.get(q)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        series.append((
                            _prom_name("transport_rtt_ms"),
                            f'{{host="{host}",quantile="{q}"}}', v, "gauge"))
                n = pct.get("count")
                if isinstance(n, (int, float)) and not isinstance(n, bool):
                    series.append((_prom_name("transport_rtt_count"),
                                   f'{{host="{host}"}}', n, "counter"))
            continue
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            typ = "counter" if key in _COUNTER_KEYS else "gauge"
            series.append((_prom_name(f"transport_{key}"), "", val, typ))
    for key in ("step", "num_replicas", "resizes"):
        if key in stats:
            series.append((_prom_name(key), "", stats[key], "gauge"))
    tenants = stats.get("tenants") or {}
    for key in ("declared", "groups", "tracked", "active_backlog",
                "active_classes", "shed_total"):
        val = tenants.get(key)
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            typ = "counter" if key == "shed_total" else "gauge"
            series.append((_prom_name(f"tenants_{key}"), "", val, typ))
    for tot_key, tot_val in (tenants.get("totals") or {}).items():
        if isinstance(tot_val, (int, float)) and not isinstance(tot_val, bool):
            series.append((_prom_name(f"tenants_total_{tot_key}"), "",
                           tot_val, "counter"))
    obs = stats.get("obs", {})
    for rid, rec in obs.get("recorders", {}).items():
        label = f'{{rid="{rid}"}}'
        series.append((_prom_name("obs_events_dropped"), label,
                       rec.get("dropped", 0), "counter"))
        for stage, n in rec.get("counts", {}).items():
            series.append((_prom_name("obs_events_total"),
                           f'{{rid="{rid}",stage="{stage}"}}', n, "counter"))
    if gauges:
        for path, value in flatten_gauges(gauges):
            add(path.replace("obs.", "", 1), value)

    # The exposition format wants every line of one metric in a single
    # contiguous group; dedupe (name, labels) — e.g. transport counters
    # appear in both the stats dict and the gauge sweep — keeping the first.
    grouped: Dict[str, List[tuple]] = {}
    types: Dict[str, str] = {}
    seen_sample = set()
    for name, labels, value, typ in series:
        if (name, labels) in seen_sample:
            continue
        seen_sample.add((name, labels))
        grouped.setdefault(name, []).append((labels, value))
        types.setdefault(name, typ)
    lines: List[str] = []
    for name, samples in grouped.items():
        lines.append(f"# HELP {name} repro fabric metric")
        lines.append(f"# TYPE {name} {types[name]}")
        for labels, value in samples:
            v = f"{value:.9g}" if isinstance(value, float) else str(value)
            lines.append(f"{name}{labels} {v}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSONL snapshots
# ---------------------------------------------------------------------------

def strip_samples(obj):
    """Deep-copy ``obj`` without raw latency reservoirs (they are exact-
    merge plumbing, not snapshot payload — DESIGN.md §13 size convention)."""
    if isinstance(obj, dict):
        return {k: strip_samples(v) for k, v in obj.items()
                if k != "latency_samples"}
    if isinstance(obj, (list, tuple)):
        return [strip_samples(v) for v in obj]
    return obj


def append_jsonl_snapshot(path: str, snapshot: dict, *,
                          t: Optional[float] = None) -> None:
    """Append one snapshot line to a JSONL file (parents created)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    rec = {"t": time.time() if t is None else t, **strip_samples(snapshot)}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
