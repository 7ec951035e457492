"""Fabric-wide metrics hub (DESIGN.md §13).

The :class:`MetricsHub` is the one object the rest of the system talks to:

  * it owns the per-replica :class:`~repro_torch.obs.recorder.FlightRecorder`
    rings (plus the producer-side ring) and hands them out at attach time;
  * it keeps the per-host transport **RTT histograms** (fed by the
    transport's remote-op timing when a hub is attached);
  * it maintains a **rolling window** of timestamped gauge sweeps — the
    future autoscaler's input: a controller reads ``hub.window()`` and
    gets the last ``metrics_window_s`` seconds of protection-window
    occupancy, queue depth, ring depth and RTT without touching the fabric.

Attachment is post-construction and idempotent: emitting objects carry a
class-level ``_obs = None`` default (so un-attached fabrics pay one
``is None`` check), and :meth:`attach` re-walks the object graph after any
operation that rebuilds replicas or engines (open / restore / resize /
fail_host).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Tuple

from repro_torch.obs.gauges import sample_fabric_gauges
from repro_torch.obs.recorder import PRODUCER_RID, FlightRecorder, ObsConfig
from repro_torch.sched.stats import LatencyWindow


class MetricsHub:
    def __init__(self, config: ObsConfig):
        config.validate()
        self.config = config
        self._recorders: Dict[int, FlightRecorder] = {}
        self.rtt: Dict[int, LatencyWindow] = {}  # dest host -> histogram
        self._window: Deque[Tuple[float, dict]] = deque()
        self.samples_taken = 0

    # ---------------------------------------------------------- recorders
    def recorder(self, rid: int = PRODUCER_RID, host: int = 0
                 ) -> FlightRecorder:
        rec = self._recorders.get(rid)
        if rec is None:
            rec = self._recorders[rid] = FlightRecorder(
                self.config, host=host, rid=rid)
        return rec

    def events(self) -> List[tuple]:
        """All retained events across every ring, time-ordered — the
        exporters' input."""
        out: List[tuple] = []
        for rec in self._recorders.values():
            out.extend(rec.events())
        out.sort(key=lambda ev: ev[0])
        return out

    # ---------------------------------------------------------------- RTT
    def record_rtt(self, host: int, seconds: float) -> None:
        """One remote-op round trip to ``host`` (called by the transport's
        remote paths when a hub is attached — never on home-host ops)."""
        w = self.rtt.get(host)
        if w is None:
            w = self.rtt[host] = LatencyWindow(1024)
        w.record(seconds)

    # --------------------------------------------------------- attachment
    def attach(self, replica_set, engines=()) -> None:
        """(Re-)wire every emit site of a fabric to this hub's recorders.
        Idempotent; call after any operation that rebuilds replicas or
        engines (open / restore / resize / fail_host)."""
        producer = self.recorder(PRODUCER_RID)
        for qc in replica_set.scheduler.classes:
            qc._obs = producer
            for q in qc.shards.queues:
                q._obs = producer
                q._obs_cls = qc.name
        for r in replica_set.replicas:
            rec = self.recorder(r.rid, r.addr.host)
            r._obs = rec
            for v in r.views:
                v._obs = rec
        replica_set.transport._obs = self
        for eng in engines:
            rec = self.recorder(eng.sched.rid, eng.sched.addr.host)
            eng._obs = rec
            ring = getattr(eng, "_dev_admit", None)
            if ring is not None:
                ring._obs = rec
            pool = getattr(eng, "pool", None)
            if pool is not None:  # counts its host reads
                pool._obs = rec

    # ------------------------------------------------------ rolling window
    def sample(self, replica_set, engines=()) -> dict:
        """One gauge sweep, appended to the rolling window (older samples
        past ``metrics_window_s`` drop off the front)."""
        now = time.monotonic()
        sweep = sample_fabric_gauges(replica_set, engines, hub=self)
        self._window.append((now, sweep))
        self.samples_taken += 1
        horizon = now - self.config.metrics_window_s
        while self._window and self._window[0][0] < horizon:
            self._window.popleft()
        return sweep

    def window(self) -> List[Tuple[float, dict]]:
        """The retained (timestamp, gauge-sweep) samples, oldest first."""
        return list(self._window)

    def totals(self) -> dict:
        """Running span and counter totals summed over every recorder:
        ``span_n`` / ``span_s`` by span name, ``span_counters`` by
        (counter, innermost span). Differences of two readings cover the
        steps between them, however many the rings kept."""
        out = {"span_n": {}, "span_s": {}, "span_counters": {}}
        for rec in self._recorders.values():
            for key in out:
                acc = out[key]
                for k, v in getattr(rec, key).items():
                    acc[k] = acc.get(k, 0) + v
        return out

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """The ``Fabric.stats_view().obs`` view: recorder ring health +
        per-stage event totals, RTT percentiles, rolling-window extent,
        and the latest gauge sweep (when one has been taken)."""
        counts: Dict[str, int] = {}
        for rec in self._recorders.values():
            for stage, n in rec.counts.items():
                counts[stage] = counts.get(stage, 0) + n
        out = {
            "trace_rate": self.config.trace_rate,
            "events_total": counts,
            "recorders": {rid: rec.snapshot()
                          for rid, rec in sorted(self._recorders.items())},
            "rtt_ms": {
                host: {"p50": None if (p := w.percentile(50)) is None
                       else p * 1e3,
                       "p99": None if (p := w.percentile(99)) is None
                       else p * 1e3,
                       "count": w.count}
                for host, w in sorted(self.rtt.items())},
            "window": {"samples": len(self._window),
                       "span_s": (self._window[-1][0] - self._window[0][0]
                                  if len(self._window) > 1 else 0.0),
                       "taken": self.samples_taken},
        }
        if self._window:
            out["gauges"] = self._window[-1][1]
        return out
