"""Flight recorder: per-replica lifecycle event rings (DESIGN.md §13).

The observability plane follows the same zero-added-atomics discipline as
the rest of the telemetry stack (``sched/stats.py``): event appends are
plain GIL-atomic list operations by whichever single thread owns the
emitting object (the drainer for drain-side stages, the producer for
submit-side stages), and reads are sampled diagnostic snapshots —
approximate under races, exact when quiesced. No lock, no atomic, no
allocation beyond one tuple per recorded event ever enters the hot path.

Head-sampling keeps the hot path O(1): the trace decision for an envelope
is a pure function of its class cycle — ``seq % every == 0`` with
``every = round(1 / trace_rate)`` — so every emit site along the lifecycle
agrees on which envelopes are traced *without the envelope carrying a trace
bit* (``Envelope`` is a ``__slots__`` dataclass; the sampling arithmetic is
cheaper than widening it). Control events (steals, rescues, device-ring
kernel calls, flushes) are rare by construction and always recorded.

Event tuples are ``(t, stage, cls, seq, rid, host, arg)`` — ``t`` from the
same monotonic clock as the admission-latency stamps, so exporter-built
spans and the latency reservoirs agree on durations.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Event taxonomy (DESIGN.md §13). The eight lifecycle stages, in envelope
# order; plus the control events. Stage names are the wire strings — emit
# sites outside this package (e.g. core/cmp.py, which must not import obs)
# use the literals, and these constants pin them.
# ---------------------------------------------------------------------------
SUBMIT = "submit"                # class-cycle stamp assigned (producer)
WINDOW_ADMIT = "window_admit"    # admission-window seat claimed (producer)
SHARD_ENQUEUE = "shard_enqueue"  # spliced into the home CMP shard (producer)
DRAIN = "drain"                  # claimed out of a shard by a drain loop
SEAT = "seat"                    # delivered at its exact FIFO seat
LANE_PREFILL = "lane_prefill"    # laned + prompt prefilled (serving)
DECODE = "decode"                # first decode token after prefill (serving)
COMPLETE = "complete"            # request finished (serving)

STEAL = "steal"                  # seat ownership claimed from a peer
REQUEUE = "requeue"              # preempted back to its class seat
RESCUE = "rescue"                # reclaim stole stalled-claimer data (Alg 4)
CLAIM_BLOCK = "claim_block"      # device-ring fused kernel invocation
FLUSH = "flush"                  # device-ring checkpoint/resize boundary
CONTROL = "control"              # control-plane decision (resize/weights)

LIFECYCLE_STAGES: Tuple[str, ...] = (
    SUBMIT, WINDOW_ADMIT, SHARD_ENQUEUE, DRAIN, SEAT,
    LANE_PREFILL, DECODE, COMPLETE)
CONTROL_EVENTS: Tuple[str, ...] = (STEAL, REQUEUE, RESCUE, CLAIM_BLOCK,
                                   FLUSH, CONTROL)

#: rid used for fabric-global (producer-side / shard-side) rings — events
#: emitted by code that is not pinned to one replica's drain loop.
PRODUCER_RID = -1


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability plane configuration (``FabricConfig(obs=...)``).

    Attributes:
      enabled: master switch; a disabled config wires nothing (emit sites
        pay one ``is None`` check).
      trace_rate: fraction of envelopes head-sampled into the flight
        recorder (1.0 = every envelope, 0.0 = lifecycle tracing off;
        control events are always recorded). The sampling decision is
        deterministic per class cycle, so every stage of a sampled
        envelope's life is captured.
      ring_capacity: events retained per recorder ring (oldest overwritten).
      metrics_window_s: rolling gauge-sample retention for the
        :class:`~repro_torch.obs.hub.MetricsHub` window (the autoscaler's input).
      sample_every_n_steps: gauge-sweep cadence in ``Fabric.step`` calls.
      snapshot_path: optional JSONL file; when set, every gauge sweep also
        appends one snapshot line (``reports/…``-style periodic export).
    """

    enabled: bool = True
    trace_rate: float = 0.01
    ring_capacity: int = 4096
    metrics_window_s: float = 60.0
    sample_every_n_steps: int = 16
    snapshot_path: Optional[str] = None

    def validate(self) -> None:
        if not (0.0 <= self.trace_rate <= 1.0):
            raise ValueError(
                f"ObsConfig: trace_rate must be in [0, 1] "
                f"(got {self.trace_rate})")
        if self.ring_capacity < 1:
            raise ValueError(
                f"ObsConfig: ring_capacity must be >= 1 "
                f"(got {self.ring_capacity})")
        if self.metrics_window_s <= 0:
            raise ValueError(
                f"ObsConfig: metrics_window_s must be > 0 "
                f"(got {self.metrics_window_s})")
        if self.sample_every_n_steps < 1:
            raise ValueError(
                f"ObsConfig: sample_every_n_steps must be >= 1 "
                f"(got {self.sample_every_n_steps})")


def sample_stride(trace_rate: float) -> int:
    """trace_rate -> the deterministic head-sampling stride ``every``
    (0 disables tracing entirely)."""
    if trace_rate <= 0.0:
        return 0
    return max(1, int(round(1.0 / trace_rate)))


class FlightRecorder:
    """One fixed-size event ring (per replica, or the producer-side ring).

    Appends are plain list ops (GIL-atomic, single logical writer per
    emitting object); the ring never grows past ``capacity``. ``events()``
    returns an append-ordered snapshot for the exporters.
    """

    __slots__ = ("host", "rid", "capacity", "every", "_buf", "_idx",
                 "dropped", "counts")

    def __init__(self, config: ObsConfig, *, host: int = 0,
                 rid: int = PRODUCER_RID):
        self.host = int(host)
        self.rid = int(rid)
        self.capacity = int(config.ring_capacity)
        self.every = sample_stride(config.trace_rate)
        self._buf: List[tuple] = []
        self._idx = 0
        self.dropped = 0  # events overwritten by ring wrap
        self.counts: Dict[str, int] = {}  # per-stage emitted totals

    def sampled(self, seq: int) -> bool:
        """O(1) head-sampling decision, a pure function of the class cycle
        — every emit site along an envelope's lifecycle agrees."""
        e = self.every
        return e > 0 and seq % e == 0

    def emit(self, stage: str, cls: str, seq: int, *,
             t: Optional[float] = None, arg: Any = None) -> None:
        """Record one event. Callers gate on :meth:`sampled` for lifecycle
        stages; control events skip the gate (rare by construction)."""
        ev = (time.monotonic() if t is None else t,
              stage, cls, seq, self.rid, self.host, arg)
        buf = self._buf
        if len(buf) < self.capacity:
            buf.append(ev)
        else:
            self._buf[self._idx] = ev
            self._idx = (self._idx + 1) % self.capacity
            self.dropped += 1
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def events(self) -> List[tuple]:
        """Append-ordered snapshot of the retained ring contents."""
        buf = self._buf
        i = self._idx
        return buf[i:] + buf[:i] if i else list(buf)

    def snapshot(self) -> dict:
        return {"rid": self.rid, "host": self.host,
                "retained": len(self._buf), "dropped": self.dropped,
                "counts": dict(self.counts)}
