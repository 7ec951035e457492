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

Step spans (:meth:`FlightRecorder.span`) time the serving loop's phases:
``fabric.step`` around ``Fabric.step``, and inside it ``engine.step`` with
its children (``SPAN_PARENTS``). A span is one ring record, ``(start,
SPAN, cls, seq, rid, host, Span(...))``, written when it closes; spans
nest strictly on a thread, so a span's parent is the innermost span open
on the same thread when it opened, in whichever recorder. Beside the ring
each recorder keeps running totals per span name (count and seconds) and
per counter (:meth:`FlightRecorder.count`; ``HOST_READS`` counts the
device->host reads of the serving step where they happen), so a reader
differences them over windows longer than the ring. While a
``torch.profiler`` records, every span is also a ``record_function`` range
named ``repro.<span>``, on the device trace's own timeline. Emit sites
check ``_obs is None`` once and, when it is, touch neither the recorder
nor the profiler.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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

# Step spans: the serving loop's phases, and the parent each nests in.
SPAN = "span"                    # the stage of a span record
FABRIC_STEP = "fabric.step"      # Fabric.step
ENGINE_STEP = "engine.step"      # Engine.step
ENGINE_ADMIT = "engine.admit"    # _admit, class-aware preemption included
ADMIT_RING = "admit.ring"        # the scheduler drain + the ring's fused call
ADMIT_PREFILL = "admit.prefill"  # one laned request: pages, [1, S] forward, read
ENGINE_GROW = "engine.grow"      # _grow_pages
ENGINE_DECODE = "engine.decode"  # issuing the decode forward over every lane
ENGINE_READ = "engine.read"      # the decode's host read
ENGINE_RETIRE = "engine.retire"  # the per-lane bookkeeping after the read
SPAN_PARENTS: Dict[str, Optional[str]] = {
    FABRIC_STEP: None, ENGINE_STEP: FABRIC_STEP,
    ENGINE_ADMIT: ENGINE_STEP, ADMIT_RING: ENGINE_ADMIT,
    ADMIT_PREFILL: ENGINE_ADMIT, ENGINE_GROW: ENGINE_STEP,
    ENGINE_DECODE: ENGINE_STEP, ENGINE_READ: ENGINE_STEP,
    ENGINE_RETIRE: ENGINE_STEP}
#: the profiler range of span ``name`` is ``RANGE_PREFIX + name``
RANGE_PREFIX = "repro."
#: counter of device->host reads (each blocks the host until the stream
#: drains), counted where the read happens
HOST_READS = "host_reads"

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


class Span(NamedTuple):
    """The ``arg`` of a span record (its start is the record's ``t``)."""
    name: str
    end: float
    sid: int               # unique in the process
    parent: Optional[int]  # the enclosing span's sid
    uid: Optional[int]     # the request's uid (admit.prefill)


_SIDS = itertools.count(1)
_OPEN = threading.local()  # .spans: this thread's open spans, outermost first


def _open_spans() -> list:
    st = getattr(_OPEN, "spans", None)
    if st is None:
        st = _OPEN.spans = []
    return st


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records. Without torch loaded none can:
    a scheduler-only fabric stays plain host Python."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class _OpenSpan:
    """One span while it is open: the context manager of
    :meth:`FlightRecorder.span`."""

    __slots__ = ("rec", "name", "cls", "seq", "uid", "t0", "sid", "parent",
                 "_range")

    def __init__(self, rec, name, cls, seq, uid):
        self.rec, self.name, self.cls, self.seq, self.uid = (
            rec, name, cls, seq, uid)

    def __enter__(self):
        st = _open_spans()
        self.parent = st[-1].sid if st else None
        self.sid = next(_SIDS)
        st.append(self)
        self._range = None
        if _profiling():
            from torch.autograd import profiler

            self._range = profiler.record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open_spans().pop()
        self.rec._close(self, t1)
        return False


class FlightRecorder:
    """One fixed-size event ring (per replica, or the producer-side ring).

    Appends are plain list ops (GIL-atomic, single logical writer per
    emitting object); the ring never grows past ``capacity``. ``events()``
    returns an append-ordered snapshot for the exporters. Span and counter
    totals (``span_n``, ``span_s``, ``span_counters``) are running sums
    from the recorder's creation.
    """

    __slots__ = ("host", "rid", "capacity", "every", "_buf", "_idx",
                 "dropped", "counts", "span_n", "span_s", "span_counters")

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
        self.span_n: Dict[str, int] = {}  # spans closed, by name
        self.span_s: Dict[str, float] = {}  # their seconds, by name
        # (counter, innermost open span's name or None) -> total
        self.span_counters: Dict[Tuple[str, Optional[str]], int] = {}

    def sampled(self, seq: int) -> bool:
        """O(1) head-sampling decision, a pure function of the class cycle
        — every emit site along an envelope's lifecycle agrees."""
        e = self.every
        return e > 0 and seq % e == 0

    def emit(self, stage: str, cls: str, seq: int, *,
             t: Optional[float] = None, arg: Any = None) -> None:
        """Record one event. Callers gate on :meth:`sampled` for lifecycle
        stages; control events skip the gate (rare by construction)."""
        self._push((time.monotonic() if t is None else t,
                    stage, cls, seq, self.rid, self.host, arg))
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def _push(self, ev: tuple) -> None:
        buf = self._buf
        if len(buf) < self.capacity:
            buf.append(ev)
        else:
            self._buf[self._idx] = ev
            self._idx = (self._idx + 1) % self.capacity
            self.dropped += 1

    def span(self, name: str, cls: Optional[str] = None,
             seq: Optional[int] = None, uid: Optional[int] = None
             ) -> _OpenSpan:
        """A context manager that records one span named ``name`` (with
        the request's lifecycle key ``(cls, seq)`` and ``uid`` where it
        has one) when it closes."""
        return _OpenSpan(self, name, cls, seq, uid)

    def _close(self, sp: _OpenSpan, t1: float) -> None:
        name = sp.name
        self._push((sp.t0, SPAN, sp.cls, sp.seq, self.rid, self.host,
                    Span(name, t1, sp.sid, sp.parent, sp.uid)))
        self.span_n[name] = self.span_n.get(name, 0) + 1
        self.span_s[name] = self.span_s.get(name, 0.0) + (t1 - sp.t0)

    def count(self, counter: str, n: int = 1) -> None:
        """Add ``n`` to ``counter`` against the innermost span open on this
        thread (``None`` outside every span)."""
        st = _open_spans()
        key = (counter, st[-1].name if st else None)
        self.span_counters[key] = self.span_counters.get(key, 0) + n

    def events(self) -> List[tuple]:
        """Append-ordered snapshot of the retained ring contents."""
        buf = self._buf
        i = self._idx
        return buf[i:] + buf[:i] if i else list(buf)

    def snapshot(self) -> dict:
        return {"rid": self.rid, "host": self.host,
                "retained": len(self._buf), "dropped": self.dropped,
                "counts": dict(self.counts)}
