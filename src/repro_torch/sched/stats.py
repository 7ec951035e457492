"""Per-class scheduler telemetry with zero added atomics (DESIGN.md §8).

Everything here is sampled from state that already exists for correctness:
shard occupancy comes from the domain counters (``cycle`` − ``deque_cycle``,
plain atomic loads), class depth from the class cycle vs. the drain frontier,
and admission latency from the wall-clock stamp every envelope already
carries. Delivery-side counters are plain ints written by the single drainer;
submit-side counters (submitted/rejected) have arbitrarily many writers, so
they are fetch-adds — reads are diagnostic snapshots, exact when quiesced.
"""

from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.core.atomics import AtomicCell

#: Merged-snapshot reservoirs are decimated past this size so chained
#: roll-ups (the resize-retirement path folds old aggregates into new ones)
#: stay bounded. Decimation strides over the *sorted* pool, preserving the
#: distribution shape.
_POOL_CAP = 8192


def _interp_percentile(s: List[float], p: float) -> float:
    """Percentile with linear interpolation between closest ranks.
    ``s`` must be sorted ascending and non-empty; ``p`` in [0, 100]."""
    n = len(s)
    f = (p / 100.0) * (n - 1)
    if f <= 0.0:
        return s[0]
    lo = int(f)
    if lo >= n - 1:
        return s[n - 1]
    frac = f - lo
    return s[lo] + (s[lo + 1] - s[lo]) * frac


class LatencyWindow:
    """Fixed-size ring of the most recent latency samples (seconds).
    Appended by the single drainer — no locks, no atomics."""

    def __init__(self, capacity: int = 2048):
        self.capacity = int(capacity)
        self._buf: List[float] = []
        self._idx = 0
        self.count = 0  # total samples ever recorded
        # Sorted view of _buf, rebuilt lazily by percentile() and
        # invalidated on every record: stats() at tenant scale reads
        # several percentiles per class per interval, and re-sorting the
        # full ring for each read is the dominant telemetry cost.
        self._sorted: Optional[List[float]] = None

    def record(self, seconds: float) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(seconds)
        else:
            self._buf[self._idx] = seconds
            self._idx = (self._idx + 1) % self.capacity
        self.count += 1
        self._sorted = None

    def record_many(self, samples: List[float]) -> None:
        """Batched append with slice-assigned wraparound (the bulk-drain
        fast path): the reservoir is order-free — :meth:`percentile` sorts a
        snapshot — so overwriting the oldest run with one or two C-speed
        slice assignments keeps the same most-recent-N contents as N scalar
        :meth:`record` calls."""
        cap = self.capacity
        buf = self._buf
        self.count += len(samples)
        self._sorted = None
        if len(samples) >= cap:
            self._buf = list(samples[-cap:])
            self._idx = 0
            return
        room = cap - len(buf)
        if room:
            buf.extend(samples[:room])
            samples = samples[room:]
            if not samples:
                return
        i = self._idx
        end = i + len(samples)
        if end <= cap:
            buf[i:end] = samples
            self._idx = end % cap
        else:
            first = cap - i
            buf[i:] = samples[:first]
            rest = len(samples) - first
            buf[:rest] = samples[first:]
            self._idx = rest

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None when empty. Sorts a snapshot of the ring
        once and caches it until the next record — consecutive percentile
        reads (p50 then p99 per class, across many classes per stats
        interval) share one sort. Linear interpolation between closest
        ranks (numpy's default), not nearest-rank: at small sample counts
        nearest-rank rounding can move a p99 by a whole sample step,
        which is exactly the regime the SLO view reads."""
        if not self._buf:
            return None
        if self._sorted is None or len(self._sorted) != len(self._buf):
            self._sorted = sorted(self._buf)
        return _interp_percentile(self._sorted, p)

    def samples(self) -> List[float]:
        """Copy of the retained reservoir contents (unordered, seconds).
        Lets aggregators pool raw samples across replicas for exact merged
        percentiles instead of conservative picks."""
        return list(self._buf)


class ClassStats:
    """Counters + admission-latency reservoir for one :class:`QueueClass`.
    ``delivered``/``requeued``/``gap_waits`` are written by the single
    drainer only; the submit-side counts race across producers and go
    through :meth:`add_submitted`/:meth:`add_rejected` (fetch-add)."""

    def __init__(self, name: str, latency_capacity: int = 2048):
        self.name = name
        self._submitted = AtomicCell(0)
        self._rejected = AtomicCell(0)
        self.delivered = 0
        self.requeued = 0
        self.gap_waits = 0
        self.latency = LatencyWindow(latency_capacity)

    @property
    def submitted(self) -> int:
        return self._submitted.load()

    @property
    def rejected(self) -> int:
        return self._rejected.load()

    def add_submitted(self, n: int = 1) -> None:
        self._submitted.fetch_add(n)

    def add_rejected(self, n: int = 1) -> None:
        self._rejected.fetch_add(n)

    def record_delivery(self, env) -> None:
        self.latency.record(time.monotonic() - env.t_submit)

    def record_delivery_many(self, envs) -> None:
        """Batched delivery accounting: one clock read for the whole batch
        (the bulk-drain fast path, DESIGN.md §12)."""
        now = time.monotonic()
        self.latency.record_many([now - env.t_submit for env in envs])

    def snapshot(self, *, pending: int = 0,
                 shard_depths: Optional[List[int]] = None) -> dict:
        p50 = self.latency.percentile(50)
        p99 = self.latency.percentile(99)
        return {
            "class": self.name,
            "pending": pending,
            "shard_depths": list(shard_depths or []),
            "submitted": self.submitted,
            "rejected": self.rejected,
            "delivered": self.delivered,
            "requeued": self.requeued,
            "gap_waits": self.gap_waits,
            "admit_p50_ms": None if p50 is None else p50 * 1e3,
            "admit_p99_ms": None if p99 is None else p99 * 1e3,
            "latency_samples": self.latency.samples(),
        }


def aggregate_class_snapshots(per_replica: List[dict]) -> dict:
    """Fabric-wide roll-up of one class's per-replica ``ClassStats``
    snapshots: counters and shard depths add; latency percentiles merge
    *exactly* by pooling each replica's raw reservoir samples
    (``latency_samples``, seconds) and recomputing over the pool. Snapshots
    lacking raw samples (e.g. deserialized legacy aggregates) fall back to
    the conservative pick — worst replica's p99, best replica's p50 — for
    the whole merge, since a partial pool would under-weight them."""
    assert per_replica
    out = dict(per_replica[0])
    for snap in per_replica[1:]:
        for key in ("pending", "submitted", "rejected", "delivered",
                    "requeued", "gap_waits"):
            out[key] = out[key] + snap[key]
        out["shard_depths"] = out["shard_depths"] + snap["shard_depths"]

    pooled: List[float] = []
    exact = True
    for snap in per_replica:
        s = snap.get("latency_samples")
        if s is not None:
            pooled.extend(s)
        elif snap.get("admit_p50_ms") is not None:
            exact = False  # has latency but no raw samples to pool
    if pooled and exact:
        pooled.sort()
        out["admit_p50_ms"] = _interp_percentile(pooled, 50) * 1e3
        out["admit_p99_ms"] = _interp_percentile(pooled, 99) * 1e3
        if len(pooled) > _POOL_CAP:
            stride = -(-len(pooled) // _POOL_CAP)
            pooled = pooled[::stride]
        out["latency_samples"] = pooled
    else:
        for key, pick in (("admit_p50_ms", min), ("admit_p99_ms", max)):
            vals = [snap.get(key) for snap in per_replica]
            vals = [v for v in vals if v is not None]
            out[key] = pick(vals) if vals else None
        out["latency_samples"] = sorted(pooled) if pooled else None
    return out
