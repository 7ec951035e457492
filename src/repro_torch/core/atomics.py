"""Atomic primitives for the host-side (shared-memory) queue implementations.

CPython has no native CAS on arbitrary fields.  ``AtomicCell`` emulates one
atomic machine word with a per-cell lock: a CAS on a cell contends only with
other operations on the *same* cell, which structurally mirrors cache-line
contention on real hardware.  Plain loads/stores are GIL-atomic and lock-free.

Every atomic operation is counted per-thread so benchmarks can report the
paper's scheduler-independent metric (atomic ops / queue operation: CMP claims
3-5 enq, 4-9 deq) and a *chaos hook* may be installed to inject delays or
yields at atomic boundaries for interleaving fuzz tests.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# instrumentation
# ---------------------------------------------------------------------------

_tls = threading.local()

# Optional callable invoked before every atomic op: hook(kind: str) -> None.
_chaos_hook: Optional[Callable[[str], None]] = None


def set_chaos_hook(hook: Optional[Callable[[str], None]]) -> None:
    global _chaos_hook
    _chaos_hook = hook


def reset_op_counts() -> None:
    _tls.ops = {}


def op_counts() -> dict:
    """Per-thread atomic-op counts since last reset (for the calling thread)."""
    return dict(getattr(_tls, "ops", {}))


def total_ops() -> int:
    return sum(getattr(_tls, "ops", {}).values())


def _count(kind: str) -> None:
    if _chaos_hook is not None:
        _chaos_hook(kind)
    ops = getattr(_tls, "ops", None)
    if ops is None:
        ops = {}
        _tls.ops = ops
    ops[kind] = ops.get(kind, 0) + 1


# ---------------------------------------------------------------------------
# atomic cell
# ---------------------------------------------------------------------------


class AtomicCell:
    """One atomic variable (pointer- or integer-valued)."""

    __slots__ = ("_v", "_lock")

    def __init__(self, value: Any = None):
        self._v = value
        self._lock = threading.Lock()

    # Loads/stores are single bytecode ops under the GIL -> atomic.
    def load(self) -> Any:
        _count("load")
        return self._v

    def store(self, value: Any) -> None:
        _count("store")
        self._v = value

    def cas(self, expected: Any, new: Any) -> bool:
        """Compare-and-swap by identity (pointers) or equality (ints)."""
        _count("cas")
        with self._lock:
            cur = self._v
            ok = cur is expected or cur == expected
            if ok:
                self._v = new
            return ok

    def fetch_inc(self) -> int:
        """Atomically increment; returns the *new* value (paper: INCREMENT)."""
        _count("faa")
        with self._lock:
            self._v += 1
            return self._v

    def fetch_add(self, delta: int) -> int:
        """Atomically add; returns the *old* value."""
        _count("faa")
        with self._lock:
            old = self._v
            self._v = old + delta
            return old

    def fetch_max(self, value: int) -> int:
        """Monotone max-publish (CMP Phase 5 boundary update). Counted as its
        own ``"max"`` kind so the paper's op-kind breakdown separates the
        boundary publish from true compare-and-swaps."""
        _count("max")
        with self._lock:
            if value > self._v:
                self._v = value
            return self._v


# ---------------------------------------------------------------------------
# atomic array
# ---------------------------------------------------------------------------


class AtomicArray:
    """``n`` int64 atomic words backed by one numpy array under striped locks.

    Scalar ops mirror :class:`AtomicCell` per index and contend only on the
    stripe covering that index. Range ops sweep the covering stripes — each
    stripe's segment is transformed in one critical section — and are counted
    as ONE atomic op of their kind: a fused batch RMW is a single coordination
    event whose cost is shared by the whole range, so dividing total ops by
    items yields the amortized (fractional) per-item atomics the batched
    benchmarks report (DESIGN.md §12).

    Atomicity granularity: scalar ops and single-stripe ranges are atomic; a
    multi-stripe range op is atomic per stripe, not as a whole. Per-index
    exactly-once arbitration (the AVAILABLE -> CLAIMED claim/rescue race) only
    needs per-index atomicity, which striping delivers with room to spare.
    """

    __slots__ = ("_a", "_locks", "_stripe")

    def __init__(self, n: int, init: int = 0, stripes: Optional[int] = None):
        n = int(n)
        self._a = np.full(n, init, dtype=np.int64)
        if stripes is None:
            stripes = max(1, min(8, n // 512))
        stripes = max(1, min(int(stripes), n)) if n else 1
        self._stripe = -(-n // stripes) if n else 1  # indices per stripe (ceil)
        self._locks = [threading.Lock() for _ in range(stripes)]

    def __len__(self) -> int:
        return len(self._a)

    def _spans(self, lo: int, hi: int):
        """Yield (lock, a, b) covering [lo, hi) one stripe at a time."""
        w = self._stripe
        a = lo
        while a < hi:
            s = a // w
            b = min(hi, (s + 1) * w)
            yield self._locks[s], a, b
            a = b

    # -- scalar ops (one counted atomic each) ---------------------------
    def load(self, i: int) -> int:
        _count("load")
        return int(self._a[i])

    def store(self, i: int, value: int) -> None:
        _count("store")
        self._a[i] = value

    def cas(self, i: int, expected: int, new: int) -> bool:
        _count("cas")
        with self._locks[i // self._stripe]:
            if self._a[i] == expected:
                self._a[i] = new
                return True
            return False

    def fetch_add(self, i: int, delta: int) -> int:
        """Atomically add at index ``i``; returns the *old* value."""
        _count("faa")
        with self._locks[i // self._stripe]:
            old = int(self._a[i])
            self._a[i] = old + delta
            return old

    def fetch_max(self, i: int, value: int) -> int:
        _count("max")
        with self._locks[i // self._stripe]:
            if value > self._a[i]:
                self._a[i] = value
            return int(self._a[i])

    # -- range ops (one counted atomic per call) ------------------------
    def fill(self, lo: int, hi: int, value: int) -> None:
        """Store ``value`` into every index of [lo, hi)."""
        _count("store")
        for lock, a, b in self._spans(lo, hi):
            with lock:
                self._a[a:b] = value

    def load_range(self, lo: int, hi: int):
        """Snapshot of [lo, hi) (per-stripe consistent)."""
        _count("load")
        out = np.empty(hi - lo, dtype=np.int64)
        for lock, a, b in self._spans(lo, hi):
            with lock:
                out[a - lo:b - lo] = self._a[a:b]
        return out

    def exchange_where(self, lo: int, hi: int, expected: int, new: int):
        """Vectorized multi-CAS: for every index of [lo, hi) holding
        ``expected``, install ``new``. Returns the per-index success mask
        (numpy bool array of length hi-lo). Per index this is exactly one
        CAS — two racing exchanges can never both win the same index."""
        _count("cas")
        won = np.zeros(hi - lo, dtype=bool)
        for lock, a, b in self._spans(lo, hi):
            with lock:
                seg = self._a[a:b]
                m = seg == expected
                seg[m] = new
                won[a - lo:b - lo] = m
        return won

    def count_equal(self, lo: int, hi: int, value: int) -> int:
        """Number of indices in [lo, hi) currently holding ``value``."""
        _count("load")
        n = 0
        for lock, a, b in self._spans(lo, hi):
            with lock:
                n += int((self._a[a:b] == value).sum())
        return n


def cpu_pause() -> None:
    """Paper's CPU_PAUSE: yield the core briefly under contention."""
    _count("pause")
    # time.sleep(0) releases the GIL, the closest analogue to `pause`.
    import time

    time.sleep(0)
