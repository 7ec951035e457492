"""Baseline queues the paper evaluates against, on the same atomic substrate
as CMPQueue so atomic-op counts are directly comparable.

* ``MSQueue``      — Michael & Scott with the full helping mechanism (paper
                     Alg 2) and *hazard-pointer* reclamation ("Boost-like").
                     Exhibits the O(P x K) scan cost the paper targets.
* ``SegmentedQueue`` — per-producer segmented sub-queues with relaxed (per-
                     producer-only) FIFO ("Moodycamel-like").
* ``MutexQueue``   — lock-based unbounded queue ("TBB/folly-like").
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, Optional

from repro_torch.core.atomics import AtomicCell, _count

# ---------------------------------------------------------------------------
# Hazard pointers (Michael 2004)
# ---------------------------------------------------------------------------


class HazardPointers:
    """K hazard slots per registered thread + per-thread retire lists.

    Reclamation scans ALL slots of ALL threads — the O(P x K) coordination
    cost CMP eliminates.
    """

    def __init__(self, k: int = 2, scan_threshold: Optional[int] = None):
        self.k = k
        self._slots: List[AtomicCell] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._scan_threshold = scan_threshold
        self.stats = {"scans": 0, "scan_comparisons": 0, "freed": 0}

    def _my_base(self) -> int:
        base = getattr(self._tls, "base", None)
        if base is None:
            with self._lock:
                base = len(self._slots)
                for _ in range(self.k):
                    self._slots.append(AtomicCell(None))
            self._tls.base = base
            self._tls.retired = []
        return base

    def protect(self, idx: int, ptr: Any) -> None:
        self._slots[self._my_base() + idx].store(ptr)

    def clear(self, idx: int) -> None:
        self._slots[self._my_base() + idx].store(None)

    def clear_all(self) -> None:
        base = self._my_base()
        for i in range(self.k):
            self._slots[base + i].store(None)

    def retire(self, node: Any, free_fn) -> None:
        self._my_base()
        retired = self._tls.retired
        retired.append(node)
        threshold = self._scan_threshold or max(16, 2 * len(self._slots))
        if len(retired) >= threshold:
            self.scan(free_fn)

    def scan(self, free_fn) -> None:
        """The coordination step: read every thread's every hazard slot."""
        self.stats["scans"] += 1
        hazards = set()
        for slot in list(self._slots):
            self.stats["scan_comparisons"] += 1
            p = slot.load()
            if p is not None:
                hazards.add(id(p))
        retired = self._tls.retired
        keep = []
        for node in retired:
            if id(node) in hazards:
                keep.append(node)
            else:
                free_fn(node)
                self.stats["freed"] += 1
        self._tls.retired = keep


# ---------------------------------------------------------------------------
# Michael & Scott queue with helping + hazard pointers
# ---------------------------------------------------------------------------


class _MSNode:
    __slots__ = ("data", "next")

    def __init__(self, data: Any = None):
        self.data = AtomicCell(data)
        self.next = AtomicCell(None)


class MSQueue:
    """Classic M&S MPMC queue, full helping mechanism, HP reclamation."""

    def __init__(self, hp_slots: int = 2, scan_threshold: Optional[int] = None):
        dummy = _MSNode()
        self.head = AtomicCell(dummy)
        self.tail = AtomicCell(dummy)
        self.hp = HazardPointers(hp_slots, scan_threshold)
        self._free: List[_MSNode] = []  # recycled nodes (type-stable-ish)
        self._free_lock = threading.Lock()

    def _alloc(self, data: Any) -> _MSNode:
        _count("lock")
        with self._free_lock:
            if self._free:
                n = self._free.pop()
                n.data.store(data)
                n.next.store(None)
                return n
        return _MSNode(data)

    def _free_node(self, node: _MSNode) -> None:
        node.data.store(None)
        node.next.store(None)
        _count("lock")
        with self._free_lock:
            self._free.append(node)

    def enqueue(self, data: Any) -> bool:
        node = self._alloc(data)
        while True:
            tail = self.tail.load()
            self.hp.protect(0, tail)
            if tail is not self.tail.load():  # revalidate after publish
                continue
            nxt = tail.next.load()
            if tail is self.tail.load():  # paper Alg 2 line 5 revalidation
                if nxt is not None:
                    self.tail.cas(tail, nxt)  # HELP advance (possibly stale)
                    continue
                if tail.next.cas(None, node):
                    break
        self.tail.cas(tail, node)
        self.hp.clear(0)
        return True

    def dequeue(self) -> Optional[Any]:
        while True:
            head = self.head.load()
            self.hp.protect(0, head)
            if head is not self.head.load():
                continue
            tail = self.tail.load()
            nxt = head.next.load()
            self.hp.protect(1, nxt)
            if head is not self.head.load():
                continue
            if nxt is None:
                self.hp.clear_all()
                return None
            if head is tail:
                self.tail.cas(tail, nxt)  # help
                continue
            data = nxt.data.load()
            if self.head.cas(head, nxt):
                self.hp.clear_all()
                self.hp.retire(head, self._free_node)
                return data


# ---------------------------------------------------------------------------
# Per-producer segmented queue (relaxed FIFO, "Moodycamel-like")
# ---------------------------------------------------------------------------

_SEG_SIZE = 256


class _SubQueue:
    """Single-producer sub-queue: producer-local tail, CAS-claimed head."""

    __slots__ = ("slots", "tail", "head")

    def __init__(self):
        self.slots: List[Any] = []
        self.tail = AtomicCell(0)  # published count (release store)
        self.head = AtomicCell(0)  # consumer claim cursor

    def push(self, data: Any) -> None:
        self.slots.append(data)  # producer-exclusive
        self.tail.store(len(self.slots))  # publish

    def try_pop(self) -> Optional[Any]:
        while True:
            h = self.head.load()
            t = self.tail.load()
            if h >= t:
                return None
            if self.head.cas(h, h + 1):
                data = self.slots[h]
                self.slots[h] = None  # allow GC of payload
                return data


class SegmentedQueue:
    """Relaxed-FIFO MPMC: strict order within a producer, interleaving between
    producers unspecified — the trade-off the paper calls out in Moodycamel."""

    def __init__(self):
        self._subs: List[_SubQueue] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _mine(self) -> _SubQueue:
        sub = getattr(self._tls, "sub", None)
        if sub is None:
            sub = _SubQueue()
            with self._lock:
                self._subs.append(sub)
            self._tls.sub = sub
            self._tls.rr = 0
        return sub

    def enqueue(self, data: Any) -> bool:
        self._mine().push(data)
        return True

    def dequeue(self) -> Optional[Any]:
        self._mine()
        subs = self._subs
        n = len(subs)
        if n == 0:
            return None
        start = self._tls.rr
        for i in range(n):
            sub = subs[(start + i) % n]
            data = sub.try_pop()
            if data is not None:
                self._tls.rr = (start + i) % n
                return data
        return None


# ---------------------------------------------------------------------------
# Mutex queue
# ---------------------------------------------------------------------------


class MutexQueue:
    """Blocking baseline: one lock around a deque (TBB/folly-style hybrid
    designs reduce to this under contention)."""

    def __init__(self):
        self._q: deque = deque()
        self._lock = threading.Lock()

    def enqueue(self, data: Any) -> bool:
        _count("lock")
        with self._lock:
            self._q.append(data)
        return True

    def dequeue(self) -> Optional[Any]:
        _count("lock")
        with self._lock:
            if not self._q:
                return None
            return self._q.popleft()


ALL_QUEUES = {
    "cmp": "repro_torch.core.cmp.CMPQueue",
    "ms_hp": "repro_torch.core.baselines.MSQueue",
    "segmented": "repro_torch.core.baselines.SegmentedQueue",
    "mutex": "repro_torch.core.baselines.MutexQueue",
}


def make_queue(kind: str, **kwargs):
    from repro_torch.core.cmp import CMPQueue

    if kind == "cmp":
        return CMPQueue(**kwargs)
    if kind == "ms_hp":
        return MSQueue(**kwargs)
    if kind == "segmented":
        return SegmentedQueue(**kwargs)
    if kind == "mutex":
        return MutexQueue(**kwargs)
    raise ValueError(f"unknown queue kind {kind!r}; one of {sorted(ALL_QUEUES)}")
