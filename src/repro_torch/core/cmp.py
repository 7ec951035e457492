"""Cyclic Memory Protection (CMP) queue — faithful implementation of the paper's
Algorithms 1 (enqueue), 3 (dequeue) and 4 (coordination-free reclamation).

This is the *host* embodiment of the unified protection domain
(:mod:`repro.core.domain`, DESIGN.md §1-2): state constants, window
arithmetic and the reclamation predicate are imported from there — the device
slot pool and the paged KV pool share the exact same definitions.

Properties implemented exactly as in the paper:

* strict global FIFO (append-only linking + cursor minimality + earliest claim),
* unbounded capacity (nodes allocated on demand, recycled via a type-stable pool),
* two-state node lifecycle AVAILABLE -> CLAIMED,
* immutable monotone per-node ``cycle`` assigned at enqueue,
* unilateral monotone publication of ``deque_cycle`` (no handshakes),
* sliding protection window  P = [deque_cycle - W, deque_cycle]  — a node is
  reclaimed iff  (state != AVAILABLE) and (cycle < deque_cycle - W),
* reclamation triggered every N enqueues (cycle % N == 0), single reclaimer at
  a time, batched head advancement, stalled-thread tolerance (a CLAIMED node
  from a dead thread is reclaimed after at most W further dequeue cycles).

Beyond the paper (DESIGN.md §3): batched ``enqueue_many``/``dequeue_many``
amortize the per-operation atomics — one cycle-range fetch-add and one linked
splice per enqueue batch, one boundary publish and one cursor advance per
dequeue batch — the amortization move bounded-memory designs like wCQ/SCQ use
to earn their throughput.

The Michael & Scott *helping* mechanism is deliberately absent (paper §3.4):
on observing a stale tail the enqueuer retries with fresh state instead of
CAS-ing the tail forward from a stale observation.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, List, Optional

from repro_torch.core.atomics import AtomicArray, AtomicCell, cpu_pause
from repro_torch.core.domain import (
    AVAILABLE,
    CLAIMED,
    compute_window,
    reclaim_enqueue_mask,
    safe_cycle,
)

_RETRY_PAUSE_THRESHOLD = 3  # paper Alg 1 line 17


class Node:
    """Queue node. ``cycle`` is immutable after enqueue-publication; ``next``,
    ``data`` and ``state`` are atomic. Nodes are recycled, never freed (type-
    stable pool), so any stale pointer still references a valid Node."""

    __slots__ = ("cycle", "next", "data", "state")

    def __init__(self):
        self.cycle = 0
        self.next = AtomicCell(None)
        self.data = AtomicCell(None)
        self.state = AtomicCell(CLAIMED)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<Node cycle={self.cycle} state={self.state._v}>"


class BlockNode:
    """A batch segment (DESIGN.md §12): ONE linked-list node carrying ``n``
    items with the contiguous cycle range [base+1, base+n]. This is the
    BlockFIFO/SCQ move applied inside the CMP list — the batch's protection
    state lives in one counted :class:`AtomicArray` instead of ``n`` cells,
    so stamping, claiming and recycling the whole batch are single fused
    array ops.

    Layout of ``ctl`` (length n+1): indices [0, n) hold the per-item state
    (FREE until armed, then AVAILABLE -> CLAIMED, monotone — blocks are never
    recycled, so no ABA is possible through a stale block reference); index
    [n] is the claim cursor, advanced by one fetch-add per dequeue batch.

    ``cycle`` is the LAST item's cycle (base + n): it is the window key — the
    block leaves the protection window only when its newest item does, which
    is conservative and keeps the Phase-4 pointer+cycle dual check valid
    (cycles stay monotone along the chain). ``data`` is written before the
    splice publishes the block and never mutated afterwards, so claim winners
    can read it without a data CAS."""

    __slots__ = ("base", "n", "cycle", "next", "data", "ctl")

    def __init__(self, data: List[Any], base: int, n: int):
        self.base = base
        self.n = n
        self.cycle = base + n  # immutable window key (last item's cycle)
        self.next = AtomicCell(None)
        self.data = data
        self.ctl = AtomicArray(n + 1)  # [0,n): item states; [n]: claim cursor

    def take(self, want: int):
        """Claim up to ``want`` items past the block cursor with one cursor
        fetch-add and one vectorized exchange for the whole run. Returns
        ``(items, hi_cycle, exhausted)`` where ``hi_cycle`` is the highest
        cycle of the attempted range (every index in it is CLAIMED after the
        exchange — by us or by a reclaim rescue — so publishing it is safe).
        ``exhausted`` means the cursor has passed the end of the block."""
        n = self.n
        ctl = self.ctl
        if ctl.load(n) >= n:
            return [], -1, True
        old = ctl.fetch_add(n, want)
        start = old if old < n else n
        end = old + want if old + want < n else n
        if start >= end:
            return [], -1, True
        won = ctl.exchange_where(start, end, AVAILABLE, CLAIMED)
        if won.all():
            items = self.data[start:end]
        else:
            # A reclaim rescue beat us to behind-window holes in the range;
            # deliver only the indices our exchange won (exactly-once).
            items = [d for d, w in zip(self.data[start:end], won) if w]
        return items, self.base + end, end >= n

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<BlockNode base={self.base} n={self.n} cursor={self.ctl._a[self.n]}>"


class NodePool:
    """Type-stable node pool: a Treiber stack of recycled nodes. Nodes are
    never returned to the OS; pool underflow allocates fresh nodes (unbounded
    capacity). ``next`` is reused as the free-list link.

    The top is a *version-tagged* pointer ``(head, version)`` — the classic
    counted-pointer fix: every successful push/pop installs a fresh tag, so
    a stale observation can never CAS successfully (no ABA), which is what
    makes the multi-node walk of ``get_many`` safe. ``get_many``/``put_many``
    move a whole chain with a single CAS — the free-list half of the
    batched-op amortization (DESIGN.md §3)."""

    def __init__(self, prealloc: int = 0):
        self._top = AtomicCell((None, 0))  # (head node, monotone version)
        self.allocated = 0  # total Nodes ever constructed (monotone)
        self._alloc_lock = threading.Lock()
        for _ in range(prealloc):
            self.put(self._fresh())

    def _fresh(self) -> Node:
        with self._alloc_lock:
            self.allocated += 1
        return Node()

    def get(self) -> Node:
        while True:
            top = self._top.load()
            head, ver = top
            if head is None:
                return self._fresh()
            nxt = head.next.load()
            if self._top.cas(top, (nxt, ver + 1)):
                head.next.store(None)
                return head

    def put(self, node: Node) -> None:
        while True:
            top = self._top.load()
            node.next.store(top[0])
            if self._top.cas(top, (node, top[1] + 1)):
                return

    def get_many(self, n: int) -> List[Node]:
        """Pop up to ``n`` recycled nodes with one CAS per attempt (walk the
        chain, CAS the tagged top past it — the tag makes the walk ABA-safe);
        underflow allocates fresh nodes."""
        got: List[Node] = []
        while len(got) < n:
            top = self._top.load()
            head, ver = top
            if head is None:
                break
            chain: List[Node] = []
            cur: Optional[Node] = head
            while cur is not None and len(chain) < n - len(got):
                chain.append(cur)
                cur = cur.next.load()
            if self._top.cas(top, (cur, ver + 1)):
                for nd in chain:
                    nd.next.store(None)
                got.extend(chain)
        while len(got) < n:
            got.append(self._fresh())
        return got

    def put_many(self, nodes: List[Node]) -> None:
        """Push a privately-linked chain with a single CAS."""
        if not nodes:
            return
        for a, b in zip(nodes, nodes[1:]):
            a.next.store(b)
        while True:
            top = self._top.load()
            nodes[-1].next.store(top[0])
            if self._top.cas(top, (nodes[0], top[1] + 1)):
                return

    def size(self) -> int:
        """O(n) free-list length (diagnostics only)."""
        n, cur = 0, self._top.load()[0]
        while cur is not None:
            n += 1
            cur = cur.next.load()
        return n


class CMPQueue:
    """Lock-free MPMC FIFO queue with Cyclic Memory Protection.

    Args:
      window: protection window W (cycles). If None, derived via
        ``domain.compute_window(ops_per_sec, resilience_s)``.
      reclaim_period: N — reclamation trigger every N enqueues.
      min_batch: MIN_BATCH_SIZE for batched reclamation.
      prealloc: nodes to pre-populate the type-stable pool with.
    """

    def __init__(
        self,
        window: Optional[int] = None,
        *,
        ops_per_sec: float = 1e6,
        resilience_s: float = 0.001,
        reclaim_period: int = 64,
        min_batch: int = 8,
        prealloc: int = 0,
        cursor_to_claimed: bool = True,
    ):
        self.window = int(window) if window is not None else compute_window(ops_per_sec, resilience_s)
        self.reclaim_period = int(reclaim_period)
        self.min_batch = int(min_batch)
        # Beyond-paper fix (DESIGN.md §5): the paper's Alg 3 Phase 4 advances
        # scan_cursor only to current.next, so when the claimed node is the
        # tail (next == NULL) the cursor stays put and strict-alternation
        # workloads re-walk the whole retained window (O(W) per dequeue,
        # measured 583us at W=1000). Advancing to the claimed node itself
        # preserves cursor minimality (everything at or before it is
        # non-AVAILABLE) and restores O(1). Set False for the paper-faithful
        # behavior.
        self.cursor_to_claimed = bool(cursor_to_claimed)
        self.pool = NodePool(prealloc)

        dummy = self.pool.get()
        dummy.cycle = 0
        dummy.state.store(CLAIMED)  # dummy is never claimable
        self.head = AtomicCell(dummy)
        self.tail = AtomicCell(dummy)
        self.scan_cursor = AtomicCell(dummy)
        self.cycle = AtomicCell(0)        # global enqueue cycle counter
        self.deque_cycle = AtomicCell(0)  # highest claimed cycle (monotone)
        self._reclaiming = AtomicCell(0)  # single-reclaimer guard (try-lock)

        # Diagnostics (non-atomic; approximate under races, exact when quiesced).
        self.stats = {"enq_retries": 0, "deq_scans": 0, "reclaimed": 0,
                      "reclaim_passes": 0, "reclaim_contended": 0,
                      "rescued": 0}

    # flight-recorder attachment (repro.obs): set externally by a
    # MetricsHub; rescues are rare control events, recorded when attached.
    _obs = None
    _obs_cls = "?"

    # ------------------------------------------------------------------
    # Algorithm 1: lock-free enqueue
    # ------------------------------------------------------------------
    def enqueue(self, data: Any) -> bool:
        if data is None:
            raise ValueError("CMPQueue payloads must be non-None (None marks empty slots)")
        # Phase 1: node allocation and cycle assignment.
        node = self.pool.get()
        node.data.store(data)
        node.next.store(None)
        node.state.store(AVAILABLE)
        cycle = self.cycle.fetch_inc()
        node.cycle = cycle  # immutable from here on

        # Phase 2: lock-free insertion (M&S minus helping).
        self._splice(node, node)

        # Phase 3: conditional reclamation (deterministic modulo policy).
        if cycle % self.reclaim_period == 0:
            self.reclaim()
        return True

    def enqueue_many(self, items: Iterable[Any]) -> int:
        """Vectorized batched enqueue (DESIGN.md §3/§12): one cycle-range
        fetch-add, one striped state fill and one linked splice for the whole
        batch — the batch becomes a single :class:`BlockNode`, so the cost is
        O(1) Python bytecodes and a handful of counted atomics per *batch*,
        not per item. Data and cycles are private until the single tail CAS
        publishes the block fully formed. Returns the number enqueued."""
        batch = list(items)
        if not batch:
            return 0
        if any(d is None for d in batch):
            raise ValueError("CMPQueue payloads must be non-None (None marks empty slots)")
        n = len(batch)
        if n == 1:
            self.enqueue(batch[0])
            return 1
        # Phase 1 (fused): one fetch-add reserves the cycle range
        # [base+1, base+n]; one fill arms every item state.
        base = self.cycle.fetch_add(n)
        block = BlockNode(batch, base, n)
        block.ctl.fill(0, n, AVAILABLE)

        # Phase 2: one splice publishes the whole block.
        self._splice(block, block)

        # Phase 3: reclaim once if the range crossed a trigger multiple.
        if (base + n) // self.reclaim_period > base // self.reclaim_period:
            self.reclaim()
        return n

    def _splice(self, first: Node, last: Node) -> None:
        """Lock-free insertion of a pre-linked chain (M&S minus helping)."""
        retry_count = 0
        while True:
            tail = self.tail.load()
            nxt = tail.next.load()
            if nxt is not None:
                # Tail is stale: retry with fresh state (no helping, §3.4).
                retry_count += 1
                self.stats["enq_retries"] += 1
                if retry_count > _RETRY_PAUSE_THRESHOLD:
                    cpu_pause()
                continue
            if tail.next.cas(None, first):
                # Optional tail advancement; failure is benign.
                self.tail.cas(tail, last)
                return
            retry_count += 1
            self.stats["enq_retries"] += 1

    # ------------------------------------------------------------------
    # Algorithm 3: lock-free dequeue
    # ------------------------------------------------------------------
    def dequeue(self) -> Optional[Any]:
        out = self.dequeue_many(1)
        return out[0] if out else None

    def dequeue_many(self, k: int) -> List[Any]:
        """Claim up to ``k`` items in FIFO order. For k == 1 this is exactly
        the paper's Algorithm 3. For k > 1 the per-item work is only the
        claim CASes (Phases 1-3); the scan-cursor advance (Phase 4) and the
        monotone boundary publish (Phase 5) run once for the whole batch
        (DESIGN.md §3)."""
        out: List[Any] = []
        if k <= 0:
            return out
        current = self.head.load()  # non-NULL (dummy)
        last_deque_cycle = -1       # force initial cursor load
        last_cursor = current
        cursor_cycle = current.cycle
        last_claimed = None
        max_cycle = -1
        park = None  # partially-consumed block to park the scan cursor on

        # Phases 1+2: scan-cursor load and atomic node claiming.
        while len(out) < k and current is not None:
            deque_cycle = self.deque_cycle.load()
            if deque_cycle != last_deque_cycle:
                # Other threads progressed: re-accelerate from the cursor.
                last_deque_cycle = deque_cycle
                current = self.scan_cursor.load()
                last_cursor = current
                cursor_cycle = last_cursor.cycle
            if type(current) is BlockNode:
                # Vectorized claim: the whole remaining want in one cursor
                # fetch-add + one exchange (Phases 1-3 fused per block run).
                got, hi, exhausted = current.take(k - len(out))
                if got:
                    out.extend(got)
                    last_claimed = current
                    if hi > max_cycle:
                        max_cycle = hi
                else:
                    self.stats["deq_scans"] += 1
                if not exhausted:
                    if len(out) >= k:
                        # Items remain past the block cursor: the scan cursor
                        # parks ON the block (everything claimed or skipped
                        # before it is non-AVAILABLE; its internal cursor
                        # tracks the intra-block position).
                        park = current
                        break
                    # A rescue stole part of our range: retake from the same
                    # block — the cursor advanced, so this terminates.
                    continue
                current = current.next.load()
                continue
            if current.state.cas(AVAILABLE, CLAIMED):
                # Phase 3: claim data with CAS (guards vs stalled-thread ABA
                # reuse). A lost race means the node was recycled underneath
                # us while we stalled — its ``next`` is no longer trustworthy,
                # so restart the scan instead of following a stale pointer.
                if (current.state.load() == AVAILABLE
                        or (data := current.data.load()) is None
                        or not current.data.cas(data, None)):
                    last_deque_cycle = -1  # force cursor re-acceleration
                    current = self.head.load()
                    continue
                out.append(data)
                last_claimed = current
                if current.cycle > max_cycle:
                    max_cycle = current.cycle
                if len(out) >= k:
                    break
            else:
                self.stats["deq_scans"] += 1
            current = current.next.load()

        if last_claimed is None:
            return out  # empty dequeue linearizes at cursor reaching null

        advance_boundary = True
        # Phase 4 (once per batch): opportunistic scan-cursor advance
        # (pointer+cycle dual check eliminates ABA: cycles are monotone, so a
        # recycled same-address node can never satisfy both conditions).
        # Everything at or before the last claimed node is non-AVAILABLE, so
        # cursor minimality is preserved.
        sc = self.scan_cursor.load()
        if sc is last_cursor and cursor_cycle == sc.cycle:
            if park is not None:
                nxt = park  # partially-consumed block: cursor points at it
            else:
                nxt = last_claimed.next.load()
                if nxt is None and self.cursor_to_claimed:
                    nxt = last_claimed  # tail claimed: park cursor on it (see __init__)
            advance_boundary = False
            if nxt is None or self.scan_cursor.cas(last_cursor, nxt):
                advance_boundary = True

        # Phase 5 (once per batch): protection boundary update — the domain's
        # monotone max-publish, realized as an atomic fetch-max.
        if advance_boundary:
            self.deque_cycle.fetch_max(max_cycle)

        return out

    # ------------------------------------------------------------------
    # Algorithm 4: coordination-free memory reclamation
    # ------------------------------------------------------------------
    def reclaim(self) -> int:
        """Batched, lock-free reclamation. Returns number of nodes recycled.
        Non-blocking: if another thread is reclaiming, returns immediately."""
        if not self._reclaiming.cas(0, 1):
            # another thread holds the reclaim try-lock: this pass stalls
            # (retried at the next trigger) — the "reclaim stall" gauge
            self.stats["reclaim_contended"] += 1
            return 0
        reclaimed = 0
        try:
            self.stats["reclaim_passes"] += 1
            # Phase 1: protection boundary (domain.safe_cycle).
            dc = self.deque_cycle.load()
            head = self.head.load()
            current = head.next.load()

            rescued: List[Any] = []
            while current is not None:
                original_next = current
                new_next = current
                batch: List[Any] = []
                # Phases 2-4: collect a batch of safely reclaimable nodes —
                # the domain predicate (state == CLAIMED) & (cycle < dc - W).
                # The cycle is immutable (plain read); the state load is the
                # atomic half of the check. Block segments additionally get a
                # hole rescue (see _block_rescue) before the check.
                while current is not None:
                    if type(current) is BlockNode:
                        self._block_rescue(current, dc, rescued)
                        if not self._block_reclaimable(current, dc):
                            break
                    elif not reclaim_enqueue_mask(current.state.load(),
                                                  current.cycle, dc, self.window):
                        break
                    batch.append(current)
                    nxt = current.next.load()
                    new_next = nxt
                    current = nxt
                if len(batch) < self.min_batch:
                    break
                # Phase 5: single CAS advances head.next across the batch.
                if head.next.cas(original_next, new_next):
                    scalars: List[Node] = []
                    for node in batch:
                        if type(node) is BlockNode:
                            # Blocks are never pooled: no ABA is possible
                            # through a stale block reference, and ``data``
                            # must stay readable for a claimer racing the
                            # unlink, so the block simply drops to GC.
                            node.next.store(None)
                            reclaimed += node.n
                            continue
                        # Beyond-paper fix (DESIGN.md §5): a claimer that was
                        # descheduled between its state CAS and its data CAS
                        # still owns undelivered data here. The paper destroys
                        # it (silent loss under a W-cycle stall); we steal it
                        # with one CAS and re-publish it instead. The claimer's
                        # own data CAS then fails and it rescans — exactly-once
                        # either way, still coordination-free, memory still
                        # bounded (the node is recycled regardless).
                        d = node.data.load()
                        if d is not None and node.data.cas(d, None):
                            rescued.append(d)
                        # Terminate stale traversals, then recycle.
                        node.next.store(None)
                        node.data.store(None)
                        scalars.append(node)
                        reclaimed += 1
                    self.pool.put_many(scalars)
                else:
                    break  # concurrent modification: abandon, retry later
            if rescued:
                # Re-enqueue at the tail regardless of unlink success — block
                # hole rescues happen during collection, so their items are
                # already stolen. (The nested reclaim trigger no-ops on the
                # _reclaiming guard we hold.)
                self.stats["rescued"] += len(rescued)
                if self._obs is not None:
                    self._obs.emit("rescue", self._obs_cls, -1,
                                   arg=len(rescued))
                self.enqueue_many(rescued)
        finally:
            self._reclaiming.store(0)
        self.stats["reclaimed"] += reclaimed
        return reclaimed

    def _block_rescue(self, block: BlockNode, dc: int, rescued: List[Any]) -> None:
        """Steal behind-window AVAILABLE holes below the block's claim cursor
        — claim attempts that stalled between the cursor fetch-add and the
        exchange (the block analogue of the scalar data rescue). One
        vectorized exchange arbitrates against the waking claimer, so each
        hole is delivered exactly once. Backlog items at or past the cursor
        are never touched: AVAILABLE nodes stay absolutely protected."""
        n = block.n
        cursor = block.ctl.load(n)
        if cursor <= 0:
            return
        lim = safe_cycle(dc, self.window) - block.base - 1
        if lim > cursor:
            lim = cursor
        if lim > n:
            lim = n
        if lim <= 0:
            return
        won = block.ctl.exchange_where(0, lim, AVAILABLE, CLAIMED)
        if won.any():
            data = block.data
            rescued.extend(data[i] for i in won.nonzero()[0])

    def _block_reclaimable(self, block: BlockNode, dc: int) -> bool:
        """A block is reclaimable iff its newest cycle left the window and no
        AVAILABLE item remains (states are monotone AVAILABLE -> CLAIMED and
        blocks are never recycled, so once true this stays true — the unlink
        can never race a late claim win)."""
        if block.cycle >= safe_cycle(dc, self.window):
            return False
        return block.ctl.count_equal(0, block.n, AVAILABLE) == 0

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def live_nodes(self) -> int:
        """Nodes currently linked from head (incl. dummy). O(n), diagnostics."""
        n, cur = 0, self.head.load()
        while cur is not None:
            n += 1
            cur = cur.next.load()
        return n

    def snapshot_invariants(self) -> dict:
        """Checked by tests: window safety + cursor minimality (quiesced)."""
        dc = self.deque_cycle.load()
        head = self.head.load()
        cur = head.next.load()
        min_linked_cycle = None
        while cur is not None:
            if min_linked_cycle is None:
                min_linked_cycle = (cur.base + 1 if type(cur) is BlockNode
                                    else cur.cycle)
            cur = cur.next.load()
        return {
            "deque_cycle": dc,
            "safe_cycle": safe_cycle(dc, self.window),
            "min_linked_cycle": min_linked_cycle,
            "enq_cycle": self.cycle.load(),
        }

    def check_quiesced(self) -> None:
        """Run the domain's quiesced invariant checker over the linked list
        (the host analogue of ``slotpool.check_invariants``)."""
        from repro_torch.core import domain

        states, cycles = [], []
        cur = self.head.load().next.load()
        while cur is not None:
            if type(cur) is BlockNode:
                # Expand the block into per-item states/cycles so the domain
                # checker sees the same shape as scalar nodes.
                snap = cur.ctl.load_range(0, cur.n)
                states.extend(int(s) for s in snap)
                cycles.extend(range(cur.base + 1, cur.base + 1 + cur.n))
            else:
                states.append(cur.state.load())
                cycles.append(cur.cycle)
            cur = cur.next.load()
        domain.check_quiesced(states, cycles, self.cycle.load(),
                              self.deque_cycle.load(), self.window)
