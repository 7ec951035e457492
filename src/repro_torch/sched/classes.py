"""Priority-class CMP queue fabric (DESIGN.md §8).

The paper's pitch is that CMP makes queues cheap enough to be the *fabric* of
a serving pipeline. This module composes many CMP queues under one scheduler:

  * :class:`ShardSet` — S independent :class:`CMPQueue` shards. Shard load is
    sampled straight from the domain counters (``cycle`` − ``deque_cycle``),
    zero added atomics.
  * :class:`QueueClass` — one tenant/priority class. Every submit linearizes
    at a dense per-class cycle stamp (one fetch-add); the item lands on shard
    ``seq % S``. The drain side re-merges shards through a *cycle frontier*:
    items are delivered in exactly class-cycle order, no matter which shard
    holds them — which is what makes work stealing (migration between shards)
    order-invisible. Admission is window-bounded via ``domain.window_admit``:
    the class rejects (backpressure) instead of growing without bound.
  * :class:`Scheduler` — the fabric: classes + a drain policy + one global
    arrival stamp (for FIFO-across-classes merges).

Ordering contract: *strict FIFO per class, policy-relaxed across classes.*
Within a class, delivery order is exactly the class-cycle order assigned at
submit — stronger than the base queue's per-producer FIFO, and preserved
under concurrent producers and stealers (tests/test_sched.py). Across
classes, the policy decides — that is the only ordering the fabric relaxes.

Concurrency contract: any number of producers (``submit``/``submit_many``)
and stealers (:mod:`repro.sched.steal`) run fully concurrently; the *drain*
of one class is single-caller (the scheduler loop), like the engine's
scheduler thread. A producer stalled between its stamp and its shard enqueue
stalls only its own class's frontier (head-of-line within the class is what
strict FIFO *means*); other classes are unaffected — that is the fabric's
whole point.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.atomics import AtomicCell, cpu_pause
from repro_torch.core.cmp import CMPQueue
from repro_torch.core.domain import window_admit
from repro_torch.sched.stats import ClassStats

# Drain-side bounded spin while the frontier item is mid-enqueue (a producer
# between its stamp fetch-add and its shard splice). The gap window is a few
# instructions; a handful of pauses covers it without coordinating.
_GAP_PATIENCE = 64


@dataclasses.dataclass
class Envelope:
    """What actually travels through a class's shards.

    ``seq`` is the class cycle (dense, assigned at submit — the class-local
    FIFO order). ``stamp`` is the fabric-global arrival cycle (the merge key
    for FIFO-across-classes). ``t_submit`` feeds admission-latency telemetry.
    """
    __slots__ = ("seq", "stamp", "t_submit", "payload")
    seq: int
    stamp: int
    t_submit: float
    payload: Any

    def __lt__(self, other: "Envelope") -> bool:  # heapq (requeue order)
        return self.seq < other.seq


def shard_for(key: int, num_shards: int) -> int:
    """Stable multiplicative hash (Knuth) — producer-side shard pick."""
    return (int(key) * 2654435761 % (1 << 32)) % num_shards


def encode_envelopes(envs: Iterable[Envelope], encode=None) -> List[list]:
    """Checkpoint wire format for envelopes: ``[seq, stamp, payload]``
    records, seat-sorted. ``encode`` maps payloads to JSON-able values
    (default identity). Shared by the single-drain and replica codecs so
    the format cannot drift between them."""
    enc = encode or (lambda p: p)
    return [[e.seq, e.stamp, enc(e.payload)] for e in sorted(envs)]


def decode_envelope(rec: list, decode=None, *, now: float = None) -> Envelope:
    """Inverse of :func:`encode_envelopes` for one record. ``t_submit`` is
    reset to ``now`` — the old process's monotonic clock is meaningless
    here, and latency telemetry should count from the restore."""
    dec = decode or (lambda p: p)
    return Envelope(rec[0], rec[1],
                    time.monotonic() if now is None else now, dec(rec[2]))


def queue_depth(q: CMPQueue) -> int:
    """Unclaimed-depth estimate for one CMP queue, read from the domain
    counters alone (enqueue cycle − protection boundary): zero added
    atomics, approximate under in-flight claims, exact when quiesced."""
    return max(0, q.cycle.load() - q.deque_cycle.load())


class ShardSet:
    """S independent CMP queues with domain-state load sampling."""

    def __init__(self, num_shards: int = 1, **queue_kw):
        assert num_shards >= 1
        self.queues: List[CMPQueue] = [CMPQueue(**queue_kw)
                                       for _ in range(num_shards)]

    def __len__(self) -> int:
        return len(self.queues)

    def shard_for(self, key: int) -> int:
        return shard_for(key, len(self.queues))

    def depth(self, idx: int) -> int:
        """Unclaimed-depth estimate for one shard (see `queue_depth`)."""
        return queue_depth(self.queues[idx])

    def depths(self) -> List[int]:
        return [self.depth(i) for i in range(len(self.queues))]

    def live_nodes(self) -> int:
        return sum(q.live_nodes() for q in self.queues)


class QueueClass:
    """One tenant/priority class over a CMP shard set.

    Args:
      name: class identity (policy and telemetry key).
      priority: bigger = more urgent (strict-priority order, preemption rank).
      weight: share under weighted-fair draining.
      num_shards: CMP queue shards (stealing targets).
      admit_window: window-based admission bound — at most this many items
        in flight (submitted, not yet first-delivered); ``None`` = unbounded.
        This is ``domain.window_admit`` read as backpressure: the j-th
        outstanding submission is admitted iff j < W. Enforced with one
        fetch-add on an in-flight counter (claim-then-check, surplus rolled
        back before anything is enqueued), so the bound holds under any
        number of racing producers — overshoot is impossible; a transient
        spurious reject under a race is the conservative direction.
      queue_kw: forwarded to each shard's :class:`CMPQueue`.
    """

    def __init__(self, name: str, *, priority: int = 0, weight: float = 1.0,
                 num_shards: int = 1, admit_window: Optional[int] = None,
                 **queue_kw):
        self.name = name
        self.priority = int(priority)
        self.weight = float(weight)
        self.admit_window = admit_window
        self._queue_kw = dict(queue_kw)  # retained for checkpointing
        self.shards = ShardSet(num_shards, **queue_kw)
        self._seq = AtomicCell(0)      # class cycle: submit linearization point
        self._inflight = AtomicCell(0)  # admission-window occupancy (atomic)
        self._frontier = 0             # next seq to deliver (drain-side only)
        self._stage: Dict[int, Envelope] = {}   # claimed, awaiting their turn
        self._requeue: List[Envelope] = []      # preempted (seq < frontier)
        self.stats = ClassStats(name)

    # flight-recorder attachment (repro.obs): None until a MetricsHub
    # attaches — the un-observed hot path pays one `is None` check.
    # Head-sampling is a pure function of the class cycle (`rec.sampled`),
    # so every lifecycle emit site agrees on which envelopes are traced.
    _obs = None

    # active-set attachment (repro.sched.tenants): None until a tenant
    # fabric enables O(active) tracking via Scheduler.enable_active_
    # tracking() — same discipline as _obs, one `is None` check when off.
    # Producers mark AFTER their item is visible in a shard, so a retire
    # sweep can never strand an item (see ActiveSet).
    _active = None

    # ------------------------------------------------------------- producers
    def pending(self) -> int:
        """Items submitted but not yet first-delivered (+ requeued)."""
        return max(0, self._seq.load() - self._frontier) + len(self._requeue)

    def submit(self, payload: Any, *, stamp: int = 0) -> Optional[Envelope]:
        """Admit one item; returns its envelope, or None on window rejection.

        The fetch-add on the class cycle is the linearization point; placement
        is round-robin by cycle (``seq % S``) so the frontier drain knows the
        stamps are dense."""
        if self.admit_window is not None:
            # Claim a window seat first, roll back on overflow: racing
            # producers can never exceed the bound (j-th in flight iff j < W).
            pos = self._inflight.fetch_add(1)
            if not window_admit(pos, self.admit_window):
                self._inflight.fetch_add(-1)
                self.stats.add_rejected()
                return None
        seq = self._seq.fetch_add(1)
        env = Envelope(seq, stamp, time.monotonic(), payload)
        self.shards.queues[seq % len(self.shards)].enqueue(env)
        act = self._active
        if act is not None:
            act.mark(self.name)  # after the enqueue: never strands the item
        self.stats.add_submitted()
        rec = self._obs
        if rec is not None and rec.sampled(seq):
            self._trace_submit(rec, seq, env.t_submit)
        return env

    def _trace_submit(self, rec, seq: int, t0: float) -> None:
        """Off the fast path: the three producer-side lifecycle stages for
        one sampled envelope (stamp, window seat, shard splice)."""
        rec.emit("submit", self.name, seq, t=t0)
        rec.emit("window_admit", self.name, seq, t=t0)
        rec.emit("shard_enqueue", self.name, seq,
                 arg=seq % len(self.shards))

    def submit_many(self, payloads: Sequence[Any], *, stamp: int = 0
                    ) -> List[Optional[Envelope]]:
        """Batched admission: one cycle-range fetch-add for the accepted
        prefix, one ``enqueue_many`` splice per shard. Items beyond the
        admission window are rejected (None entries, suffix-aligned)."""
        payloads = list(payloads)
        n = len(payloads)
        if self.admit_window is not None:
            # Claim the whole range, return the surplus: bound never exceeded.
            old = self._inflight.fetch_add(n)
            room = max(0, min(n, self.admit_window - old))
            if room < n:
                self._inflight.fetch_add(room - n)
            n = room
        if n == 0:
            self.stats.add_rejected(len(payloads))
            return [None] * len(payloads)
        base = self._seq.fetch_add(n)
        now = time.monotonic()
        envs = [Envelope(base + i, stamp + i, now, p)
                for i, p in enumerate(payloads[:n])]
        S = len(self.shards)
        for s in range(S):
            group = envs[(s - base) % S::S] if S > 1 else envs
            if group:
                self.shards.queues[s].enqueue_many(group)
        act = self._active
        if act is not None:
            act.mark(self.name)
        self.stats.add_submitted(n)
        if len(payloads) > n:
            self.stats.add_rejected(len(payloads) - n)
        rec = self._obs
        if rec is not None and rec.every:
            # trace only the sampled seqs in [base, base+n): the batched
            # path stays O(batch/every), not O(batch)
            for seq in range(base + (-base) % rec.every, base + n, rec.every):
                self._trace_submit(rec, seq, now)
        return envs + [None] * (len(payloads) - n)

    # ---------------------------------------------------------------- drain
    def requeue(self, env: Envelope) -> None:
        """Return a previously-delivered envelope (preemption, admission
        park) to the class. It re-enters at its *original* cycle position:
        the requeue heap is served before the frontier, ordered by seq."""
        heapq.heappush(self._requeue, env)
        act = self._active
        if act is not None:
            act.mark(self.name)
        self.stats.requeued += 1
        rec = self._obs
        if rec is not None and rec.sampled(env.seq):
            rec.emit("requeue", self.name, env.seq)

    def _stage_from_shards(self, want: int) -> int:
        """Claim up to ``want`` envelopes from every shard into the staging
        map. A steal (migration) between shards is invisible here: staging
        keys by seq, delivery is by frontier, placement does not matter."""
        got = 0
        rec = self._obs
        for q in self.shards.queues:
            for env in q.dequeue_many(want):
                self._stage[env.seq] = env
                got += 1
                if rec is not None and rec.sampled(env.seq):
                    rec.emit("drain", self.name, env.seq)
        return got

    def drain(self, k: int) -> List[Envelope]:
        """Deliver up to ``k`` envelopes in exact class-cycle order.

        Single-caller (the scheduler loop). Requeued (preempted) items first
        — their cycles predate the frontier — then frontier items, claimed
        from the shards and re-merged by the dense seq stamps. Never delivers
        past a gap: a missing seq means a producer is mid-submit, so we spin
        briefly and otherwise return short (strict FIFO is preserved, the
        gap's class alone waits)."""
        out: List[Envelope] = []
        while self._requeue and len(out) < k:
            out.append(heapq.heappop(self._requeue))
        spins = 0
        rec = self._obs
        while len(out) < k:
            while len(out) < k and self._frontier in self._stage:
                env = self._stage.pop(self._frontier)
                self._frontier += 1
                if self.admit_window is not None:
                    self._inflight.fetch_add(-1)  # window seat freed
                self.stats.record_delivery(env)
                if rec is not None and rec.sampled(env.seq):
                    rec.emit("seat", self.name, env.seq)
                out.append(env)
                spins = 0
            if len(out) >= k:
                break
            if self._frontier >= self._seq.load():
                break  # nothing submitted beyond the frontier
            if self._stage_from_shards(k - len(out)) == 0:
                # Frontier item stamped but not yet spliced: bounded wait.
                spins += 1
                if spins > _GAP_PATIENCE:
                    self.stats.gap_waits += 1
                    break
                cpu_pause()
        self.stats.delivered += len(out)
        return out

    def drain_block(self, k: int) -> List[Envelope]:
        """Bulk drain with the same delivery contract as :meth:`drain`, used
        by the device-admission feeder (DESIGN.md §12). When the fast shape
        applies — single shard, no requeues, nothing staged, and the claimed
        run is seq-contiguous from the frontier — the per-item frontier and
        stage bookkeeping collapses to O(1) per batch: one vectorized shard
        claim, one frontier advance, one batched window-seat release, one
        clock read. Any other shape routes through the exact per-item
        :meth:`drain` (out-of-order runs are staged first, so nothing is
        lost or reordered)."""
        if self._requeue or self._stage or len(self.shards) != 1:
            return self.drain(k)
        envs = self.shards.queues[0].dequeue_many(k)
        if not envs:
            return []  # nothing claimable (or a producer mid-splice): retry next pull
        base = self._frontier
        n = len(envs)
        if [e.seq for e in envs] != list(range(base, base + n)):
            # Producers spliced out of seq order: merge the slow, exact way.
            for e in envs:
                self._stage[e.seq] = e
            return self.drain(k)
        self._frontier = base + n
        if self.admit_window is not None:
            self._inflight.fetch_add(-n)  # one batched seat release
        self.stats.record_delivery_many(envs)
        self.stats.delivered += n
        rec = self._obs
        if rec is not None and rec.every:
            now = time.monotonic()
            for seq in range(base + (-base) % rec.every, base + n, rec.every):
                rec.emit("drain", self.name, seq, t=now)
                rec.emit("seat", self.name, seq, t=now)
        return envs

    # ---------------------------------------------------------- checkpoint
    def _capture_pending(self) -> int:
        """Claim every spliced-but-undelivered envelope into the staging map
        (delivery order is unaffected: the drain already serves the stage).
        Returns the number of seats in [frontier, seq) that could *not* be
        captured — nonzero only when a producer is mid-submit, the same
        head-of-line contract as `drain`."""
        spins = 0
        while True:
            missing = (self._seq.load() - self._frontier) - len(self._stage)
            if missing <= 0:
                return 0
            if self._stage_from_shards(missing) == 0:
                spins += 1
                if spins > _GAP_PATIENCE:
                    return missing
                cpu_pause()
            else:
                spins = 0

    def _meta_state(self) -> dict:
        """The class-identity + cycle-counter half of a snapshot, shared by
        the single-drain and replica codecs. ``queue_kw`` (the shards'
        CMPQueue configuration — window, reclaim cadence, …) is captured so
        a restore rebuilds the *same* protection behavior, not a guessed
        one. ``deque_cycles`` (the shards' protection boundaries) rides
        along as *diagnostics only*: restore rebuilds fresh shards and
        re-enqueues the captured envelopes, so queue-internal counters
        restart at zero by design."""
        return {
            "name": self.name,
            "priority": self.priority,
            "weight": self.weight,
            "admit_window": self.admit_window,
            "num_shards": len(self.shards),
            "queue_kw": dict(self._queue_kw),
            "seq": self._seq.load(),
            "deque_cycles": [q.deque_cycle.load() for q in self.shards.queues],
        }

    @classmethod
    def _from_meta(cls, state: dict, **queue_kw) -> "QueueClass":
        """Rebuild the class identity; shard CMPQueue config comes from the
        snapshot, with caller kwargs as explicit overrides."""
        merged = {**state.get("queue_kw", {}), **queue_kw}
        qc = cls(state["name"], priority=state["priority"],
                 weight=state["weight"], num_shards=state["num_shards"],
                 admit_window=state["admit_window"], **merged)
        qc._seq.store(state["seq"])
        return qc

    def state(self, *, encode=None) -> dict:
        """Exact-seat frontier snapshot: ``(class seq, frontier, requeue
        heap, staged pending, per-shard deque_cycle)``. Every undelivered
        envelope is captured (claimed into the stage first), so a restored
        class resumes each tenant at its exact FIFO seat. The returned dict
        is plain data — safe to hand to an async checkpoint writer while
        this class keeps draining. Exact when producers are quiesced (a
        producer mid-submit is reported in ``gaps``, and its item — not yet
        spliced anywhere — cannot be captured by anyone).

        ``encode`` maps payloads to JSON-able values (default: identity).
        """
        gaps = self._capture_pending()
        return {
            **self._meta_state(),
            "frontier": self._frontier,
            "gaps": gaps,
            "requeue": encode_envelopes(self._requeue, encode),
            "stage": encode_envelopes(self._stage.values(), encode),
        }

    @classmethod
    def from_state(cls, state: dict, *, decode=None, **queue_kw) -> "QueueClass":
        """Rebuild a class at its checkpointed seats: the cycle counter,
        drain frontier and every undelivered envelope resume exactly where
        `state` captured them (staged items re-enter their home shard
        ``seq % S``; requeued seats are served first, as before)."""
        qc = cls._from_meta(state, **queue_kw)
        qc._frontier = state["frontier"]
        if qc.admit_window is not None:
            # window seats are freed at first delivery; everything in
            # [frontier, seq) is still occupying one
            qc._inflight.store(max(0, state["seq"] - state["frontier"]))
        now = time.monotonic()
        for rec in state["requeue"]:
            heapq.heappush(qc._requeue, decode_envelope(rec, decode, now=now))
        for rec in state["stage"]:
            env = decode_envelope(rec, decode, now=now)
            qc.shards.queues[env.seq % len(qc.shards)].enqueue(env)
        return qc

    # ------------------------------------------------------------ telemetry
    def snapshot(self) -> dict:
        return self.stats.snapshot(pending=self.pending(),
                                   shard_depths=self.shards.depths())


class Scheduler:
    """The class fabric: named classes + a drain policy + the global arrival
    stamp that FIFO-across-classes merges on."""

    def __init__(self, classes: Sequence[QueueClass], policy="strict"):
        from repro_torch.sched.policy import make_policy
        assert classes, "scheduler needs at least one class"
        self.classes: List[QueueClass] = list(classes)
        self.by_name: Dict[str, QueueClass] = {c.name: c for c in self.classes}
        assert len(self.by_name) == len(self.classes), "duplicate class names"
        self.policy = make_policy(policy)
        self._stamp = AtomicCell(0)  # fabric-global arrival cycle
        # O(active) index (sched/tenants.py), None unless a tenant fabric
        # enables it: with it set, drain/pending/snapshot walk only the
        # classes that currently hold work instead of the whole grid.
        self.active = None

    @property
    def default_class(self) -> str:
        return self.classes[0].name

    def enable_active_tracking(self):
        """Switch drain/pending/snapshot to O(active classes).

        Attached post-construction (like the obs recorder) so none of the
        construction paths — direct, from_state, replica rebuild — need
        threading a flag. All classes start marked; the first drain sweep
        retires the idle ones, after which only classes with queued work
        are ever touched."""
        if self.active is None:
            from repro_torch.sched.tenants import ActiveSet
            self.active = ActiveSet()
            for qc in self.classes:
                qc._active = self.active
                self.active.mark(qc.name)
        return self.active

    def submit(self, qclass: str, payload: Any) -> Optional[Envelope]:
        return self.by_name[qclass].submit(payload,
                                           stamp=self._stamp.fetch_add(1))

    def submit_many(self, qclass: str, payloads: Sequence[Any]
                    ) -> List[Optional[Envelope]]:
        qc = self.by_name[qclass]
        return qc.submit_many(payloads,
                              stamp=self._stamp.fetch_add(len(payloads)))

    def drain(self, k: int) -> List[Tuple[QueueClass, Envelope]]:
        """One admission batch: the policy composes per-class drains.
        With active tracking on, only classes holding work are offered to
        the policy, and classes observed empty afterwards leave the
        active set (a racing producer re-marks them post-enqueue)."""
        act = self.active
        if act is None:
            return self.policy.drain(self.classes, k)
        offered = [self.by_name[n] for n in act.names()]
        out = self.policy.drain(offered, k)
        for qc in offered:
            if qc.pending() == 0:
                act.discard(qc.name)
        return out

    def drain_bulk(self, k: int) -> List[Tuple[QueueClass, Envelope]]:
        """Bulk admission drain for the device-admission feeder (DESIGN.md
        §12): a single-class fabric has nothing to interleave, so the policy
        merge is skipped in favor of the class's vectorized block drain; any
        other shape (multi-class, policy-held heads) takes the normal
        policy-composed drain."""
        if len(self.classes) == 1 and self.policy.held() == 0:
            qc = self.classes[0]
            return [(qc, env) for env in qc.drain_block(k)]
        return self.drain(k)

    def pending(self) -> int:
        act = self.active
        if act is not None:
            # inactive => pending 0 by the mark-after-enqueue invariant
            return (sum(self.by_name[n].pending() for n in act.names())
                    + self.policy.held())
        return sum(c.pending() for c in self.classes) + self.policy.held()

    def snapshot(self, *, active_only: bool = False) -> dict:
        if active_only and self.active is not None:
            return {n: self.by_name[n].snapshot()
                    for n in self.active.names()}
        return {c.name: c.snapshot() for c in self.classes}
