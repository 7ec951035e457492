"""Pluggable drain policies: how one admission batch is composed from many
priority classes (DESIGN.md §8).

A policy's ``drain(classes, k)`` returns up to ``k`` ``(qclass, envelope)``
pairs — one batched admission per engine step, built from per-class
``QueueClass.drain`` calls (which are themselves batched ``dequeue_many``
claims underneath). Policies only decide the *cross-class* interleaving;
within a class the frontier drain already fixed the order.

  * :class:`StrictPriority` — higher ``priority`` empties first. Interactive
    traffic starves background under load, by design.
  * :class:`WeightedFair` — deficit round robin over ``weight``: each round a
    class earns quantum × weight credits and spends one per item drained;
    an emptied class forfeits its credit (no hoarding). Long-run throughput
    shares converge to the weights.
  * :class:`ClassFifo` — FIFO *across* classes, recovered by merging class
    heads on the fabric-global arrival stamp: the single-queue behavior,
    re-expressed over the sharded fabric (exact when quiesced, races resolve
    like the base queue's).
"""

from __future__ import annotations

import heapq

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sched.classes import Envelope, QueueClass

Drained = List[Tuple[QueueClass, Envelope]]


class DrainPolicy:
    # True iff this policy admits strictly by class priority, which is what
    # makes priority-driven *lane* preemption in the engine meaningful: the
    # freed lane is guaranteed to go to the higher class. Weight- or
    # stamp-driven policies must leave it False or an eviction can be
    # immediately undone by the policy re-admitting the victim.
    honors_priority = False

    def drain(self, classes: Sequence[QueueClass], k: int) -> Drained:
        raise NotImplementedError

    def held(self) -> int:
        """Envelopes drained from their class but not yet handed out (some
        policies buffer class heads between calls). Counted as pending by
        the scheduler's emptiness check."""
        return 0

    def held_items(self) -> Drained:
        """The buffered ``(qclass, envelope)`` pairs behind :meth:`held` —
        checkpointing records them as requeued seats (their class cursor
        already advanced past them, exactly like a preempted lane)."""
        return []

    def take_held(self) -> Drained:
        """Remove and return the buffered heads — the destructive variant
        used when a replica's local state is handed off (resize, host
        failure): the heads ride to the new seat owners and must not stay
        counted here."""
        return []


class StrictPriority(DrainPolicy):
    honors_priority = True

    def __init__(self):
        # Priority order cached per class-set: the set is stable between
        # calls (same Scheduler, or same active subset), so the common
        # case pays an O(C) identity check instead of an O(C log C) sort.
        self._order_key: Optional[Tuple[int, ...]] = None
        self._order: List[QueueClass] = []

    def _ordered(self, classes: Sequence[QueueClass]) -> List[QueueClass]:
        key = tuple(map(id, classes))
        if key != self._order_key:
            self._order = sorted(classes, key=lambda c: -c.priority)
            self._order_key = key
        return self._order

    def drain(self, classes: Sequence[QueueClass], k: int) -> Drained:
        out: Drained = []
        for qc in self._ordered(classes):
            if len(out) >= k:
                break
            out.extend((qc, env) for env in qc.drain(k - len(out)))
        return out


class WeightedFair(DrainPolicy):
    """Deficit round robin over ``weight``. Each ``drain`` call is one DRR
    round: every backlogged class earns its weight-share of the ``k`` slots
    (fractions carry over as deficit, so a small-weight class still gets a
    slot every few rounds), then classes spend their credit round-robin until
    the batch is full or everyone is dry. An emptied class forfeits its
    credit; accumulated credit is burst-capped so a class returning from idle
    cannot monopolize a batch."""

    def __init__(self, quantum: float = 1.0):
        self.quantum = float(quantum)
        self._deficit: Dict[str, float] = {}

    def drain(self, classes: Sequence[QueueClass], k: int) -> Drained:
        out: Drained = []
        backlogged = [qc for qc in classes if qc.pending() > 0]
        for qc in classes:
            if qc.pending() == 0:
                self._deficit[qc.name] = 0.0  # forfeit: no credit hoarding
        if not backlogged:
            return out
        # One round's credit: k slots split in weight proportion (quantum
        # scales the round size), accumulated onto carried-over deficit.
        total_w = sum(qc.weight for qc in backlogged)
        for qc in backlogged:
            share = self.quantum * k * qc.weight / total_w
            d = self._deficit.get(qc.name, 0.0) + share
            self._deficit[qc.name] = min(d, 2.0 * share + 1.0)  # burst cap
        # Spend the credit round-robin; ~k+len iterations always suffice.
        for _ in range(2 * k + len(backlogged) + 2):
            if len(out) >= k:
                break
            progressed = False
            for qc in backlogged:
                if len(out) >= k:
                    break
                take = min(k - len(out), int(self._deficit[qc.name]))
                got = qc.drain(take) if take > 0 else []
                self._deficit[qc.name] -= len(got)
                if take > 0 and len(got) < take:
                    self._deficit[qc.name] = 0.0  # ran dry mid-quantum
                if got:
                    progressed = True
                    out.extend((qc, env) for env in got)
            if not progressed:
                break
        if not out:
            # All deficits still fractional (many classes, small k): grant
            # the largest creditor one item so every call makes progress.
            qc = max(backlogged, key=lambda c: self._deficit[c.name])
            got = qc.drain(1)
            self._deficit[qc.name] -= len(got)
            out.extend((qc, env) for env in got)
        return out


class ClassFifo(DrainPolicy):
    """Cycle-timestamp merge: repeatedly deliver the class head with the
    smallest fabric arrival stamp. Heads drained but not yet merged persist
    in the policy between calls (they count as pending deliveries)."""

    def __init__(self):
        self._heads: Dict[str, Tuple[QueueClass, Envelope]] = {}
        # Min-heap of (stamp, name) mirroring _heads with lazy deletion:
        # take_held()/supersession leave stale entries behind, and drain
        # skips any popped entry whose stamp no longer matches the live
        # head. One drain is O(C + k log C) — the per-class top-up runs
        # once per call, and each emitted item refills only its own
        # class — instead of the old O(C·k) min-scan per item.
        self._heap: List[Tuple[int, str]] = []

    def held(self) -> int:
        return len(self._heads)

    def held_items(self) -> Drained:
        return list(self._heads.values())

    def take_held(self) -> Drained:
        out = list(self._heads.values())
        self._heads.clear()
        self._heap.clear()
        return out

    def _fill(self, qc: QueueClass) -> None:
        got = qc.drain(1)
        if got:
            self._heads[qc.name] = (qc, got[0])
            heapq.heappush(self._heap, (got[0].stamp, qc.name))

    def drain(self, classes: Sequence[QueueClass], k: int) -> Drained:
        out: Drained = []
        for qc in classes:
            if qc.name not in self._heads:
                self._fill(qc)
        while len(out) < k and self._heap:
            stamp, name = heapq.heappop(self._heap)
            entry = self._heads.get(name)
            if entry is None or entry[1].stamp != stamp:
                continue  # stale heap entry (head taken or superseded)
            del self._heads[name]
            out.append(entry)
            self._fill(entry[0])
        return out


class HierarchicalWFQ(DrainPolicy):
    """Two-level drain for the tenant fabric (DESIGN.md §16): deficit
    round robin *across class groups* (equal shares — groups are hash
    buckets of tenants, so fairness between buckets is fairness between
    tenant populations), strict priority *within* a group (interactive
    beats batch beats background for the tenants sharing the bucket).

    Groups are recovered from the class-name prefix before ``:`` (the
    ``g017:interactive`` convention from sched/tenants.py); a class
    without a prefix forms its own group. The group partition and each
    group's priority order are cached per class-set, so with an active-
    set filter a drain touches only backlogged groups.

    ``honors_priority`` stays False: admission is weight-driven across
    groups, so a priority-evicted lane could be immediately re-admitted.
    """

    def __init__(self, quantum: float = 1.0):
        self.quantum = float(quantum)
        self._deficit: Dict[str, float] = {}
        self._cache_key: Optional[Tuple[int, ...]] = None
        self._groups: List[Tuple[str, List[QueueClass]]] = []

    def _grouped(self, classes: Sequence[QueueClass]):
        key = tuple(map(id, classes))
        if key != self._cache_key:
            by_key: Dict[str, List[QueueClass]] = {}
            for qc in classes:
                by_key.setdefault(qc.name.partition(":")[0], []).append(qc)
            self._groups = [
                (gkey, sorted(members, key=lambda c: -c.priority))
                for gkey, members in by_key.items()]
            self._cache_key = key
        return self._groups

    @staticmethod
    def _drain_group(members: List[QueueClass], k: int) -> Drained:
        out: Drained = []
        for qc in members:  # already priority-sorted
            if len(out) >= k:
                break
            out.extend((qc, env) for env in qc.drain(k - len(out)))
        return out

    def drain(self, classes: Sequence[QueueClass], k: int) -> Drained:
        # No pending() pre-sweep: with an active-set filter the offered
        # groups almost all hold work, so probing every member first costs
        # O(active x tiers) atomic loads per step for nothing. A group
        # that turns out dry forfeits its deficit the first time its
        # quantum comes up empty (the ran-dry reset below) — same
        # no-hoarding guarantee, paid only by groups that are actually
        # empty.
        out: Drained = []
        backlogged = self._grouped(classes)
        if not backlogged:
            return out
        share = self.quantum * k / len(backlogged)
        for gkey, _ in backlogged:
            d = self._deficit.get(gkey, 0.0) + share
            self._deficit[gkey] = min(d, 2.0 * share + 1.0)  # burst cap
        dry = {}  # groups observed empty this call: no point re-probing
        dry_passes = 0
        for _ in range(2 * k + len(backlogged) + 2):
            if len(out) >= k:
                break
            progressed = False
            for gkey, members in backlogged:
                if len(out) >= k:
                    break
                if gkey in dry:
                    continue
                take = min(k - len(out), int(self._deficit[gkey]))
                got = self._drain_group(members, take) if take > 0 else []
                self._deficit[gkey] -= len(got)
                if take > 0 and len(got) < take:
                    self._deficit[gkey] = 0.0  # ran dry mid-quantum
                    dry[gkey] = True
                if got:
                    progressed = True
                    out.extend(got)
            if progressed:
                dry_passes = 0
                continue
            # Work-conserving re-credit: every deficit may be fractional
            # (many groups, small k) while some group still holds items —
            # classic DRR runs more rounds until the budget is spent, so
            # grant another share and retry; two consecutive no-progress
            # passes mean everything offered is actually dry.
            dry_passes += 1
            if dry_passes >= 2:
                break
            for gkey, _ in backlogged:
                if gkey not in dry:
                    self._deficit[gkey] += share
        if not out:
            # All deficits still fractional (many groups, small k): grant
            # the largest creditor one item so every call makes progress.
            gkey, members = max(backlogged,
                                key=lambda g: self._deficit[g[0]])
            got = self._drain_group(members, 1)
            self._deficit[gkey] -= len(got)
            out.extend(got)
        return out


_POLICIES = {
    "strict": StrictPriority,
    "wfq": WeightedFair,
    "fifo": ClassFifo,
    "hier": HierarchicalWFQ,
}


def make_policy(policy) -> DrainPolicy:
    """Accept a policy instance or a name: strict | wfq | fifo | hier."""
    if isinstance(policy, DrainPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown policy {policy!r}; "
                         f"choose from {sorted(_POLICIES)}") from None
