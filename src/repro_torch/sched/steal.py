"""Coordination-free work stealing between CMP shards (DESIGN.md §8).

The stealing invariant: **a steal is a claim.** A stealer is just another
consumer running the paper's dequeue — the state CAS hands it the item
exactly once, and the protection window already guarantees the node it
touched stays type-stable for W cycles. No new synchronization is introduced
anywhere in this module; every primitive below is composed from
``dequeue_many`` (the claim) and ``enqueue_many`` (the republish), so window
safety is *inherited*, not re-proven.

Two modes:

  * **Migration** (:func:`steal_into`, :func:`rebalance`) — move a batch of
    items from a deep shard to a shallow one. Under a :class:`QueueClass`
    frontier drain this is order-invisible: delivery is by cycle stamp, not
    by placement.
  * **Consuming steal** (:class:`ShardConsumer`) — a worker bound to a home
    shard consumes it first and, when idle, claims directly from the deepest
    sibling. This bounds shard idle time without any shared scan state:
    victim selection reads the domain counters (zero added atomics).
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.cmp import CMPQueue
from repro_torch.sched.classes import ShardSet, queue_depth  # noqa: F401 (re-export)


def steal_into(victim: CMPQueue, thief: CMPQueue, max_items: int = 8) -> int:
    """Migrate up to ``max_items`` from victim to thief: one batched claim,
    one batched republish. Exactly-once is the claim CAS's property; if the
    stealer dies between the two calls the items are lost with it — the same
    contract as any consumer that claimed and crashed, which is why callers
    that need stronger guarantees steal *consumingly* (ShardConsumer)."""
    batch = victim.dequeue_many(max_items)
    if batch:
        thief.enqueue_many(batch)
    return len(batch)


def rebalance(shards: ShardSet, max_items: int = 8) -> int:
    """One rebalance step: migrate from the deepest to the shallowest shard
    when the imbalance exceeds the batch size. Safe to run from any number
    of concurrent rebalancer threads (it is only claims + republishes)."""
    if len(shards) < 2:
        return 0
    depths = shards.depths()
    hi = max(range(len(depths)), key=depths.__getitem__)
    lo = min(range(len(depths)), key=depths.__getitem__)
    if hi == lo or depths[hi] - depths[lo] <= max_items:
        return 0
    return steal_into(shards.queues[hi], shards.queues[lo],
                      min(max_items, (depths[hi] - depths[lo]) // 2))


def claim_seat(seat, thief) -> bool:
    """Replica-level steal (DESIGN.md §9/§11): claim a whole shard
    cycle-run by CASing the :class:`~repro_torch.sched.replica.ShardSeat` owner
    cell to the thief's host-addressed
    :class:`~repro_torch.sched.transport.HostAddr`. One CAS, no victim
    participation — ownership of the run (its backlog *and* all its future
    cycles, since placement is ``seq % S``) moves atomically; when the
    victim lives on another host this is the body of the one claim RPC the
    transport carries. The victim discovers the loss lazily and republishes
    anything it had staged from that shard; the seat cursor, not queue
    position, keeps the thief's delivery in exact run order. Returns False
    when the CAS lost a race (or the thief already owns the seat) — retry
    next step."""
    owner = seat.owner.load()
    if owner == thief:
        return False
    return seat.owner.cas(owner, thief)


class ShardConsumer:
    """A consumer with a home shard that steals when the home runs dry.

    ``take(k)`` drains the home shard first (locality); on emptiness it
    picks the deepest sibling and claims from it directly. ``idle_polls``
    counts takes that found nothing anywhere — the quantity stealing is
    meant to bound."""

    def __init__(self, shards: ShardSet, home: int, *,
                 steal_batch: Optional[int] = None):
        self.shards = shards
        self.home = int(home)
        self.steal_batch = steal_batch
        self.steals = 0        # successful steal events
        self.stolen_items = 0  # items claimed from non-home shards
        self.idle_polls = 0

    def take(self, k: int = 1) -> List:
        got = self.shards.queues[self.home].dequeue_many(k)
        if got:
            return got
        order = sorted((i for i in range(len(self.shards)) if i != self.home),
                       key=lambda i: -self.shards.depth(i))
        for victim in order:
            got = self.shards.queues[victim].dequeue_many(
                min(k, self.steal_batch or k))
            if got:
                self.steals += 1
                self.stolen_items += len(got)
                return got
        self.idle_polls += 1
        return []
