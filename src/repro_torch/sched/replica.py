"""Sharded scheduler replicas: N drain loops over one class fabric
(DESIGN.md §9), host-addressed and transport-agnostic (DESIGN.md §11).

A many-producer, one-consumer fabric has a single policy drain loop
feeding the engine, and that loop is the scalability ceiling the paper
says a CMP system should not have. This module splits the
*consumer* side into N :class:`SchedulerReplica`\\ s, each owning a subset of
every class's shards and running its own policy drain — no replica ever
waits on another. Two CMP ideas carry the whole design:

  * **Ownership is a claim.** Each (class, shard) pair has a
    :class:`ShardSeat` whose ``owner`` field is a single CAS-published cell
    holding a host-addressed :class:`~repro_torch.sched.transport.HostAddr`
    ``(host, rid)``. A starved replica *steals the seat* — one claim RPC
    through the :class:`~repro_torch.sched.transport.Transport`, no handshake, no
    victim participation — and with it the shard's entire cycle-run, past
    and future (placement is ``seq % S``, so a seat carries the arithmetic
    sequence ``s, s+S, s+2S, …`` of class cycles forever). Stealing items
    one batch at a time would poke holes in a peer's frontier arithmetic;
    stealing the seat moves the *run*, which is exactly the granularity at
    which class-cycle order is preserved — and exactly one message when the
    peer lives on another host.
  * **The seat cursor makes delivery exact.** ``ShardSeat.next_seat`` is
    the next undelivered class cycle of that shard. Only the replica
    holding the claimed envelope for that cycle advances the cursor
    (the queue's claim CAS already made holding exclusive, so the advance
    needs no CAS of its own). A replica's drain is a frontier merge over
    its owned seats: always deliver the lowest pending cycle it owns —
    which is why transport-level reordering of a fetched batch is
    invisible to delivery order.

Ordering contract: *within every shard's cycle-run, delivery is exactly the
class-cycle order; across the fabric, each class's seats are delivered
exactly once, and merging the replica streams by seat recovers the dense
class-cycle order 0,1,2,….* With static ownership each replica's stream is
itself seat-monotone; a steal splices a run between replicas but never
reorders within one, never loses a seat, never delivers one twice — on one
host or across simulated hosts under message drop/delay/reorder.

Crash contract: a replica that dies holding claimed-but-undelivered
envelopes takes them with it — the same contract as any crashed consumer in
the paper. Recovery is :meth:`ReplicaSet.state` / :meth:`ReplicaSet.from_state`
(an exact-seat frontier snapshot from which every tenant resumes at its
exact FIFO seat) — and, live, :meth:`ReplicaSet.fail_host`: the lost host's
final frontier state is replayed through the wire codec into the survivors
(the DESIGN.md §9 observation that the checkpoint format *is* the wire
format, as one running operation).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.atomics import AtomicCell, cpu_pause
from repro_torch.sched.classes import (_GAP_PATIENCE, Envelope, QueueClass,
                                 Scheduler, decode_envelope,
                                 encode_envelopes)
from repro_torch.sched.policy import make_policy
from repro_torch.sched.stats import ClassStats, aggregate_class_snapshots
from repro_torch.sched.transport import (HostAddr, LocalTransport, Transport,
                                   decode_owner, wire_decode, wire_encode)

# Active-set retirement sweep cadence (rebalance calls between sweeps).
# The sweep is O(active x replicas) pending() probes; a stale entry only
# costs one empty policy visit per drain, so amortizing it is pure win.
_RETIRE_EVERY = 8


class ShardSeat:
    """Ownership + delivery cursor for one (class, shard) pair.

    ``owner`` is the :class:`HostAddr` of the replica currently entitled to
    drain the shard — CAS-published, so a steal is literally one claim (one
    RPC when the thief is on another host). ``next_seat`` is the next
    undelivered class cycle of the shard's run (always ≡ shard index mod
    S); it is advanced with a plain store by whichever replica holds the
    claimed envelope for that cycle — the queue's claim CAS already made
    that replica unique, so the cursor needs no second CAS.
    """

    __slots__ = ("owner", "next_seat")

    def __init__(self, owner: HostAddr, shard: int):
        self.owner = AtomicCell(owner)
        self.next_seat = AtomicCell(int(shard))


class ClassView:
    """One replica's drain view of one :class:`QueueClass`.

    Quacks like a ``QueueClass`` for everything a drain policy or the
    engine touches (``name``/``priority``/``weight``/``drain``/``pending``/
    ``requeue``/``snapshot``), but delivers only the cycle-runs of the
    seats this replica currently owns. All shard I/O goes through the
    transport (claim = ``fetch``, republish = ``publish``); shard *depth*
    sampling stays a direct domain-counter read — telemetry, zero messages,
    as in the single-consumer fabric.
    """

    def __init__(self, qclass: QueueClass, seats: List[ShardSeat],
                 addr: HostAddr, transport: Transport):
        self.qclass = qclass
        self.seats = seats
        self.addr = addr
        self.transport = transport
        self._stride = len(qclass.shards)
        self._stage: Dict[int, Envelope] = {}  # claimed, awaiting their seat
        self._requeue: List[Envelope] = []     # preempted (seat already spent)
        # cross-thread relocation inbox (resize / host recovery): carried
        # seat-spent envelopes land here under a lock and are absorbed into
        # the requeue heap by the single drainer thread — heap operations
        # stay single-threaded, handoff is race-free
        self._handoff: List[Envelope] = []
        self._handoff_lock = threading.Lock()
        self.stats = ClassStats(qclass.name)

    # flight-recorder attachment (repro_torch.obs): the owning replica's ring;
    # None until a MetricsHub attaches (one `is None` check un-observed)
    _obs = None

    # ---- QueueClass facade ------------------------------------------------
    @property
    def name(self) -> str:
        return self.qclass.name

    @property
    def priority(self) -> int:
        return self.qclass.priority

    @property
    def weight(self) -> float:
        return self.qclass.weight

    @property
    def rid(self) -> int:
        return self.addr.rid

    def owned(self) -> List[int]:
        return [s for s, seat in enumerate(self.seats)
                if seat.owner.load() == self.addr]

    def _remaining(self, shard: int) -> int:
        """Undelivered seats left in one owned shard's cycle-run."""
        nxt = self.seats[shard].next_seat.load()
        seq = self.qclass._seq.load()
        if nxt >= seq:
            return 0
        return (seq - nxt + self._stride - 1) // self._stride

    def pending(self) -> int:
        return (len(self._requeue) + len(self._handoff)
                + sum(self._remaining(s) for s in self.owned()))

    def handoff(self, env: Envelope) -> None:
        """Relocate a seat-spent envelope to this view from another thread
        (resize / host recovery). Not a preemption: the requeued counter is
        not bumped — the seat's delivery telemetry rode into the retired
        roll-up with its old owner."""
        with self._handoff_lock:
            self._handoff.append(env)
        act = self.qclass._active
        if act is not None:
            act.mark(self.name)  # after the append: never strands the item

    def _absorb_handoff(self) -> None:
        if self._handoff:  # racy peek is fine: a miss is absorbed next round
            with self._handoff_lock:
                arrived, self._handoff = self._handoff, []
            for env in arrived:
                heapq.heappush(self._requeue, env)

    def requeue(self, env: Envelope) -> None:
        """Return a delivered envelope (preemption) to *this replica*: its
        seat was already spent, so it re-enters through the local requeue
        heap, served before any frontier seat — exactly the QueueClass
        contract, replica-local."""
        heapq.heappush(self._requeue, env)
        act = self.qclass._active
        if act is not None:
            act.mark(self.name)
        self.stats.requeued += 1
        rec = self._obs
        if rec is not None and rec.sampled(env.seq):
            rec.emit("requeue", self.name, env.seq)

    # ---- drain ------------------------------------------------------------
    def _release_lost(self) -> None:
        """Republish staged envelopes whose seat was stolen out from under
        us: one batched publish per home shard, through the transport. The
        thief's seat cursor (not queue position) drives its delivery order,
        so a republish at the tail is order-safe — even when the publish
        crosses hosts."""
        lost = [e for e in self._stage.values()
                if self.seats[e.seq % self._stride].owner.load() != self.addr]
        by_shard: Dict[int, List[Envelope]] = {}
        for env in sorted(lost):
            del self._stage[env.seq]
            by_shard.setdefault(env.seq % self._stride, []).append(env)
        for s, envs in by_shard.items():
            self.transport.publish(self.name, s, envs, self.addr)

    def _deliver(self, env: Envelope, first: bool) -> None:
        qc = self.qclass
        if first:
            if qc.admit_window is not None:
                qc._inflight.fetch_add(-1)  # window seat freed
            self.stats.record_delivery(env)
        self.stats.delivered += 1

    def drain(self, k: int) -> List[Envelope]:
        """Deliver up to ``k`` envelopes: requeued seats first, then the
        frontier merge over owned seats — always the lowest pending class
        cycle this replica owns, claimed from its home shard through the
        transport. Never delivers past a gap in a run: a missing seat is a
        producer mid-submit, a claimed envelope still held by the seat's
        previous owner (who will deliver it — the cursor advances — or
        republish it), or a message in flight on a lossy transport; all of
        them resolve on a later round, so we spin briefly and otherwise
        return short."""
        out: List[Envelope] = []
        self._absorb_handoff()
        while self._requeue and len(out) < k:
            env = heapq.heappop(self._requeue)
            self._deliver(env, first=False)
            out.append(env)
        self._release_lost()
        spins = 0
        while len(out) < k:
            best: Optional[Tuple[int, int]] = None  # (next_seat, shard)
            for s in self.owned():
                nxt = self.seats[s].next_seat.load()
                if nxt < self.qclass._seq.load() and \
                        (best is None or nxt < best[0]):
                    best = (nxt, s)
            if best is None:
                break  # nothing pending in any owned run
            nxt, s = best
            env = self._stage.pop(nxt, None)
            claimed_any = False
            if env is None:
                rec = self._obs
                for e in self.transport.fetch(self.name, s, k, self.addr):
                    claimed_any = True
                    if rec is not None and rec.sampled(e.seq):
                        rec.emit("drain", self.name, e.seq, arg=s)
                    if e.seq == nxt:
                        env = e
                    else:
                        self._stage[e.seq] = e
            if env is None:
                if claimed_any or self.seats[s].next_seat.load() != nxt:
                    spins = 0
                    continue  # progress was made / seat advanced meanwhile
                spins += 1
                if spins > _GAP_PATIENCE:
                    self.stats.gap_waits += 1
                    break
                cpu_pause()
                continue
            spins = 0
            # We hold the claimed envelope -> we are the unique advancer.
            self.seats[s].next_seat.store(nxt + self._stride)
            self._deliver(env, first=True)
            rec = self._obs
            if rec is not None and rec.sampled(env.seq):
                rec.emit("seat", self.name, env.seq, arg=s)
            out.append(env)
        return out

    def snapshot(self) -> dict:
        return self.stats.snapshot(
            pending=self.pending(),
            shard_depths=[self.qclass.shards.depth(s) for s in self.owned()])


class SchedulerReplica:
    """One drain loop's worth of the fabric: a policy over per-class views.

    Presents the same surface as :class:`Scheduler` (``drain``/``policy``/
    ``classes``/``pending``/``snapshot``/``submit``…), so an engine built
    against the scheduler runs unchanged against a replica. Submissions
    delegate to the shared fabric — producers never care which replica will
    drain their item. The replica's :class:`HostAddr` pins it to a
    transport host; ``alive`` goes False when that host is failed.
    """

    def __init__(self, rid: int, scheduler: Scheduler,
                 seats: Dict[str, List[ShardSeat]], *, policy="strict",
                 min_steal: int = 2,
                 transport: Optional[Transport] = None):
        self.rid = rid
        self.scheduler = scheduler
        if transport is None:  # standalone construction (outside ReplicaSet)
            transport = LocalTransport()
            transport.bind(scheduler, seats)
        self.transport = transport
        self.addr = self.transport.addr_of(rid)
        self.alive = self.transport.alive(self.addr.host)
        self.policy = make_policy(policy)
        self.min_steal = int(min_steal)
        self.views: List[ClassView] = [
            ClassView(qc, seats[qc.name], self.addr, self.transport)
            for qc in scheduler.classes]
        self.by_name = {v.name: v for v in self.views}
        self.steals = 0         # successful seat claims
        self.stolen_cycles = 0  # pending cycles acquired via steals
        self.empty_drains = 0   # drain calls that found nothing (idleness)
        self._in_drain = False  # fence for fail_host (plain GIL-atomic bool)

    # flight-recorder attachment (repro_torch.obs); steals are rare control
    # events, recorded unconditionally when a hub is attached
    _obs = None

    # ---- Scheduler facade -------------------------------------------------
    @property
    def classes(self) -> List[ClassView]:
        return self.views

    def _offered(self) -> List[ClassView]:
        """Views offered to the policy / scans: all of them, or — with the
        fabric's active tracking on — only classes that currently hold
        work (the mark-after-enqueue invariant makes the filter safe; a
        racing producer's class shows up by the next call)."""
        act = self.scheduler.active
        if act is None:
            return self.views
        return [self.by_name[n] for n in act.names()]

    @property
    def default_class(self) -> str:
        return self.scheduler.default_class

    def submit(self, qclass: str, payload: Any) -> Optional[Envelope]:
        return self.scheduler.submit(qclass, payload)

    def submit_many(self, qclass: str, payloads: Sequence[Any]
                    ) -> List[Optional[Envelope]]:
        return self.scheduler.submit_many(qclass, payloads)

    def drain(self, k: int) -> List[Tuple[ClassView, Envelope]]:
        # Raise the activity flag BEFORE the liveness check (and lower it
        # after): fail_host sets ``alive`` False and then waits for the
        # flag, so any drain that saw ``alive`` True is waited out and any
        # drain that starts after the wait sees ``alive`` False — no
        # window where recovery and a dying drain touch the same state.
        self._in_drain = True
        try:
            if not self.alive:
                return []
            got = self.policy.drain(self._offered(), k)
        finally:
            self._in_drain = False
        if not got:
            self.empty_drains += 1
        return got

    def pending(self) -> int:
        return sum(v.pending() for v in self._offered()) + self.policy.held()

    def snapshot(self, *, active_only: bool = False) -> dict:
        views = self._offered() if active_only else self.views
        return {v.name: v.snapshot() for v in views}

    # ---- stealing ---------------------------------------------------------
    def steal_if_starved(self) -> int:
        """Starvation rebalance: when this replica has nothing pending,
        claim the seat with the deepest remaining cycle-run from the most
        loaded peer — one claim RPC through the transport, nothing else.
        Returns the number of pending cycles acquired (0 when not starved,
        nothing worth stealing, or the claim failed — CAS race or a
        dropped message, all fine, try again next step)."""
        # Same fence discipline as drain(): a steal by a replica whose
        # host is being failed must either complete before recovery
        # reassigns seats (the wait covers it) or observe alive=False and
        # claim nothing — otherwise a dying thief could CAS a seat back to
        # a dead owner after reassignment and strand the run.
        self._in_drain = True
        try:
            if not self.alive or self.pending() > 0:
                return 0
            return self._steal_best()
        finally:
            self._in_drain = False

    def _steal_best(self) -> int:
        """Pick the victim seat by *unclaimed shard depth* (the domain
        counters: ``cycle − deque_cycle``), not by cursor arithmetic: depth
        counts only items physically claimable from the queue, so a seat
        whose backlog is staged inside a busy peer (claimed, awaiting its
        turn) is never chosen — stealing it would buy nothing until the
        peer republishes, and near a wave's tail that hostage-chasing
        degenerates into seat ping-pong.

        Concurrently starved thieves must also not converge on the single
        deepest seat (they would steal it from each other faster than any
        of them drains it — a thundering herd that starves everyone), so
        each thief indexes into the depth-ranked candidates by its replica
        id: distinct thieves disperse across distinct runs with no shared
        scan state."""
        cands = []
        for v in self._offered():
            for s, seat in enumerate(v.seats):
                owner = seat.owner.load()
                if owner == self.addr:
                    continue
                depth = v.qclass.shards.depth(s)
                if depth >= self.min_steal:
                    cands.append((depth, id(v), v, s))
        if not cands:
            return 0
        cands.sort(key=lambda c: -c[0])
        depth, _, v, s = cands[self.rid % len(cands)]
        if self.transport.claim_seat(v.name, s, self.addr):
            self.steals += 1
            self.stolen_cycles += v._remaining(s)
            rec = self._obs
            if rec is not None:
                rec.emit("steal", v.name, -1,
                         arg={"shard": s, "depth": depth})
            return depth
        return 0


class ReplicaSet:
    """N coordination-free scheduler replicas over one class fabric, spread
    across the transport's hosts.

    Seat ownership starts round-robin (replica ``s % R`` owns shard ``s`` of
    every class — which, under the sim transport's round-robin host layout,
    home-aligns every seat with its shard's host); from then on ownership
    evolves purely through claim RPCs. The set is also the checkpoint
    boundary: :meth:`state` captures an exact-seat frontier snapshot of
    every class — call it between replica steps (or quiesced) and hand the
    plain dict to an async writer.
    """

    def __init__(self, scheduler: Scheduler, num_replicas: int, *,
                 policy="strict", min_steal: int = 2,
                 transport: Optional[Transport] = None):
        assert num_replicas >= 1
        self.scheduler = scheduler
        self.num_replicas = int(num_replicas)
        self.transport = transport if transport is not None \
            else LocalTransport()
        self._policy_spec = policy
        self.min_steal = int(min_steal)
        self.resizes = 0
        self.host_failures = 0
        self._retire_tick = 0
        # per-class roll-up of retired replicas' stats (resize survivors)
        self._retired: Dict[str, dict] = {}
        self.seats: Dict[str, List[ShardSeat]] = {}
        for qc in scheduler.classes:
            S = len(qc.shards)
            assert S >= num_replicas, (
                f"class {qc.name!r} has {S} shards; needs >= {num_replicas} "
                f"(one seat per replica)")
            self.seats[qc.name] = [
                ShardSeat(self.transport.addr_of(s % num_replicas), s)
                for s in range(S)]
        self.transport.bind(scheduler, self.seats)
        self.replicas = self._build_replicas(self.num_replicas)

    def _build_replicas(self, n: int) -> List[SchedulerReplica]:
        return [
            SchedulerReplica(rid, self.scheduler, self.seats,
                             policy=self._policy_spec,
                             min_steal=self.min_steal,
                             transport=self.transport)
            for rid in range(n)]

    def submit(self, qclass: str, payload: Any) -> Optional[Envelope]:
        return self.scheduler.submit(qclass, payload)

    def submit_many(self, qclass: str, payloads: Sequence[Any]
                    ) -> List[Optional[Envelope]]:
        return self.scheduler.submit_many(qclass, payloads)

    def pending(self) -> int:
        return sum(r.pending() for r in self.replicas)

    def rebalance(self) -> int:
        """One steal pass: every starved live replica claims one deep run.
        With active tracking on, the same pass retires drained-empty
        classes from the active set (a class is only fabric-empty when
        every replica's view of it is empty — no single drain loop can
        decide that, so the sweep lives here at the set level)."""
        self._retire_tick += 1
        if self._retire_tick % _RETIRE_EVERY == 0:
            self._retire_idle()
        return sum(r.steal_if_starved() for r in self.replicas if r.alive)

    def _retire_idle(self) -> None:
        # O(active x replicas) pending() probes — correct every step, but
        # retirement is purely an optimization (a stale active entry costs
        # one empty policy visit), so the sweep runs every _RETIRE_EVERY
        # rebalances instead of all of them.
        act = self.scheduler.active
        if act is None:
            return
        for name in act.names():
            if all(r.by_name[name].pending() == 0 for r in self.replicas):
                act.discard(name)

    def live_replicas(self) -> List[SchedulerReplica]:
        return [r for r in self.replicas if r.alive]

    # ---- replica-local state handoff (resize + host recovery) -------------
    def _gather_local(self, replicas: Sequence[SchedulerReplica]
                      ) -> Dict[str, List[Envelope]]:
        """Strip the given replicas of their local state: requeued and
        policy-held envelopes (seats already spent — they must ride to a
        new owner) are returned per class; staged claims (seat not yet
        reached) are republished into their home shard — the new owner's
        cursor, not queue position, drives delivery, so a tail republish is
        order-safe (the same move a steal victim makes in
        :meth:`ClassView._release_lost`). Each replica's counters retire
        into the per-class roll-up so fabric-wide stats survive."""
        carried: Dict[str, List[Envelope]] = {
            qc.name: [] for qc in self.scheduler.classes}
        for r in replicas:
            for view, env in r.policy.take_held():
                carried[view.name].append(env)
            for v in r.views:
                carried[v.name].extend(v._requeue)
                v._requeue = []
                with v._handoff_lock:  # relocated but not yet absorbed
                    carried[v.name].extend(v._handoff)
                    v._handoff = []
                by_shard: Dict[int, List[Envelope]] = {}
                for env in sorted(v._stage.values()):
                    by_shard.setdefault(env.seq % len(v.seats),
                                        []).append(env)
                for s, envs in by_shard.items():
                    self.transport.publish(v.name, s, envs, r.addr)
                v._stage.clear()
                # retire the view's counters into the per-class roll-up so
                # fabric-wide stats (and the SLO view) survive
                snaps = [v.stats.snapshot(pending=0, shard_depths=[])]
                if v.name in self._retired:
                    snaps.append(self._retired[v.name])
                self._retired[v.name] = aggregate_class_snapshots(snaps)
        return carried

    def _reinject(self, carried: Dict[str, List[Envelope]]) -> None:
        """Hand carried (seat-spent) envelopes to their seats' current
        owners through the thread-safe handoff inbox (the owner's drain
        loop may be running concurrently during host recovery; its heap is
        only ever touched by its own thread). A relocation, not a
        preemption — the requeued telemetry is not inflated."""
        for name, envs in carried.items():
            seats = self.seats[name]
            for env in sorted(envs):
                rid = seats[env.seq % len(seats)].owner.load().rid
                self.replicas[rid].by_name[name].handoff(env)

    # ---- live elasticity --------------------------------------------------
    def resize(self, num_replicas: int) -> int:
        """Grow/shrink to ``num_replicas`` drain loops over the same fabric:
        a batch of seat claims plus replica-local state handoff — producers
        are never paused, and every class keeps its exact delivery order.

        Mechanics (call from the drain control thread, i.e. between drain
        rounds — producers may keep submitting concurrently): every
        replica's local state is gathered (:meth:`_gather_local`), seat
        ownership is re-claimed round-robin over the *live-host* replicas
        (seat ``s`` -> the s-th live replica, one CAS per moving seat;
        ``next_seat`` cursors are untouched, so delivery resumes at the
        exact frontier), and carried envelopes land on the new owners.

        Returns the number of seats that changed owner.
        """
        new_n = int(num_replicas)
        assert new_n >= 1
        if new_n == self.num_replicas:
            return 0
        for qc in self.scheduler.classes:
            assert len(qc.shards) >= new_n, (
                f"class {qc.name!r} has {len(qc.shards)} shards; resize to "
                f"{new_n} replicas needs one seat per replica")
        self.transport.quiesce()  # delayed in-flight envelopes re-shard
        carried = self._gather_local(self.replicas)
        self.num_replicas = new_n
        self.replicas = self._build_replicas(new_n)
        live = [r.addr for r in self.replicas if r.alive]
        assert live, "resize with every host dead"
        # One reseat batch for the whole sweep: in-process transports CAS
        # the seat cells directly; the wire transport coalesces each host's
        # slice into one batched claim frame.
        moved = self.transport.reseat(
            [(name, s, live[s % len(live)])
             for name, seats in self.seats.items()
             for s in range(len(seats))])
        self._reinject(carried)
        self.resizes += 1
        return moved

    # ---- host failure recovery --------------------------------------------
    def fail_host(self, host: int) -> int:
        """Kill one transport host mid-run and recover its seats into the
        survivors. The dead host's drain loops stop (``alive`` goes False);
        its final frontier state — requeued seats, policy-held heads,
        staged claims — is serialized through the wire codec (the frontier
        checkpoint format, DESIGN.md §9/§11) and replayed into the
        surviving owners; its seats are re-claimed round-robin across the
        survivors. Per-class delivery order is preserved exactly: spent
        seats ride as requeues, unreached seats republish to their home
        shards, cursors are untouched.

        In deployment the replay source is the host's latest frontier
        snapshot; in the sim it is the host's in-process state — the bytes
        are identical, which is the point. Returns the number of seats
        reassigned.
        """
        dead = [r for r in self.replicas
                if r.alive and r.addr.host == host]
        assert dead, f"no live replicas on host {host}"
        survivors = [r for r in self.replicas
                     if r.alive and r.addr.host != host]
        assert survivors, "cannot fail the last live host"
        # Fence: kill the dead replicas' drain/steal loops BEFORE touching
        # their local state. Both drain() and steal_if_starved() raise
        # ``_in_drain`` before checking ``alive``, so after this wait no
        # dead replica can deliver an envelope this recovery republishes
        # (delivered twice) or CAS a seat back to a dead owner after the
        # reassignment below (stranded run).
        for r in dead:
            r.alive = False
        while any(r._in_drain for r in dead):
            cpu_pause()
        self.transport.fail_host(host)  # marks dead, flushes in-flight
        carried = self._gather_local(dead)
        # The recovery replay rides the wire: encode -> bytes -> decode,
        # preserving submit stamps (same monotonic clock in the sim).
        for name, envs in carried.items():
            if not envs:
                continue
            stamps = [e.t_submit for e in sorted(envs)]
            carried[name] = wire_decode(
                wire_encode(envs, self.transport._encode),
                self.transport._decode, t_submit=stamps)
        # Reassign the dead host's seats round-robin over the survivors —
        # recovery is control-plane: a reseat batch, not chaos-lossy RPCs,
        # conditional on the owner still being the dead host (a concurrent
        # steal that got there first wins). One cycle shared across ALL
        # classes: restarting it per class would hand every class's dead
        # seat to the same survivor and concentrate the dead host's whole
        # backlog on one replica.
        tgt = itertools.cycle(survivors)
        assignments = []
        for name, seats in self.seats.items():
            for s, seat in enumerate(seats):
                if seat.owner.load().host == host:
                    assignments.append((name, s, next(tgt).addr))
        moved = self.transport.reseat(assignments, expect_host=host)
        self._reinject(carried)
        self.host_failures += 1
        return moved

    def snapshot(self, *, active_only: bool = False) -> dict:
        out: dict = {"replicas": {}, "classes": {},
                     "transport": self.transport.stats()}
        for r in self.replicas:
            out["replicas"][r.rid] = {
                "host": r.addr.host, "alive": r.alive,
                "steals": r.steals, "stolen_cycles": r.stolen_cycles,
                "empty_drains": r.empty_drains, "pending": r.pending(),
                "classes": r.snapshot(active_only=active_only),
            }
        act = self.scheduler.active
        if active_only and act is not None:
            classes = [self.scheduler.by_name[n] for n in act.names()]
        else:
            classes = self.scheduler.classes
        for qc in classes:
            snaps = [r.by_name[qc.name].snapshot() for r in self.replicas]
            if qc.name in self._retired:  # counters from pre-resize replicas
                snaps.append(self._retired[qc.name])
            agg = aggregate_class_snapshots(snaps)
            # submit-side counters live on the class, not the views
            agg["submitted"] = qc.stats.submitted
            agg["rejected"] = qc.stats.rejected
            out["classes"][qc.name] = agg
        return out

    # ---- checkpoint -------------------------------------------------------
    def state(self, *, encode=None) -> dict:
        """Exact-seat frontier snapshot of the whole fabric: per class the
        cycle counter, per-seat cursors/owners (owners as host-addressed
        ``[host, rid]`` pairs), and every undelivered envelope (in-flight
        transport envelopes are quiesced back first; shard leftovers are
        claimed, recorded, and republished in place — the snapshot consumes
        nothing). Take it at a step boundary (no replica mid-drain); the
        returned dict is plain data for an async writer. Restoring resumes
        every tenant at its exact seat — under any transport/host layout,
        because owners are recorded by replica and re-addressed on
        restore."""
        self.transport.quiesce()
        out = {"num_replicas": self.num_replicas,
               "stamp": self.scheduler._stamp.load(),
               "transport": self.transport.spec(),
               "classes": {}}
        for qc in self.scheduler.classes:
            seats = self.seats[qc.name]
            S = len(qc.shards)
            seq = qc._seq.load()
            # every undelivered seat the cursors say exists must be captured
            expected = sum(
                (seq - seat.next_seat.load() + S - 1) // S
                for seat in seats if seat.next_seat.load() < seq)
            claimed: List[Envelope] = []
            staged: List[Envelope] = []
            requeue: List[Envelope] = []
            for r in self.replicas:
                v = r.by_name[qc.name]
                staged.extend(v._stage.values())
                requeue.extend(v._requeue)
                requeue.extend(v._handoff)  # relocated, not yet absorbed
                # envelopes buffered inside the policy (e.g. a fifo-merge
                # head pulled but not yet emitted): their seat cursor has
                # already advanced, so they checkpoint as requeued seats
                requeue.extend(env for view, env in r.policy.held_items()
                               if view.name == qc.name)
            # Claim-accumulate until the cursors' count is covered: a seat
            # can be momentarily invisible while a producer sits between
            # its stamp fetch-add and its shard splice — same bounded-spin
            # head-of-line contract as QueueClass._capture_pending; an
            # uncaptured seat is reported in ``gaps``, never silent.
            spins = 0
            while True:
                got_any = False
                for q in qc.shards.queues:
                    while True:
                        got = q.dequeue_many(64)
                        if not got:
                            break
                        claimed.extend(got)
                        got_any = True
                if len(claimed) + len(staged) >= expected:
                    break
                if not got_any:
                    spins += 1
                    if spins > _GAP_PATIENCE:
                        break
                    cpu_pause()
            for env in claimed:  # republish in place: snapshot, not drain
                qc.shards.queues[env.seq % S].enqueue(env)
            pending = claimed + staged
            out["classes"][qc.name] = {
                **qc._meta_state(),
                "owners": [list(s.owner.load()) for s in seats],
                "next_seats": [s.next_seat.load() for s in seats],
                "frontier": min((s.next_seat.load() for s in seats),
                                default=0),
                "gaps": max(0, expected - len(pending)),
                "pending": encode_envelopes(pending, encode),
                "requeue": encode_envelopes(requeue, encode),
            }
        return out

    @classmethod
    def from_state(cls, state: dict, *, decode=None, policy="strict",
                   min_steal: int = 2,
                   transport: Optional[Transport] = None,
                   **queue_kw) -> "ReplicaSet":
        """Rebuild the fabric at the checkpointed seats: cycle counters,
        seat cursors and ownership resume exactly; undelivered envelopes
        re-enter their home shard (``seq % S``); requeued seats land on the
        replica owning their home seat. Owners are recorded by replica id
        and re-addressed through the *restoring* transport, so a snapshot
        taken under one host layout (e.g. ``LocalTransport``) restores onto
        another (e.g. a multi-host ``SimHostTransport``) — the host half of
        the address is derived, the seat protocol state is what transfers.
        Continuing delivers every tenant's remaining items from its exact
        FIFO seat — nothing lost, nothing reordered within a run."""
        classes = []
        for name, cs in state["classes"].items():
            qc = QueueClass._from_meta(cs, **queue_kw)
            # keep the Scheduler facade's counters coherent too: its
            # pending() is frontier-based (under replica management the
            # authoritative emptiness check is ReplicaSet.pending(), which
            # reads the live seat cursors)
            qc._frontier = cs["frontier"]
            if qc.admit_window is not None:
                # undelivered (pending) items still hold window seats;
                # requeued ones freed theirs at first delivery
                qc._inflight.store(len(cs["pending"]))
            classes.append(qc)
        sched = Scheduler(classes, policy=policy)
        sched._stamp.store(state["stamp"])
        rs = cls(sched, state["num_replicas"], policy=policy,
                 min_steal=min_steal, transport=transport)
        now = time.monotonic()
        for name, cs in state["classes"].items():
            qc = sched.by_name[name]
            S = len(qc.shards)
            seats = rs.seats[name]
            assignments = []
            for s, (owner, nxt) in enumerate(zip(cs["owners"],
                                                 cs["next_seats"])):
                _, rid = decode_owner(owner)
                assignments.append((name, s, rs.transport.addr_of(rid)))
                seats[s].next_seat.store(int(nxt))
            # restore is a reseat sweep like resize: in-process transports
            # CAS the cells; the wire transport also updates the spawned
            # fleet's authoritative seat tables
            rs.transport.reseat(assignments)
            for rec in cs["pending"]:
                env = decode_envelope(rec, decode, now=now)
                qc.shards.queues[env.seq % S].enqueue(env)
            for rec in cs["requeue"]:
                env = decode_envelope(rec, decode, now=now)
                rid = seats[env.seq % S].owner.load().rid
                rs.replicas[rid].by_name[name].requeue(env)
        return rs
