"""Pluggable seat-protocol transport: host-addressed ownership over one
class fabric (DESIGN.md §11).

Seat ownership is a CAS-published cell, and the
exact-seat frontier snapshot *is* the whole cross-host protocol: a steal is
one ownership claim, a drain is a gather of staged envelopes, and the
checkpoint encoding (``[seq, stamp, payload]`` records + per-seat cursors)
is already the wire format. This module cashes that observation in. Seat
owners become **host-addressed** — :class:`HostAddr` ``(host, rid)`` instead
of a bare replica index — and every cross-owner operation of the replica
layer goes through a :class:`Transport`:

  * ``fetch``      — gather staged envelopes from a shard (the drain claim);
  * ``publish``    — republish envelopes into their home shard (the
    steal-victim / resize / recovery move);
  * ``claim_seat`` — the one ownership-claim RPC that a steal is.

Two transports ship:

  * :class:`LocalTransport` — one host, in-process, zero-copy. Exactly
    today's behavior: every call degenerates to the direct ``dequeue_many``
    / ``enqueue_many`` / owner-CAS it replaced, no serialization anywhere.
  * :class:`SimHostTransport` — N simulated hosts in one process. Replicas
    and shard queues are partitioned round-robin across hosts
    (``host_of(rid) = rid % H``, ``shard_home(s) = s % H``, so the default
    seat layout is *home-aligned*: cross-host messages are exactly the
    coordination-free operations — steals, republishes, recovery). Every
    cross-host envelope is serialized through the wire codec (a JSON round
    trip of the checkpoint record format) and the chaos knobs inject
    message **drop** (a lost request: fetch returns empty, a claim fails —
    both retried by the caller's next round, no state consumed), **delay**
    (claimed envelopes park in an in-flight buffer and arrive on a later
    fetch) and **reorder** (a fetched batch is shuffled — order-safe by
    construction, because the seat cursor, not arrival order, drives
    delivery). ``fail_host`` kills a host's drain loops mid-run.

Why drops can never lose an item: chaos is only ever applied *before* state
changes hands (a dropped fetch claims nothing; a dropped claim CASes
nothing) or to messages that are retried-until-acked (``publish`` counts a
retransmit instead of dropping — a republish carries claimed envelopes, so
at-least-once delivery with an idempotent apply is the only sound model).
Delayed envelopes live in the transport's in-flight buffer and are flushed
back into their home shards by :meth:`Transport.quiesce` (checkpoints) and
:meth:`Transport.fail_host` (recovery), so the exact-seat acceptance holds
under any chaos setting.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from repro_torch.sched.classes import (Envelope, decode_envelope, encode_envelopes)


class HostAddr(NamedTuple):
    """A host-addressed seat owner: which simulated host, which replica.

    ``rid`` stays globally unique (the index into ``ReplicaSet.replicas``);
    ``host`` is where that replica's drain loop runs. The pair is what the
    seat cell CAS-publishes — equality-comparable, JSON-encodable as
    ``[host, rid]``, and exactly the granularity a cross-host steal claims.
    """

    host: int
    rid: int

    def __repr__(self) -> str:  # telemetry-friendly
        return f"h{self.host}r{self.rid}"


def decode_owner(rec) -> Tuple[int, int]:
    """Wire/JSON -> ``(host, rid)``. Accepts the older format (a bare
    replica index, implicitly single-host) so pre-transport frontier
    snapshots restore under any transport."""
    if isinstance(rec, int):
        return (0, rec)
    host, rid = rec
    return (int(host), int(rid))


def wire_encode(envs: List[Envelope], encode=None) -> str:
    """Envelope batch -> wire bytes: a JSON array of the checkpoint record
    format ``[seq, stamp, payload]`` (DESIGN.md §9 — the frontier snapshot
    encoding IS the wire format; sharing :func:`encode_envelopes` makes
    that a fact, not a convention)."""
    return json.dumps(encode_envelopes(envs, encode))


def wire_decode(blob: str, decode=None, *,
                t_submit: Optional[List[float]] = None) -> List[Envelope]:
    """Wire bytes -> envelopes. ``t_submit`` (optional, parallel to the
    records) preserves the originals' submit stamps so a same-process hop
    does not fake the admission-latency telemetry."""
    recs = json.loads(blob)
    out = []
    for i, rec in enumerate(recs):
        now = t_submit[i] if t_submit is not None else None
        out.append(decode_envelope(rec, decode, now=now))
    return out


class Transport:
    """The seat-protocol message layer (ABC).

    A transport is bound once to a fabric (``bind``) and then mediates the
    three cross-owner operations of the replica layer. Implementations
    decide what "cross-host" means; callers never branch on it — the
    replica/steal/fabric code is transport-agnostic.
    """

    kind = "abstract"
    num_hosts = 1
    _encode = None  # payload -> JSON-able (wire/codec hook)
    _decode = None  # JSON-able -> payload
    # metrics-plane attachment (repro_torch.obs.MetricsHub): when set, remote
    # operations report their round-trip time via ``_obs.record_rtt``
    _obs = None

    def bind(self, scheduler, seats: Dict[str, List]) -> None:
        """Attach to the fabric state (class queues + seat cells)."""
        self._sched = scheduler
        self._seats = seats

    # ---- addressing -------------------------------------------------------
    def host_of(self, rid: int) -> int:
        raise NotImplementedError

    def addr_of(self, rid: int) -> HostAddr:
        return HostAddr(self.host_of(rid), int(rid))

    def alive(self, host: int) -> bool:
        return True

    def live_hosts(self) -> List[int]:
        return [h for h in range(self.num_hosts) if self.alive(h)]

    # ---- the three seat-protocol operations -------------------------------
    def fetch(self, cls_name: str, shard: int, k: int,
              addr: HostAddr) -> List[Envelope]:
        """Gather up to ``k`` staged envelopes from one shard (the drain
        claim). May return short or empty under chaos — the caller's drain
        loop already retries, so a lost request costs latency, never
        items."""
        raise NotImplementedError

    def publish(self, cls_name: str, shard: int, envs: List[Envelope],
                addr: HostAddr) -> int:
        """Republish envelopes into their home shard (steal-victim /
        resize / recovery move). Reliable: retried-until-acked, because a
        republish carries already-claimed envelopes."""
        raise NotImplementedError

    def claim_seat(self, cls_name: str, shard: int, addr: HostAddr) -> bool:
        """The ownership-claim RPC a steal is: one CAS on the seat cell.
        False when the CAS lost a race, the claimant already owns the seat,
        or chaos dropped the request — all retried next round."""
        raise NotImplementedError

    def reseat(self, assignments, *, expect_host: Optional[int] = None
               ) -> int:
        """Apply a batch of seat reassignments — the control-plane move
        that resize / recovery / restore make, distinct from a steal's
        single racing claim. ``assignments`` is an iterable of
        ``(cls_name, shard, HostAddr)``; with ``expect_host`` set, a seat
        is only moved while its current owner lives on that host (the
        conditional recovery sweep — a racing steal wins). Returns the
        number of seats actually moved.

        The default is the direct CAS loop over the bound seat cells that
        the in-process transports share; distributed transports override
        it to coalesce each destination host's slice into one batched
        claim frame."""
        moved = 0
        for cls_name, shard, target in assignments:
            seat = self._seats[cls_name][shard]
            cur = seat.owner.load()
            while True:
                if cur == target:
                    break
                if expect_host is not None and cur.host != expect_host:
                    break  # a concurrent steal already moved this seat
                if seat.owner.cas(cur, target):
                    moved += 1
                    break
                cur = seat.owner.load()
        return moved

    # ---- lifecycle --------------------------------------------------------
    def quiesce(self) -> int:
        """Flush any in-flight (delayed) envelopes back into their home
        shards so a step-boundary checkpoint captures every seat. Returns
        the number flushed."""
        return 0

    def fail_host(self, host: int) -> int:
        """Mark a host dead and flush its in-flight envelopes back into the
        fabric. Data-plane only — seat reassignment is the ReplicaSet's
        recovery move (:meth:`repro_torch.sched.ReplicaSet.fail_host`)."""
        raise NotImplementedError(f"{self.kind} transport cannot fail hosts")

    def add_host(self) -> int:
        """Grow the host fleet by one; returns the new host count.
        Data-plane only — replicas spread onto the new host at the next
        reseat (``ReplicaSet.resize`` recomputes ``addr_of(rid)``)."""
        raise NotImplementedError(
            f"{self.kind} transport cannot add hosts (single-host by "
            f"definition — use transport='sim')")

    def stats(self) -> dict:
        raise NotImplementedError

    def spec(self) -> dict:
        """JSON-able description (rides frontier snapshots as metadata)."""
        return {"kind": self.kind, "hosts": self.num_hosts}


class LocalTransport(Transport):
    """One host, in-process, zero-copy — today's behavior, now behind the
    transport seam. Every operation is the direct call it replaced; the
    only bookkeeping is a pair of counters so ``stats()`` stays uniform."""

    kind = "local"
    num_hosts = 1

    def __init__(self):
        self._lock = threading.Lock()
        self.fetches = 0
        self.publishes = 0

    def host_of(self, rid: int) -> int:
        return 0

    def fetch(self, cls_name, shard, k, addr):
        # Hot-path counter: plain += on purpose — approximate under
        # concurrent drains, exact when quiesced (the repo's telemetry
        # contract, see sched/stats.py); a lock here would serialize every
        # frontier probe of every replica.
        self.fetches += 1
        return self._sched.by_name[cls_name].shards.queues[shard].dequeue_many(k)

    def publish(self, cls_name, shard, envs, addr):
        if envs:
            with self._lock:
                self.publishes += 1
            self._sched.by_name[cls_name].shards.queues[shard].enqueue_many(
                list(envs))
        return len(envs)

    def claim_seat(self, cls_name, shard, addr):
        from repro_torch.sched.steal import claim_seat
        return claim_seat(self._seats[cls_name][shard], addr)

    def stats(self) -> dict:
        return {"kind": self.kind, "hosts": 1, "dead_hosts": [],
                "fetches": self.fetches, "publishes": self.publishes,
                "remote_msgs": 0, "remote_bytes": 0, "drops": 0,
                "delayed": 0, "reordered": 0, "retransmits": 0,
                "remote_claims": 0}


class SimHostTransport(Transport):
    """N simulated hosts over one in-process fabric, with a serialized wire
    and injectable chaos (see module docstring for the loss model).

    The CMP shard queues are the durable substrate: host loss kills drain
    loops and their staged claims, not enqueued items — in deployment the
    lost host's latest frontier snapshot (byte-identical to these wire
    records) is replayed by the recovering owners, which is exactly what
    :meth:`repro_torch.sched.ReplicaSet.fail_host` does through this codec.
    """

    kind = "sim"

    def __init__(self, num_hosts: int, *, drop: float = 0.0,
                 reorder: bool = False, delay: float = 0.0, seed: int = 0,
                 rtt: float = 0.0, encode=None, decode=None):
        assert num_hosts >= 1
        assert 0.0 <= drop < 1.0, f"drop={drop} must be in [0, 1)"
        assert 0.0 <= delay < 1.0, f"delay={delay} must be in [0, 1)"
        assert rtt >= 0.0, f"rtt={rtt} must be >= 0"
        self.num_hosts = int(num_hosts)
        self.drop = float(drop)
        self.delay = float(delay)
        # Deterministic injected round-trip time (seconds) charged to every
        # seat-protocol op — fetch, publish, claim — modelling a driver
        # that is network-separated from the whole host fleet (the wire
        # transport's topology, where even a home-shard op crosses a
        # socket). rtt=0 (the default) is exactly the pre-knob behavior;
        # rtt>0 is the wire bench's sim-at-RTT baseline.
        self.rtt = float(rtt)
        self.reorder = bool(reorder)
        self._encode = encode
        self._decode = decode
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._dead: set = set()
        # claimed-but-delayed envelopes, keyed by (class, shard): they were
        # dequeued from the fabric and are in flight on the wire — flushed
        # by quiesce()/fail_host() so checkpoints and recovery see them
        self._inflight: Dict[Tuple[str, int], List[Envelope]] = {}
        self.remote_msgs = 0
        self.remote_bytes = 0
        self.local_fetches = 0
        self.publishes = 0
        self.drops = 0
        self.delayed = 0
        self.reordered = 0
        self.retransmits = 0
        self.remote_claims = 0

    # ---- addressing -------------------------------------------------------
    def host_of(self, rid: int) -> int:
        return int(rid) % self.num_hosts

    def shard_home(self, shard: int) -> int:
        return int(shard) % self.num_hosts

    def alive(self, host: int) -> bool:
        return host not in self._dead

    # ---- chaos + wire -----------------------------------------------------
    def _rtt(self, addr, t0: float) -> None:
        """Report one remote operation's round-trip time to the attached
        metrics hub (no-op until a MetricsHub attaches)."""
        if self._obs is not None:
            self._obs.record_rtt(addr.host, time.perf_counter() - t0)

    def _roll(self, p: float) -> bool:
        if p <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < p

    def _pay_rtt(self) -> None:
        """Charge one injected round trip (no-op at the rtt=0 default)."""
        if self.rtt > 0.0:
            time.sleep(self.rtt)

    def _wire(self, envs: List[Envelope]) -> List[Envelope]:
        """One serialized hop: encode -> bytes -> decode. The originals'
        ``t_submit`` stamps ride along (same process, same monotonic clock)
        so admission-latency telemetry stays honest."""
        if not envs:
            return envs
        blob = wire_encode(envs, self._encode)
        with self._lock:
            self.remote_msgs += 1
            self.remote_bytes += len(blob)
        stamps = [e.t_submit for e in sorted(envs)]
        return wire_decode(blob, self._decode, t_submit=stamps)

    # ---- seat-protocol operations -----------------------------------------
    def fetch(self, cls_name, shard, k, addr):
        if addr.host in self._dead:
            return []  # a dead host's loops make no RPCs
        self._pay_rtt()
        q = self._sched.by_name[cls_name].shards.queues[shard]
        if self.shard_home(shard) == addr.host:
            # Home-host fetch: zero-copy, lock-free (the counter is the
            # approximate-when-racing hot-path kind) — except to reclaim
            # anything a previous remote owner left parked in flight for
            # this shard: a stolen-back seat must never strand delayed
            # envelopes. The unlocked peek is safe: entries are only added
            # under the lock, and a racy miss is reclaimed next fetch.
            self.local_fetches += 1
            parked: List[Envelope] = []
            if self._inflight:
                with self._lock:
                    parked = self._inflight.pop((cls_name, shard), [])
            return parked + q.dequeue_many(k)
        # remote: the request can be lost BEFORE anything is claimed
        t0 = time.perf_counter()
        if self._roll(self.drop):
            with self._lock:
                self.drops += 1
            self._rtt(addr, t0)
            return []
        with self._lock:
            parked = self._inflight.pop((cls_name, shard), [])
        fresh = q.dequeue_many(k)
        if fresh and self._roll(self.delay):
            # claimed but in flight: arrives on a later fetch (or a
            # quiesce/recovery flush) — never lost
            with self._lock:
                self.delayed += len(fresh)
                self._inflight.setdefault((cls_name, shard), []).extend(fresh)
            fresh = []
        out = self._wire(parked + fresh)
        if self.reorder and len(out) > 1:
            with self._lock:
                self._rng.shuffle(out)
                self.reordered += 1
        self._rtt(addr, t0)
        return out

    def publish(self, cls_name, shard, envs, addr):
        if not envs:
            return 0
        self._pay_rtt()
        envs = list(envs)
        remote = self.shard_home(shard) != addr.host
        t0 = time.perf_counter()
        if remote:
            if self._roll(self.drop):
                with self._lock:
                    self.retransmits += 1  # republish is retried-until-acked
            envs = self._wire(envs)
        with self._lock:
            self.publishes += 1
        self._sched.by_name[cls_name].shards.queues[shard].enqueue_many(envs)
        if remote:
            self._rtt(addr, t0)
        return len(envs)

    def claim_seat(self, cls_name, shard, addr):
        self._pay_rtt()
        seat = self._seats[cls_name][shard]
        remote = self.shard_home(shard) != addr.host
        t0 = time.perf_counter()
        if remote:
            with self._lock:
                self.remote_claims += 1
                self.remote_msgs += 1
                self.remote_bytes += 32  # fixed-size claim frame
            if self._roll(self.drop):
                with self._lock:
                    self.drops += 1
                self._rtt(addr, t0)
                return False
        from repro_torch.sched.steal import claim_seat
        ok = claim_seat(seat, addr)
        if remote:
            self._rtt(addr, t0)
        return ok

    # ---- lifecycle --------------------------------------------------------
    def _flush_inflight(self, keys=None) -> int:
        with self._lock:
            if keys is None:
                keys = list(self._inflight)
            flushed = {k: self._inflight.pop(k) for k in keys
                       if k in self._inflight}
        n = 0
        for (cls_name, shard), envs in flushed.items():
            self._sched.by_name[cls_name].shards.queues[shard].enqueue_many(
                envs)
            n += len(envs)
        return n

    def quiesce(self) -> int:
        return self._flush_inflight()

    def fail_host(self, host: int) -> int:
        assert 0 <= host < self.num_hosts
        live = [h for h in self.live_hosts() if h != host]
        assert live, "cannot fail the last live host"
        self._dead.add(host)
        # everything in flight is flushed back into the fabric: in-flight
        # envelopes are addressed to shards, not hosts, so none are lost
        return self._flush_inflight()

    def add_host(self) -> int:
        # Flush first: ``host_of``/``shard_home`` are modular in num_hosts,
        # so parked envelopes keyed under the old modulus must land in
        # their shards before the mapping shifts.
        self._flush_inflight()
        self.num_hosts += 1
        return self.num_hosts

    def stats(self) -> dict:
        return {"kind": self.kind, "hosts": self.num_hosts,
                "dead_hosts": sorted(self._dead),
                "fetches": self.local_fetches, "publishes": self.publishes,
                "remote_msgs": self.remote_msgs,
                "remote_bytes": self.remote_bytes,
                "drops": self.drops, "delayed": self.delayed,
                "reordered": self.reordered,
                "retransmits": self.retransmits,
                "remote_claims": self.remote_claims}

    def spec(self) -> dict:
        return {"kind": self.kind, "hosts": self.num_hosts,
                "drop": self.drop, "delay": self.delay,
                "reorder": self.reorder, "rtt_ms": self.rtt * 1e3}


def make_transport(kind: str, hosts: int = 1, *, drop: float = 0.0,
                   reorder: bool = False, delay: float = 0.0, seed: int = 0,
                   rtt_ms: float = 0.0, credit: int = 4,
                   encode=None, decode=None) -> Transport:
    """``"local"`` | ``"sim"`` | ``"wire"`` -> a transport instance (the
    FabricConfig / serve.py entry point)."""
    if kind == "local":
        assert hosts == 1, "local transport is single-host; use kind='sim'"
        return LocalTransport()
    if kind == "sim":
        return SimHostTransport(hosts, drop=drop, reorder=reorder,
                                delay=delay, seed=seed, rtt=rtt_ms / 1e3,
                                encode=encode, decode=decode)
    if kind == "wire":
        assert not reorder, ("wire transport cannot reorder: TCP delivers "
                             "per-connection in order; use kind='sim'")
        from repro_torch.net.wire import WireTransport  # lazy: avoids a cycle
        return WireTransport(hosts, drop=drop, delay=delay, rtt_ms=rtt_ms,
                             credit=credit, seed=seed, encode=encode,
                             decode=decode)
    raise ValueError(f"unknown transport kind {kind!r}; "
                     f"choose from ['local', 'sim', 'wire']")
