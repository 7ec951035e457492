"""Driver-side wire transport: the seat protocol over real sockets
(DESIGN.md §15).

:class:`WireTransport` implements the :class:`~repro_torch.sched.transport.Transport`
ABC over a fleet of **real OS processes**: ``bind`` spawns one
:mod:`repro_torch.net.server` worker per host, each owning the authoritative
CMP shard queues and seat table for the shards homed on it, and keeps one
persistent TCP connection (:class:`PeerClient`) per peer. The driver's
shard queues become :class:`ShardProxy` mirrors and its seat cells become
response-fed mirrors; every byte between them is a
:mod:`repro_torch.net.framing` frame whose body carries the existing
``wire_encode`` JSON codec — the frontier checkpoint format stays the wire
format.

What makes it fast (the RTT-amortization trio, per the paper's thesis that
coordination cost, not queue cost, dominates):

  * **fetch pipelining with prefetch credit** — each consumer keeps up to
    ``credit`` fetches in flight per home shard (mirroring
    ``DeviceAdmissionRing``'s claim look-ahead), so a hot drain loop pops
    locally-buffered envelopes while the next batches are already on the
    wire; ``credit=1`` degenerates to a synchronous fetch per round (the
    bench's comparison baseline). The buffer is keyed by shard, not owner,
    so a steal inherits the victim's prefetched batches exactly like the
    sim's in-flight reclaim.
  * **batched claim frames** — ``reseat`` coalesces a whole cycle-run of
    seat CASes (a resize or recovery's reassignment sweep) into one frame
    per destination host.
  * **piggybacked gauges** — every data-plane response carries the serving
    host's shard depths, so steal ranking reads fresh mirrors without
    dedicated polling.

Failure model (chaos-invariant exactness, same argument as the sim): a
dropped request is discarded by the server *before* any state changes, so
the client's timeout is exact — fetch expires to an empty round, claim
expires to ``False``, and ``publish`` (which carries claimed envelopes)
retransmits the **same request id** with exponential backoff until acked,
with server-side id dedupe making at-least-once delivery idempotent.
"""

from __future__ import annotations

import itertools
import json
import os
import select
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, Tuple

from repro_torch.core.atomics import AtomicCell
from repro_torch.net.framing import KIND_REQ, FrameDecoder, FrameError, pack_frame
from repro_torch.sched.transport import (HostAddr, Transport, wire_decode,
                                   wire_encode)


class WireError(RuntimeError):
    """A wire-transport failure the protocol cannot absorb: an unacked
    reliable op past its total deadline, a dead peer connection, or a
    server-side handler error."""


class PeerClient:
    """One persistent connection to one host server.

    A single reader thread demultiplexes responses by request id: sync
    requests park on an event, async fetches are handed to the transport's
    prefetch buffer. Reliable requests retransmit the *same* id on timeout
    (the server dedupes applied mutations), with exponential backoff.
    """

    def __init__(self, host: int, port: int, transport: "WireTransport"):
        self.host = int(host)
        self._transport = transport
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._sync: Dict[int, list] = {}    # id -> [event, response]
        self._fetch: Dict[int, tuple] = {}  # id -> (key, deadline, t0)
        self._dec = FrameDecoder()
        self.alive = True
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"wire-peer{host}-reader").start()

    # ------------------------------------------------------------- sending
    def _send(self, frame: bytes) -> None:
        if not self.alive:
            raise WireError(f"connection to host {self.host} is closed")
        try:
            with self._send_lock:
                self.sock.sendall(frame)
        except OSError as exc:
            self.alive = False
            raise WireError(
                f"send to host {self.host} failed: {exc}") from exc

    def request(self, body: dict, *, timeout: float, retry: bool = False,
                max_total: float = 30.0) -> Tuple[dict, int]:
        """Send one request and wait for its response. ``retry=True`` is
        the reliable (ack-before-done) mode: retransmit the same id with
        doubling timeouts until acked or ``max_total`` elapses. Returns
        ``(response_or_None, attempts)``."""
        rid = next(self._ids)
        body = dict(body)
        body["id"] = rid
        frame = pack_frame(KIND_REQ, body)
        ev = threading.Event()
        slot = [ev, None]
        with self._lock:
            self._sync[rid] = slot
        deadline = time.monotonic() + max_total
        wait = timeout
        attempts = 0
        try:
            while True:
                attempts += 1
                self._send(frame)
                if ev.wait(wait):
                    return slot[1], attempts
                if not retry or time.monotonic() >= deadline:
                    return None, attempts
                wait = min(wait * 2.0, 2.0)  # exponential backoff
        finally:
            with self._lock:
                self._sync.pop(rid, None)

    def fetch_async(self, body: dict, key: tuple, deadline: float) -> None:
        """Fire one pipelined fetch; its response (or expiry) is handled by
        the transport's prefetch state."""
        rid = next(self._ids)
        body["id"] = rid
        frame = pack_frame(KIND_REQ, body)
        with self._lock:
            self._fetch[rid] = (key, deadline, time.perf_counter())
        try:
            self._send(frame)
        except WireError:
            with self._lock:
                self._fetch.pop(rid, None)
            raise

    def expire_fetches(self, key: tuple, now: float) -> int:
        """Drop timed-out in-flight fetch entries for ``key`` (a dropped
        request claimed nothing server-side, so expiry is exact)."""
        with self._lock:
            dead = [r for r, (k, dl, _) in self._fetch.items()
                    if k == key and dl <= now]
            for r in dead:
                del self._fetch[r]
        return len(dead)

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ receiving
    def _read_loop(self) -> None:
        try:
            while True:
                data = self.sock.recv(65536)
                if not data:
                    break
                for _, body in self._dec.feed(data):
                    self._dispatch(body)
        except (OSError, FrameError):
            pass
        finally:
            self.alive = False
            with self._lock:
                slots = list(self._sync.values())
                self._sync.clear()
                fetches = list(self._fetch.values())
                self._fetch.clear()
            for slot in slots:
                slot[0].set()  # response stays None -> callers see a timeout
            if fetches:
                self._transport._abandon_fetches(
                    [ent[0] for ent in fetches])

    def _dispatch(self, body: dict) -> None:
        rid = body.get("id")
        ent = slot = None
        with self._lock:
            if rid is not None:
                ent = self._fetch.pop(rid, None)
                if ent is None:
                    slot = self._sync.pop(rid, None)
        if ent is not None:
            self._transport._on_fetch_response(self, ent, body,
                                               counted=True)
        elif slot is not None:
            slot[1] = body
            slot[0].set()
        elif body.get("op") == "fetch":
            # late response to an expired fetch: its envelopes were claimed
            # server-side, so park them — claimed-but-in-flight, never lost
            self._transport._on_fetch_response(self, None, body,
                                               counted=False)


class _PoolMirror:
    """Stand-in for ``CMPQueue.pool`` on a proxy: gauge mirror only."""

    __slots__ = ("allocated",)

    def __init__(self) -> None:
        self.allocated = 0


class ShardProxy:
    """Driver-side mirror of one host-resident CMP shard.

    Presents exactly the surface the driver-side fabric reads —
    ``cycle``/``deque_cycle`` cells (depth gauges + steal ranking),
    ``window``, ``pool.allocated``, ``stats`` and the enqueue/dequeue entry
    points — while the authoritative queue lives in the shard's home host
    process. Counter mirrors advance monotonically from response
    piggybacks; enqueue/dequeue are synchronous RPCs (the drain hot path
    does NOT come through here — it uses the transport's pipelined
    ``fetch``)."""

    # flight-recorder attachment points (MetricsHub.attach sets these)
    _obs = None
    _obs_cls = "?"

    def __init__(self, transport: "WireTransport", cls_name: str,
                 shard: int, window: int):
        self._transport = transport
        self.cls_name = cls_name
        self.shard = int(shard)
        self.window = window
        self.cycle = AtomicCell(0)
        self.deque_cycle = AtomicCell(0)
        self.pool = _PoolMirror()
        self.stats = {"enq_retries": 0, "deq_scans": 0, "reclaimed": 0,
                      "reclaim_passes": 0, "reclaim_contended": 0,
                      "rescued": 0}

    def enqueue(self, env) -> bool:
        return self.enqueue_many([env]) == 1

    def enqueue_many(self, envs) -> int:
        envs = list(envs)
        if not envs:
            return 0
        return self._transport._shard_enqueue(self.cls_name, self.shard,
                                              envs)

    def dequeue(self):
        got = self.dequeue_many(1)
        return got[0] if got else None

    def dequeue_many(self, k: int) -> list:
        return self._transport._shard_dequeue(self.cls_name, self.shard,
                                              int(k))


class WireTransport(Transport):
    """The seat protocol over TCP to per-host worker processes."""

    kind = "wire"

    def __init__(self, num_hosts: int, *, drop: float = 0.0,
                 delay: float = 0.0, rtt_ms: float = 0.0, credit: int = 4,
                 seed: int = 0, encode=None, decode=None,
                 fetch_timeout: float = 0.0):
        assert num_hosts >= 1
        assert 0.0 <= drop < 1.0, f"drop={drop} must be in [0, 1)"
        assert 0.0 <= delay < 1.0, f"delay={delay} must be in [0, 1)"
        assert credit >= 1, f"credit={credit} must be >= 1"
        self.num_hosts = int(num_hosts)
        self.drop = float(drop)
        self.delay = float(delay)
        self.rtt_ms = float(rtt_ms)
        self.credit = int(credit)
        self.seed = int(seed)
        self._encode = encode
        self._decode = decode
        rtt_s = self.rtt_ms / 1e3
        # Timeout calibration IS the failure model: injected RTT bounds the
        # response delay, so a client-side expiry implies the request was
        # dropped before processing (nothing claimed) — except for
        # publish/reseat, which retransmit the same id until acked.
        self.fetch_timeout = float(fetch_timeout) or max(
            0.25, 10.0 * rtt_s + 0.1)
        self.pub_timeout = max(0.1, 4.0 * rtt_s + 0.05)
        self.claim_timeout = max(0.15, 4.0 * rtt_s + 0.05)
        self.ctl_timeout = 10.0
        self.max_op_s = 30.0
        self._dead: set = set()
        self._closed = False
        self._procs: list = []
        self._peers: Dict[int, PeerClient] = {}
        # prefetch-credit state: per-(cls, shard) buffered envelopes +
        # in-flight fetch count + a hot/cold hint from the last response
        self._fcond = threading.Condition()
        self._buf: Dict[tuple, Deque] = {}
        self._outstanding: Dict[tuple, int] = {}
        self._hot: Dict[tuple, bool] = {}
        self._empty_tick: Dict[tuple, int] = {}
        self._depth_refresh_t = 0.0
        self._stats_cache: dict = {}
        self._stats_cache_t = 0.0
        # client-side counters (plain +=: the repo's approximate-when-racing
        # telemetry contract)
        self.fetches = 0
        self.publishes = 0
        self.remote_msgs = 0
        self.remote_bytes = 0
        self.retransmits = 0
        self.remote_claims = 0
        self.fetch_timeouts = 0

    # ---- addressing -------------------------------------------------------
    def host_of(self, rid: int) -> int:
        return int(rid) % self.num_hosts

    def shard_home(self, shard: int) -> int:
        return int(shard) % self.num_hosts

    def alive(self, host: int) -> bool:
        return host not in self._dead

    # ---- lifecycle: spawn + bind ------------------------------------------
    def bind(self, scheduler, seats) -> None:
        if self._procs:
            raise WireError("wire transport is already bound to a fleet")
        super().bind(scheduler, seats)
        self._spawn(scheduler, seats)
        # Swap every driver-side shard queue for a mirror proxy. Anything
        # already enqueued (producers cannot start before bind, but belt
        # and braces) is forwarded to its authoritative home.
        for qc in scheduler.classes:
            for s, q in enumerate(qc.shards.queues):
                proxy = ShardProxy(self, qc.name, s, window=q.window)
                leftovers: list = []
                while True:
                    got = q.dequeue_many(256)
                    if not got:
                        break
                    leftovers.extend(got)
                qc.shards.queues[s] = proxy
                if leftovers:
                    proxy.enqueue_many(leftovers)

    def _spawn(self, scheduler, seats) -> None:
        # Plain subprocesses running `python -m repro_torch.net.server` (spec on
        # stdin, `PORT <n>` on stdout) rather than multiprocessing spawn:
        # no re-import of the driver's __main__, no pickling — the spec
        # line IS the worker's whole world, which is also what keeps the
        # worker import graph accelerator-free.
        src_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        for h in range(self.num_hosts):
            spec = {
                "host": h,
                "num_hosts": self.num_hosts,
                "classes": [{"name": qc.name,
                             "num_shards": len(qc.shards),
                             "queue_kw": dict(qc._queue_kw)}
                            for qc in scheduler.classes],
                "owners": [[name, s, [seat.owner.load().host,
                                      seat.owner.load().rid]]
                           for name, cls_seats in seats.items()
                           for s, seat in enumerate(cls_seats)
                           if s % self.num_hosts == h],
                "chaos": {"drop": self.drop, "delay": self.delay,
                          "rtt_ms": self.rtt_ms,
                          "seed": self.seed + 1000 * h},
            }
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.net"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=env, text=True)
            proc.stdin.write(json.dumps(spec) + "\n")
            proc.stdin.flush()
            self._procs.append(proc)
        for h, proc in enumerate(self._procs):
            ready, _, _ = select.select([proc.stdout], [], [], 30.0)
            line = proc.stdout.readline() if ready else ""
            if not line.startswith("PORT "):
                self.close()
                raise WireError(
                    f"host worker {h} did not report a port within 30s "
                    f"(got {line!r}; exit={proc.poll()})")
            self._peers[h] = PeerClient(h, int(line.split()[1]), self)

    def close(self) -> None:
        """Shut the fleet down: one shutdown frame per worker, then wait
        (terminate/kill as a last resort — closing the worker's stdin is
        itself an exit signal). Idempotent."""
        if self._closed:
            return
        self._closed = True
        for peer in self._peers.values():
            try:
                peer.request({"op": "shutdown"}, timeout=2.0)
            except Exception:
                pass
            peer.close()
        for proc in self._procs:
            for stream in (proc.stdin, proc.stdout):
                try:
                    if stream:
                        stream.close()
                except OSError:
                    pass
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=2.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=2.0)

    # ---- mirror maintenance ----------------------------------------------
    def _rtt(self, host: int, dt: float) -> None:
        if self._obs is not None:
            self._obs.record_rtt(host, dt)

    def _bump(self, cls_name: str, shard: int, cycle=None,
              dcycle=None) -> None:
        """Advance a proxy's depth mirror monotonically (responses can
        overtake each other across the control/data planes; the counters
        themselves never regress)."""
        qc = self._sched.by_name.get(cls_name)
        if qc is None or shard >= len(qc.shards.queues):
            return
        q = qc.shards.queues[shard]
        if not isinstance(q, ShardProxy):
            return
        if cycle is not None and cycle > q.cycle.load():
            q.cycle.store(cycle)
        if dcycle is not None and dcycle > q.deque_cycle.load():
            q.deque_cycle.store(dcycle)

    def _apply_depths(self, body: dict) -> None:
        for rec in body.get("d") or ():
            name, s, cyc, dcyc = rec
            self._bump(name, int(s), cycle=cyc, dcycle=dcyc)

    def _store_owner(self, cls_name: str, shard: int, owner) -> None:
        if owner is None:
            return
        seats = self._seats.get(cls_name)
        if seats is None or shard >= len(seats):
            return
        seats[shard].owner.store(HostAddr(int(owner[0]), int(owner[1])))

    # ---- prefetch-credit fetch pipeline -----------------------------------
    def _on_fetch_response(self, peer: PeerClient, ent, body: dict,
                           counted: bool) -> None:
        """Reader-thread handler for one fetch response (pipelined or
        late). ``counted`` distinguishes a tracked in-flight entry (whose
        outstanding slot this response releases) from a late response whose
        entry already expired — the latter only parks envelopes."""
        if counted:
            key, _deadline, t0 = ent
            self._rtt(peer.host, time.perf_counter() - t0)
        else:
            key = (body.get("cls"), body.get("shard"))
        envs: list = []
        blob = body.get("envs")
        if blob:
            try:
                envs = wire_decode(blob, self._decode,
                                   t_submit=body.get("t"))
            except (ValueError, KeyError, TypeError):
                envs = []
            if envs:
                self.remote_bytes += len(blob)
        self._store_owner(key[0], key[1], body.get("owner"))
        self._apply_depths(body)
        with self._fcond:
            if counted:
                self._outstanding[key] = max(
                    0, self._outstanding.get(key, 0) - 1)
            if envs:
                self._buf.setdefault(key, deque()).extend(envs)
                self._hot[key] = True
            else:
                self._hot[key] = False
                self._empty_tick[key] = self._empty_tick.get(key, 0) + 1
            self._fcond.notify_all()

    def _abandon_fetches(self, keys) -> None:
        """A peer connection died with fetches in flight: release their
        outstanding slots so waiters stop blocking."""
        with self._fcond:
            for key in keys:
                self._outstanding[key] = max(
                    0, self._outstanding.get(key, 0) - 1)
            self._fcond.notify_all()

    def _issue(self, peer: PeerClient, key: tuple, k: int,
               addr: HostAddr) -> None:
        body = {"op": "fetch", "cls": key[0], "shard": key[1], "k": int(k),
                "addr": [int(addr.host), int(addr.rid)]}
        self.remote_msgs += 1
        try:
            peer.fetch_async(body, key,
                             time.monotonic() + self.fetch_timeout)
        except WireError:
            with self._fcond:
                self._outstanding[key] = max(
                    0, self._outstanding.get(key, 0) - 1)

    def fetch(self, cls_name, shard, k, addr):
        if self._closed or addr.host in self._dead:
            return []
        key = (cls_name, int(shard))
        peer = self._peers[self.shard_home(shard)]
        self.fetches += 1
        deadline = time.monotonic() + self.fetch_timeout
        to_issue = 0
        out: list = []
        with self._fcond:
            expired = peer.expire_fetches(key, time.monotonic())
            if expired:
                self._outstanding[key] = max(
                    0, self._outstanding.get(key, 0) - expired)
                self.fetch_timeouts += expired
            buf = self._buf.setdefault(key, deque())
            while buf and len(out) < k:
                out.append(buf.popleft())
            outst = self._outstanding.get(key, 0)
            if self.credit > 1:
                # pipeline: keep `credit` fetches in flight while the shard
                # is producing; idle back to 1 probe once it runs dry
                target = self.credit if self._hot.get(key, True) else 1
                to_issue = max(0, target - outst)
                if not out and outst == 0 and to_issue == 0:
                    to_issue = 1
            elif not out and outst == 0:
                # credit=1: one synchronous fetch, issued only on a dry
                # buffer — no look-ahead (the bench's baseline)
                to_issue = 1
            self._outstanding[key] = outst + to_issue
            tick0 = self._empty_tick.get(key, 0)
        for _ in range(to_issue):
            self._issue(peer, key, k, addr)
        if out:
            return out
        # dry buffer: wait for the pipeline's next response (an empty
        # response while dry means the shard has nothing — return and let
        # the drain loop pace its own retry)
        with self._fcond:
            while True:
                buf = self._buf.get(key)
                if buf:
                    while buf and len(out) < k:
                        out.append(buf.popleft())
                    return out
                if self._empty_tick.get(key, 0) != tick0:
                    break
                if self._outstanding.get(key, 0) <= 0:
                    break
                now = time.monotonic()
                if now >= deadline:
                    break
                self._fcond.wait(min(0.05, deadline - now))
                expired = peer.expire_fetches(key, time.monotonic())
                if expired:
                    self._outstanding[key] = max(
                        0, self._outstanding.get(key, 0) - expired)
                    self.fetch_timeouts += expired
        self._maybe_refresh_depths()
        return out

    def _maybe_refresh_depths(self) -> None:
        """Starved-consumer path: refresh every live host's depth mirrors
        (rate-limited) so steal ranking sees remote backlogs even when no
        data-plane response has piggybacked them recently."""
        now = time.monotonic()
        if now - self._depth_refresh_t < 0.05 or self._closed:
            return
        self._depth_refresh_t = now
        for h, peer in self._peers.items():
            if not peer.alive:
                continue
            try:
                resp, _ = peer.request({"op": "depths"}, timeout=0.25)
            except WireError:
                continue
            if resp:
                self._apply_depths(resp)

    # ---- publish / claim --------------------------------------------------
    def publish(self, cls_name, shard, envs, addr):
        if not envs:
            return 0
        envs = sorted(envs)
        blob = wire_encode(envs, self._encode)
        stamps = [e.t_submit for e in envs]
        peer = self._peers[self.shard_home(shard)]
        body = {"op": "publish", "cls": cls_name, "shard": int(shard),
                "envs": blob, "t": stamps,
                "addr": [int(addr.host), int(addr.rid)]}
        self.publishes += 1
        self.remote_msgs += 1
        self.remote_bytes += len(blob)
        t0 = time.perf_counter()
        resp, attempts = peer.request(body, timeout=self.pub_timeout,
                                      retry=True, max_total=self.max_op_s)
        self.retransmits += attempts - 1
        if resp is None:
            raise WireError(
                f"publish of {len(envs)} envelopes to host {peer.host} "
                f"unacked after {attempts} attempts")
        if "err" in resp:
            raise WireError(f"publish rejected by host {peer.host}: "
                            f"{resp['err']}")
        self._rtt(peer.host, time.perf_counter() - t0)
        self._apply_depths(resp)
        return len(envs)

    def claim_seat(self, cls_name, shard, addr):
        peer = self._peers[self.shard_home(shard)]
        body = {"op": "claim", "cls": cls_name, "shard": int(shard),
                "thief": [int(addr.host), int(addr.rid)]}
        self.remote_claims += 1
        self.remote_msgs += 1
        self.remote_bytes += 32  # fixed-size claim frame (sim parity)
        t0 = time.perf_counter()
        try:
            resp, _ = peer.request(body, timeout=self.claim_timeout)
        except WireError:
            return False
        if resp is None or "err" in resp:
            # dropped before processing: the CAS never happened — the
            # caller's next steal round is the retry, exactly as in sim
            return False
        self._rtt(peer.host, time.perf_counter() - t0)
        self._store_owner(cls_name, int(shard), resp.get("owner"))
        self._apply_depths(resp)
        return bool(resp.get("won"))

    def reseat(self, assignments, *, expect_host=None) -> int:
        """The batched claim frame: one reseat request per destination
        host carries that host's whole slice of a reassignment sweep
        (resize / recovery / restore), applied serially against the
        authoritative seat table; the response feeds the driver mirrors."""
        by_host: Dict[int, list] = {}
        for cls_name, shard, target in assignments:
            by_host.setdefault(self.shard_home(shard), []).append(
                [cls_name, int(shard),
                 [int(target.host), int(target.rid)]])
        moved = 0
        for h in sorted(by_host):
            peer = self._peers[h]
            body = {"op": "reseat", "assignments": by_host[h],
                    "expect_host": expect_host}
            self.remote_msgs += 1
            resp, _ = peer.request(body, timeout=self.ctl_timeout,
                                   retry=True, max_total=self.max_op_s)
            if resp is None or "err" in resp:
                raise WireError(
                    f"reseat on host {h} failed: "
                    f"{'timeout' if resp is None else resp['err']}")
            for name, s, owner in resp["owners"]:
                self._store_owner(name, int(s), owner)
            moved += int(resp["moved"])
        return moved

    # ---- proxy ops (driver-side shard mirror RPCs) ------------------------
    def _shard_enqueue(self, cls_name: str, shard: int, envs: list) -> int:
        envs = sorted(envs)
        blob = wire_encode(envs, self._encode)
        stamps = [e.t_submit for e in envs]
        peer = self._peers[self.shard_home(shard)]
        body = {"op": "shard_enq", "cls": cls_name, "shard": int(shard),
                "envs": blob, "t": stamps}
        resp, _ = peer.request(body, timeout=self.pub_timeout, retry=True,
                               max_total=self.max_op_s)
        if resp is None or "err" in resp:
            raise WireError(
                f"shard enqueue on host {peer.host} failed: "
                f"{'timeout' if resp is None else resp['err']}")
        self._bump(cls_name, shard, cycle=resp.get("cycle"),
                   dcycle=resp.get("dcycle"))
        return int(resp["n"])

    def _shard_dequeue(self, cls_name: str, shard: int, k: int) -> list:
        peer = self._peers[self.shard_home(shard)]
        body = {"op": "shard_deq", "cls": cls_name, "shard": int(shard),
                "k": int(k)}
        resp, _ = peer.request(body, timeout=self.ctl_timeout)
        if resp is None or "err" in resp:
            raise WireError(
                f"shard dequeue on host {peer.host} failed: "
                f"{'timeout' if resp is None else resp['err']}")
        self._bump(cls_name, shard, cycle=resp.get("cycle"),
                   dcycle=resp.get("dcycle"))
        return wire_decode(resp["envs"], self._decode,
                           t_submit=resp.get("t"))

    # ---- quiesce / failure ------------------------------------------------
    def quiesce(self) -> int:
        """Settle the pipeline for a checkpoint: wait out every in-flight
        fetch, republish the client-side prefetch buffers to their home
        shards (chaos-free — a quiesce republish is control-plane), and
        flush the servers' delayed batches. After this, every envelope is
        in an authoritative queue."""
        if self._closed:
            return 0
        deadline = time.monotonic() + self.fetch_timeout + 0.5
        with self._fcond:
            while time.monotonic() < deadline:
                now = time.monotonic()
                for key in list(self._outstanding):
                    peer = self._peers[self.shard_home(key[1])]
                    n = peer.expire_fetches(key, now)
                    if n:
                        self._outstanding[key] = max(
                            0, self._outstanding[key] - n)
                        self.fetch_timeouts += n
                if not any(self._outstanding.values()):
                    break
                self._fcond.wait(0.01)
            drained = []
            for key, buf in self._buf.items():
                if buf:
                    drained.append((key, list(buf)))
                    buf.clear()
        n = 0
        for (cls_name, shard), envs in drained:
            home = self.shard_home(shard)
            # home-addressed publish: control-plane, exempt from chaos
            self.publish(cls_name, shard, envs, HostAddr(home, -1))
            n += len(envs)
        for peer in self._peers.values():
            if not peer.alive:
                continue
            resp, _ = peer.request({"op": "quiesce"},
                                   timeout=self.ctl_timeout)
            if resp and "err" not in resp:
                n += int(resp.get("flushed", 0))
                self._apply_depths(resp)
        return n

    def fail_host(self, host: int) -> int:
        """Mark a host's replicas dead (their drain loops stop being
        served) and settle everything in flight. The worker *process*
        stays up: its shard queues are the durable substrate, exactly like
        the sim's host-loss model — recovery republishes staged claims and
        reseats onto survivors."""
        assert 0 <= host < self.num_hosts
        live = [h for h in self.live_hosts() if h != host]
        assert live, "cannot fail the last live host"
        self._dead.add(host)
        return self.quiesce()

    def add_host(self) -> int:
        raise NotImplementedError(
            "wire transport cannot add hosts live: shard homes are modular "
            "in the spawned fleet size — open a new fabric at the larger "
            "size (or use transport='sim' for elasticity experiments)")

    # ---- telemetry --------------------------------------------------------
    def _server_sweep(self) -> dict:
        """Aggregate server-side counters + refresh every proxy's full
        gauge mirror. Cached briefly: stats() sits on gauge-sampling paths
        that tick far faster than counters matter."""
        now = time.monotonic()
        if self._stats_cache and (self._closed or
                                  now - self._stats_cache_t < 0.05):
            return self._stats_cache
        agg = {"drops": 0, "delayed": 0, "deduped": 0, "server_inflight": 0}
        for peer in self._peers.values():
            if not peer.alive:
                continue
            try:
                resp, _ = peer.request({"op": "stats"}, timeout=1.0)
            except WireError:
                continue
            if not resp or "err" in resp:
                continue
            for name, s, cyc, dcyc, alloc, qstats in resp["shards"]:
                self._bump(name, int(s), cycle=cyc, dcycle=dcyc)
                qc = self._sched.by_name.get(name)
                if qc is not None:
                    q = qc.shards.queues[int(s)]
                    if isinstance(q, ShardProxy):
                        q.pool.allocated = alloc
                        q.stats.update(qstats)
            c = resp.get("counters", {})
            agg["drops"] += int(c.get("drops", 0))
            agg["delayed"] += int(c.get("delayed", 0))
            agg["deduped"] += int(c.get("deduped", 0))
            agg["server_inflight"] += int(c.get("inflight", 0))
        self._stats_cache = agg
        self._stats_cache_t = now
        return agg

    def stats(self) -> dict:
        agg = self._server_sweep() if getattr(self, "_sched", None) \
            else {"drops": 0, "delayed": 0, "deduped": 0,
                  "server_inflight": 0}
        return {"kind": self.kind, "hosts": self.num_hosts,
                "dead_hosts": sorted(self._dead),
                "fetches": self.fetches, "publishes": self.publishes,
                "remote_msgs": self.remote_msgs,
                "remote_bytes": self.remote_bytes,
                "drops": agg["drops"], "delayed": agg["delayed"],
                "reordered": 0, "retransmits": self.retransmits,
                "remote_claims": self.remote_claims,
                "deduped": agg["deduped"],
                "server_inflight": agg["server_inflight"],
                "fetch_timeouts": self.fetch_timeouts,
                "prefetch_buffered": sum(len(b)
                                         for b in self._buf.values()),
                "credit": self.credit}

    def spec(self) -> dict:
        return {"kind": self.kind, "hosts": self.num_hosts,
                "drop": self.drop, "delay": self.delay,
                "rtt_ms": self.rtt_ms, "credit": self.credit}
