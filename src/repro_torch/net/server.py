"""Per-host shard server for the wire transport (DESIGN.md §15).

One :class:`HostWorker` is one host of the fleet, run as a real OS process
(spawned by :class:`~repro_torch.net.wire.WireTransport`). It owns the
**authoritative half** of the fabric for the shards homed on it
(``shard_home(s) = s % H``, same modular layout as ``SimHostTransport``):

  * the real :class:`~repro_torch.core.cmp.CMPQueue` instances — the durable
    substrate; driver-side shard objects become mirrors (ShardProxy);
  * the **seat-owner table** for those shards — a claim is one serialized
    compare-and-swap here, exactly :func:`repro_torch.sched.steal.claim_seat`'s
    semantics; the driver's seat cells become response-fed mirrors.

The failure model mirrors the sim transport's exactness argument
(module docstring of ``sched/transport.py``): chaos **drop** discards a
request *before* it is processed (a dropped fetch claims nothing, a dropped
claim CASes nothing; the client times the request out and its retry — a
later fetch round, a publish retransmit with the same request id — is the
recovery). Chaos **delay** parks freshly-claimed fetch batches in a
server-side in-flight buffer (claimed-but-on-the-wire); they surface on a
later fetch of the same shard or on a ``quiesce`` flush, so no setting of
the knobs can lose an item. Mutating retried ops (``publish``,
``shard_enq``, ``reseat``) are **deduplicated by request id**: a
retransmitted request whose original was applied returns the cached ack
without re-applying, which is what makes at-least-once delivery exact.

Injected RTT (``rtt_ms``) delays data-plane *responses* through a sender
queue, so pipelined requests overlap their round trips — the mechanism the
prefetch-credit client exploits.
"""

from __future__ import annotations

import json
import os
import random
import socket
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Tuple

from repro_torch.core.cmp import CMPQueue
from repro_torch.net.framing import KIND_RESP, FrameDecoder, pack_frame
from repro_torch.sched.transport import wire_decode, wire_encode

# ops whose responses model a network round trip (and whose requests are
# subject to chaos): the three seat-protocol operations. Control-plane ops
# (reseat/quiesce/stats/...) and proxy ops are chaos-free, matching the
# sim transport's chaos-free quiesce/resize/checkpoint paths.
_DATA_OPS = ("fetch", "publish", "claim")
# mutating ops that clients retry with the same request id -> id-deduped
_RETRIED_OPS = ("publish", "shard_enq", "reseat")
_DEDUPE_CAP = 4096


class HostWorker:
    """Authoritative shard state + request handlers for one host."""

    def __init__(self, spec: dict):
        self.host = int(spec["host"])
        self.num_hosts = int(spec["num_hosts"])
        self.queues: Dict[Tuple[str, int], CMPQueue] = {}
        for c in spec["classes"]:
            kw = dict(c.get("queue_kw") or {})
            for s in range(int(c["num_shards"])):
                if s % self.num_hosts == self.host:
                    self.queues[(c["name"], s)] = CMPQueue(**kw)
        # seat-owner table for homed shards: (cls, shard) -> (host, rid)
        self.owners: Dict[Tuple[str, int], Tuple[int, int]] = {}
        for name, s, owner in spec.get("owners", []):
            self.owners[(name, int(s))] = (int(owner[0]), int(owner[1]))
        chaos = spec.get("chaos") or {}
        self.drop = float(chaos.get("drop", 0.0))
        self.delay = float(chaos.get("delay", 0.0))
        self.rtt_s = float(chaos.get("rtt_ms", 0.0)) / 1e3
        self._rng = random.Random(int(chaos.get("seed", 0)))
        self._lock = threading.RLock()
        # claimed-but-delayed fetch batches (the sim's _inflight, host-local)
        self._inflight: Dict[Tuple[str, int], List] = {}
        # request-id dedupe cache for retried mutations: id -> cached resp
        self._done: "OrderedDict[int, dict]" = OrderedDict()
        self.counters = {"drops": 0, "delayed": 0, "deduped": 0,
                         "fetches": 0, "publishes": 0, "claims": 0}

    # ------------------------------------------------------------ helpers
    def _roll(self, p: float) -> bool:
        if p <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < p

    def _depths(self) -> List[List]:
        """Gauge piggyback: ``[cls, shard, cycle, deque_cycle]`` for every
        shard homed here — rides every data-plane response so the driver's
        steal ranking and depth gauges never read a stale mirror for long."""
        return [[name, s, q.cycle.load(), q.deque_cycle.load()]
                for (name, s), q in self.queues.items()]

    def _envs_out(self, envs) -> Tuple[str, List[float]]:
        envs = sorted(envs)
        return (wire_encode(envs),
                [e.t_submit for e in envs])

    # ----------------------------------------------------------- handlers
    def handle(self, body: dict) -> dict:
        """One request -> one response body (the connection layer frames it
        and applies the RTT sender delay). Never raises on bad input — a
        malformed op gets an ``{"err": ...}`` response so the driver fails
        loudly instead of hanging on a silent connection death."""
        op = body.get("op")
        rid = body.get("id")
        if op in _RETRIED_OPS and rid is not None:
            with self._lock:
                cached = self._done.get(rid)
                if cached is not None:
                    self.counters["deduped"] += 1
                    return cached
        try:
            fn = getattr(self, "_op_" + str(op), None)
            if fn is None:
                resp = {"err": f"unknown op {op!r}"}
            else:
                resp = fn(body)
        except Exception as exc:  # surface, don't kill the connection
            resp = {"err": f"{type(exc).__name__}: {exc}"}
        resp["id"] = rid
        if op in _RETRIED_OPS and rid is not None and "err" not in resp:
            with self._lock:
                self._done[rid] = resp
                while len(self._done) > _DEDUPE_CAP:
                    self._done.popitem(last=False)
        return resp

    def _op_ping(self, body):
        return {"host": self.host}

    def _op_fetch(self, body):
        key = (body["cls"], int(body["shard"]))
        addr = tuple(body["addr"])
        resp = {"op": "fetch", "cls": key[0], "shard": key[1]}
        with self._lock:
            self.counters["fetches"] += 1
            own = self.owners.get(key)
            if own is not None and own != (int(addr[0]), int(addr[1])):
                # stale mirror: the seat moved (a steal landed here first).
                # Claim nothing; return the authoritative owner so the
                # driver's seat mirror catches up immediately.
                resp.update(envs="[]", t=[], owner=list(own),
                            d=self._depths())
                return resp
            parked = self._inflight.pop(key, [])
        q = self.queues[key]
        fresh = q.dequeue_many(int(body["k"]))
        if fresh and self._roll(self.delay):
            # claimed but in flight on the (simulated) wire: parks until a
            # later fetch of this shard or a quiesce flush — never lost
            with self._lock:
                self.counters["delayed"] += len(fresh)
                self._inflight.setdefault(key, []).extend(fresh)
            fresh = []
        blob, t = self._envs_out(parked + fresh)
        resp.update(envs=blob, t=t, d=self._depths())
        if (own := self.owners.get(key)) is not None:
            resp["owner"] = list(own)
        return resp

    def _op_publish(self, body):
        key = (body["cls"], int(body["shard"]))
        envs = wire_decode(body["envs"], t_submit=body.get("t"))
        self.queues[key].enqueue_many(envs)
        with self._lock:
            self.counters["publishes"] += 1
        return {"n": len(envs), "d": self._depths()}

    def _op_claim(self, body):
        key = (body["cls"], int(body["shard"]))
        thief = (int(body["thief"][0]), int(body["thief"][1]))
        with self._lock:
            self.counters["claims"] += 1
            cur = self.owners.get(key)
            won = cur is not None and cur != thief
            if won:
                self.owners[key] = thief  # the serialized seat CAS
            owner = self.owners.get(key)
        return {"won": won, "owner": list(owner) if owner else None,
                "d": self._depths()}

    def _op_reseat(self, body):
        expect = body.get("expect_host")
        moved = 0
        keys = []
        with self._lock:
            for name, s, target in body["assignments"]:
                key = (name, int(s))
                keys.append(key)
                cur = self.owners.get(key)
                tgt = (int(target[0]), int(target[1]))
                if cur == tgt:
                    continue
                if expect is not None and (cur is None
                                           or cur[0] != int(expect)):
                    continue
                self.owners[key] = tgt
                moved += 1
            owners = [[k[0], k[1], list(self.owners[k])] for k in keys]
        return {"moved": moved, "owners": owners}

    def _op_shard_enq(self, body):
        key = (body["cls"], int(body["shard"]))
        envs = wire_decode(body["envs"], t_submit=body.get("t"))
        q = self.queues[key]
        q.enqueue_many(envs)
        return {"n": len(envs),
                "cycle": q.cycle.load(), "dcycle": q.deque_cycle.load()}

    def _op_shard_deq(self, body):
        key = (body["cls"], int(body["shard"]))
        q = self.queues[key]
        blob, t = self._envs_out(q.dequeue_many(int(body["k"])))
        return {"envs": blob, "t": t,
                "cycle": q.cycle.load(), "dcycle": q.deque_cycle.load()}

    def _op_depths(self, body):
        return {"d": self._depths()}

    def _op_quiesce(self, body):
        """Flush claimed-but-delayed batches back into their home shards
        (the sim's ``_flush_inflight``) so a checkpoint or recovery pass
        sees every envelope in a queue."""
        with self._lock:
            flushed = self._inflight
            self._inflight = {}
        n = 0
        for key, envs in flushed.items():
            self.queues[key].enqueue_many(envs)
            n += len(envs)
        return {"flushed": n, "d": self._depths()}

    def _op_stats(self, body):
        shards = []
        for (name, s), q in self.queues.items():
            shards.append([name, s, q.cycle.load(), q.deque_cycle.load(),
                           q.pool.allocated, dict(q.stats)])
        with self._lock:
            counters = dict(self.counters)
            counters["inflight"] = sum(len(v)
                                       for v in self._inflight.values())
        return {"shards": shards, "counters": counters}


class HostServer:
    """Threaded TCP front end for one :class:`HostWorker`.

    One accept loop; per connection, one reader thread that decodes frames,
    dispatches to the worker and sends responses. With injected RTT, data-
    plane responses are handed to a per-connection **sender queue** that
    releases each at ``receive time + rtt``: per-connection FIFO (TCP
    ordering) is preserved while pipelined requests overlap their delays —
    which is exactly what prefetch credit buys the client.
    """

    def __init__(self, worker: HostWorker, port: int = 0):
        self.worker = worker
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"host{worker.host}-accept",
            daemon=True)

    def start(self) -> None:
        self._accept_thread.start()

    def serve_forever(self) -> None:
        self.start()
        self._stop.wait()

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ plumbing
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"host{self.worker.host}-conn",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        worker = self.worker
        send_lock = threading.Lock()
        sender = _DelayedSender(conn, send_lock) if worker.rtt_s > 0 else None
        dec = FrameDecoder()
        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                for _, body in dec.feed(data):
                    op = body.get("op")
                    if op == "shutdown":
                        frame = pack_frame(KIND_RESP,
                                           {"id": body.get("id"), "ok": 1})
                        with send_lock:
                            conn.sendall(frame)
                        self.shutdown()
                        return
                    is_data = op in _DATA_OPS
                    remote = True
                    if is_data:
                        src = body.get("addr") or body.get("thief")
                        remote = src is None or int(src[0]) != worker.host
                    if is_data and remote and worker._roll(worker.drop):
                        # lost request: nothing processed, nothing sent —
                        # the client's timeout/retry is the recovery
                        with worker._lock:
                            worker.counters["drops"] += 1
                        continue
                    resp = worker.handle(body)
                    frame = pack_frame(KIND_RESP, resp)
                    if sender is not None and is_data:
                        sender.put(frame, worker.rtt_s)
                    else:
                        with send_lock:
                            conn.sendall(frame)
        finally:
            if sender is not None:
                sender.close()
            try:
                conn.close()
            except OSError:
                pass


class _DelayedSender:
    """Per-connection FIFO of (due-time, frame): releases each frame once
    its injected RTT has elapsed. FIFO + constant delay keeps responses in
    request order, like a real pipe with latency."""

    def __init__(self, conn: socket.socket, send_lock: threading.Lock):
        self._conn = conn
        self._send_lock = send_lock
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        threading.Thread(target=self._run, daemon=True,
                         name="wire-delayed-sender").start()

    def put(self, frame: bytes, delay_s: float) -> None:
        with self._cond:
            self._q.append((time.monotonic() + delay_s, frame))
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q and self._closed:
                    return
                due, frame = self._q[0]
                wait = due - time.monotonic()
                if wait > 0:
                    self._cond.wait(wait)
                    continue
                self._q.popleft()
            try:
                with self._send_lock:
                    self._conn.sendall(frame)
            except OSError:
                return


def worker_main(spec_json: str) -> None:
    """Entry point for one host worker process (``python -m
    repro_torch.net.server``): build the shard state from the spec line on
    stdin, bind an ephemeral localhost port, report it as ``PORT <n>`` on
    stdout, then serve until a ``shutdown`` frame arrives — or until
    stdin hits EOF, which means the driver died; exiting then (rather
    than serving an orphaned fleet) is the crash-cleanup path. Import
    cost is deliberately tiny (core CMP + stdlib, no accelerator stack)
    so a 2-host fleet spawns in well under a second."""
    spec = json.loads(spec_json)
    server = HostServer(HostWorker(spec), port=0)
    sys.stdout.write(f"PORT {server.port}\n")
    sys.stdout.flush()

    def _watch_stdin() -> None:
        while sys.stdin.read(64):
            pass
        server.shutdown()
        os._exit(0)

    threading.Thread(target=_watch_stdin, daemon=True,
                     name="wire-stdin-watch").start()
    server.serve_forever()


def main() -> None:
    worker_main(sys.stdin.readline())


if __name__ == "__main__":
    main()
