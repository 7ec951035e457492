"""Continuous-batching serving engine on the priority-class CMP queue fabric.

CMP end to end:
  * admission — requests enter through the :mod:`repro_torch.sched` fabric:
    one :class:`QueueClass` per tenant/priority tier (strict FIFO *within* a
    class, window-bounded admission) and a pluggable policy composing one
    batched drain per engine step — or, with ``device_admission``, the
    fused CMP ring kernel on the card;
  * KV memory — pages from :class:`PagedKVPool`; finished/preempted requests
    retire pages which recycle after the protection window W (no refcounts,
    no sweep barrier);
  * overload — if the pool runs dry the engine preempts the least entitled
    lane: lowest class priority first, youngest arrival within it. The
    victim's pages retire and its request re-enters *its own* class queue at
    its original cycle position.

The lane tables ``block_tables``/``seq_lens``/``last_tok`` live on the
engine's device across steps and are updated in place; prefill and decode
share one forward callable. The engine runs on the card unless built with
``device="cpu"``.

With a flight recorder attached (``FabricConfig(obs=...)``) a step records
its phases as spans (``engine.step`` > ``engine.admit`` > ``admit.ring``,
``admit.prefill``; ``engine.grow``, ``engine.decode``, ``engine.read``,
``engine.retire``) and counts each device->host read (``host_reads``) where
it happens; without one each site is one ``is None`` check.

Scale-out is :class:`EngineReplicaGroup`: N of these engines over one
fabric, each fed by a :class:`~repro_torch.sched.SchedulerReplica` that owns
a seat subset of every class, rebalanced purely by seat-claim steals, with
exact-seat frontier checkpointing via :meth:`EngineReplicaGroup.sched_state`.
The replicas share one forward callable and one set of parameter tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.obs.recorder import (ADMIT_PREFILL, ADMIT_RING, ENGINE_ADMIT,
                                      ENGINE_DECODE, ENGINE_GROW, ENGINE_READ,
                                      ENGINE_RETIRE, ENGINE_STEP, HOST_READS)
from repro_torch.sched import Envelope, QueueClass, ReplicaSet, Scheduler
from repro_torch.serving.admission import DeviceAdmissionRing, resolve_device_admission
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.paged_model import paged_forward


# the span of a site when no recorder is attached (reused, never allocated)
_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    qclass: str = "default"
    output: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0


def request_state(req: "Request") -> dict:
    """JSON-able snapshot of a request for frontier checkpointing. Decoded
    output is deliberately not captured: a restored request re-enters its
    class at its original cycle seat and re-prefills — the same contract as
    preemption."""
    return {"uid": req.uid, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens, "qclass": req.qclass,
            "preemptions": req.preemptions}


def request_from_state(state: dict) -> "Request":
    req = Request(state["uid"], list(state["prompt"]),
                  state["max_new_tokens"], qclass=state["qclass"])
    req.preemptions = state["preemptions"]
    return req


def resolve_device(device) -> torch.device:
    """The serving device, checked before anything is made on it: the card
    unless the caller asks for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} needs a CUDA device; pass "
                           "device='cpu' to serve on the CPU")
    return dev


class Engine:
    # flight-recorder attachment: None until a recorder attaches
    _obs = None

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 page_size: int = 16, num_pages: int = 64, window: int = 4,
                 max_seq: int = 128,
                 classes: Optional[Sequence[QueueClass]] = None,
                 policy="strict", sched=None, forward_fn=None,
                 device_admission=False, admit_prefetch: int = 0,
                 device="cuda"):
        assert all(k in ("dense", "moe") for k in cfg.block_pattern), \
            "paged engine serves attention-based families"
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.max_batch, self.page_size, self.max_seq = max_batch, page_size, max_seq
        self.pps = max_seq // page_size
        self.pool = PagedKVPool(cfg, num_pages=num_pages, page_size=page_size,
                                window=window, device=self.device)
        # Reserve page 0 as the scratch target for inactive batch lanes
        # (their masked decode writes land here, never on live pages).
        scratch, ok = self.pool.alloc(1)
        assert bool(ok.all()) and int(scratch[0]) == 0
        if sched is None:
            if classes is None:
                classes = [QueueClass("default", window=max(64, window),
                                      reclaim_period=32)]
            sched = Scheduler(classes, policy=policy)
        # Any Scheduler-shaped drain source works: the engine only ever
        # calls drain/policy/classes/pending/submit.
        self.sched = sched
        self.step_count = 0
        self._uid = itertools.count()
        # active request table (host side); lane tensors live on the device
        # across steps and are updated in place.
        self.active: List[Optional[Request]] = [None] * max_batch
        # the envelope each lane was admitted with: (QueueClass, Envelope);
        # preemption requeues it so the request keeps its class-cycle seat
        self._lane_env: List[Optional[Tuple[QueueClass, Envelope]]] = \
            [None] * max_batch
        i32 = dict(dtype=torch.int32, device=self.device)
        self.block_tables = torch.zeros((max_batch, self.pps), **i32)
        self.seq_lens = torch.zeros((max_batch,), **i32)
        self.last_tok = torch.zeros((max_batch,), **i32)
        self.completed: Dict[int, Request] = {}
        # Prefill and decode are the same function at different sequence
        # lengths.
        self._forward = forward_fn or (
            lambda p, t, kp, vp, bt, sl: paged_forward(p, t, cfg, kp, vp, bt, sl))
        # Device-resident admission: policy-drained batches route through a
        # bounded CMP ring on the engine's device — one fused
        # reclaim+enqueue+claim+publish kernel call per refill. "auto"
        # enables it when a CUDA device is present.
        self._dev_admit = None
        self._admit_prefetch = 0
        if resolve_device_admission(device_admission):
            # claim look-ahead well past max_batch: the fused call's fixed
            # cost divides by claim_block, and the ordering relaxation it
            # buys stays bounded by the prefetch depth.
            self._dev_admit = DeviceAdmissionRing(
                k=max_batch, claim_block=max(8 * max_batch, 2 * max_batch),
                device=self.device)
            self._admit_prefetch = (int(admit_prefetch)
                                    or 2 * self._dev_admit.claim_block)

    @property
    def pending(self) -> int:
        """Accepted-but-not-laned items (incl. requeues and ring-resident
        prefetch), derived from the scheduler's and ring's own counters."""
        return self.sched.pending() + self.ring_pending

    @property
    def ring_pending(self) -> int:
        """Entries prefetched into the device admission ring (0 on the
        host path)."""
        return 0 if self._dev_admit is None else self._dev_admit.pending

    def flush_admission(self) -> None:
        """Return every ring-resident entry to its exact class seat (no-op
        on the host path)."""
        if self._dev_admit is not None:
            for qc, env in self._dev_admit.flush():
                qc.requeue(env)

    # ---------------------------------------------------------------- client
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               qclass: Optional[str] = None) -> Optional[int]:
        """Enqueue one request into its class; returns its uid, or None when
        the class's admission window rejected it (backpressure)."""
        name = qclass or self.sched.default_class
        req = Request(next(self._uid), list(prompt), max_new_tokens,
                      qclass=name)
        if self.sched.submit(name, req) is None:
            return None
        return req.uid

    def submit_many(self, prompts: List[List[int]], max_new_tokens: int = 16,
                    qclass: Optional[str] = None) -> List[Optional[int]]:
        """Batched admission enqueue: one class-cycle-range fetch-add + one
        splice per shard for the whole burst. Window-rejected entries come
        back as None."""
        name = qclass or self.sched.default_class
        reqs = [Request(next(self._uid), list(p), max_new_tokens, qclass=name)
                for p in prompts]
        envs = self.sched.submit_many(name, reqs)
        return [r.uid if e is not None else None for r, e in zip(reqs, envs)]

    # ---------------------------------------------------------------- pages
    def _alloc_pages(self, n: int) -> Optional[np.ndarray]:
        if n == 0:
            return np.zeros((0,), np.int32)
        ids, valid = self.pool.alloc(n)
        both = torch.stack([ids, valid.to(torch.int32)]).cpu().numpy()
        if self._obs is not None:
            self._obs.count(HOST_READS)
        if not both[1].all():
            self.pool.retire(ids)  # return partial grab
            return None
        return both[0]

    def _retire_request(self, lane: int) -> None:
        used = (int(self.seq_lens[lane]) + self.page_size - 1) // self.page_size
        if self._obs is not None:
            self._obs.count(HOST_READS)
        if used > 0:
            self.pool.retire(self.block_tables[lane, :used])
        self.block_tables[lane] = 0
        self.seq_lens[lane] = 0
        self.active[lane] = None
        self._lane_env[lane] = None

    def _entitlement(self, lane: int):
        """Lane sort key, least entitled first: lowest class priority, then
        youngest arrival (fabric-global arrival stamp)."""
        qc, env = self._lane_env[lane]
        return (qc.priority, -env.stamp)

    def _evict_lane(self, lane: int) -> None:
        """Preempt one lane: retire its pages (they recycle after W steps)
        and requeue the request into *its own* class at its original cycle."""
        qc, env = self._lane_env[lane]
        req = self.active[lane]
        req.preemptions += 1
        req.output = []
        self._retire_request(lane)
        qc.requeue(env)

    def _preempt_for(self, prio: int, stamp: int) -> bool:
        """Free pages for a claimant entitled as (class priority, arrival
        stamp): evict the least entitled active lane, but never one at
        least as entitled as the claimant."""
        lanes = [i for i, r in enumerate(self.active) if r is not None]
        if not lanes:
            return False
        lane = min(lanes, key=self._entitlement)
        if self._entitlement(lane) >= (prio, -stamp):
            return False
        self._evict_lane(lane)
        return True

    # ---------------------------------------------------------------- sched
    def _drain_admission(self, want: int):
        """Compose the admission batch of (QueueClass, Envelope) pairs.

        Host path: one policy drain. Ring path: top the device ring up from
        the scheduler and claim ``want`` lanes in one fused kernel call.
        Ring-rejected entries go straight back to their exact class seats.
        """
        if self._dev_admit is None:
            return self.sched.drain(want)
        ring = self._dev_admit
        fresh = []
        if ring.buffered < want:  # a fused call is imminent: top up
            need = max(want, self._admit_prefetch) - ring.pending
            if need > 0:
                drain = (getattr(self.sched, "drain_bulk", None)
                         or self.sched.drain)
                fresh = drain(min(need, ring.room))
        claimed, rejected = ring.step(fresh, want)
        for qc, env in rejected:
            qc.requeue(env)
        return claimed

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.active) if r is None]
        # Class-aware lane preemption: pending work of a *strictly higher*
        # class claims lanes even when none are free, evicting the least
        # entitled occupants (only under a priority-honoring policy).
        while self.sched.policy.honors_priority and len(free) < self.max_batch:
            occupied = [i for i, r in enumerate(self.active) if r is not None]
            lane = min(occupied, key=self._entitlement)
            victim_prio = self._lane_env[lane][0].priority
            higher_pending = sum(qc.pending() for qc in self.sched.classes
                                 if qc.priority > victim_prio)
            if higher_pending <= len(free):
                break
            self._evict_lane(lane)
            free.append(lane)
        if not free:
            return
        rec = self._obs
        with _NO_SPAN if rec is None else rec.span(ADMIT_RING):
            batch = self._drain_admission(len(free))
        for idx, (lane, (qc, env)) in enumerate(zip(free, batch)):
            req: Request = env.payload
            with (_NO_SPAN if rec is None
                  else rec.span(ADMIT_PREFILL, qc.name, env.seq, req.uid)):
                if not self._prefill(lane, qc, env, req):
                    # Pool dry, nothing less entitled to evict: every request
                    # not yet laned goes back to its own class seat.
                    for qc2, env2 in batch[idx:]:
                        qc2.requeue(env2)
                    return

    def _prefill(self, lane: int, qc: QueueClass, env: Envelope,
                 req: Request) -> bool:
        """Lane ``req``: its pages (preempting less entitled lanes if the
        pool is dry), the ``[1, S]`` forward and the first token. False
        when the pool stays dry."""
        need = (len(req.prompt) + self.page_size - 1) // self.page_size
        pages = self._alloc_pages(max(1, need))
        while pages is None:
            if not self._preempt_for(qc.priority, env.stamp):
                return False
            pages = self._alloc_pages(max(1, need))
        self.active[lane] = req
        self._lane_env[lane] = (qc, env)
        self.block_tables[lane, :len(pages)] = torch.from_numpy(pages).to(self.device)
        self.seq_lens[lane] = 0
        # prefill: the whole prompt at once (same callable as decode)
        toks = torch.tensor([req.prompt], dtype=torch.int32, device=self.device)
        bt = self.block_tables[lane:lane + 1]
        sl = torch.zeros((1,), dtype=torch.int32, device=self.device)
        logits, self.pool.k_pages, self.pool.v_pages = self._forward(
            self.params, toks, self.pool.k_pages, self.pool.v_pages, bt, sl)
        tok = int(torch.argmax(logits[0]))
        self.seq_lens[lane] = len(req.prompt)
        self.last_tok[lane] = tok
        req.output.append(tok)
        rec = self._obs
        if rec is not None:
            # the first-token read, and paged_forward's read of seq_lens in
            # a call of more than one token
            rec.count(HOST_READS, 2 if len(req.prompt) > 1 else 1)
            if rec.sampled(env.seq):
                rec.emit("lane_prefill", qc.name, env.seq, arg=lane)
        return True

    def _grow_pages(self) -> None:
        """Allocate fresh pages for every lane whose next token crosses a page
        boundary — one batched allocation for all of them (pool pressure
        triggers preemption, paper Alg 1 Phase 1)."""
        sl = self.seq_lens.cpu().numpy()
        if self._obs is not None:
            self._obs.count(HOST_READS)
        used = -(-sl // self.page_size)
        need = -(-(sl + 1) // self.page_size)
        lanes = [i for i, r in enumerate(self.active)
                 if r is not None and need[i] > used[i]]
        if not lanes:
            return
        # Fast path: enough FREE pages for every growing lane -> one batched
        # grab + one scatter.
        if self.pool.free_pages() >= len(lanes):
            pages = self._alloc_pages(len(lanes))
            if pages is not None:
                rows = torch.as_tensor(lanes, device=self.device)
                cols = torch.as_tensor(used[lanes], device=self.device).long()
                self.block_tables[rows, cols] = torch.from_numpy(pages).to(self.device)
                return
        # Pool pressure: grow lane by lane (earliest lane first), preempting
        # as needed; a lane preempted out from under us is skipped.
        for lane in lanes:
            if self.active[lane] is None:
                continue
            qc, env = self._lane_env[lane]
            page = self._alloc_pages(1)
            while page is None:
                if (not self._preempt_for(qc.priority, env.stamp)
                        or self.active[lane] is None):
                    break
                page = self._alloc_pages(1)
            if page is not None and self.active[lane] is not None:
                self.block_tables[lane, int(used[lane])] = int(page[0])
            elif page is None and self.active[lane] is not None:
                # Nobody less entitled to evict and the pool is dry: the
                # growing lane preempts *itself* (requeue at its cycle seat)
                # rather than decode into the scratch page.
                self._evict_lane(lane)

    # ---------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One engine iteration: tick window clock, reclaim, admit, decode."""
        rec = self._obs
        if rec is None:
            return self._step(None)
        with rec.span(ENGINE_STEP):
            return self._step(rec)

    def _step(self, rec) -> List[Request]:
        self.step_count += 1
        self.pool.tick(self.step_count)
        with _NO_SPAN if rec is None else rec.span(ENGINE_ADMIT):
            self._admit()
        with _NO_SPAN if rec is None else rec.span(ENGINE_GROW):
            self._grow_pages()
        active_np = np.array([r is not None for r in self.active])
        if not active_np.any():
            return []
        with _NO_SPAN if rec is None else rec.span(ENGINE_DECODE):
            # Decode all lanes in one call on the device-resident tables.
            logits, self.pool.k_pages, self.pool.v_pages = self._forward(
                self.params, self.last_tok[:, None], self.pool.k_pages,
                self.pool.v_pages, self.block_tables, self.seq_lens)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            mask = torch.from_numpy(active_np).to(self.device)
            self.seq_lens += mask.to(torch.int32)
            self.last_tok = torch.where(mask, nxt, self.last_tok)
        with _NO_SPAN if rec is None else rec.span(ENGINE_READ):
            # single host sync per step for completion bookkeeping
            nxt_np, sl_np = torch.stack([nxt, self.seq_lens]).cpu().numpy()
            if rec is not None:
                rec.count(HOST_READS)
        with _NO_SPAN if rec is None else rec.span(ENGINE_RETIRE):
            return self._retire_step(rec, active_np, nxt_np, sl_np)

    def _retire_step(self, rec, active_np, nxt_np, sl_np) -> List[Request]:
        """The bookkeeping after the decode's read: each lane's new token,
        and the lanes whose requests finished retire."""
        done = []
        for lane in np.nonzero(active_np)[0]:
            req = self.active[lane]
            req.output.append(int(nxt_np[lane]))
            lane_env = self._lane_env[lane]
            traced = (rec is not None and lane_env is not None
                      and rec.sampled(lane_env[1].seq))
            if traced and len(req.output) == 2:
                # first post-prefill token: the lane has entered steady decode
                rec.emit("decode", lane_env[0].name, lane_env[1].seq,
                         arg=int(lane))
            if (len(req.output) >= req.max_new_tokens
                    or sl_np[lane] + 1 >= self.max_seq):
                done.append(req)
                self.completed[req.uid] = req
                if traced:
                    rec.emit("complete", lane_env[0].name, lane_env[1].seq,
                             arg=len(req.output))
                self._retire_request(int(lane))
        return done

    def run_until_idle(self, max_steps: int = 1000) -> Dict[int, Request]:
        for _ in range(max_steps):
            self.step()
            if all(r is None for r in self.active) and self.pending == 0:
                break
        return self.completed

    # ------------------------------------------------------------ telemetry
    def class_stats(self) -> dict:
        """Per-class fabric snapshot (occupancy, admission latency, rejects)
        — reads existing domain counters only."""
        return self.sched.snapshot()


def _split_budget(total: int, parts: int) -> List[int]:
    """Partition an integer budget as evenly as possible, every part >= 1."""
    assert total >= parts, f"budget {total} cannot cover {parts} replicas"
    base, rem = divmod(total, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _split_budget_hosted(total: int, hosts: List[int],
                         min_per: int = 1) -> List[int]:
    """Host-aware budget partition: every replica is granted ``min_per``
    first (an engine needs 1 lane, and 2 pages — the reserved scratch page
    plus one live page — to serve at all), then the *remainder* splits
    evenly across the hosts (a host's lanes and pages are physically its
    own) and each host divides its share among its own replicas. With one
    host this degenerates to :func:`_split_budget` exactly; with replicas
    spread unevenly (e.g. 3 replicas on 2 hosts) each host still gets an
    equal share of the surplus without ever pushing a lone replica below
    the serving minimum."""
    n = len(hosts)
    assert total >= min_per * n, (
        f"budget {total} cannot give {n} replicas {min_per} each")
    out = [min_per] * n
    rem = total - min_per * n
    uniq = sorted(set(hosts))
    base, extra = divmod(rem, len(uniq))
    for j, h in enumerate(uniq):
        share = base + (1 if j < extra else 0)
        rids = [i for i, hh in enumerate(hosts) if hh == h]
        b, e = divmod(share, len(rids))
        for k, i in enumerate(rids):
            out[i] += b + (1 if k < e else 0)
    return out


class EngineReplicaGroup:
    """N engine replicas over one class fabric.

    Each replica is a full :class:`Engine` — its own lanes, its own page
    pool (the lane and page budgets are partitioned, not shared), its own
    policy drain — fed by a :class:`~repro_torch.sched.SchedulerReplica`
    that owns a seat subset of every class. Replicas share the model's
    parameter tensors (one copy on the device, however many replicas) and
    one forward callable. Rebalancing is pure stealing: a starved replica
    claims a whole cycle-run seat with one CAS; no replica ever blocks on
    another.

    The group is also the checkpoint boundary: :meth:`sched_state` is an
    exact-seat frontier snapshot taken between steps (active lanes are
    recorded at their original seats, like preemption victims), and
    :meth:`from_sched_state` restores a group in which every tenant resumes
    at its exact FIFO seat.
    """

    def __init__(self, cfg: ModelConfig, params, *, num_replicas: int = 2,
                 max_batch: int = 4, page_size: int = 16, num_pages: int = 64,
                 window: int = 4, max_seq: int = 128,
                 classes: Optional[Sequence[QueueClass]] = None,
                 policy="strict", min_steal: int = 1,
                 replica_set: Optional[ReplicaSet] = None,
                 forward_fn=None, uid_start: int = 0, transport=None,
                 device_admission=False, device="cuda"):
        self.device = resolve_device(device)
        if replica_set is None:
            if classes is None:
                classes = [QueueClass("default", num_shards=num_replicas,
                                      window=max(64, window),
                                      reclaim_period=32)]
            replica_set = ReplicaSet(Scheduler(classes, policy=policy),
                                     num_replicas, policy=policy,
                                     min_steal=min_steal,
                                     transport=transport)
        self.replica_set = replica_set
        self.sched = replica_set.scheduler
        self.num_replicas = replica_set.num_replicas
        self._fwd = forward_fn or (
            lambda p, t, kp, vp, bt, sl: paged_forward(p, t, cfg, kp, vp, bt, sl))
        # the fabric-wide budgets + geometry, retained so resize() can
        # re-partition them across a different replica count
        self.cfg, self.params = cfg, params
        self._budget = dict(max_batch=max_batch, page_size=page_size,
                            num_pages=num_pages, window=window,
                            max_seq=max_seq)
        self._device_admission = device_admission
        self._completed: Dict[int, Request] = {}  # survivors of resizes
        self.engines = self._build_engines()
        self._next_uid = int(uid_start)
        self.step_count = 0

    def _build_engines(self) -> List[Engine]:
        """One engine per *live* scheduler replica, the fabric-wide lane
        and page budgets partitioned host-first across them (each live
        transport host gets an equal hardware share, split among its
        replicas — a dead host's replicas get no engine and no budget),
        all sharing one forward callable and one set of parameters."""
        live = self.replica_set.live_replicas()
        assert live, "engine group with every host dead"
        hosts = [r.addr.host for r in live]
        lanes = _split_budget_hosted(self._budget["max_batch"], hosts,
                                     min_per=1)
        pages = _split_budget_hosted(self._budget["num_pages"], hosts,
                                     min_per=2)
        return [
            Engine(self.cfg, self.params, max_batch=lanes[i],
                   page_size=self._budget["page_size"], num_pages=pages[i],
                   window=self._budget["window"],
                   max_seq=self._budget["max_seq"],
                   sched=r, forward_fn=self._fwd,
                   device_admission=self._device_admission,
                   device=self.device)
            for i, r in enumerate(live)]

    # ---------------------------------------------------------------- client
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               qclass: Optional[str] = None) -> Optional[int]:
        name = qclass or self.sched.default_class
        req = Request(self._next_uid, list(prompt), max_new_tokens,
                      qclass=name)
        if self.sched.submit(name, req) is None:
            return None
        self._next_uid += 1
        return req.uid

    def submit_many(self, prompts: List[List[int]], max_new_tokens: int = 16,
                    qclass: Optional[str] = None) -> List[Optional[int]]:
        name = qclass or self.sched.default_class
        reqs = []
        for p in prompts:
            reqs.append(Request(self._next_uid + len(reqs), list(p),
                                max_new_tokens, qclass=name))
        envs = self.sched.submit_many(name, reqs)
        self._next_uid += len(reqs)
        return [r.uid if e is not None else None for r, e in zip(reqs, envs)]

    # ---------------------------------------------------------------- step
    def step(self) -> List[Request]:
        """One group iteration: every live replica runs its own
        admit/decode step, then one steal pass rebalances starved
        replicas (dead hosts' engines are skipped — their lanes were
        evicted to exact seats by :meth:`fail_host`)."""
        self.step_count += 1
        done: List[Request] = []
        for eng in self.engines:
            if eng.sched.alive:
                done.extend(eng.step())
        self.replica_set.rebalance()
        return done

    def idle(self) -> bool:
        return (self.replica_set.pending() == 0
                and all(eng.ring_pending == 0 for eng in self.engines)
                and all(r is None for eng in self.engines
                        for r in eng.active))

    def run_until_idle(self, max_steps: int = 1000) -> Dict[int, Request]:
        for _ in range(max_steps):
            self.step()
            if self.idle():
                break
        return self.completed

    @property
    def completed(self) -> Dict[int, Request]:
        out: Dict[int, Request] = dict(self._completed)
        for eng in self.engines:
            out.update(eng.completed)
        return out

    # ------------------------------------------------------------- elasticity
    def resize(self, num_replicas: int) -> "EngineReplicaGroup":
        """Live replica elasticity: grow/shrink the running group to
        ``num_replicas`` engines with no drain pause. Every active lane is
        preempted to its exact class-cycle seat (it re-prefills on its next
        admission), the scheduler fabric reseats by a batch of seat claims,
        and the fabric-wide lane/page budgets are re-split over the new
        engine count. Per-class FIFO delivery order is preserved exactly."""
        n = int(num_replicas)
        assert n >= 1
        if n == self.num_replicas:
            return self
        for eng in self.engines:
            eng.flush_admission()  # ring entries back to exact seats
            for lane, req in enumerate(eng.active):
                if req is not None:
                    eng._evict_lane(lane)  # exact-seat requeue
            self._completed.update(eng.completed)
        self.replica_set.resize(n)
        self.num_replicas = n
        self.engines = self._build_engines()
        return self

    def fail_host(self, host: int) -> int:
        """Kill one transport host mid-run: every lane on the dead host's
        engines is preempted to its exact class-cycle seat (KV pages die
        with the host, the request re-prefills on its next admission),
        completed requests are carried, and the scheduler fabric replays
        the host's frontier state into the survivors. Returns the number
        of seats reassigned."""
        for eng in self.engines:
            if eng.sched.addr.host != host or not eng.sched.alive:
                continue
            eng.flush_admission()  # ring entries back to exact seats
            for lane, req in enumerate(eng.active):
                if req is not None:
                    eng._evict_lane(lane)  # exact-seat requeue
            self._completed.update(eng.completed)
        moved = self.replica_set.fail_host(host)
        # drop the dead engines: their KV pools die with the host and
        # step()/idle()/completed stop scanning them
        self.engines = [e for e in self.engines if e.sched.alive]
        return moved

    # ------------------------------------------------------------ checkpoint
    def sched_state(self) -> dict:
        """Exact-seat frontier snapshot of the serving fabric, taken
        between steps. Undrained seats are captured in place; requests
        currently *on a lane* are recorded at their original seats as
        requeue entries (their KV pages are not checkpointed — on restore
        they re-prefill, the preemption contract). The dict is plain JSON
        data: hand it to the async checkpointer's aux channel."""
        for eng in self.engines:
            eng.flush_admission()  # ring entries back to exact seats
        st = self.replica_set.state(encode=request_state)
        for eng in self.engines:
            for lane_env in eng._lane_env:
                if lane_env is None:
                    continue
                qc, env = lane_env
                st["classes"][qc.name]["requeue"].append(
                    [env.seq, env.stamp, request_state(env.payload)])
        for cs in st["classes"].values():
            cs["requeue"].sort(key=lambda rec: rec[0])
        st["next_uid"] = self._next_uid
        return st

    @classmethod
    def from_sched_state(cls, cfg: ModelConfig, params, state: dict, *,
                         policy="strict", min_steal: int = 1,
                         forward_fn=None, window: int = 4, transport=None,
                         **engine_kw) -> "EngineReplicaGroup":
        """Restore a replica group from :meth:`sched_state`: every tenant
        resumes at its exact FIFO seat (in-flight requests re-prefill),
        under whatever transport/host layout the restoring caller runs.
        Each class's shard CMPQueue configuration is restored from the
        snapshot itself; ``window`` here is only the KV pools' protection
        window. ``engine_kw`` takes the budgets and ``device``."""
        rs = ReplicaSet.from_state(
            state, decode=request_from_state, policy=policy,
            min_steal=min_steal, transport=transport)
        return cls(cfg, params, replica_set=rs, forward_fn=forward_fn,
                   window=window, uid_start=state.get("next_uid", 0),
                   **engine_kw)

    # ------------------------------------------------------------ telemetry
    def class_stats(self) -> dict:
        """Fabric-wide per-class roll-up, same ``{name: snap}`` shape as
        :meth:`Engine.class_stats`. Per-replica detail lives in
        :meth:`replica_stats`."""
        return self.replica_set.snapshot()["classes"]

    def replica_stats(self) -> dict:
        """Per-replica steal/idle/pending detail (domain counters only)."""
        return self.replica_set.snapshot()["replicas"]
