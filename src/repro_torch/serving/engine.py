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
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sched import Envelope, QueueClass, Scheduler
from repro_torch.serving.admission import DeviceAdmissionRing, resolve_device_admission
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.paged_model import paged_forward


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


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
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
        self.device = _device(device)
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
        if not both[1].all():
            self.pool.retire(ids)  # return partial grab
            return None
        return both[0]

    def _retire_request(self, lane: int) -> None:
        used = (int(self.seq_lens[lane]) + self.page_size - 1) // self.page_size
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
        batch = self._drain_admission(len(free))
        for idx, (lane, (qc, env)) in enumerate(zip(free, batch)):
            req: Request = env.payload
            need = (len(req.prompt) + self.page_size - 1) // self.page_size
            pages = self._alloc_pages(max(1, need))
            while pages is None:
                if not self._preempt_for(qc.priority, env.stamp):
                    # Pool dry, nothing less entitled to evict: every request
                    # not yet laned goes back to its own class seat.
                    for qc2, env2 in batch[idx:]:
                        qc2.requeue(env2)
                    return
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
            if rec is not None and rec.sampled(env.seq):
                rec.emit("lane_prefill", qc.name, env.seq, arg=lane)

    def _grow_pages(self) -> None:
        """Allocate fresh pages for every lane whose next token crosses a page
        boundary — one batched allocation for all of them (pool pressure
        triggers preemption, paper Alg 1 Phase 1)."""
        sl = self.seq_lens.cpu().numpy()
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
        self.step_count += 1
        self.pool.tick(self.step_count)
        self._admit()
        self._grow_pages()
        active_np = np.array([r is not None for r in self.active])
        if not active_np.any():
            return []
        # Decode all lanes in one call on the device-resident tables.
        logits, self.pool.k_pages, self.pool.v_pages = self._forward(
            self.params, self.last_tok[:, None], self.pool.k_pages,
            self.pool.v_pages, self.block_tables, self.seq_lens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        mask = torch.from_numpy(active_np).to(self.device)
        self.seq_lens += mask.to(torch.int32)
        self.last_tok = torch.where(mask, nxt, self.last_tok)
        # single host sync per step for completion bookkeeping
        nxt_np, sl_np = torch.stack([nxt, self.seq_lens]).cpu().numpy()
        done = []
        rec = self._obs
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
