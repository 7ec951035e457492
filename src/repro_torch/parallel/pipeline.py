"""Pipeline parallelism with CMP-windowed microbatch buffers, in torch.

The coordination problem in pipeline parallelism is buffer lifecycle: stage
s's activation output must stay alive until stage s+1 consumes it (and, for
training, until the backward pass revisits it), after which the buffer must
recycle — classically done with per-microbatch ready-flags and stage
barriers. The CMP mapping (DESIGN.md §2):

  * an activation buffer is *produced* (AVAILABLE, cycle = microbatch tick)
    when a stage writes it;
  * the consuming stage *claims* it (CLAIMED) — the claim IS the dataflow
    edge, no flag handshake;
  * claimed buffers recycle once outside the window W = pipeline depth
    (the number of in-flight microbatches) — a stalled stage can delay at
    most W buffers, never the pool.

The JAX package's ``parallel/pipeline.py`` on one process: the same 1F1B
planner (tick for tick), an executor guarding one
:mod:`repro_torch.core.slotpool` pool per stage boundary on the runner's
device, and ``jax.vjp`` replaced by a forward that records a graph on
detached leaves of the stage's params (and of its input activation), whose
backward ``torch.autograd.grad`` runs when the schedule's ``bwd`` tick
comes. An activation may be a tree (e.g. a ``(hidden, targets)`` pair, so
a language model's targets travel with it to the loss); its floating-point
tensors carry gradients, the rest passes through.

As in the reference, every microbatch is produced into boundary 0 before
the first tick, into ``window + extra_buffers`` slots, so ``num_micro >
window + extra_buffers`` stops with "buffer pool exhausted" (ROADMAP
Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import slotpool as sp
from repro_torch.core.domain import AVAILABLE, STATE_NAMES


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tick:
    kind: str        # "fwd" | "bwd"
    stage: int
    microbatch: int


def one_f_one_b(num_stages: int, num_micro: int) -> List[Tick]:
    """Classic 1F1B: warmup fwds, steady-state alternation, cooldown bwds.
    In-flight microbatches per stage never exceed num_stages (= window W).
    Emitted in global order as a time-stepped wavefront."""
    ticks: List[Tick] = []
    fwd_done = [0] * num_stages
    bwd_done = [0] * num_stages
    total = num_micro * num_stages
    while sum(fwd_done) + sum(bwd_done) < 2 * total:
        progressed = False
        for s in range(num_stages):
            warmup = min(num_stages - s, num_micro)
            can_fwd = (fwd_done[s] < num_micro
                       and (s == 0 or fwd_done[s] < fwd_done[s - 1])
                       and fwd_done[s] - bwd_done[s] < min(num_stages, num_micro))
            can_bwd = (bwd_done[s] < num_micro
                       and bwd_done[s] < fwd_done[s]
                       and (s == num_stages - 1 or bwd_done[s] < bwd_done[s + 1])
                       and fwd_done[s] >= min(warmup, num_micro))
            if can_bwd and (fwd_done[s] - bwd_done[s] >= min(warmup, num_micro)
                            or fwd_done[s] == num_micro):
                ticks.append(Tick("bwd", s, bwd_done[s]))
                bwd_done[s] += 1
                progressed = True
            elif can_fwd:
                ticks.append(Tick("fwd", s, fwd_done[s]))
                fwd_done[s] += 1
                progressed = True
        if not progressed:
            # drain any remaining legal bwd
            for s in range(num_stages - 1, -1, -1):
                if (bwd_done[s] < fwd_done[s]
                        and (s == num_stages - 1 or bwd_done[s] < bwd_done[s + 1])):
                    ticks.append(Tick("bwd", s, bwd_done[s]))
                    bwd_done[s] += 1
                    progressed = True
                    break
            if not progressed:
                raise RuntimeError("1F1B schedule deadlock (bug)")
        if all(f == num_micro for f in fwd_done) and all(b == num_micro for b in bwd_done):
            break
    return ticks


def max_in_flight(ticks: List[Tick], num_stages: int) -> int:
    """Peak outstanding (fwd-issued, bwd-incomplete) microbatches at stage 0
    == the protection window the buffer pool needs."""
    peak = cur = 0
    for t in ticks:
        if t.stage == 0 and t.kind == "fwd":
            cur += 1
            peak = max(peak, cur)
        if t.stage == 0 and t.kind == "bwd":
            cur -= 1
    return peak


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _live(tree) -> Tuple[Any, List[torch.Tensor]]:
    """``tree`` with each floating-point tensor replaced by a detached leaf
    that records the graph, and those leaves in flatten order."""
    live: List[torch.Tensor] = []

    def one(x):
        if not _is_float(x):
            return x
        x = x.detach().requires_grad_(True)
        live.append(x)
        return x

    return T.tree_map(one, tree), live


class PipelineRunner:
    """Runs stage_s(x[, params_s]) over a 1F1B schedule with activation
    buffers guarded by a CMP slot pool.

    stage_fns: list of callables (length = num_stages); ``forward`` calls
    each as ``f(x)``, ``train_grads`` as ``f(x, params_s)``.
    The runner checks every buffer access against the pool state: reading a
    recycled slot raises — i.e., the window invariant is *enforced*, not
    assumed. The pools live on ``device``.
    """

    def __init__(self, stage_fns: List, num_micro: int, *,
                 extra_buffers: int = 2, device="cuda"):
        self.stage_fns = stage_fns
        self.num_stages = len(stage_fns)
        self.num_micro = num_micro
        self.device = torch.device(device)
        self.ticks = one_f_one_b(self.num_stages, num_micro)
        self.window = max_in_flight(self.ticks, self.num_stages)
        # one ring per stage boundary: W slots + slack
        n_slots = self.window + extra_buffers
        self.pools = [sp.make(n_slots, self.device) for _ in range(self.num_stages + 1)]
        self.slot_of: List[Dict[int, int]] = [dict() for _ in range(self.num_stages + 1)]
        self.buffers: List[Dict[int, Any]] = [dict() for _ in range(self.num_stages + 1)]
        self.stats = {"fwd": 0, "bwd": 0, "reclaimed": 0, "peak_slots": 0}

    # ------------------------------------------------------------- buffers
    def _produce(self, boundary: int, micro: int, value) -> None:
        pool, ids, valid = sp.produce(self.pools[boundary], 1)
        if not bool(valid[0]):
            pool, ids, valid = sp.produce_with_reclaim(
                self.pools[boundary], 1, self.window)
            assert bool(valid[0]), (
                f"buffer pool exhausted at boundary {boundary}: the schedule "
                f"exceeded the protection window {self.window}")
        self.pools[boundary] = pool
        slot = int(ids[0])
        self.slot_of[boundary][micro] = slot
        self.buffers[boundary][slot] = value
        used = sp.counts(self.pools[boundary])
        self.stats["peak_slots"] = max(self.stats["peak_slots"],
                                       used["available"] + used["claimed"])

    def _consume(self, boundary: int, micro: int):
        slot = self.slot_of[boundary][micro]
        state = int(self.pools[boundary].state[slot])
        assert state == AVAILABLE, (
            f"UAF: microbatch {micro} buffer at boundary {boundary} was "
            f"recycled (state={STATE_NAMES.get(state, state)}) — window violation")
        value = self.buffers[boundary][slot]
        self.pools[boundary] = sp.claim_ids(
            self.pools[boundary],
            torch.tensor([slot], dtype=torch.int32, device=self.device),
            torch.tensor([True], device=self.device))
        # claimed buffers recycle once the window slides past them
        self.pools[boundary], n = sp.reclaim(self.pools[boundary], self.window)
        self.stats["reclaimed"] += int(n)
        return value

    # ------------------------------------------------------------- run
    def forward(self, microbatches: List[Any]) -> List[Any]:
        """Forward-only pipeline (serving/eval). Returns per-micro outputs."""
        assert len(microbatches) == self.num_micro
        outs: Dict[int, Any] = {}
        for m, x in enumerate(microbatches):
            self._produce(0, m, x)
        for t in self.ticks:
            if t.kind != "fwd":
                continue
            x = self._consume(t.stage, t.microbatch)
            y = self.stage_fns[t.stage](x)
            self.stats["fwd"] += 1
            if t.stage + 1 < self.num_stages:
                self._produce(t.stage + 1, t.microbatch, y)
            else:
                outs[t.microbatch] = y
        return [outs[m] for m in range(self.num_micro)]

    def train_grads(self, params_stages: List[Any], microbatches: List[Any],
                    loss_fn) -> Tuple[List[Any], torch.Tensor]:
        """Full 1F1B with backward: returns (per-stage grads summed over
        microbatches, mean loss). Numerically identical to non-pipelined
        accumulation (validated in tests). ``loss_fn(y)`` takes the last
        stage's output alone."""
        num_s = self.num_stages
        fwd_cache: Dict[Tuple[int, int], Any] = {}
        grads: List[Any] = [None] * num_s
        dlosses: Dict[int, List[torch.Tensor]] = {}
        cot: Dict[Tuple[int, int], List[torch.Tensor]] = {}  # cotangent flowing backward
        losses = []
        for m, x in enumerate(microbatches):
            self._produce(0, m, x)

        for t in self.ticks:
            s, m = t.stage, t.microbatch
            if t.kind == "fwd":
                x, x_live = _live(self._consume(s, m))
                p, p_live = _live(params_stages[s])
                y = self.stage_fns[s](x, p)
                self.stats["fwd"] += 1
                if s + 1 < num_s:
                    fwd_cache[(s, m)] = (y, p_live, x_live)
                    self._produce(s + 1, m, T.tree_map(
                        lambda v: v.detach() if _is_float(v) else v, y))
                else:
                    # value_and_grad(loss_fn)(y), on y's own leaves
                    y_in, y_live = _live(y)
                    loss = loss_fn(y_in)
                    dlosses[m] = list(torch.autograd.grad(loss, y_live))
                    losses.append(loss.detach())
                    fwd_cache[(s, m)] = (y, p_live, x_live)
            else:  # bwd
                g_out = dlosses.pop(m) if s == num_s - 1 else cot.pop((s + 1, m))
                y, p_live, x_live = fwd_cache.pop((s, m))
                outs = [v for v in T.tree_leaves(y) if _is_float(v)]
                want = p_live + (x_live if s > 0 else [])
                got = torch.autograd.grad(outs, want, grad_outputs=g_out,
                                          allow_unused=True)
                got = [torch.zeros_like(w) if g is None else g for g, w in zip(got, want)]
                g_params = got[:len(p_live)]
                if grads[s] is None:
                    grads[s] = g_params
                else:
                    for acc, g in zip(grads[s], g_params):
                        acc.add_(g)
                if s > 0:
                    cot[(s, m)] = got[len(p_live):]
                self.stats["bwd"] += 1
        grads = [None if g is None else T.tree_unflatten(params_stages[s], iter(g))
                 for s, g in enumerate(grads)]
        return grads, torch.stack(losses).mean()
