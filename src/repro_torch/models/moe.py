"""Mixture-of-Experts with CMP-style capacity-slot dispatch, in torch: the
JAX package's ``models/moe.py`` (``assign_slots``, ``moe_block``), which
has no Pallas kernel. The expert products are batched matrix products over
the experts, as the reference leaves them to XLA.

Expert capacity slots are a cyclic slot pool: tokens claim slots in token
order (the earliest-claim FIFO property), claims past capacity drop
deterministically (bounded capacity = protection window), and every slot is
reclaimed each step. Where JAX and torch differ:

* routing ties: ``lax.top_k`` breaks ties to the lower expert index and
  ``torch.topk`` promises no order, so the top k are the first k of a
  stable descending sort;
* the router weight is float32 in every model; JAX promotes the product
  with it to float32, so the tokens are cast to float32 first;
* ``.at[...].set(..., mode="drop")`` lands the sentinel in a spare trailing
  row that is cut off;
* the combine ``.at[token].add`` sums each token's k lanes in lane order in
  the working dtype, without atomics, so the card gives the same bits run
  after run.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.domain import window_admit


def assign_slots(expert_ids: torch.Tensor, num_experts: int,
                 capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIFO capacity-slot assignment.

    expert_ids: [A] integer (A = tokens*k, claim requests in token order).
    Returns (slot [A] int32 in [0, E*C), or E*C where dropped; keep [A]
    bool). The j-th request for expert e gets slot (e, j); requests past
    capacity are dropped (the earliest claim wins)."""
    e = num_experts
    a = expert_ids.shape[0]
    ids = expert_ids.long()
    # a stable sort keeps token order within each expert: earliest-claim FIFO
    order = torch.argsort(ids, stable=True)
    cnt = torch.bincount(ids, minlength=e)
    starts = torch.cumsum(cnt, 0) - cnt  # exclusive prefix
    pos_sorted = torch.arange(a, device=ids.device) - starts[ids[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    # bounded capacity IS the protection window (domain.window_admit)
    keep = window_admit(pos, capacity)
    slot = torch.where(keep, ids * capacity + pos, e * capacity)
    return slot.to(torch.int32), keep


def moe_block(x: torch.Tensor, p: dict, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, min_capacity: int = 8,
              act: str = "silu", groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D]; p: router [D, E] (float32), wg/wu [E, D, F], wd [E, F, D].
    Returns (y [B, S, D] in x's dtype, the load-balancing aux loss)."""
    B, S, D = x.shape
    if groups > 1 and B % groups == 0:
        # group-local dispatch: each group of B/groups sequences claims its
        # own capacity (the reference vmaps the block over the groups)
        outs = [moe_block(xx, p, num_experts=num_experts, top_k=top_k,
                          capacity_factor=capacity_factor,
                          min_capacity=min_capacity, act=act, groups=1)
                for xx in x.reshape(groups, B // groups, S, D)]
        y = torch.stack([o[0] for o in outs]).reshape(B, S, D)
        return y, torch.stack([o[1] for o in outs]).mean()
    T = B * S
    E, k = num_experts, top_k
    xt = x.reshape(T, D)

    # routing
    logits = xt.float() @ p["router"].float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # slot claim (CMP earliest-claim); capacity is a host int from shapes
    capacity = min(T * k, max(min_capacity, int(T * k * capacity_factor / E)))
    slot, _ = assign_slots(ids.reshape(-1), E, capacity)  # token-major = claim order
    slot = slot.long()

    # dispatch: gather token rows into [E*C, D] expert buffers; a dropped
    # claim writes the spare row E*C, and an unclaimed slot reads token T,
    # the zero row
    flat_token = torch.arange(T, device=x.device).repeat_interleave(k)
    token_for_slot = torch.full((E * capacity + 1,), T, dtype=torch.long,
                                device=x.device)
    token_for_slot[slot] = flat_token
    x_pad = torch.cat([xt, xt.new_zeros((1, D))])
    xin = x_pad[token_for_slot[:-1]].reshape(E, capacity, D)

    # expert MLPs, batched over the experts
    g = torch.bmm(xin, p["wg"])
    u = torch.bmm(xin, p["wu"])
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    out_ec = torch.bmm(a * u, p["wd"])  # [E, C, D]

    # combine: each request's slot output (dropped -> the zero row), weighted,
    # summed over the token's k lanes in lane order
    out_pad = torch.cat([out_ec.reshape(E * capacity, D), out_ec.new_zeros((1, D))])
    per_req = out_pad[slot] * gates.reshape(-1, 1).to(out_ec.dtype)
    per_req = per_req.view(T, k, D)
    y = per_req[:, 0]
    for lane in range(1, k):
        y = y + per_req[:, lane]

    # aux: the load-balancing loss term (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, D).to(x.dtype), aux
