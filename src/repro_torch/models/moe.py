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

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.domain import window_admit
from repro_torch.parallel.sharding import Rows, view


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """Claims on each of ``e`` experts (``bincount``, which neither DTensor
    nor the meta device runs)."""
    return torch.zeros(e, dtype=ids.dtype, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def assign_slots(expert_ids: torch.Tensor, num_experts: int, capacity: int,
                 before: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIFO capacity-slot assignment.

    expert_ids: [A] integer (A = tokens*k, claim requests in token order).
    ``before`` [E]: the claims on each expert that come earlier in the
    global claim order than these (other ranks' tokens; none when None).
    Returns (slot [A] int32 in [0, E*C), or E*C where dropped; keep [A]
    bool). The j-th request for expert e gets slot (e, j); requests past
    capacity are dropped (the earliest claim wins)."""
    e = num_experts
    a = expert_ids.shape[0]
    ids = expert_ids.long()
    # a stable sort keeps token order within each expert: earliest-claim FIFO
    order = torch.argsort(ids, stable=True)
    cnt = _counts(ids, e)
    starts = torch.cumsum(cnt, 0) - cnt  # exclusive prefix
    pos_sorted = torch.arange(a, device=ids.device) - starts[ids[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    if before is not None:
        pos = pos + before.long()[ids]
    # bounded capacity IS the protection window (domain.window_admit)
    keep = window_admit(pos, capacity)
    slot = torch.where(keep, ids * capacity + pos, e * capacity)
    return slot.to(torch.int32), keep


def _expert_layout(xin, w):
    """The expert buffers [E, G*C, D], a Partial sum over the token shards
    when sharded, laid out for the products with ``w`` [E, D, F]: the
    experts split where ``w``'s are (EP), the slots over the other mesh
    dims of the token shards where they divide (a reduce-scatter), else
    replicated."""
    if not isinstance(xin, DTensor):
        return xin
    mesh = xin.device_mesh
    wp = w.placements if isinstance(w, DTensor) else [Replicate()] * mesh.ndim
    pl = [Shard(0) if wpl == Shard(0)
          else Shard(1) if xpl.is_partial() and xin.shape[1] % mesh.size(i) == 0
          else Replicate() for i, (wpl, xpl) in enumerate(zip(wp, xin.placements))]
    return xin.redistribute(mesh, pl)


def moe_block(x: torch.Tensor, p: dict, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, min_capacity: int = 8,
              act: str = "silu", groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D]; p: router [D, E] (float32), wg/wu [E, D, F], wd [E, F, D].
    Returns (y [B, S, D] in x's dtype, the load-balancing aux loss).

    ``groups`` > 1 dividing B: each group of B/groups sequences claims its
    own capacity (the reference vmaps the block over the groups); the
    claims key on (group, expert), the buffers stack the groups' slots
    behind each expert, and the aux loss is the mean of the groups'.

    On DTensors the routing and the claim run on each rank's tokens
    (:class:`~repro_torch.parallel.sharding.Rows`): the ranks all-gather
    their claims a (group, expert) and offset their positions by the
    claims of the ranks before them, so every claim gets the slot, and
    every drop, of the single-device step over the global token order.
    A rank fills the expert buffers with its own claims only, and the
    buffers are the sum over the ranks; the expert products are DTensor
    products under the weights' layout (EP or TP); each rank reads back
    its claims' outputs from the replicated buffers."""
    B, S, D = x.shape
    G = groups if groups > 1 and B % groups == 0 else 1
    T = B * S
    E, k = num_experts, top_k
    Tg = T // G
    # capacity over a group's global tokens; a host int from shapes
    capacity = min(Tg * k, max(min_capacity, int(Tg * k * capacity_factor / E)))
    xt = view(x, T, D)
    rows = Rows(xt)
    xl = rows.local(xt)
    Tl = xl.shape[0]

    # routing
    logits = xl.float() @ rows.whole(p["router"]).float()  # [Tl, E]
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # slot claim (CMP earliest-claim) keyed on (group, expert), in the
    # global token order (token-major = claim order)
    keys = ids.reshape(-1)
    if G > 1:
        group = (rows.index * Tl + torch.arange(Tl, device=xl.device)) // Tg
        keys = keys + (group * E).repeat_interleave(k)
    before = rows.before(_counts(keys, G * E)) if rows.n > 1 else None
    slot, _ = assign_slots(keys, G * E, capacity, before)
    slot = slot.long()

    # dispatch: gather this rank's token rows into [G*E*C, D] buffers; a
    # dropped claim writes the spare row G*E*C, and a slot this rank did
    # not claim reads token Tl, the zero row
    flat_token = torch.arange(Tl, device=xl.device).repeat_interleave(k)
    token_for_slot = torch.full((G * E * capacity + 1,), Tl, dtype=torch.long,
                                device=xl.device)
    token_for_slot[slot] = flat_token
    x_pad = torch.cat([xl, xl.new_zeros((1, D))])
    xin = x_pad[token_for_slot[:-1]].reshape(G, E, capacity, D).transpose(0, 1)
    xin = _expert_layout(rows.sum(xin.reshape(E, G * capacity, D)), p["wg"])

    # expert MLPs, batched over the experts
    g = torch.bmm(xin, p["wg"])
    u = torch.bmm(xin, p["wu"])
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    out_ec = torch.bmm(a * u, p["wd"])  # [E, G*C, D]

    # combine: each request's slot output (dropped -> the zero row), weighted,
    # summed over the token's k lanes in lane order
    out = rows.whole(out_ec).reshape(E, G, capacity, D).transpose(0, 1)
    out_pad = torch.cat([out.reshape(G * E * capacity, D), out.new_zeros((1, D))])
    per_req = out_pad[slot] * gates.reshape(-1, 1).to(out.dtype)
    per_req = per_req.view(Tl, k, D)
    y = per_req[:, 0]
    for lane in range(1, k):
        y = y + per_req[:, lane]

    # aux: the load-balancing loss term (Switch-style), a group's means over
    # its global tokens
    me = view(rows.wrap(probs), G, Tg, E).mean(dim=1)
    ce = view(rows.wrap(F.one_hot(ids[:, 0], E).float()), G, Tg, E).mean(dim=1)
    aux = (E * torch.sum(me * ce, dim=-1)).mean()
    return view(rows.wrap(y), B, S, D).to(x.dtype), aux
