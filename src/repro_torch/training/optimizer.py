"""AdamW + schedules in torch, op for op the JAX package's
``training/optimizer.py`` in float32.

* the optimizer-moment dtype is configurable (bf16 moments for the largest
  models, as the llama4-maverick config asks);
* the state mirrors the params tree (nested dicts of tensors), with the
  step a 0-dim int32 tensor on the params' device, so a step reads nothing
  back to the host;
* global-norm clipping; cosine schedule with linear warmup.

:func:`apply_updates` updates the params and moments in place (the
counterpart of the reference's donated buffers). It and
:func:`global_norm` walk each leaf along its leading axis in slices of at
most ``SLICE`` elements (one layer of a stacked leaf), so their float32
temporaries stay a slice's size and not the leaf's: on Yi-6B a stacked MLP
leaf would need 5.8 GB for each. The update is elementwise, so slicing
changes none of its values; only the norm's sum runs in another order. A
DTensor leaf's norm is summed over its local shard in the same slices, so
on one rank the sharded step's norm, and so the step, is the plain step's
bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.tree import tree_leaves, tree_unflatten

SLICE = 1 << 25  # elements of one slice of a leaf (128 MiB of float32)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _slices(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Views of ``x`` along its leading axis, of at most SLICE elements
    each (at least one row). A DTensor is one slice: its leading axis may
    be sharded, where a split would gather it, and its shards are already
    a fraction of the leaf."""
    if x.dim() == 0 or x.numel() <= SLICE or isinstance(x, DTensor):
        return (x,)
    rows = max(1, SLICE // (x.numel() // x.shape[0]))
    return x.split(rows)


def init(params, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, iter([torch.zeros_like(p, dtype=dt) for p in leaves]))

    return OptState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                    mu=zeros(), nu=zeros())


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (int32 tensor), computed in float32."""
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 sum of squares, summed slice by slice. A DTensor's
    is its local shard's (a partial leaf summed over the ranks first), in
    the same slices, then summed over the mesh dims that split it: the
    same bits as the plain leaf's where the mesh is one rank."""
    if not isinstance(x, DTensor):
        return torch.stack([torch.sum(torch.square(s.float())) for s in _slices(x)]).sum()
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(placements=[Replicate() if p.is_partial() else p
                                       for p in x.placements])
    local = DTensor.from_local(_square_sum(x.to_local()), x.device_mesh,
                               [Partial() if p.is_shard() else Replicate() for p in x.placements],
                               run_check=False)
    return local.redistribute(placements=[Replicate()] * len(x.placements))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([_square_sum(x) for x in tree_leaves(tree)])))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig
                  ) -> Tuple[Any, OptState, dict]:
    """One AdamW step. Writes the new params and moments into ``params``,
    ``state.mu`` and ``state.nu`` and returns them with the next step and
    the metrics ``grad_norm`` and ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(state.step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                 tree_leaves(state.nu))
    for leaf in leaves:
        for p, g, mu, nu in zip(*map(_slices, leaf)):
            g = g.float() * scale
            mu32 = mu.float() * b1 + (1 - b1) * g
            nu32 = nu.float() * b2 + (1 - b2) * g * g
            mhat = mu32 / bc1
            nhat = nu32 / bc2
            delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            mu.copy_(mu32)
            nu.copy_(nu32)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
