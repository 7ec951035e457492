"""Model parameters, the full-sequence forward and the loss, in torch.

The parameter tree has the JAX package's key paths: ``embed``,
``final_norm.scale``, ``blocks.<j>.{ln1,attn,ln2,mlp}.*`` with a leading
layer-stack dim, and ``lm_head``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights made on ``device`` from ``generator`` (whose device
    must match). Each stacked leaf is allocated once at its final dtype and
    filled one layer at a time, so the f32 draws never exceed one layer."""
    dt = B._dt(cfg)
    embed = B._dense_init(generator, (cfg.vocab_size, cfg.d_model), dt, device)
    params: Dict[str, Any] = {
        "embed": embed,
        "final_norm": B._norm_params(cfg, cfg.d_model, device),
    }
    r = cfg.pattern_repeats
    blocks = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind not in B.INIT:
            raise NotImplementedError(f"block kind {kind!r} is not ported yet")
        stacked = None
        for i in range(r):
            one = B.INIT[kind](cfg, generator, device)
            if stacked is None:
                stacked = _tree_map(lambda x: x.new_empty((r,) + x.shape), one)
            _tree_zip(lambda dst, src: dst[i].copy_(src), stacked, one)
        blocks[str(j)] = stacked
    params["blocks"] = blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = B._dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                          dt, device)
    return params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def active_param_count(cfg: ModelConfig, params) -> int:
    """Active params per token (MoE: top_k of num_experts routed)."""
    total = param_count(params)
    if cfg.num_experts == 0:
        return total
    expert = 0
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "moe":
            sub = params["blocks"][str(j)]["moe"]
            expert += sum(x.numel() for k, x in sub.items() if k != "router")
    active_frac = cfg.num_experts_per_tok / cfg.num_experts
    return int(total - expert + expert * active_frac)


def _logits(x: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    """Working-dtype product with the head, then f32 (as the reference)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _unstack(tree, r: int) -> list:
    """The ``r`` per-layer trees of a stacked tree, each leaf taken apart
    once with ``unbind``. Indexing the leaf a layer at a time would, under
    autograd, write a zero tensor the size of the whole leaf for every
    layer in the backward; one ``unbind`` has one ``stack`` there."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, r) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(r)]
    return list(tree.unbind(0))


def apply(params, tokens: torch.Tensor, cfg: ModelConfig, *,
          extra_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over tokens [B, S] (after ``extra_embeds`` [B,
    n_extra, D], the frontend stubs' embeddings, when given). Returns
    (logits [B, n_extra + S, V] float32, the summed aux loss). With
    ``cfg.remat`` each repeat of the block pattern is recomputed in the
    backward, as the reference's ``jax.checkpoint`` of its scan body."""
    for kind in cfg.block_pattern:
        if kind not in B.APPLY:
            raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    x = params["embed"][tokens.long()]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    r = cfg.pattern_repeats
    stacks = [_unstack(params["blocks"][str(j)], r) for j in range(len(cfg.block_pattern))]

    def super_fn(x, layer_p):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(cfg.block_pattern):
            x, a = B.APPLY[kind](x, layer_p[j], cfg)
            aux = aux + a
        return x, aux

    auxs = []
    for i in range(r):
        layer_p = [stack[i] for stack in stacks]
        if cfg.remat:
            x, a = checkpoint(super_fn, x, layer_p, use_reentrant=False)
        else:
            x, a = super_fn(x, layer_p)
        auxs.append(a)
    x = L.norm(x, params["final_norm"], cfg.norm)
    return _logits(x, params, cfg), torch.stack(auxs).sum()


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_weight: float = 0.01):
    """Next-token cross-entropy. batch: {"tokens": [B, S]} (+"extra_embeds").
    The loss is taken on token positions only (frontend embeds are
    unlabelled). Returns (loss + aux_weight * aux, metrics)."""
    tokens = batch["tokens"]
    extra = batch.get("extra_embeds")
    logits, aux = apply(params, tokens[:, :-1], cfg, extra_embeds=extra)
    n_extra = 0 if extra is None else extra.shape[1]
    logits = logits[:, n_extra:]
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    metrics = {"loss": loss, "aux_loss": aux,
               "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    return loss + aux_weight * aux, metrics
