"""Model parameters, the full-sequence forward, the loss and the decode
path (``init_cache`` -> ``prefill`` -> ``decode_step``), in torch, for
every block kind (dense / moe / mlstm / slstm / hymba).

The parameter tree has the JAX package's key paths: ``embed``,
``final_norm.scale``, ``blocks.<j>.<block params>`` with a leading
layer-stack dim, and ``lm_head``. The cache tree has the JAX package's
structure too: ``blocks.<j>`` stacked per pattern position (``KVCache``
NamedTuples, hymba's ``(kv, state)`` pairs, the recurrent state tuples)
and a shared ``pos`` [B] int32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import per_batch_shard, vocab_nll


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
        stacked = None
        for i in range(r):
            one = B.INIT[kind](cfg, generator, device)
            if stacked is None:
                stacked = T.tree_map(lambda x: x.new_empty((r,) + x.shape), one)
            T.tree_map(lambda dst, src: dst[i].copy_(src), stacked, one)
        blocks[str(j)] = stacked
    params["blocks"] = blocks
    if not cfg.tie_embeddings:
        params["lm_head"] = B._dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                          dt, device)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in T.tree_leaves(params))


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
    parts = [x.unbind(0) for x in T.tree_leaves(tree)]
    return [T.tree_unflatten(tree, (p[i] for p in parts)) for i in range(r)]


def _stack(trees: list):
    """The inverse of :func:`_unstack`: one tree with a leading layer dim."""
    return T.tree_map(lambda *xs: torch.stack(xs), *trees)


@per_batch_shard(whole=("table",))
def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def _embed(params, tokens: torch.Tensor, extra_embeds=None) -> torch.Tensor:
    # a DTensor table is gathered whole and looked up on each batch shard
    x = _lookup(tokens, params["embed"])
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def apply(params, tokens: torch.Tensor, cfg: ModelConfig, *,
          extra_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over tokens [B, S] (after ``extra_embeds`` [B,
    n_extra, D], the frontend stubs' embeddings, when given). Returns
    (logits [B, n_extra + S, V] float32, the summed aux loss). With
    ``cfg.remat`` each repeat of the block pattern is recomputed in the
    backward, as the reference's ``jax.checkpoint`` of its scan body."""
    x = _embed(params, tokens, extra_embeds)
    r = cfg.pattern_repeats
    stacks = [_unstack(params["blocks"][str(j)], r) for j in range(len(cfg.block_pattern))]

    def super_fn(x, layer_p):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(cfg.block_pattern):
            x, a, _ = B.APPLY[kind](x, layer_p[j], cfg)
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


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cuda") -> Dict[str, Any]:
    """Empty caches stacked per pattern position, and a shared position
    counter ``pos`` [B] int32."""
    r = cfg.pattern_repeats
    blocks = {str(j): _stack([B.init_cache_kind(kind, cfg, batch, seq_len, device)] * r)
              for j, kind in enumerate(cfg.block_pattern)}
    return {"blocks": blocks, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _run_with_cache(params, x, cfg: ModelConfig, cache, positions):
    """Every layer over x with its cache; returns (final-normed x, the new
    stacked block caches)."""
    r, n = cfg.pattern_repeats, len(cfg.block_pattern)
    stacks = [_unstack(params["blocks"][str(j)], r) for j in range(n)]
    caches = [_unstack(cache["blocks"][str(j)], r) for j in range(n)]
    new = [[] for _ in range(n)]
    for i in range(r):
        for j, kind in enumerate(cfg.block_pattern):
            x, _, nc = B.APPLY[kind](x, stacks[j][i], cfg, positions=positions,
                                     cache=caches[j][i])
            new[j].append(nc)
    x = L.norm(x, params["final_norm"], cfg.norm)
    return x, {str(j): _stack(new[j]) for j in range(n)}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache, *,
            extra_embeds: Optional[torch.Tensor] = None):
    """Process a prompt (after ``extra_embeds``, when given) from the
    cache's positions on, filling the cache. Returns (last-position logits
    [B, V] f32, new cache); the old cache is left as it was."""
    x = _embed(params, tokens, extra_embeds)
    S = x.shape[1]
    positions = cache["pos"][:, None] + torch.arange(S, dtype=torch.int32,
                                                     device=x.device)[None, :]
    x, new_blocks = _run_with_cache(params, x, cfg, cache, positions)
    logits = _logits(x[:, -1:], params, cfg)[:, 0]
    return logits, {"blocks": new_blocks, "pos": cache["pos"] + S}


def decode_step(params, tokens: torch.Tensor, cfg: ModelConfig, cache):
    """One-token decode. tokens [B, 1] -> (logits [B, V] f32, new cache)."""
    x = _embed(params, tokens)
    x, new_blocks = _run_with_cache(params, x, cfg, cache, cache["pos"][:, None])
    logits = _logits(x, params, cfg)[:, 0]
    return logits, {"blocks": new_blocks, "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


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
    nll = vocab_nll(logits, targets)
    loss = torch.mean(nll)
    metrics = {"loss": loss, "aux_loss": aux,
               "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
    return loss + aux_weight * aux, metrics
