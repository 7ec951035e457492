"""Model parameters and the logits head, in torch.

The parameter tree has the JAX package's key paths: ``embed``,
``final_norm.scale``, ``blocks.<j>.{ln1,attn,ln2,mlp}.*`` with a leading
layer-stack dim, and ``lm_head``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B


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


def _logits(x: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    """Working-dtype product with the head, then f32 (as the reference)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()
