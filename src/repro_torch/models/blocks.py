"""The dense and MoE decoder blocks: parameter initialisation, with the
JAX package's distributions (normal * 0.02, output projections scaled by
1/sqrt(2*num_layers), unit norm scales) drawn from a ``torch.Generator``,
and the full-sequence forward without a cache (``APPLY``, training).

The numbers differ from the JAX package's for the same seed (another
generator); the parity tests take the JAX package's weights through
:func:`repro_torch.bridge.params_from_numpy` instead.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _norm_params(cfg: ModelConfig, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=_dt(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_dt(cfg), device=device)
    return p


def _dense_init(gen: torch.Generator, shape, dtype, device, scale=0.02):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def _out_scale(cfg: ModelConfig) -> float:
    return 0.02 / max(1.0, (2 * cfg.num_layers) ** 0.5)


def _init_attn(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = _dt(cfg)
    return {
        "wq": _dense_init(gen, (D, H * hd), dt, device),
        "wk": _dense_init(gen, (D, KV * hd), dt, device),
        "wv": _dense_init(gen, (D, KV * hd), dt, device),
        "wo": _dense_init(gen, (H * hd, D), dt, device, _out_scale(cfg)),
    }


def _init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    dt = _dt(cfg)
    return {
        "wg": _dense_init(gen, (D, F), dt, device),
        "wu": _dense_init(gen, (D, F), dt, device),
        "wd": _dense_init(gen, (F, D), dt, device, _out_scale(cfg)),
    }


def init_dense(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Parameters of ONE dense layer."""
    return {
        "ln1": _norm_params(cfg, cfg.d_model, device),
        "attn": _init_attn(cfg, gen, device),
        "ln2": _norm_params(cfg, cfg.d_model, device),
        "mlp": _init_mlp(cfg, gen, device),
    }


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Parameters of ONE MoE layer: attention, then the experts. The router
    stays float32 whatever the model's dtype, as in the reference."""
    D, E, F = cfg.d_model, cfg.num_experts, cfg.expert_d_ff or cfg.d_ff
    dt = _dt(cfg)
    return {
        "ln1": _norm_params(cfg, D, device),
        "attn": _init_attn(cfg, gen, device),
        "ln2": _norm_params(cfg, D, device),
        "moe": {
            "router": _dense_init(gen, (D, E), torch.float32, device),
            "wg": _dense_init(gen, (E, D, F), dt, device),
            "wu": _dense_init(gen, (E, D, F), dt, device),
            "wd": _dense_init(gen, (E, F, D), dt, device, _out_scale(cfg)),
        },
    }


def _attention(x, p, cfg: ModelConfig) -> torch.Tensor:
    return L.attention_block(
        L.norm(x, p["ln1"], cfg.norm), p["attn"], num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window,
        softcap=cfg.attn_softcap, impl=cfg.attention_impl)


def apply_dense(x, p, cfg: ModelConfig):
    """One dense layer over x [B,S,D]: (x', aux 0.0 f32)."""
    x = x + _attention(x, p, cfg)
    x = x + L.swiglu(L.norm(x, p["ln2"], cfg.norm), p["mlp"], cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_moe(x, p, cfg: ModelConfig):
    """One MoE layer over x [B,S,D]: (x', the block's aux loss)."""
    x = x + _attention(x, p, cfg)
    y, aux = M.moe_block(L.norm(x, p["ln2"], cfg.norm), p["moe"],
                         num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                         capacity_factor=cfg.capacity_factor, act=cfg.act,
                         groups=cfg.moe_groups)
    return x + y, aux


INIT = {"dense": init_dense, "moe": init_moe}
APPLY = {"dense": apply_dense, "moe": apply_moe}
