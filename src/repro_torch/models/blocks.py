"""Parameter initialisation of the dense decoder block, with the JAX
package's distributions (normal * 0.02, output projections scaled by
1/sqrt(2*num_layers), unit norm scales) drawn from a ``torch.Generator``.

The numbers differ from the JAX package's for the same seed (another
generator); the parity tests take the JAX package's weights through
:func:`repro_torch.bridge.params_from_numpy` instead.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


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


INIT = {"dense": init_dense}
