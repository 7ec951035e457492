"""Decoder block variants (dense / moe / mlstm / slstm / hymba) with the
JAX package's uniform interface:

  INIT[kind](cfg, generator, device)            -> params of ONE layer
  APPLY[kind](x, p, cfg, positions=, cache=)    -> (x', aux loss, new cache)

Parameters have the JAX package's distributions (normal * 0.02, output
projections scaled by 1/sqrt(2*num_layers), unit norm scales) drawn from a
``torch.Generator``; the numbers differ from the JAX package's for the same
seed (another generator), so the parity tests take the JAX package's
weights through :func:`repro_torch.bridge.params_from_numpy` instead.
Without a cache a block runs the full sequence (training); with one it
prefills or decodes, and returns the kind's new cache
(:func:`init_cache_kind`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


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


def _attention(x, p, cfg: ModelConfig, positions, cache):
    return L.attention_block(
        x, p, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        sliding_window=cfg.sliding_window, softcap=cfg.attn_softcap,
        positions=positions, cache=cache, impl=cfg.attention_impl,
        chunk_kv=cfg.attn_chunk_kv, kv_block_axis=cfg.kv_block_axis)


def _no_aux(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def apply_dense(x, p, cfg: ModelConfig, positions=None, cache=None):
    """One dense layer over x [B,S,D]: (x', aux 0.0 f32, new cache)."""
    h, new_cache = _attention(L.norm(x, p["ln1"], cfg.norm), p["attn"], cfg,
                              positions, cache)
    x = x + h
    x = x + L.swiglu(L.norm(x, p["ln2"], cfg.norm), p["mlp"], cfg.act)
    return x, _no_aux(x), new_cache


def apply_moe(x, p, cfg: ModelConfig, positions=None, cache=None):
    """One MoE layer over x [B,S,D]: (x', the block's aux loss, new cache)."""
    h, new_cache = _attention(L.norm(x, p["ln1"], cfg.norm), p["attn"], cfg,
                              positions, cache)
    x = x + h
    y, aux = M.moe_block(L.norm(x, p["ln2"], cfg.norm), p["moe"],
                         num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                         capacity_factor=cfg.capacity_factor, act=cfg.act,
                         groups=cfg.moe_groups)
    return x + y, aux, new_cache


# ---------------------------------------------------------------------------
# mlstm / slstm (xLSTM)
# ---------------------------------------------------------------------------


def _ssm_heads(cfg: ModelConfig) -> int:
    return cfg.ssm_heads or cfg.num_heads


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    D, H, dt = cfg.d_model, _ssm_heads(cfg), _dt(cfg)
    return {
        "ln1": _norm_params(cfg, D, device),
        "mlstm": {
            "wq": _dense_init(gen, (D, D), dt, device),
            "wk": _dense_init(gen, (D, D), dt, device),
            "wv": _dense_init(gen, (D, D), dt, device),
            "wi": _dense_init(gen, (D, H), dt, device),
            "wf": _dense_init(gen, (D, H), dt, device),
            "ogate": _dense_init(gen, (D, D), dt, device),
            "wo": _dense_init(gen, (D, D), dt, device, _out_scale(cfg)),
        },
    }


def apply_mlstm(x, p, cfg: ModelConfig, positions=None, cache=None):
    h, new_state = S.mlstm_block(L.norm(x, p["ln1"], cfg.norm), p["mlstm"],
                                 num_heads=_ssm_heads(cfg), state=cache)
    return x + h, _no_aux(x), new_state


def init_slstm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    D, H, dt = cfg.d_model, _ssm_heads(cfg), _dt(cfg)
    hd = D // H
    p = {k: _dense_init(gen, (D, D), dt, device) for k in ("wz", "wi", "wf", "wo")}
    p.update({k: _dense_init(gen, (H, hd, hd), dt, device) for k in ("rz", "ri", "rf", "ro")})
    p["wout"] = _dense_init(gen, (D, D), dt, device, _out_scale(cfg))
    return {"ln1": _norm_params(cfg, D, device), "slstm": p}


def apply_slstm(x, p, cfg: ModelConfig, positions=None, cache=None):
    h, new_state = S.slstm_block(L.norm(x, p["ln1"], cfg.norm), p["slstm"],
                                 num_heads=_ssm_heads(cfg), state=cache)
    return x + h, _no_aux(x), new_state


# ---------------------------------------------------------------------------
# hymba (parallel attention + mamba heads, fused by the mean of normed outputs)
# ---------------------------------------------------------------------------


def init_hymba(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Parameters of ONE hymba layer. ``mamba.a_log`` and ``mamba.d_skip``
    are float32 whatever the model's dtype, as in the reference."""
    D, H, P, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Di = H * P
    dt = _dt(cfg)
    return {
        "ln1": _norm_params(cfg, D, device),
        "attn": _init_attn(cfg, gen, device),
        "mamba": {
            "win": _dense_init(gen, (D, 2 * Di + 2 * H * N + H), dt, device),
            "a_log": torch.zeros((H,), dtype=torch.float32, device=device),
            "d_skip": torch.ones((H,), dtype=torch.float32, device=device),
            "wout": _dense_init(gen, (Di, D), dt, device, _out_scale(cfg)),
        },
        "norm_attn": _norm_params(cfg, D, device),
        "norm_ssm": _norm_params(cfg, D, device),
        "ln2": _norm_params(cfg, D, device),
        "mlp": _init_mlp(cfg, gen, device),
    }


def apply_hymba(x, p, cfg: ModelConfig, positions=None, cache=None):
    """Attention and the Mamba branch side by side on the same normed
    input. The cache is (KV ring, SSM state); the Mamba branch decodes a
    step at a time only with a cache and one token."""
    xin = L.norm(x, p["ln1"], cfg.norm)
    kv_cache = cache[0] if cache is not None else None
    ssm_state = cache[1] if cache is not None else None
    attn_out, new_kv = _attention(xin, p["attn"], cfg, positions, kv_cache)
    ssm_out, new_state = S.mamba_block(
        xin, p["mamba"], num_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state,
        chunk=cfg.ssd_chunk, state=ssm_state,
        decode=cache is not None and x.shape[1] == 1)
    fused = 0.5 * (L.norm(attn_out, p["norm_attn"], cfg.norm)
                   + L.norm(ssm_out, p["norm_ssm"], cfg.norm))
    x = x + fused
    x = x + L.swiglu(L.norm(x, p["ln2"], cfg.norm), p["mlp"], cfg.act)
    new_cache = (new_kv, new_state) if cache is not None else None
    return x, _no_aux(x), new_cache


# ---------------------------------------------------------------------------
# registry + cache builders
# ---------------------------------------------------------------------------

INIT = {"dense": init_dense, "moe": init_moe, "mlstm": init_mlstm,
        "slstm": init_slstm, "hymba": init_hymba}
APPLY = {"dense": apply_dense, "moe": apply_moe, "mlstm": apply_mlstm,
         "slstm": apply_slstm, "hymba": apply_hymba}


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring size: sliding-window archs keep only the window."""
    if cfg.sliding_window > 0:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache_kind(kind: str, cfg: ModelConfig, batch: int, seq_len: int, device):
    """The empty cache of ONE layer of ``kind``: a KV ring (dense, moe), the
    recurrent state (mlstm, slstm), or both (hymba)."""
    if kind in ("dense", "moe", "hymba"):
        kv = L.make_kv_cache(batch, cache_len(cfg, seq_len), cfg.num_kv_heads,
                             cfg.resolved_head_dim, _dt(cfg), device)
        if kind != "hymba":
            return kv
        return (kv, S.mamba_init_state(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state, device))
    H = _ssm_heads(cfg)
    if kind == "mlstm":
        return S.mlstm_init_state(batch, H, cfg.d_model // H, device)
    if kind == "slstm":
        return S.slstm_init_state(batch, H, cfg.d_model // H, device)
    raise ValueError(f"unknown block kind {kind!r}")
