"""Model building blocks in torch: norms, RoPE, GQA attention (causal
self-attention for training, attention over a cache), SwiGLU MLP. Twins of
the JAX package's ``models/layers.py`` functions of the same names, with
its layouts ([B, S, H, hd] activations, r-major GQA).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, num_heads, head_dim]; positions: [B, S]. Rotates the two
    halves of the head (not interleaved pairs), as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q:[B,S,H,hd] k,v:[B,T,KV,hd] mask broadcastable to [B,rep,KV,S,T].
    r-major GQA: query head h uses KV head h % KV. The logits come out of a
    working-dtype product and are cast to f32; the weights are cast back to
    v's dtype before the PV product, as in the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qh = q.reshape(B, S, rep, KV, hd)
    logits = torch.einsum("bsrgd,btgd->brgst", qh, k).float()
    logits = logits / math.sqrt(hd)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("brgst,btgd->bsrgd", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def self_attention(q, k, v, *, sliding_window: int = 0, softcap: float = 0.0,
                   impl: str = "ref"):
    """Causal self-attention over equal-length q/k/v (training), through
    :func:`_sdpa` with the reference's mask. The reference's ``pallas``
    branch (its forward-only flash kernel) is not ported: no config selects
    it and the reference cannot differentiate it."""
    if impl == "pallas":
        raise NotImplementedError(
            "attention_impl='pallas' is the reference's forward-only flash kernel, "
            "which has no gradient; training attends through the plain path")
    S, T = q.shape[1], k.shape[1]
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = q_pos >= k_pos
    if sliding_window > 0:
        mask = mask & (q_pos - k_pos < sliding_window)
    return _sdpa(q, k, v, mask[None, None, None], softcap=softcap)


def project_qkv(x, p: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                positions: torch.Tensor, rope_theta: float):
    """q [B,S,H,hd] and k, v [B,S,KV,hd] of x [B,S,D]; RoPE on q and k at
    ``positions`` [B,S]."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(B, S, num_kv_heads, head_dim)
    return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v


def attention_block(x, p: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    rope_theta: float, sliding_window: int = 0, softcap: float = 0.0,
                    impl: str = "ref") -> torch.Tensor:
    """The reference's ``attention_block`` without a cache (training): RoPE
    at positions ``arange(S)``, causal self-attention, the output
    projection. x [B,S,D] -> [B,S,D]."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = project_qkv(x, p, num_heads=num_heads, num_kv_heads=num_kv_heads,
                          head_dim=head_dim, positions=positions, rope_theta=rope_theta)
    out = self_attention(q, k, v, sliding_window=sliding_window, softcap=softcap,
                         impl=impl)
    return out.reshape(B, S, num_heads * head_dim) @ p["wo"]


def cache_attention(q, k, v, q_pos, k_pos, *, sliding_window: int = 0,
                    softcap: float = 0.0):
    """q [B,S,H,hd]; k,v [B,T,KV,hd] cache contents; q_pos [B,S] absolute
    query positions; k_pos [B,T] absolute slot positions (-1 invalid)."""
    mask = (k_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= k_pos[:, None, :])
    if sliding_window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < sliding_window)
    return _sdpa(q, k, v, mask[:, None, None], softcap=softcap)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, p: dict, act: str = "silu") -> torch.Tensor:
    """Gated MLP: wg/wu [D, F], wd [F, D]. ``gelu`` is the tanh
    approximation, which is what ``jax.nn.gelu`` computes by default."""
    g = x @ p["wg"]
    u = x @ p["wu"]
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ p["wd"]
