"""Model building blocks in torch: norms, RoPE, GQA attention (causal
self-attention, attention over a ring-buffer KV cache, online-softmax
attention over the cache in KV blocks), SwiGLU MLP. Twins of the JAX
package's ``models/layers.py`` functions of the same names, with its
layouts ([B, S, H, hd] activations, r-major GQA).

KV caches carry an explicit per-slot position array, so a ring-buffer
cache (sliding-window attention) and a linear cache are the same code
path: a slot whose position falls out of the window is reclaimed by the
next insert.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import per_batch_shard, per_head_shard, view

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


@per_head_shard
def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q:[B,S,H,hd] k,v:[B,T,KV,hd] mask broadcastable to [B,rep,KV,S,T].
    r-major GQA: query head h uses KV head h % KV. The logits come out of a
    working-dtype product and are cast to f32; the weights are cast back to
    v's dtype before the PV product, as in the reference. On DTensors it
    runs on each rank's batch shard and heads (``sharding.per_head_shard``)."""
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
    """Causal self-attention over equal-length q/k/v (training and prefill).
    ``impl="pallas"`` without a softcap runs the flash kernel (its plain
    version on a CPU tensor), as the reference runs its Pallas kernel;
    otherwise :func:`_sdpa` with the reference's mask. The flash kernel has
    no backward (nor has the reference's a VJP), so the pallas route refuses
    inputs that record a graph."""
    if impl == "pallas" and softcap == 0.0:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "attention_impl='pallas' runs the flash kernel, which has no backward "
                "(the reference's kernel has no VJP either); train with "
                "attention_impl='ref'")
        return kops.flash_attention(q, k, v, causal=True, sliding_window=sliding_window)
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
    q = view(x @ p["wq"], B, S, num_heads, head_dim)
    k = view(x @ p["wk"], B, S, num_kv_heads, head_dim)
    v = view(x @ p["wv"], B, S, num_kv_heads, head_dim)
    return apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta), v


def cache_attention(q, k, v, q_pos, k_pos, *, sliding_window: int = 0,
                    softcap: float = 0.0):
    """q [B,S,H,hd]; k,v [B,T,KV,hd] cache contents; q_pos [B,S] absolute
    query positions; k_pos [B,T] absolute slot positions (-1 invalid)."""
    mask = (k_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= k_pos[:, None, :])
    if sliding_window > 0:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < sliding_window)
    return _sdpa(q, k, v, mask[:, None, None], softcap=softcap)


@per_head_shard(seq_args=(0,))
def chunked_cache_attention(q, k, v, q_pos, k_pos, *, sliding_window: int = 0,
                            softcap: float = 0.0, block_k: int = 1024):
    """Online-softmax attention over the cache in KV blocks of ``block_k``:
    an O(S * block_k) working set instead of O(S * T), forward only (the
    prefill path). The running max starts at -1e30 and a masked
    probability is 0, as in the reference, so a row that sees no slot is
    0. On CPU and ``meta`` tensors it is the reference's loop (the cache
    padded to whole blocks with slots at position -1; its ``unroll`` has no
    counterpart); on CUDA tensors one kernel launch over the whole ring
    (``kernels/cache_attention.py``; ``block_k`` orders only the loop's
    sums; no backward, as the reference's loop has none). On DTensors it runs
    on each rank's batch shard and heads; with ``kv_block_axis=`` a mesh
    axis name, the queries and the running softmax state are split over
    that axis along the sequence and each KV block is read whole, as the
    reference lays them out (``sharding.per_head_shard``; no-op for plain
    tensors)."""
    return kops.chunked_cache_attention(q, k, v, q_pos, k_pos, sliding_window=sliding_window,
                                        softcap=softcap, block_k=block_k)


def kv_chunks(seq: int, t_cache: int, block_k: int) -> int:
    """Number of chunked-attention KV blocks (0 = the direct path); the
    dispatch condition of :func:`attention_block`."""
    if block_k <= 0 or seq <= 1 or t_cache <= block_k:
        return 0
    return -(-t_cache // block_k)


class KVCache(NamedTuple):
    k: torch.Tensor    # [B, T, KV, hd]
    v: torch.Tensor    # [B, T, KV, hd]
    pos: torch.Tensor  # [B, T] int32, -1 = empty slot


def make_kv_cache(batch: int, t_cache: int, num_kv: int, head_dim: int, dtype,
                  device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, t_cache, num_kv, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, t_cache, num_kv, head_dim), dtype=dtype, device=device),
        pos=torch.full((batch, t_cache), -1, dtype=torch.int32, device=device),
    )


def cache_insert(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """A new cache with S entries written at ring slots ``positions % T``
    (the old one is left as it was). When S >= T only the last T entries
    survive."""
    S, T = positions.shape[1], cache.k.shape[1]
    if S >= T:
        k_new, v_new, positions = k_new[:, -T:], v_new[:, -T:], positions[:, -T:]
    return KVCache(*_ring_write(*cache, k_new, v_new, positions))


@per_batch_shard
def _ring_write(k, v, pos, k_new, v_new, positions):
    """Copies of the ring k, v [B,T,KV,hd] and pos [B,T] with the entries
    written at slots ``positions % T``; on DTensors on each rank's batch
    shard (DTensor has no rule for the scatter, ``index_put``), the ring
    whole on every rank of the other axes."""
    B, T = k.shape[0], k.shape[1]
    slots = (positions % T).long()
    b_idx = torch.arange(B, device=positions.device)[:, None]
    k, v, pos = k.clone(), v.clone(), pos.clone()
    k[b_idx, slots] = k_new.to(k.dtype)
    v[b_idx, slots] = v_new.to(v.dtype)
    pos[b_idx, slots] = positions.to(pos.dtype)
    return k, v, pos


def attention_block(x, p: dict, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    rope_theta: float, sliding_window: int = 0, softcap: float = 0.0,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[KVCache] = None, impl: str = "ref",
                    chunk_kv: int = 0,
                    kv_block_axis: Optional[str] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x [B,S,D] -> (out [B,S,D], new cache or None). RoPE at ``positions``
    [B,S] (``arange(S)`` when None). Without a cache, causal
    self-attention; with one, the new keys (rotated at their absolute
    positions) and values go into the ring first, then the queries attend
    to the whole ring, in KV blocks of ``chunk_kv`` when
    :func:`kv_chunks` says so (the queries split over the mesh axis
    ``kv_block_axis`` names, when sharded)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = project_qkv(x, p, num_heads=num_heads, num_kv_heads=num_kv_heads,
                          head_dim=head_dim, positions=positions, rope_theta=rope_theta)
    if cache is None:
        out = self_attention(q, k, v, sliding_window=sliding_window, softcap=softcap,
                             impl=impl)
        new_cache = None
    else:
        new_cache = cache_insert(cache, k, v, positions)
        if kv_chunks(S, new_cache.k.shape[1], chunk_kv) > 0:
            out = chunked_cache_attention(
                q, new_cache.k, new_cache.v, positions, new_cache.pos,
                sliding_window=sliding_window, softcap=softcap, block_k=chunk_kv,
                kv_block_axis=kv_block_axis)
        else:
            out = cache_attention(q, new_cache.k, new_cache.v, positions, new_cache.pos,
                                  sliding_window=sliding_window, softcap=softcap)
    return view(out, B, S, num_heads * head_dim) @ p["wo"], new_cache


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
