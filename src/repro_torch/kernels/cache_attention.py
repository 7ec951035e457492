"""The KV-block scan of ``chunked_cache_attention``: a CUDA kernel
(``csrc/cache_attention.cu``) and its wrapper.

Replaces the reference's fourth ``lax.scan`` site, which XLA runs as one
loop over KV blocks on the device: ``repro/models/layers.py`` ::
``chunked_cache_attention`` (the scan at :203), the attention of a
prefill's queries over the KV ring, forward only. Layouts are the model's:
q [B, S, H, hd], the ring's k, v [B, T, KV, hd] read in place, q_pos [B, S]
and k_pos [B, T] int32 (-1 an empty slot) -> [B, S, H, hd] in q's dtype;
query head h reads KV head h % KV.

What bounds it: the products, 4 hd FLOPs a visible (query, slot) pair and
head (llava-next's 2,944-token prefill: 1.4e11 FLOPs a layer, 0.14 ms on
the tensor cores, against 121 MB); the plain loop instead writes half a
dozen [B, S, H, block_k] float32 tensors a block. So the kernel is flash
attention over the ring in one launch: a CTA lists the K/V tiles that its
query rows' positions can see (from k_pos: a ring that wraps keeps its
positions out of slot order) and walks them with an online softmax, nothing
of S x T size leaving the SM. bfloat16 with head_dim % 16 == 0 and 16-byte
aligned rows runs on the tensor cores, warp-specialised and persistent: a
CTA an SM walks blocks of 128 query rows of a head, its producer warpgroup
planning the next block and loading 128-slot K/V tiles by TMA into a ring
of stages, its two consumer warpgroups (wgmma) running each softmax under
their products; float32 and every other head_dim or stride on the CUDA
cores (64-row CTAs, 64-slot tiles).
``block_k`` is kept for parity with the reference: it orders the plain
version's sums and does not change the kernel's result.

On a CPU or ``meta`` tensor the wrapper runs the plain loop, ``plain`` (=
``ref.ref_chunked_cache_attention``; the dry run traces on ``meta``); on a
CUDA tensor it launches the kernel or raises. The reference's loop is a
``lax.scan`` that ``jax.grad`` differentiates (XLA's reverse of its jnp
ops; no Pallas kernel there), so a CUDA call that autograd records goes
through :class:`CacheAttention`: the kernel forward, and a backward that
recomputes the plain loop's vjp from the saved inputs. ``launches``
counts kernel launches, one a call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_chunked_cache_attention as plain

launches = 0


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                    k_pos: torch.Tensor, *, sliding_window: int = 0, softcap: float = 0.0,
                    block_k: int = 1024) -> torch.Tensor:
    if _build.on_host(q):
        return plain(q, k, v, q_pos, k_pos, sliding_window=sliding_window, softcap=softcap,
                     block_k=block_k)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    i32 = torch.int32
    _build.check_args("cache_attention", q.device, {
        "k": (k, (B, T, KV, hd), q.dtype), "v": (v, (B, T, KV, hd), q.dtype),
        "q_pos": (q_pos, (B, S), i32), "k_pos": (k_pos, (B, T), i32)}, q.dtype)
    _build.require(KV > 0 and H % KV == 0, f"cache_attention: H={H} not a multiple of KV={KV}")
    if _build.records(q, k, v):
        return CacheAttention.apply(q, k, v, q_pos, k_pos, sliding_window, softcap, block_k)
    return _launch(q, k, v, q_pos, k_pos, sliding_window, softcap)


def _launch(q, k, v, q_pos, k_pos, sliding_window, softcap):
    """The kernel on checked CUDA tensors: [B, S, H, hd] in q's dtype."""
    global launches
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lib = _build.lib()
    top = lib.rt_cache_attention_max_hd()
    _build.require(1 <= hd <= top, f"cache_attention: head_dim {hd} not in 1..{top}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    q_pos, k_pos = _build.contiguous(q_pos, k_pos)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B * S * H == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = lib.rt_cache_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), ctypes.addressof(strides), B, H, KV, S, T, hd, int(sliding_window),
        _build.DTYPE_CODES[q.dtype], float(softcap), _build.stream_ptr(q.device))
    _build.check(err, "cache_attention")
    launches += 1
    return out


class CacheAttention(torch.autograd.Function):
    """The kernel forward with the plain loop's vjp as its backward,
    recomputed from the saved inputs (the positions take no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, sliding_window, softcap, block_k):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.kw = {"sliding_window": sliding_window, "softcap": softcap, "block_k": block_k}
        with torch.no_grad():
            return _launch(q, k, v, q_pos, k_pos, sliding_window, softcap)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need) for t, need in zip((q, k, v),
                                                                    ctx.needs_input_grad)]
        with torch.enable_grad():
            out = plain(*leaves, q_pos, k_pos, **ctx.kw)
        grads = iter(torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dout))
        return (*(next(grads) if t.requires_grad else None for t in leaves),) + (None,) * 5
