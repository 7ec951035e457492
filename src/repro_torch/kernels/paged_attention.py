"""Paged decode attention over CMP-managed KV pages: CUDA kernel
(``csrc/paged_attention.cu``) and its wrapper.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``
(``_paged_kernel``). One query token per sequence attends over its pages;
layouts are the JAX package's: q [B, H, hd], k/v pages [P, KV, page, hd],
block_tables [B, pages_per_seq] int32, seq_lens [B] int32 -> [B, H, hd].

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_paged_attention``); on a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_attention as plain

launches = 0


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables, seq_lens)
    _build.require(q.is_cuda, f"paged_attention: unsupported device {q.device}")
    B, H, hd = q.shape
    P, KV, page, hd_k = k_pages.shape
    pps = block_tables.shape[1]
    _build.require(q.dtype in _build.DTYPE_CODES,
                   f"paged_attention: dtype {q.dtype} not float32/bfloat16")
    _build.require(H % KV == 0 and hd_k == hd,
                   "paged_attention: need H % KV == 0 and matching head_dim")
    _build.require(tuple(v_pages.shape) == tuple(k_pages.shape),
                   "paged_attention: k/v page shapes differ")
    _build.require(tuple(block_tables.shape) == (B, pps)
                   and tuple(seq_lens.shape) == (B,),
                   "paged_attention: block_tables [B,pps] / seq_lens [B] mismatch")
    for name, t, dt in (("q", q, q.dtype), ("k_pages", k_pages, q.dtype),
                        ("v_pages", v_pages, q.dtype),
                        ("block_tables", block_tables, torch.int32),
                        ("seq_lens", seq_lens, torch.int32)):
        _build.require(t.device == q.device and t.dtype == dt and t.is_contiguous(),
                       f"paged_attention: {name} must be contiguous {dt} on {q.device}")
    lib = _build.lib()
    _build.require((H // KV) * hd <= lib.rt_paged_attention_max_rep_hd(),
                   "paged_attention: (H/KV)*head_dim too large for one block")
    out = torch.empty_like(q)
    if B == 0:
        return out
    err = lib.rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, H, KV, page, hd, pps,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += 1
    return out
