"""Paged decode attention over CMP-managed KV pages: CUDA kernel
(``csrc/paged_attention.cu``) and its wrapper.

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``
(``_paged_kernel``). One query token per sequence attends over its pages;
layouts are the JAX package's: q [B, H, hd], k/v pages [P, KV, page, hd],
block_tables [B, pages_per_seq] int32, seq_lens [B] int32 -> [B, H, hd].

The kernel splits each sequence into 64-token splits (``SPLIT_TOKENS``), at
any page size: token t reads page ``block_tables[t // page]``, slot
``t % page``. One CTA takes a (KV head, sequence, split), and a second
launch combines the splits' partial softmax sums. The split count comes
from the page size and ``pages_per_seq`` alone, never from ``seq_lens``, so
a call reads nothing back to the host. bfloat16 runs both products on the
tensor cores (mma.sync) when head_dim is a multiple of 16 up to 256 and
H/KV <= 16; other bfloat16 heads, and float32, run on the CUDA cores (a
scalar kernel templated on the element type; TF32 would miss the f32
tolerance). ``softcap`` > 0 applies ``c * tanh(s / c)`` to the scaled
scores before the mask, as the reference's attention does.
``ref.ref_paged_attention_split`` is the same partition and combine in
plain PyTorch (the tests hold it to the JAX package).

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_paged_attention``); on a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches: ``launches_per_call`` of them
a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_paged_attention as plain

launches = 0
SPLIT_TOKENS = 64  # tokens a CTA takes, kChunk in csrc/paged_attention.cu


def num_splits(pps: int, page: int) -> int:
    return -(-(pps * page) // SPLIT_TOKENS)


def launches_per_call(pps: int, page: int) -> int:
    """Kernel launches of one call: the split pass, plus the combine when
    there is more than one split."""
    return 1 if num_splits(pps, page) == 1 else 2


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                    softcap: float = 0.0) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables, seq_lens, softcap=softcap)
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
                   and tuple(seq_lens.shape) == (B,) and pps > 0,
                   "paged_attention: block_tables [B,pps] / seq_lens [B] mismatch")
    for name, t, dt in (("q", q, q.dtype), ("k_pages", k_pages, q.dtype),
                        ("v_pages", v_pages, q.dtype),
                        ("block_tables", block_tables, torch.int32),
                        ("seq_lens", seq_lens, torch.int32)):
        _build.require(t.device == q.device and t.dtype == dt and t.is_contiguous(),
                       f"paged_attention: {name} must be contiguous {dt} on {q.device}")
    _build.require(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
                   and hd % 4 == 0, "paged_attention: K/V rows are copied 16 bytes at a "
                   "time: pages 16-byte aligned, head_dim % 4 == 0")
    lib = _build.lib()
    _build.require((H // KV) * hd <= lib.rt_paged_attention_max_rep_hd(),
                   "paged_attention: (H/KV)*head_dim too large for one block")
    out = torch.empty_like(q)
    if B == 0:
        return out
    n_split = num_splits(pps, page)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B, H, n_split, hd), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=q.device)
    err = lib.rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), B, H, KV, page, hd, pps,
        _build.DTYPE_CODES[q.dtype], float(softcap),
        _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += launches_per_call(pps, page)
    return out
