"""Model-layout wrappers over the kernels. Model code calls these; each
kernel wrapper picks its plain version for CPU tensors and its CUDA kernel
for CUDA tensors."""

from __future__ import annotations

from repro_torch.kernels import cmp_claim as _claim
from repro_torch.kernels import cmp_ring as _ring
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa


def flash_attention(q, k, v, *, causal=True, sliding_window=0):
    """Model layout: q [B, S, H, hd]; k/v [B, T, KV, hd] -> [B, S, H, hd]."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              sliding_window=sliding_window)
    return out.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q [B, H, hd]; pages [P, KV, page, hd] -> [B, H, hd]."""
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens)


def ring_step(state, cycle, meta, req, *, k, window):
    """Fused admission-ring step (reclaim + enqueue-many + k-way claim +
    frontier publish) in one call; ``req`` = (push_n, want) host ints."""
    return _ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)


def claim(state, cycle, *, k, block_n=None):
    """Fused earliest-claim: (new_state, ids), ids == N marks an invalid
    lane. Pools larger than one tile take the tiled path (per-tile
    candidates + cross-tile merge)."""
    return _claim.cmp_claim(state, cycle, k=k, block_n=block_n)
