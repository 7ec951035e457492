"""Model-layout wrappers over the kernels. Model code calls these; each
kernel wrapper picks its plain version for CPU tensors and its CUDA kernel
for CUDA tensors."""

from __future__ import annotations

from repro_torch.kernels import cache_attention as _ca
from repro_torch.kernels import cmp_claim as _claim
from repro_torch.kernels import cmp_ring as _ring
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import norm_rope as _nr
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import xlstm_scan as _xs


def flash_attention(q, k, v, *, causal=True, sliding_window=0, softcap=0.0):
    """Model layout: q [B, S, H, hd]; k/v [B, T, KV, hd] -> [B, S, H, hd]."""
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              sliding_window=sliding_window, softcap=softcap)
    return out.transpose(1, 2)


def chunked_cache_attention(q, k, v, q_pos, k_pos, *, sliding_window=0, softcap=0.0,
                            block_k=1024):
    """q [B, S, H, hd] over the ring k/v [B, T, KV, hd] at positions q_pos
    [B, S], k_pos [B, T] (-1 empty) -> [B, S, H, hd], forward only; one
    launch a call on the card, ``block_k`` ordering only the plain
    version's sums."""
    return _ca.cache_attention(q, k, v, q_pos, k_pos, sliding_window=sliding_window,
                               softcap=softcap, block_k=block_k)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *, softcap=0.0):
    """q [B, H, hd]; pages [P, KV, page, hd] -> [B, H, hd]."""
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                               softcap=softcap)


def rms_norm(x, scale, *, residual=None):
    """``layers.rms_norm`` of x [..., D]; with ``residual`` the pair (x +
    residual, its rms_norm), the add rounded to x's dtype. Forward only."""
    return _nr.rms_norm(x, scale, residual=residual)


def rope_write(q, k, v, positions, inv_freq, block_tables, k_pages, v_pages):
    """(q, k) RoPE'd at positions [B, S] (q [B, S, H, hd], k, v [B, S, KV,
    hd]; ``inv_freq`` = ``layers.rope_freqs``), and the RoPE'd k and v
    written into the pages [P, KV, pg, hd] at each token's (block_tables[b,
    pos // pg], :, pos % pg), in place. Forward only."""
    return _nr.rope_write(q, k, v, positions, inv_freq, block_tables, k_pages, v_pages)


def ring_step(state, cycle, meta, req, *, k, window):
    """Fused admission-ring step (reclaim + enqueue-many + k-way claim +
    frontier publish) in one call; ``req`` = (push_n, want) host ints."""
    return _ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)


def claim(state, cycle, *, k, block_n=None):
    """Fused earliest-claim: (new_state, ids), ids == N marks an invalid
    lane. One launch on the card at every N; ``block_n`` is kept for parity
    with the JAX package and does not change the result."""
    return _claim.cmp_claim(state, cycle, k=k, block_n=block_n)


def claim_pool(state, cycle, retire_cycle, deque_cycle, *, k):
    """``slotpool.claim`` fused: (new_state, ids, valid, new_retire_cycle,
    new_deque_cycle) in one launch on the card."""
    return _claim.claim_pool(state, cycle, retire_cycle, deque_cycle, k=k)


def mlstm_scan(q, k, v, log_i, log_f, C, n, m):
    """The mLSTM recurrence over q, k (scaled), v [B, H, S, d] and the log
    gates [B, H, S] from the state (C, n, m) -> (h [B, H, S, d], C, n, m)."""
    return _xs.mlstm(q, k, v, log_i, log_f, C, n, m)


def slstm_scan(zx, ix, fx, ox, r, c, n, h, m):
    """The sLSTM recurrence over the preactivations [B, S, H, hd] and r [H,
    hd, 4hd] from the state (c, n, h, m) -> (hs [B, S, H, hd], c, n, h, m)."""
    return _xs.slstm(zx, ix, fx, ox, r, c, n, h, m)


def ssd_chunked(x, b, c, log_a, *, chunk, state=None):
    """SSD's chunked scan over x [B, S, H, P], b, c [B, S, H, N] and log_a
    [B, S, H] from the state [B, H, P, N] (zeros when None) -> (y [B, S,
    H, P], the final state)."""
    return _ssd.ssd_chunked(x, b, c, log_a, chunk=chunk, state=state)


def ssd_decode(x, b, c, log_a, state):
    """One SSD token: x [B, H, P], b, c [B, H, N], log_a [B, H] and the
    state [B, H, P, N] -> (y [B, H, P], the new state)."""
    return _ssd.ssd_decode(x, b, c, log_a, state)
