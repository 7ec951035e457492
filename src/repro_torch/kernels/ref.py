"""Plain PyTorch versions of the CUDA kernels (the allclose / bit-exact
targets), twins of the JAX package's ``kernels/ref.py`` oracles.

The kernel wrappers run these only for tensors on the CPU; on the card
they launch the kernel, and ``chip_smoke.py`` holds the kernel against
these on the same inputs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.domain import AVAILABLE, CLAIMED, FREE

NEG_INF = -1e30
_INT_MAX = torch.iinfo(torch.int32).max


def _softcap(s, softcap: float):
    """``c * tanh(s / c)`` on the scaled scores (0 = off), as the
    reference's ``_sdpa``."""
    return torch.tanh(s / softcap) * softcap if softcap > 0.0 else s


def ref_flash_attention(q, k, v, *, causal=True, sliding_window=0, softcap=0.0):
    """q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd]. r-major GQA: query head
    h reads KV head h % KV. Computed in f32, cast back to q's dtype."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    kx = k.repeat(1, rep, 1, 1).float()
    vx = v.repeat(1, rep, 1, 1).float()
    s = _softcap(torch.einsum("bhsd,bhtd->bhst", q.float(), kx) / math.sqrt(hd), softcap)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if sliding_window > 0:
        mask = mask & (q_pos - k_pos < sliding_window)
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, vx).to(q.dtype)


def ref_paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *, softcap=0.0):
    """Decode attention over paged KV.

    q [B, H, hd]; k/v_pages [P, KV, page, hd]; block_tables [B, pps]
    (entries index into P); seq_lens [B]. A sequence of length 0 gives
    zeros, as the kernel does."""
    B, H, hd = q.shape
    P, KV, page, _ = k_pages.shape
    pps = block_tables.shape[1]
    rep = H // KV
    bt = block_tables.long()
    kg = k_pages[bt].movedim(2, 1).reshape(B, KV, pps * page, hd)
    vg = v_pages[bt].movedim(2, 1).reshape(B, KV, pps * page, hd)
    kg = kg.repeat(1, rep, 1, 1).float()
    vg = vg.repeat(1, rep, 1, 1).float()
    s = _softcap(torch.einsum("bhd,bhtd->bht", q.float(), kg) / math.sqrt(hd), softcap)
    valid = (torch.arange(pps * page, device=q.device)[None, :]
             < seq_lens[:, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bht,bhtd->bhd", w, vg)
    out = torch.where((seq_lens > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def ref_paged_attention_split(q, k_pages, v_pages, block_tables, seq_lens,
                              split_tokens, *, softcap=0.0):
    """The paged kernel's algorithm in plain PyTorch (for the tests): the
    token positions cut into splits of ``split_tokens`` (token t in page
    ``block_tables[t // page]``, so a split may hold several pages, part of
    one, or a page boundary), each split's partial softmax (m, l, acc) in
    f32, masked past seq_len, an empty split giving (-1e30, 0, 0), then the
    combine out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-30)."""
    B, H, hd = q.shape
    P, KV, page, _ = k_pages.shape
    pps = block_tables.shape[1]
    rep = H // KV
    chunk = split_tokens
    n_split = -(-(pps * page) // chunk)
    T = n_split * chunk  # the last split may reach past pps: masked
    bt = block_tables.long()
    kg = k_pages[bt].movedim(2, 1).reshape(B, KV, pps * page, hd)
    vg = v_pages[bt].movedim(2, 1).reshape(B, KV, pps * page, hd)
    pad = (0, 0, 0, T - pps * page)
    kg = torch.nn.functional.pad(kg.repeat(1, rep, 1, 1).float(), pad)
    vg = torch.nn.functional.pad(vg.repeat(1, rep, 1, 1).float(), pad)
    s = _softcap(torch.einsum("bhd,bhtd->bht", q.float(), kg) / math.sqrt(hd), softcap)
    valid = (torch.arange(T, device=q.device)[None, :]
             < torch.clamp(seq_lens, max=pps * page)[:, None])[:, None]
    s = torch.where(valid, s, NEG_INF).view(B, H, n_split, chunk)
    valid = valid.view(B, 1, n_split, chunk)
    m = s.max(dim=-1).values                                        # [B,H,n]
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhnt,bhntd->bhnd", p, vg.view(B, H, n_split, chunk, hd))
    w = torch.exp(m - m.max(dim=-1, keepdim=True).values)
    out = (w[..., None] * acc).sum(2) / torch.clamp((w * l).sum(-1), min=1e-30)[..., None]
    return out.to(q.dtype)


def ref_ring_step(state, cycle, meta, req, *, k, window):
    """The fused admission-ring step in plain torch: window reclaim +
    batched ring enqueue (contiguous prefix accept) + k-way earliest claim +
    monotone frontier publish. Bit-identical to the CUDA kernel.

    state, cycle: int32 [N]; meta: int32 [2] = [enq_cycle, deque_cycle];
    req = (push_n, want) as host ints (push_n is clamped to N).
    Returns (state', cycle', meta', claimed_cycles[k]), -1 in unfilled
    claim lanes."""
    n = state.shape[0]
    dev = state.device
    enq, dc = meta[0], meta[1]
    push_n = min(int(req[0]), n)
    want = int(req[1])
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    freeable = (state == CLAIMED) & (cycle < dc - window)
    state = torch.where(freeable, FREE, state)

    off = torch.remainder(idx - enq, n)  # floors, as jnp.mod does
    blocked = (off < push_n) & (state != FREE)
    accepted = torch.where(blocked, off, push_n).min()
    take = off < accepted
    state = torch.where(take, AVAILABLE, state)
    cycle = torch.where(take, enq + 1 + off, cycle)

    # Live ring cycles are unique, so the ascending-cycle claim order is
    # the sorted order of the AVAILABLE keys: sort plus threshold select.
    key = torch.where(state == AVAILABLE, cycle, _INT_MAX)
    sorted_keys = torch.sort(key).values
    lane = torch.arange(k, device=dev)
    take = torch.clamp((key != _INT_MAX).sum(), max=k).clamp(max=want)
    threshold = sorted_keys[torch.clamp(take - 1, min=0)]
    sel = (key != _INT_MAX) & (key <= threshold) & (take > 0)
    claimed_cycles = torch.where(lane < take, sorted_keys[:k], -1)
    state = torch.where(sel, CLAIMED, state)
    max_claimed = torch.where(lane < take, claimed_cycles, dc).max()
    new_meta = torch.stack([enq + accepted, torch.maximum(dc, max_claimed)])
    i32 = torch.int32
    return (state.to(i32), cycle.to(i32), new_meta.to(i32),
            claimed_cycles.to(i32))


def ref_claim(state, cycle, k):
    """Claim the k earliest-cycle AVAILABLE slots, ties to the lowest id.

    state, cycle: int32 [N]. Returns (new_state [N], ids [k], valid [k]):
    the chosen ids in ascending (cycle, id) order, AVAILABLE -> CLAIMED at
    each; lanes past the claimable slots hold ``N`` (also when k > N). A
    slot whose cycle is INT32_MAX is never claimable, as in the Pallas
    kernel. A stable sort of the key lists equal keys in index order, which
    is the kernel's tie order (``torch.topk``'s is unspecified)."""
    n = state.shape[0]
    key = torch.where(state == AVAILABLE, cycle, _INT_MAX)
    head, order = torch.sort(key, stable=True)
    head, order = head[:k], order[:k]
    if k > n:  # over-ask: pad with invalid lanes
        head = torch.cat([head, head.new_full((k - n,), _INT_MAX)])
        order = torch.cat([order, order.new_full((k - n,), n)])
    valid = head != _INT_MAX
    ids = torch.where(valid, order, n).to(torch.int32)
    return set_drop(state, ids, CLAIMED), ids, valid


def set_drop(arr, ids, values):
    """``arr.at[ids].set(values, mode="drop")`` for ids in ``[0, n]``: the
    sentinel ``n`` lands in a spare trailing slot that is cut off, so it
    is dropped without a host read and without an out-of-bounds write."""
    ext = torch.cat([arr, arr.new_zeros(1)])
    ext[ids.long()] = values
    return ext[:-1]
