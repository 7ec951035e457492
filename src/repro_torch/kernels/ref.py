"""Plain PyTorch versions of the CUDA kernels (the allclose / bit-exact
targets), twins of the JAX package's ``kernels/ref.py`` oracles.

The kernel wrappers run these only for tensors on the CPU; on the card
they launch the kernel, and ``chip_smoke.py`` holds the kernel against
these on the same inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def ref_rms_norm(x, scale, *, eps=1e-6, residual=None):
    """``models/layers.py``'s ``rms_norm`` of x (f32 inside, one rounding to
    x's dtype), or, with ``residual``, of s = x + residual rounded to x's
    dtype: then (s, rms_norm(s))."""
    if residual is not None:
        x = x + residual
    dt = x.dtype
    xf = x.float()
    y = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
         * scale.float()).to(dt)
    return y if residual is None else (x, y)


def ref_rope(x, positions, inv_freq):
    """``models/layers.py``'s ``apply_rope`` of x [B,S,heads,hd] at
    positions [B,S], with the frequencies ``rope_freqs`` gives."""
    hd = x.shape[-1]
    angles = positions[..., :, None, None].float() * inv_freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def ref_scatter_pages(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """k_pages [P,KV,pg,hd]; k_new [B,S,KV,hd]; positions [B,S] absolute.
    Writes in place. ``k_pages[rows, :, slots]`` is [B,S,KV,hd]: the two
    index tensors are split by a slice, so their broadcast dims come first,
    as in numpy and JAX. Idle lanes all write scratch page 0, slot 0; those
    duplicate writes land in no live page."""
    pg = k_pages.shape[2]
    rows = torch.gather(block_tables, 1, positions // pg).long()
    slots = (positions % pg).long()
    k_pages[rows, :, slots] = k_new.to(k_pages.dtype)
    v_pages[rows, :, slots] = v_new.to(v_pages.dtype)


def ref_rope_write(q, k, v, positions, inv_freq, block_tables, k_pages, v_pages):
    """RoPE on q [B,S,H,hd] and k [B,S,KV,hd], then the RoPE'd k and v into
    the pages at each token's (block_tables[b, pos // pg], :, pos % pg), in
    place: returns (q, k) RoPE'd."""
    q, k = ref_rope(q, positions, inv_freq), ref_rope(k, positions, inv_freq)
    ref_scatter_pages(k_pages, v_pages, k, v, block_tables, positions)
    return q, k


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


# ---------------------------------------------------------------------------
# the xLSTM time loops (the reference's two ``lax.scan`` sites)
# ---------------------------------------------------------------------------


def _gates(log_i, log_f, m):
    """One step's stabiliser and gates from the log gates and the previous
    stabiliser m (-inf before the first step): (m_new, i_s, f_s)."""
    m_new = torch.maximum(log_f + m, log_i)
    m_new = torch.where(torch.isinf(m_new), log_i, m_new)  # first step
    return (m_new, *_gates_at(log_i, log_f, m, m_new))


def _gates_at(log_i, log_f, m, m_new):
    """(i_s, f_s) of a step whose stabiliser m_new is known (the backward
    takes the saved one: the same arithmetic, so the same bits)."""
    i_s = torch.exp(log_i - m_new)
    f_s = torch.where(torch.isinf(m), 0.0, torch.exp(log_f + m - m_new))
    return i_s, f_s


def _tie(a, b):
    """d max(a, b) / da as autograd takes it (torch.maximum and
    jnp.maximum alike): 1 where a wins, 1/2 on a tie, else 0."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _gates_bwd(log_i, log_f, m, m_new, di, df, dm):
    """The stabiliser chain of one step backwards: from the gradients of
    the step's i_s and f_s (di, df) and of its m_new (dm), the gradients
    of log_i, log_f and the previous m, following autograd through
    :func:`_gates`: the first step's ``where``s pass nothing to the branch
    they drop, and a tie of the ``maximum`` splits evenly."""
    a = log_f + m
    m_til = torch.maximum(a, log_i)
    live = ~torch.isinf(m)
    i_s, f_s = _gates_at(log_i, log_f, m, m_new)
    dff = torch.where(live, df * f_s, 0.0)
    dm = dm - di * i_s - dff
    first = torch.isinf(m_til)
    dli = di * i_s + torch.where(first, dm, 0.0)
    dm_til = torch.where(first, 0.0, dm)
    wa = _tie(a, log_i)
    da = dm_til * wa
    dli = dli + dm_til * (1.0 - wa)
    return dli, dff + da, dff + da


def mlstm_step(C, n, m, qf, kf, vf, log_i, log_f):
    """One mLSTM step in float32: (C, n, m_new, h, n . q) after it, h
    [B,H,d] unrounded."""
    m_new, i_s, f_s = _gates(log_i, log_f, m)
    C = f_s[..., None, None] * C + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = f_s[..., None] * n + i_s[..., None] * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    nq = torch.einsum("bhk,bhk->bh", n, qf)
    den = torch.maximum(torch.abs(nq), torch.exp(-m_new))
    return C, n, m_new, num / den[..., None], nq


def ref_mlstm_scan(q, k, v, log_i, log_f, C, n, m):
    """The mLSTM recurrence over q, k, v [B,H,S,d] (k already scaled by
    1/sqrt(d) in its dtype) and the log gates log_i, log_f [B,H,S] float32,
    from the state C [B,H,d,d], n [B,H,d], m [B,H] (float32). Returns (h
    [B,H,S,d] in q's dtype, C, n, m)."""
    hs = []
    for qf, kf, vf, li, lf in zip(q.float().unbind(2), k.float().unbind(2),
                                  v.float().unbind(2), log_i.unbind(2), log_f.unbind(2)):
        C, n, m, h, _ = mlstm_step(C, n, m, qf, kf, vf, li, lf)
        hs.append(h.to(q.dtype))
    return torch.stack(hs, dim=2), C, n, m


def ref_mlstm_fwd_saved(q, k, v, log_i, log_f, C, n, m, every: int):
    """:func:`ref_mlstm_scan` with what the backward takes, in the CUDA
    kernel's layouts: (h, C, n, m, saved), saved = (ck [nseg,B,H,d,d], C
    before each ``every``-th step; n_all [B,H,S+1,d] and m_all [B,H,S+1],
    the initial n and m then each step's; nq [B,H,S], each step's n . q;
    h32 [B,H,S,d], h unrounded)."""
    S = q.shape[2]
    ck, ns, ms, nqs, h32 = [], [n], [m], [], []
    qs, ks, vs = q.float().unbind(2), k.float().unbind(2), v.float().unbind(2)
    for t in range(S):
        if t % every == 0:
            ck.append(C)
        C, n, m, h, nq = mlstm_step(C, n, m, qs[t], ks[t], vs[t], log_i[..., t],
                                    log_f[..., t])
        ns.append(n)
        ms.append(m)
        nqs.append(nq)
        h32.append(h)
    h32 = torch.stack(h32, dim=2)
    saved = (torch.stack(ck), torch.stack(ns, dim=2), torch.stack(ms, dim=2),
             torch.stack(nqs, dim=2), h32)
    return h32.to(q.dtype), C, n, m, saved


def ref_mlstm_bwd(q, k, v, log_i, log_f, saved, dh, dC, dn, dm, every: int):
    """The mLSTM recurrence's backward, the CUDA kernels' algorithm in
    plain torch: a reverse loop over segments of ``every`` steps, each
    recomputed from its checkpoint in ``saved`` (:func:`ref_mlstm_fwd_saved`),
    carrying dC, dn and dm. Returns the gradients of (q, k, v, log_i,
    log_f, C, n, m), q, k, v's in their dtypes."""
    ck, n_all, m_all, nq_all, h32 = saved
    S = q.shape[2]
    qs, ks, vs = q.float().unbind(2), k.float().unbind(2), v.float().unbind(2)
    dhf = dh.float()
    g = (dhf * h32).sum(-1)  # sum_v dh h: the denominator's gradient is -g / den
    dq, dk, dv = (torch.zeros_like(h32) for _ in range(3))
    dli, dlf = torch.zeros_like(log_i), torch.zeros_like(log_f)
    for seg in reversed(range(ck.shape[0])):
        t0, t1 = seg * every, min(S, seg * every + every)
        C, prev = ck[seg], []
        for t in range(t0, t1):  # C_{t-1} of each step of the segment
            prev.append(C)
            i_s, f_s = _gates_at(log_i[..., t], log_f[..., t], m_all[..., t], m_all[..., t + 1])
            C = (f_s[..., None, None] * C
                 + i_s[..., None, None] * (ks[t][..., :, None] * vs[t][..., None, :]))
        for t in reversed(range(t0, t1)):
            mp, mt, nq = m_all[..., t], m_all[..., t + 1], nq_all[..., t]
            e = torch.exp(-mt)
            den = torch.maximum(nq.abs(), e)
            dden = -g[..., t] / den
            ds = dden * _tie(nq.abs(), e) * torch.sign(nq)
            dnum = dhf[..., t, :] / den[..., None]
            dC = dC + qs[t][..., :, None] * dnum[..., None, :]
            dn = dn + ds[..., None] * qs[t]
            dq[..., t, :] = (torch.einsum("bhkv,bhv->bhk", C, dnum)
                             + ds[..., None] * n_all[..., t + 1, :])
            i_s, f_s = _gates_at(log_i[..., t], log_f[..., t], mp, mt)
            dcv = torch.einsum("bhkv,bhv->bhk", dC, vs[t])
            dk[..., t, :] = i_s[..., None] * (dcv + dn)
            dv[..., t, :] = i_s[..., None] * torch.einsum("bhkv,bhk->bhv", dC, ks[t])
            di = (ks[t] * dcv).sum(-1) + (dn * ks[t]).sum(-1)
            df = (dC * prev[t - t0]).sum((-2, -1)) + (dn * n_all[..., t, :]).sum(-1)
            dm = dm - e * dden * _tie(e, nq.abs())
            dli[..., t], dlf[..., t], dm = _gates_bwd(log_i[..., t], log_f[..., t], mp, mt,
                                                      di, df, dm)
            dC, dn = f_s[..., None, None] * dC, f_s[..., None] * dn
            C = prev[t - t0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dli, dlf, dC, dn, dm


def slstm_step(c, n, h, m, zt, it, ft, ot, r):
    """One sLSTM step in float32 over the inputs' preactivations [B,H,hd]
    and r [H,hd,4hd]: (c, n, h, m_new, z, o, log_i, the forget gate's mean
    preactivation)."""
    hd = zt.shape[-1]
    zr, ir, fr, orr = torch.einsum("bhd,hde->bhe", h, r).split(hd, dim=-1)
    z = torch.tanh(zt + zr)
    log_i = torch.mean(it + ir, dim=-1)  # per-head scalar gates [B,H]
    pre_f = torch.mean(ft + fr, dim=-1)
    o = torch.sigmoid(ot + orr)
    m_new, i_s, f_s = _gates(log_i, F.logsigmoid(pre_f), m)
    c = f_s[..., None] * c + i_s[..., None] * z
    n = f_s[..., None] * n + i_s[..., None]
    h = o * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new, z, o, log_i, pre_f


def ref_slstm_scan(zx, ix, fx, ox, r, c, n, h, m):
    """The sLSTM recurrence over the input preactivations [B,S,H,hd] and
    the recurrent matrices r [H,hd,4hd] (float32) from the state c, n, h
    [B,H,hd] and m [B,H] (float32). Returns (h [B,S,H,hd] in zx's dtype,
    c, n, h, m)."""
    hs = []
    for zt, it, ft, ot in zip(zx.float().unbind(1), ix.float().unbind(1),
                              fx.float().unbind(1), ox.float().unbind(1)):
        c, n, h, m, *_ = slstm_step(c, n, h, m, zt, it, ft, ot, r)
        hs.append(h.to(zx.dtype))
    return torch.stack(hs, dim=1), c, n, h, m


def ref_slstm_fwd_saved(zx, ix, fx, ox, r, c, n, h, m):
    """:func:`ref_slstm_scan` with what the backward takes, in the CUDA
    kernel's layouts: (hs, c, n, h, m, saved), saved = (h_all, c_all, n_all
    [B,S+1,H,hd], the initial state then each step's; z_all, o_all
    [B,S,H,hd]; li_all, pf_all [B,S,H], log_i and the forget gate's mean
    preactivation; m_all [B,S+1,H])."""
    keep = {k: [v] for k, v in (("h", h), ("c", c), ("n", n), ("m", m))}
    keep |= {k: [] for k in ("z", "o", "li", "pf")}
    for zt, it, ft, ot in zip(zx.float().unbind(1), ix.float().unbind(1),
                              fx.float().unbind(1), ox.float().unbind(1)):
        c, n, h, m, z, o, li, pf = slstm_step(c, n, h, m, zt, it, ft, ot, r)
        for key, val in (("h", h), ("c", c), ("n", n), ("m", m), ("z", z), ("o", o),
                         ("li", li), ("pf", pf)):
            keep[key].append(val)
    saved = tuple(torch.stack(keep[key], dim=1)
                  for key in ("h", "c", "n", "z", "o", "li", "pf", "m"))
    return saved[0][:, 1:].to(zx.dtype), c, n, h, m, saved


def ref_slstm_bwd(r, saved, dhs, dc, dn, dh, dm):
    """The sLSTM recurrence's backward in plain torch, the CUDA kernels'
    algorithm: a reverse loop over the states and gates in ``saved``
    (:func:`ref_slstm_fwd_saved`), carrying dh, dc, dn and dm; dr is the
    sum over rows and steps of h_{t-1} (x) the step's preactivation
    gradient. Returns the gradients of (zx, ix, fx, ox, r, c, n, h, m),
    the inputs' in dhs's dtype."""
    h_all, c_all, n_all, z_all, o_all, li_all, pf_all, m_all = saved
    S, hd = dhs.shape[1], dhs.shape[-1]
    drec = []
    for t in reversed(range(S)):
        dht = dh + dhs[:, t].float()
        c_t, n_t, z, o = c_all[:, t + 1], n_all[:, t + 1], z_all[:, t], o_all[:, t]
        li, pf, mp, mt = li_all[:, t], pf_all[:, t], m_all[:, t], m_all[:, t + 1]
        nc = torch.clamp(n_t, min=1.0)
        gh = dht / nc
        do = gh * c_t
        dct = dc + gh * o
        dnt = dn + torch.where(n_t >= 1.0, -dht * (o * c_t) / (nc * nc), 0.0)
        lf = F.logsigmoid(pf)
        i_s, f_s = _gates_at(li, lf, mp, mt)
        di = (dct * z + dnt).sum(-1)
        df = (dct * c_all[:, t] + dnt * n_all[:, t]).sum(-1)
        dli, dlf, dm = _gates_bwd(li, lf, mp, mt, di, df, dm)
        dpf = dlf * torch.sigmoid(-pf)
        step = torch.cat([dct * i_s[..., None] * (1 - z * z),
                          (dli / hd)[..., None].expand_as(z),
                          (dpf / hd)[..., None].expand_as(z),
                          do * (1 - o) * o], dim=-1)  # [B,H,4hd]
        drec.append(step)
        dh = torch.einsum("hde,bhe->bhd", r, step)
        dc, dn = f_s[..., None] * dct, f_s[..., None] * dnt
    drec = torch.stack(drec[::-1], dim=1)  # [B,S,H,4hd]
    dr = torch.einsum("bshd,bshe->hde", h_all[:, :S], drec)
    dzx, dix, dfx, dox = (g.to(dhs.dtype) for g in drec.split(hd, dim=-1))
    return dzx, dix, dfx, dox, dr, dc, dn, dh, dm


# ---------------------------------------------------------------------------
# SSD's chunk loop and decode step (the reference's third ``lax.scan`` site)
# ---------------------------------------------------------------------------


def ref_ssd_chunked(x, b, c, log_a, *, chunk: int = 256, state=None, starts=None):
    """y[t] = C[t] . h[t], h[t] = a[t] h[t-1] + B[t] (x) x[t], over x
    [B,S,H,P], b, c [B,S,H,N], log_a [B,S,H] (<= 0), from ``state``
    [B,H,P,N] (zeros when None). Quadratic within chunks, a loop across
    them. Returns (y [B,S,H,P] in x's dtype, final state f32). ``starts``,
    a list, collects the state at each chunk's start.

    The intra-chunk decay exp(la_t - la_s) is taken only where s <= t: the
    reference exponentiates every (t, s) and masks the product after, which
    gives the same values but, once a chunk's summed decay passes ~88
    (hymba-1.5b's 256-token chunks), an inf in the masked corner whose
    gradient is NaN. Masking the exponent first keeps the gradient finite;
    wherever the reference's is finite, the two agree."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    if S % chunk != 0:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    h = state if state is not None else torch.full((B, H, P, N), 0.0, dtype=torch.float32,
                                                   device=x.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for xk, bk, ck, lak in zip(x.split(chunk, 1), b.split(chunk, 1), c.split(chunk, 1),
                               log_a.split(chunk, 1)):
        if starts is not None:
            starts.append(h)
        xf, bf, cf = xk.float(), bk.float(), ck.float()
        la = torch.cumsum(lak.float(), dim=1)  # [B, c, H] inclusive
        # intra-chunk: M[t,s] = exp(la_t - la_s) * (C_t . B_s), s <= t
        cb = torch.einsum("bthn,bshn->bhts", cf, bf)
        seg = (la[:, :, None, :] - la[:, None, :, :]).movedim(3, 1)  # [B, H, t, s]
        decay = torch.exp(torch.where(causal, seg, -math.inf))
        mat = torch.where(causal, cb * decay, 0.0)
        y_intra = torch.einsum("bhts,bshp->bthp", mat, xf)
        # inter-chunk: y_inter[t] = exp(la_t) * C_t . h
        y_inter = torch.einsum("bthn,bhpn->bthp", cf, h) * torch.exp(la)[..., None]
        # state: h' = exp(la_end) h + sum_s exp(la_end - la_s) B_s (x) x_s
        la_end = la[:, -1, :]  # [B, H]
        w = torch.exp(la_end[:, None, :] - la)  # [B, c, H]
        dstate = torch.einsum("bsh,bshp,bshn->bhpn", w, xf, bf)
        h = torch.exp(la_end)[:, :, None, None] * h + dstate
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1)[:, :S], h


def ref_ssd_decode_step(x, b, c, log_a, state):
    """One-token recurrence. x [B,H,P]; b, c [B,H,N]; log_a [B,H]; state
    [B,H,P,N] f32: the state first, then the readout. Returns (y [B,H,P]
    in x's dtype, the new state)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = a * state + torch.einsum("bhp,bhn->bhpn", x.float(), b.float())
    y = torch.einsum("bhpn,bhn->bhp", state, c.float())
    return y.to(x.dtype), state


def ref_ssd_fwd_saved(x, b, c, log_a, state, chunk: int):
    """:func:`ref_ssd_chunked` with what the backward takes, in the CUDA
    kernel's layout: (y, final state, saved), saved [nc,B,H,P,N] float32
    the state at each chunk's start."""
    starts = []
    y, h = ref_ssd_chunked(x, b, c, log_a, chunk=chunk, state=state, starts=starts)
    return y, h, torch.stack(starts)


def ref_ssd_bwd(x, b, c, log_a, saved, dy, dh, chunk: int):
    """The backward of :func:`ref_ssd_chunked`, the CUDA kernels' algorithm
    in plain torch: a reverse loop over chunks carrying dh, each chunk
    recomputed from its saved start state (:func:`ref_ssd_fwd_saved`). In a
    chunk, with E[t,s] = exp(la_t - la_s) taken where s <= t only, G = C_t .
    B_s and D = dy_t . x_s:

    * dx_s = sum_t E G dy_t + w_s B_s . dh,   db_s = sum_t E D C_t + w_s x_s . dh,
    * dc_t = sum_s E D B_s + e_t dy_t . h,    dh_prev = e_end dh + sum_t e_t dy_t (x) C_t,
    * d la_t = sum_s E G D (row) - sum_t' E G D (column) + e_t dy_t . (C_t . h)
      - w_t (x_t (x) B_t) : dh, and at the chunk's last real position
      e_end h : dh + sum_s w_s (x_s (x) B_s) : dh; d log_a is its reverse
      cumsum within the chunk.

    e_t = exp(la_t), w_s = exp(la_end - la_s). A short last chunk ends at its
    last real position (the padded tail adds nothing). Returns the
    gradients of (x, b, c, log_a, state), x, b, c's in their dtypes."""
    S = x.shape[1]
    xf, bf, cf, dyf = x.float(), b.float(), c.float(), dy.float()
    dx, db, dc = torch.zeros_like(xf), torch.zeros_like(bf), torch.zeros_like(cf)
    dla = torch.zeros_like(log_a, dtype=torch.float32)
    dh = dh.float()
    for k in reversed(range(saved.shape[0])):
        t0, t1 = k * chunk, min(S, k * chunk + chunk)
        xk, bk, ck, dyk = (t[:, t0:t1] for t in (xf, bf, cf, dyf))
        h, L = saved[k], t1 - t0
        la = torch.cumsum(log_a[:, t0:t1].float(), dim=1)  # [B, L, H]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        seg = (la[:, :, None, :] - la[:, None, :, :]).movedim(3, 1)  # [B, H, t, s]
        E = torch.exp(torch.where(causal, seg, -math.inf))
        EG = E * torch.einsum("bthn,bshn->bhts", ck, bk)
        D = torch.einsum("bthp,bshp->bhts", dyk, xk)
        ED = E * D
        e, e_end = torch.exp(la), torch.exp(la[:, -1])  # [B, L, H], [B, H]
        w = torch.exp(la[:, -1:] - la)
        dx[:, t0:t1] = (torch.einsum("bhts,bthp->bshp", EG, dyk)
                        + w[..., None] * torch.einsum("bshn,bhpn->bshp", bk, dh))
        db[:, t0:t1] = (torch.einsum("bhts,bthn->bshn", ED, ck)
                        + w[..., None] * torch.einsum("bshp,bhpn->bshn", xk, dh))
        dc[:, t0:t1] = (torch.einsum("bhts,bshn->bthn", ED, bk)
                        + e[..., None] * torch.einsum("bthp,bhpn->bthn", dyk, h))
        Q = EG * D
        R = w * torch.einsum("bshp,bhpn,bshn->bsh", xk, dh, bk)
        d = (Q.sum(-1) - Q.sum(-2)).transpose(1, 2) - R
        d = d + e * torch.einsum("bthp,bthn,bhpn->bth", dyk, ck, h)
        d[:, -1] += e_end * (dh * h).sum((-2, -1)) + R.sum(1)
        dla[:, t0:t1] = d.flip(1).cumsum(1).flip(1)
        dh = e_end[..., None, None] * dh + torch.einsum("bth,bthp,bthn->bhpn", e, dyk, ck)
    return dx.to(x.dtype), db.to(b.dtype), dc.to(c.dtype), dla, dh


# ---------------------------------------------------------------------------
# chunked_cache_attention's KV-block scan (the reference's fourth ``lax.scan`` site)
# ---------------------------------------------------------------------------


def ref_chunked_cache_attention(q, k, v, q_pos, k_pos, *, sliding_window: int = 0,
                                softcap: float = 0.0, block_k: int = 1024):
    """Online-softmax attention of q [B,S,H,hd] over the cache k, v
    [B,T,KV,hd] in KV blocks of ``block_k``; q_pos [B,S] and k_pos [B,T]
    absolute positions (-1 an empty slot). The cache is padded to whole
    blocks with slots at position -1, the running max starts at -1e30 and
    a masked probability is 0, so a row with no valid key comes out 0.
    r-major GQA: query head h reads KV head h % KV. Returns [B,S,H,hd] in
    q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    pad = (-T) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    qh = q.reshape(B, S, rep, KV, hd)  # r-major GQA
    scale = 1.0 / (hd ** 0.5)
    acc = torch.zeros((B, S, rep, KV, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, S, rep, KV), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, rep, KV), dtype=torch.float32, device=q.device)
    for kc, vc, kp in zip(k.split(block_k, 1), v.split(block_k, 1), k_pos.split(block_k, 1)):
        s = torch.einsum("bsrgd,btgd->bsrgt", qh, kc).float() * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        mask = (kp[:, None, :] >= 0) & (q_pos[:, :, None] >= kp[:, None, :])
        if sliding_window > 0:
            mask = mask & (q_pos[:, :, None] - kp[:, None, :] < sliding_window)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bsrgt,btgd->bsrgd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)
