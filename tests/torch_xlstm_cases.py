"""Inputs of the xLSTM tests at smoke size (4 heads of 16), and the check
that h of the chunkwise mLSTM forward (the kernel on the card, its plain
torch mirror on the CPU) is held to at gates of +-30, row by row; run as
a script, the readings that check's factor was set from. numpy and torch
only, so the card's tests take the CPU tests' inputs from here.

At gates of +-30 h is ill-conditioned: m reaches 30, so exp(-m) no longer
floors the denominator max(|n . q|, exp(-m)), and n . q can cancel to a
small fraction of its terms, so that one row's h dwarfs the rest. There
every float32 order of the sums is far from float64, the plain loop's
too, by more than 1e-4 of the whole tensor. So h is held, row by row, to
the plain loop run in float64: where the float32 plain loop is within
``REL`` of the row, within ``REL`` of it too; on any other row (an
ill-conditioned one) within ``FACTOR`` times the float32 plain loop's own
error there. ``FACTOR`` lies between what the right orders reach on the
ill-conditioned rows and what known-wrong variants reach:

    PYTHONPATH=src python tests/torch_xlstm_cases.py         # the CPU mirror and its variants
    PYTHONPATH=src python tests/torch_xlstm_cases.py --card  # the forward kernel, on the card

The backward kernels' algorithms are mirrored here too
(``chunkwise_mlstm_bwd``, ``reformulated_slstm_bwd``) and held to the plain
backwards run in float64 (``float64_plain``); ``--bwd`` prints those
readings:

    PYTHONPATH=src python tests/torch_xlstm_cases.py --bwd
"""

from __future__ import annotations

import contextlib
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import xlstm_scan as xs

B, H, D = 2, 4, 16
L = xs.CHECKPOINT_EVERY  # 32, the mLSTM kernel's chunk too (on the card: xs.kernel_chunk())
MLSTM_SEQS = [1, L - 1, L, L + 1, 3 * L + 5]
# the extreme cases whose h has ill-conditioned rows
EXTREME_CASES = [(L + 1, False), (3 * L + 5, False), (3 * L + 5, True)]
REL = 1e-4
FACTOR = 8.0


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def mlstm_np(rng, S, carried):
    q, k, v = (rand(rng, B, H, S, D) for _ in range(3))
    i_pre, f_pre = rand(rng, B, H, S), rand(rng, B, H, S) + 1.0
    if carried:
        state = (rand(rng, B, H, D, D, scale=0.3), rand(rng, B, H, D, scale=0.3),
                 rand(rng, B, H))
    else:
        state = (np.zeros((B, H, D, D), np.float32), np.zeros((B, H, D), np.float32),
                 np.full((B, H), -np.inf, np.float32))
    return (q, k, v, i_pre, f_pre), state


def gates_np(rng, S, extreme):
    """i_pre and f_pre: normal, or a fifth of each at the extremes, log_i
    +-30 and f_pre -30 (the forget gate shut) or +30 (wide open)."""
    i_pre, f_pre = rand(rng, B, H, S), rand(rng, B, H, S) + 1.0
    if extreme:
        u, w = rng.random((B, H, S)), rng.random((B, H, S))
        i_pre = np.where(u < 0.1, 30.0, np.where(u > 0.9, -30.0, i_pre)).astype(np.float32)
        f_pre = np.where(w < 0.1, -30.0, np.where(w > 0.9, 30.0, f_pre)).astype(np.float32)
    return i_pre, f_pre


def mlstm_case(S, carried, extreme):
    """The float32 inputs (q, k / sqrt(D), v, log_i, log_f, C, n, m) of the
    chunkwise forward and the numpy inputs of the reference's
    ``mlstm_scan``."""
    rng = np.random.default_rng(S * 4 + carried * 2 + extreme + 500)
    (q, k, v, _, _), state = mlstm_np(rng, S, carried)
    i_pre, f_pre = gates_np(rng, S, extreme)
    args = [torch.from_numpy(a) for a in (q, k / math.sqrt(D), v, i_pre,
                                          F.logsigmoid(torch.from_numpy(f_pre)).numpy(), *state)]
    return args, (q, k, v, i_pre, f_pre, *state)


def extreme_case(S, carried):
    """An extreme case's inputs and ``ref_mlstm_fwd_saved`` on them."""
    args, _ = mlstm_case(S, carried, True)
    return args, ref.ref_mlstm_fwd_saved(*args, L)


def rows(args, h32, plain_h32):
    """Per row of h: the error of ``h32`` and of the float32 plain loop's
    ``plain_h32`` against the plain loop run in float64 on ``args`` (q, k, v,
    log_i, log_f, C, n, m), and the row's norm."""
    C, n, m = (a.double() for a in args[5:])
    hs = []
    for t in range(args[0].shape[2]):
        C, n, m, h, _ = ref.mlstm_step(C, n, m, *(a[:, :, t].double() for a in args[:5]))
        hs.append(h)
    exact = torch.stack(hs, dim=2)
    return ((h32.double() - exact).norm(dim=-1), (plain_h32.double() - exact).norm(dim=-1),
            exact.norm(dim=-1))


def check_rows(args, h32, plain_h32) -> int:
    """Holds ``h32`` to the rule above; returns the number of ill-conditioned
    rows, those held to ``FACTOR`` times the plain loop's own error."""
    err, own, row = rows(args, h32, plain_h32)
    loose = own > REL * row
    assert (err[~loose] <= REL * row[~loose]).all(), float((err / row)[~loose].max())
    assert (err[loose] <= FACTOR * own[loose]).all(), float((err / own)[loose].max())
    return int(loose.sum())


def readings(args, h32, plain_h32) -> tuple[int, float, float]:
    """(ill-conditioned rows, the largest err / own on them, the largest
    err / |row| on the others)."""
    err, own, row = rows(args, h32, plain_h32)
    loose = own > REL * row
    on = float((err / own)[loose].max()) if loose.any() else 0.0
    return int(loose.sum()), on, float((err / row)[~loose].max())


@contextlib.contextmanager
def float64_plain():
    """``ref.py``'s plain loops cast their inputs with ``.float()``; inside
    this block that cast leaves a float64 tensor as it is, so the loops run
    in float64 on float64 inputs (the oracle of the backward mirrors)."""
    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: (
        self if self.dtype == torch.float64 else real(self, *a, **kw))
    try:
        yield
    finally:
        torch.Tensor.float = real


def gates_bwd_scaled(log_i, log_f, m, dii, dff, dm):
    """``ref._gates_bwd`` from the products di i_s and df f_s (``dii``,
    ``dff``) instead of di and df, as the backward kernels' chain
    (``xlstm.cuh`` ``gates_bwd_scaled``) takes them: the chunkwise backward
    forms those products, and never divides by a gate."""
    a = log_f + m
    dff = torch.where(torch.isinf(m), 0.0, dff)
    dm = dm - dii - dff
    first = torch.isinf(torch.maximum(a, log_i))
    dm_til = torch.where(first, 0.0, dm)
    wa = ref._tie(a, log_i)
    dli = dii + torch.where(first, dm, 0.0) + dm_til * (1.0 - wa)
    return dli, dff + dm_til * wa, dff + dm_til * wa


def chunkwise_mlstm_bwd(q, k, v, log_i, log_f, saved, dh, dC, dn, dm, chunk, block=32):
    """The mLSTM backward kernels' algorithm (``csrc/mlstm_scan.cu``) in
    plain torch, with ``ref.ref_mlstm_bwd``'s inputs and outputs. The chunks
    of ``chunk`` steps are walked backwards carrying dC (the gradient of
    the chunk's exit state) and dn; within a chunk, from the saves alone,
    w_ts = exp(D_ts + log_i_s - m_t) (D_ts summed over (s, t] only) and c_t
    = exp(F_t + m0 - m_t), and, with dNum = dh / den, S = Q K^T, P = w S,
    dP = dNum V^T:

      dv    = P^T dNum + w_last (K dC)
      dq    = (w dP) K + c dNum C0^T            (+ ds n_t, the reduce's)
      dk    = (w (dP + ds))^T Q + w_last (V dC^T + dn)
      dC0   = Q^T (c dNum) + c_last dC,  dn0 = Q^T (c ds) + c_last dn
      di_t i_t = sum_u M_ut + y_t
      df_t f_t = sum_{u>=t} a_u + e + sum_{u>=t, s<t} M_us + sum_{s<t} y_s

    with M = P (dP + ds), y_s = w_last_s (k_s^T dC v_s + dn . k_s), a_u =
    c_u q_u^T C0 dnum_u + c_u ds_u q_u . n0 and e = c_last (<dC, C0> + dn .
    n0): no division by a gate and no difference of two cumulative sums.
    The value columns are split in blocks of ``block`` as the kernel's CTAs
    take them; every sum over them is a partial of its block, the ds and dn
    terms the first block's, summed over the blocks in order as the second
    launch does, which then runs the stabiliser chain."""
    ck, n_all, m_all, nq_all, h32 = saved
    B, H, S, d = q.shape
    qf, kf, vf, dhf = q.float(), k.float(), v.float(), dh.float()
    g = (dhf * h32).sum(-1)
    e = torch.exp(-m_all[..., 1:])
    den = torch.maximum(nq_all.abs(), e)
    dden = -g / den
    ds = dden * ref._tie(nq_all.abs(), e) * torch.sign(nq_all)
    dmden = -e * dden * ref._tie(e, nq_all.abs())
    dnum = dhf / den[..., None]
    blocks = [slice(x, min(d, x + block)) for x in range(0, d, block)]
    dq_part = torch.zeros(len(blocks), *q.shape, dtype=h32.dtype)
    dk_part, dv = torch.zeros_like(dq_part), torch.zeros_like(h32)
    ii, ff = (torch.zeros(len(blocks), B, H, S, dtype=h32.dtype) for _ in range(2))
    dCx, dnx = dC.clone(), dn.clone()
    for kc in reversed(range(ck.shape[0])):
        t0, t1 = kc * chunk, min(S, kc * chunk + chunk)
        r = torch.arange(t1 - t0)
        causal = r[:, None] >= r[None, :]
        inside = (r[None, None, :] > r[None, :, None]) & (r[None, None, :] <= r[:, None, None])
        li, lf = log_i[..., t0:t1], log_f[..., t0:t1]
        D = torch.where(inside, lf[..., None, None, :], 0.0).sum(-1)  # [.., t, s]: (s, t]
        m0, mt = m_all[..., t0], m_all[..., t0 + 1:t1 + 1]
        w = torch.where(causal, torch.exp(D + li[..., None, :] - mt[..., None]), 0.0)
        c = torch.where(torch.isinf(m0)[..., None], 0.0,
                        torch.exp(torch.cumsum(lf, -1) + m0[..., None] - mt))
        wl, cl = w[..., -1, :], c[..., -1]
        Q, K, C0, n0 = qf[..., t0:t1, :], kf[..., t0:t1, :], ck[kc], n_all[..., t0, :]
        P = w * (Q @ K.transpose(-1, -2))
        dsc = ds[..., t0:t1]
        up = r[None, :] >= r[:, None]  # [t, u]: u >= t
        cross = (r[None, :, None] >= r[:, None, None]) & (r[None, None, :] < r[:, None, None])
        dC_new = torch.empty_like(dCx)
        for x, cols in enumerate(blocks):
            V, dN, dCb = vf[..., t0:t1, cols], dnum[..., t0:t1, cols], dCx[..., :, cols]
            dsx = dsc if x == 0 else torch.zeros_like(dsc)
            dP = dN @ V.transpose(-1, -2)
            Mk = w * (dP + dsx[..., None])
            M = P * (dP + dsx[..., None])
            xv = wl[..., None] * (K @ dCb)
            y = (xv * V).sum(-1)
            dv[..., t0:t1, cols] = xv + P.transpose(-1, -2) @ dN
            cdN = c[..., None] * dN
            dqc = cdN @ C0[..., :, cols].transpose(-1, -2)
            a = (dqc * Q).sum(-1)
            dq_part[x, ..., t0:t1, :] = dqc + (w * dP) @ K
            dk = wl[..., None] * (V @ dCb.transpose(-1, -2))
            e_ = cl * (dCb * C0[..., :, cols]).sum((-2, -1))
            if x == 0:
                dk = dk + wl[..., None] * dnx[..., None, :]
                y = y + wl * (K @ dnx[..., None])[..., 0]
                a = a + c * dsc * (Q @ n0[..., None])[..., 0]
                e_ = e_ + cl * (dnx * n0).sum(-1)
            dk_part[x, ..., t0:t1, :] = dk + Mk.transpose(-1, -2) @ Q
            ii[x, ..., t0:t1] = M.sum(-2) + y
            ff[x, ..., t0:t1] = ((a[..., None, :] * up).sum(-1) + e_[..., None]
                                 + (M[..., None, :, :] * cross).sum((-2, -1))
                                 + (y[..., None, :] * ~up).sum(-1))
            dC_new[..., :, cols] = cl[..., None, None] * dCb + Q.transpose(-1, -2) @ cdN
        dnx = cl[..., None] * dnx + (Q * (c * dsc)[..., None]).sum(-2)
        dCx = dC_new
    dq = dq_part.sum(0) + ds[..., None] * n_all[..., 1:, :]
    dk = dk_part.sum(0)
    ii, ff = ii.sum(0), ff.sum(0)
    dli, dlf = torch.zeros_like(log_i), torch.zeros_like(log_f)
    for t in reversed(range(S)):
        dli[..., t], dlf[..., t], dm = gates_bwd_scaled(
            log_i[..., t], log_f[..., t], m_all[..., t], ii[..., t], ff[..., t],
            dm + dmden[..., t])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dli, dlf, dCx, dnx, dm


def reformulated_slstm_bwd(r, saved, dhs, dc, dn, dh, dm):
    """The sLSTM backward kernels' algorithm (``csrc/slstm_scan.cu``) in
    plain torch, with ``ref.ref_slstm_bwd``'s inputs and outputs. The i and
    f columns of a step's preactivation gradient are per-head scalars (dli
    / hd, dpf / hd) broadcast over hd, so r's i and f blocks enter dh_{t-1}
    only through wi and wf, those blocks summed over their columns:
    dh_{t-1} = rz gz + ro go + wi gi + wf gf, the matvec over the z and o
    columns alone; dr's i and f blocks are sum over (b, t) of h_{t-1} gi
    (and gf), each written across its hd columns, its z and o blocks the
    [hd, B S] x [B S, 2 hd] product."""
    h_all, c_all, n_all, z_all, o_all, li_all, pf_all, m_all = saved
    S, hd = dhs.shape[1], dhs.shape[-1]
    rz, ro = r[..., :hd], r[..., 3 * hd:]
    wi, wf = r[..., hd:2 * hd].sum(-1), r[..., 2 * hd:3 * hd].sum(-1)  # [H, hd]
    gzs, gos, gis, gfs = [], [], [], []
    for t in reversed(range(S)):
        dht = dh + dhs[:, t].float()
        c_t, n_t, z, o = c_all[:, t + 1], n_all[:, t + 1], z_all[:, t], o_all[:, t]
        li, pf, mp, mt = li_all[:, t], pf_all[:, t], m_all[:, t], m_all[:, t + 1]
        nc = torch.clamp(n_t, min=1.0)
        gh = dht / nc
        dct = dc + gh * o
        dnt = dn + torch.where(n_t >= 1.0, -dht * (o * c_t) / (nc * nc), 0.0)
        lf = F.logsigmoid(pf)
        i_s, f_s = ref._gates_at(li, lf, mp, mt)
        gz, go = dct * i_s[..., None] * (1 - z * z), gh * c_t * (1 - o) * o
        di = (dct * z + dnt).sum(-1)
        df = (dct * c_all[:, t] + dnt * n_all[:, t]).sum(-1)
        dli, dlf, dm = ref._gates_bwd(li, lf, mp, mt, di, df, dm)
        gi, gf = dli / hd, dlf * torch.sigmoid(-pf) / hd  # [B, H]
        dh = (torch.einsum("hde,bhe->bhd", rz, gz) + torch.einsum("hde,bhe->bhd", ro, go)
              + gi[..., None] * wi + gf[..., None] * wf)
        dc, dn = f_s[..., None] * dct, f_s[..., None] * dnt
        gzs.append(gz)
        gos.append(go)
        gis.append(gi)
        gfs.append(gf)
    gz, go, gi, gf = (torch.stack(x[::-1], dim=1) for x in (gzs, gos, gis, gfs))
    hp = h_all[:, :S]  # [B, S, H, hd]
    dr_i, dr_f = (torch.einsum("bshd,bsh->hd", hp, x)[..., None].expand(*r.shape[:2], hd)
                  for x in (gi, gf))
    dr = torch.cat([torch.einsum("bshd,bshe->hde", hp, gz), dr_i, dr_f,
                    torch.einsum("bshd,bshe->hde", hp, go)], dim=-1)
    dzx, dox = gz.to(dhs.dtype), go.to(dhs.dtype)
    dix, dfx = (x[..., None].expand_as(gz).to(dhs.dtype) for x in (gi, gf))
    return dzx, dix, dfx, dox, dr, dc, dn, dh, dm


def _show(tag, n_rows, got):
    n, on, off = got
    print(f"{tag}: {n} of {n_rows} rows ill-conditioned, err/own there at most {on:.4g}, "
          f"err/|row| elsewhere at most {off:.4g}")


def _top(a, b):
    return a[0] + b[0], max(a[1], b[1]), max(a[2], b[2])


def _mirror():
    """The CPU mirror and its known-wrong variants at the extreme gates of
    ``test_torch_xlstm_scan.py``, every S and state."""
    import test_torch_xlstm_scan as T

    top = {}
    for S in MLSTM_SEQS:
        for carried in (False, True):
            args, plain = extreme_case(S, carried)
            for defect in (None, *T.DEFECTS):
                h32 = T.chunkwise_mlstm_fwd(*args, L, defect=defect)[4][4]
                got = readings(args, h32, plain[4][4])
                _show(f"S={S} carried={carried} {defect or 'mirror'}", h32[..., 0].numel(), got)
                top[defect] = _top(top.get(defect, (0, 0.0, 0.0)), got)
    for defect, got in top.items():
        _show(f"all cases, {defect or 'mirror'}", "all", got)


def _card():
    """The forward kernel in float32 on ``EXTREME_CASES`` (the plain loops
    on the CPU, as the CPU tests run them) and on the extreme cases of
    ``test_torch_cuda.py`` (xlstm-125m's heads; the plain loops on the card)."""
    import test_torch_cuda as TC

    name = torch.cuda.get_device_name(0)
    top = (0, 0.0, 0.0)
    for S, carried in EXTREME_CASES:
        args, plain = extreme_case(S, carried)
        h32 = xs.mlstm_fwd(*(a.cuda() for a in args), save=True)[4][4].cpu()
        got = readings(args, h32, plain[4][4])
        _show(f"kernel, B={B} H={H} d={D} S={S} carried={carried}", h32[..., 0].numel(), got)
        top = _top(top, got)
    _show(f"these cases, kernel ({name})", "all", top)
    top = (0, 0.0, 0.0)
    for B_, S, carried, d, extreme in TC.MLSTM_CASES:
        if extreme:
            args = TC._mlstm_inputs("cuda", "float32", B_, S, carried, d=d, extreme=True)
            h32 = xs.mlstm_fwd(*args, save=True)[4][4]
            plain = ref.ref_mlstm_fwd_saved(*args, xs.kernel_chunk())[4][4]
            got = readings(args, h32, plain)
            _show(f"kernel, B={B_} H=4 d={d} S={S} carried={carried}", h32[..., 0].numel(), got)
            top = _top(top, got)
    _show(f"these cases, kernel ({name})", "all", top)


def _backward_mirrors():
    """The backward mirrors' relative L2 errors against the plain backwards
    run in float64, beside the float32 plain backwards' own, over the
    CPU tests' cases (``test_torch_xlstm_scan.py``: S = 1, 40, 100, fresh
    and carried, normal gates and gates at +-30); the largest of each,
    gradient by gradient."""
    import test_torch_xlstm_scan as T

    for kind in ("mlstm", "slstm"):
        for extreme in (False, True):
            top_m, top_p = None, None
            for S in T.BWD_SEQS:
                for carried in (False, True):
                    got, plain, exact = T.backward_case(kind, S, carried, extreme)
                    m = [T._rel(a, c) for a, c in zip(got, exact)]
                    q = [T._rel(b, c) for b, c in zip(plain, exact)]
                    top_m = m if top_m is None else [max(a, b) for a, b in zip(top_m, m)]
                    top_p = q if top_p is None else [max(a, b) for a, b in zip(top_p, q)]
            print(f"{kind} backward, gates {'+-30' if extreme else 'normal'}: mirror "
                  + " ".join(f"{x:.3g}" for x in top_m) + "; float32 plain "
                  + " ".join(f"{x:.3g}" for x in top_p))


if __name__ == "__main__":
    {"--card": _card, "--bwd": _backward_mirrors}.get(sys.argv[1] if sys.argv[1:] else "",
                                                       _mirror)()
