"""The SSD chunk kernels' algorithm (``csrc/ssd_scan.cu``) in plain torch,
for the CPU tests, and the check a strong-decay case is held to.

``tiled_fwd`` and ``tiled_bwd`` take ``ref.ref_ssd_fwd_saved``'s and
``ref.ref_ssd_bwd``'s inputs and give their outputs, computed as the
kernels compute them. The chunks go in groups of ``cluster`` (a cluster of
CTAs, one a chunk): first each chunk's own change of the state from zero
(forward X^T (w o B), backward (e o dy)^T C) and its e_end, then the walk
h_{k+1} = e_end_k h_k + dH_k over the group in chunk order (the backward
dh from the last chunk), every CTA of a cluster walking the same steps, and
then each chunk's terms from its state: in a chunk the 16-row strips, each
over its 16 x 16 tiles on and below the diagonal (the backward's row pass)
or on and right of it (its column pass, the tiles transposed), a strip's
tiles side by side in one product, per (value block, state tile) slice;
the partials of the slices summed in the kernels' order. Every product
takes its operands as the kernels feed the tensor cores when ``split``:
each one rounded to a bf16 hi part and a bf16 lo part of the rest, hi hi +
lo hi + hi lo (a bf16 input's lo part is 0). The arithmetic is the inputs'
dtype: float64 for the algorithm against the plain loop run in float64,
float32 for the strong-decay case, where the factored decay exp(la_t)
exp(-la_s) (``decay="factored"``, a known-wrong variant) overflows.

    PYTHONPATH=src python tests/torch_ssd_cases.py   # the readings the tests' limits were set from
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ref

FWD_BLOCK, BWD_BLOCK, TILE_N = 64, 64, 16  # the kernels' value blocks and state tile
CLUSTER = 4  # chunks a cluster walks side by side (the kernels' kMaxCluster)
REL_SPLIT = 1e-4  # a relative L2 the split products keep (the card's float32 tolerance)


def rel(got, want) -> float:
    """The relative L2 distance of ``got`` from ``want``."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def parts(v, split):
    """v's bf16 hi part and the bf16 lo part of the rest (v and 0 unsplit)."""
    if not split:
        return v, torch.zeros_like(v)
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


def mm(a, b, split):
    """a @ b as the kernels' products: hi hi + lo hi + hi lo."""
    (ah, al), (bh, bl) = parts(a, split), parts(b, split)
    return ah @ bh + al @ bh + ah @ bl


def decay_of(pt, lt, ps, ls, mode):
    """E[.., t, s] = exp(la_t - la_s) where s <= t, else 0, for rows at the
    positions pt with la lt [.., m] and columns at ps with la ls [.., n]."""
    live = ps[None, :] <= pt[:, None]
    if mode == "difference":
        return torch.exp(torch.where(live, lt[..., :, None] - ls[..., None, :], -math.inf))
    assert mode == "factored"
    return torch.where(live, torch.exp(lt)[..., :, None] * torch.exp(-ls)[..., None, :], 0.0)


def _heads(t):
    """[B, S, H, ...] -> [B * H, S, ...]."""
    return t.transpose(1, 2).reshape(t.shape[0] * t.shape[2], t.shape[1], *t.shape[3:])


def _unheads(t, B, H):
    return t.reshape(B, H, *t.shape[1:]).transpose(1, 2)


def _chunk(ts, t0, Lk, Lp):
    """Rows [t0, t0 + Lk) of each of ts [BH, S, ...], zero-padded to Lp."""
    out = []
    for t in ts:
        c = t[:, t0:t0 + Lk]
        pad = torch.zeros((c.shape[0], Lp - Lk, *c.shape[2:]), dtype=c.dtype)
        out.append(torch.cat([c, pad], dim=1))
    return out


def _blocks(P, block):
    return [slice(p0, min(P, p0 + block)) for p0 in range(0, P, block)]


def tiled_fwd(x, b, c, log_a, state, chunk, *, split=True, decay="difference",
              block=FWD_BLOCK, tile_n=TILE_N, cluster=CLUSTER):
    """(y, final state, saved) as ``ref.ref_ssd_fwd_saved``, by the forward
    kernel's algorithm."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    X, Bm, Cm, La = (_heads(t) for t in (x, b, c, log_a))
    h = state.reshape(B * H, P, N).to(x.dtype)
    blocks, tiles = _blocks(P, block), _blocks(N, tile_n)

    def local(t0):  # a chunk's own terms: its rows, la, e, and dH from zero
        Lk = min(chunk, S - t0)
        Lp = 16 * -(-Lk // 16)
        Xk, Bk, Ck, lk = _chunk((X, Bm, Cm, La), t0, Lk, Lp)
        la = torch.cumsum(lk, dim=1)  # zero past Lk: la_end there
        la_end = la[:, Lk - 1]
        w = torch.exp(la_end[:, None] - la)
        dH = torch.zeros_like(h)
        for nt in tiles:
            for pb in blocks:
                dH[:, pb, nt] = mm(Xk[:, :, pb].transpose(1, 2), w[..., None] * Bk[:, :, nt], split)
        return Lk, Xk, Bk, Ck, la, la_end.exp(), dH

    ys, saved = [], []
    starts = list(range(0, S, chunk))
    for g0 in range(0, len(starts), cluster):
        group = [local(t0) for t0 in starts[g0:g0 + cluster]]
        for Lk, Xk, Bk, Ck, la, e_end, dH in group:  # the walk, in chunk order
            saved.append(h)
            ns = -(-Lk // 16)
            pos = torch.arange(16 * ns)
            e = torch.exp(la)
            y = torch.zeros((B * H, 16 * ns, P), dtype=x.dtype)
            for nt in tiles:
                for pb in blocks:
                    hs = h[:, pb, nt]
                    for i in range(ns):
                        r, s = slice(16 * i, 16 * i + 16), slice(0, 16 * i + 16)  # tiles j <= i
                        acc = e[:, r, None] * mm(Ck[:, r, nt], hs.transpose(1, 2), split)
                        G = mm(Ck[:, r, nt], Bk[:, s, nt].transpose(1, 2), split)
                        E = decay_of(pos[r], la[:, r], pos[s], la[:, s], decay)
                        y[:, r, pb] += acc + mm(G * E, Xk[:, s, pb], split)  # past N = 16: partials
            ys.append(y[:, :Lk])
            h = e_end[:, None, None] * h + dH
    y = _unheads(torch.cat(ys, dim=1), B, H).to(x.dtype)
    return (y, h.reshape(B, H, P, N),
            torch.stack([t.reshape(B, H, P, N) for t in saved]))


def tiled_bwd(x, b, c, log_a, saved, dy, dh, chunk, *, split=True, decay="difference",
              block=BWD_BLOCK, tile_n=TILE_N, cluster=CLUSTER):
    """The gradients of (x, b, c, log_a, state) as ``ref.ref_ssd_bwd``, by
    the backward kernel's algorithm."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    X, Bm, Cm, DY, La = (_heads(t) for t in (x, b, c, dy, log_a))
    dt = x.dtype
    dh = dh.reshape(B * H, P, N).to(dt)
    dx = torch.zeros_like(X)
    db, dc = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dla = torch.zeros_like(La)
    blocks, tiles = _blocks(P, block), _blocks(N, tile_n)

    def local(k):  # a chunk's rows, la, e, and its change of dh from zero
        t0 = k * chunk
        Lk = min(chunk, S - t0)
        Lp = 16 * -(-Lk // 16)
        Xk, Bk, Ck, DYk, lk = _chunk((X, Bm, Cm, DY, La), t0, Lk, Lp)
        la = torch.cumsum(lk, dim=1)
        e = torch.exp(la)
        ddh = torch.zeros_like(dh)
        for nt in tiles:
            for pb in blocks:
                ddh[:, pb, nt] = mm((e[..., None] * DYk[:, :, pb]).transpose(1, 2), Ck[:, :, nt],
                                    split)
        return k, t0, Lk, Xk, Bk, Ck, DYk, la, ddh

    def passes(k, t0, Lk, Xk, Bk, Ck, DYk, la, dh):  # the chunk's gradients, dh at its end
        ns = -(-Lk // 16)
        Lp = 16 * ns
        h = saved[k].reshape(B * H, P, N).to(dt)
        la_end = la[:, Lk - 1]
        e_end = la_end.exp()
        pos = torch.arange(Lp)
        e, w = torch.exp(la), torch.exp(la_end[:, None] - la)
        dxk = torch.zeros((B * H, Lp, P), dtype=dt)
        dbk, dck = torch.zeros((B * H, Lp, N), dtype=dt), torch.zeros((B * H, Lp, N), dtype=dt)
        d_all = torch.zeros((B * H, Lp), dtype=dt)
        for nt in tiles:
            for pb in blocks:
                Xb, DYb, Bt, Ct = Xk[:, :, pb], DYk[:, :, pb], Bk[:, :, nt], Ck[:, :, nt]
                hb, dhb = h[:, pb, nt], dh[:, pb, nt]
                row, col, R = (torch.zeros((B * H, Lp), dtype=dt) for _ in range(3))
                for i in range(ns):  # row pass: strip i's tiles (t, s <= t)
                    r, s = slice(16 * i, 16 * i + 16), slice(0, 16 * i + 16)
                    u = mm(DYb[:, r], hb, split)
                    G = mm(Ct[:, r], Bt[:, s].transpose(1, 2), split)
                    D = mm(DYb[:, r], Xb[:, s].transpose(1, 2), split)
                    ED = decay_of(pos[r], la[:, r], pos[s], la[:, s], decay) * D
                    dck[:, r, nt] += e[:, r, None] * u + mm(ED, Bt[:, s], split)
                    row[:, r] = (ED * G).sum(-1) + e[:, r] * (Ct[:, r] * u).sum(-1)
                for j in range(ns):  # column pass: strip j's tiles transposed, (s, t >= s)
                    s, r = slice(16 * j, 16 * j + 16), slice(16 * j, Lp)
                    v = mm(Xb[:, s], dhb, split)
                    R[:, s] = w[:, s] * (Bt[:, s] * v).sum(-1)
                    Et = decay_of(pos[r], la[:, r], pos[s], la[:, s], decay).transpose(1, 2)
                    EG = Et * mm(Bt[:, s], Ct[:, r].transpose(1, 2), split)
                    Dt = mm(Xb[:, s], DYb[:, r].transpose(1, 2), split)
                    dxk[:, s, pb] += (w[:, s, None] * mm(Bt[:, s], dhb.transpose(1, 2), split)
                                      + mm(EG, DYb[:, r], split))
                    dbk[:, s, nt] += w[:, s, None] * v + mm(Et * Dt, Ct[:, r], split)
                    col[:, s] = (EG * Dt).sum(-1)
                d = (row - col - R)[:, :Lk]
                d[:, Lk - 1] += e_end * (hb * dhb).sum((-2, -1)) + R[:, :Lk].sum(-1)
                d_all[:, :Lk] += d
        dx[:, t0:t0 + Lk], db[:, t0:t0 + Lk], dc[:, t0:t0 + Lk] = (
            t[:, :Lk] for t in (dxk, dbk, dck))
        dla[:, t0:t0 + Lk] = d_all[:, :Lk].flip(1).cumsum(1).flip(1)
        return e_end

    nc = saved.shape[0]
    for g0 in reversed(range(0, nc, cluster)):
        group = [local(k) for k in range(g0, min(nc, g0 + cluster))]
        for piece in reversed(group):  # the walk, from the group's last chunk
            e_end = passes(*piece[:-1], dh)
            dh = e_end[:, None, None] * dh + piece[-1]
    return (_unheads(dx, B, H).to(x.dtype), _unheads(db, B, H).to(b.dtype),
            _unheads(dc, B, H).to(c.dtype), _unheads(dla, B, H), dh.reshape(B, H, P, N))


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

B, H, P, N = 2, 4, 4, 3
CASES = [(1, 1), (40, 16), (300, 256)]  # (S, chunk): a token; whole chunks; a padded last chunk
STRONG = -0.7  # log_a a step: a 256-token chunk's summed decay 179, past float32's exp range


def inputs(S, carried, *, strong=False, seed=0, shape=(B, H, P, N)):
    """x, b, c, log_a (-softplus of a normal, or STRONG everywhere), a state
    (zeros when not carried) and the cotangents dy, dh, as float32 numpy."""
    Bn, Hn, Pn, Nn = shape
    rng = np.random.default_rng(seed * 1000 + S * 4 + carried * 2 + strong)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x, b, c = f(Bn, S, Hn, Pn), f(Bn, S, Hn, Nn), f(Bn, S, Hn, Nn)
    log_a = (np.full((Bn, S, Hn), STRONG, np.float32) if strong
             else -np.logaddexp(f(Bn, S, Hn), 0.0).astype(np.float32))
    state = f(Bn, Hn, Pn, Nn) if carried else np.zeros((Bn, Hn, Pn, Nn), np.float32)
    return (x, b, c, log_a, state), (f(Bn, S, Hn, Pn), f(Bn, Hn, Pn, Nn))


def run_mirror(args, cots, chunk, *, split=True, decay="difference", fblock=FWD_BLOCK,
               bblock=BWD_BLOCK, tile_n=TILE_N, cluster=CLUSTER):
    """The mirror's forward and backward (on its own saves): y, h, saved,
    then the gradients of x, b, c, log_a, state."""
    y, h, saved = tiled_fwd(*args, chunk, split=split, decay=decay, block=fblock,
                            tile_n=tile_n, cluster=cluster)
    return [y, h, saved, *tiled_bwd(*args[:4], saved, *cots, chunk, split=split, decay=decay,
                                    block=bblock, tile_n=tile_n, cluster=cluster)]


def run_plain(args, cots, chunk):
    """``ref_ssd_fwd_saved`` and ``ref_ssd_bwd`` (on its own saves) in the
    inputs' dtype (float64 inside ``float64_plain``)."""
    y, h, saved = ref.ref_ssd_fwd_saved(*args, chunk)
    return [y, h, saved, *ref.ref_ssd_bwd(*args[:4], saved, *cots, chunk)]


def hold_where_finite(got, want, limit):
    """Each of ``got`` finite, and within a relative L2 of ``limit`` of
    ``want`` where ``want`` is finite; returns the largest distance."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        fin = torch.isfinite(w)
        assert torch.isfinite(g).all(), f"output {i} not finite"
        worst = max(worst, rel(g[fin], w[fin]))
        assert worst <= limit, (i, worst)
    return worst


def _readings():
    import contextlib

    from torch_xlstm_cases import float64_plain

    for S, chunk in CASES:
        for carried in (False, True):
            a, cots = inputs(S, carried)
            a64 = [torch.from_numpy(t).double() for t in a]
            c64 = [torch.from_numpy(t).double() for t in cots]
            with float64_plain():
                want = run_plain(a64, c64, chunk)
            for split in (False, True):
                got = run_mirror(a64, c64, chunk, split=split)
                print(f"S={S} chunk={chunk} carried={carried} split={split}: relative L2 "
                      + " ".join(f"{rel(g, w):.2e}" for g, w in zip(got, want)))
    a, cots = inputs(256, True, strong=True)
    a32, c32 = [torch.from_numpy(t) for t in a], [torch.from_numpy(t) for t in cots]
    want = run_plain(a32, c32, 256)
    for mode in ("difference", "factored"):
        got = run_mirror(a32, c32, 256, decay=mode)
        fin = [bool(torch.isfinite(g).all()) for g in got]
        with contextlib.suppress(AssertionError):
            print(mode, fin, hold_where_finite(got, want, REL_SPLIT))
        print(mode, "finite:", fin)


if __name__ == "__main__":
    _readings()
