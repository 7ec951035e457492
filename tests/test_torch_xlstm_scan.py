"""The xLSTM time loops' plain versions (``kernels/ref.py``) and wrapper
(``kernels/xlstm_scan.py``) on the CPU, at smoke size in float32 (4 heads
of 16, S in {1, 7, 40}), from a zero state and a carried one:

* each plain backward (``ref_mlstm_bwd``, ``ref_slstm_bwd``, the CUDA
  kernels' algorithm) against torch autograd of the plain forward, and,
  through the wrapper's autograd Functions, against ``jax.vjp`` of the
  reference's ``mlstm_scan`` / ``slstm_block`` on the same numpy inputs;
* the mLSTM's segment recompute with a checkpoint interval K below S and
  not dividing it;
* CPU and ``meta`` tensors reach the plain loop, and launch nothing.

Tolerance 1e-5 (atol = rtol): float32 sums in another order, as in
``test_torch_ssm.py``. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``); their algorithms run here
as plain torch mirrors: the two forwards' against the plain loops and the
reference, the two backwards' (``torch_xlstm_cases.py``) against the plain
backwards run in float64 (S in {1, 40, 100}), each at a relative L2 of
1e-4, with the tolerance at gates of +-30 stated where it is set."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as JS
from repro_torch.kernels import _build, ref
from repro_torch.kernels import xlstm_scan as xs
from repro_torch.models import ssm as TS
from torch_xlstm_cases import (B, D, EXTREME_CASES, FACTOR, H, L, MLSTM_SEQS, REL,
                               check_rows, chunkwise_mlstm_bwd, extreme_case, float64_plain,
                               gates_bwd_scaled, mlstm_case, mlstm_np, rand,
                               reformulated_slstm_bwd, rows)

TOL = 1e-5
SEQS = [1, 7, 40]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _grads(out, leaves, cots):
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("every", [3, xs.CHECKPOINT_EVERY])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_mlstm_plain_backward_matches_autograd(S, carried, every):
    """``ref_mlstm_bwd``, recomputing segments of ``every`` steps from the
    checkpoints, against autograd of ``ref_mlstm_scan``: every input's
    gradient, the state's included."""
    rng = np.random.default_rng(S * 10 + carried)
    (q, k, v, i_pre, f_pre), state = mlstm_np(rng, S, carried)
    leaves = [_leaf(a) for a in (q, k / math.sqrt(D), v, i_pre)]
    leaves.append(_leaf(F.logsigmoid(torch.from_numpy(f_pre)).numpy()))
    leaves += [_leaf(a) for a in state]
    out = ref.ref_mlstm_scan(*leaves)
    cots = [torch.from_numpy(rand(rng, *o.shape)) for o in out]
    want = _grads(out, leaves, cots)
    with torch.no_grad():
        *fwd, saved = ref.ref_mlstm_fwd_saved(*leaves, every)
        got = ref.ref_mlstm_bwd(*leaves[:5], saved, *cots, every)
    for a, b in zip(fwd, out, strict=True):
        assert torch.equal(a, b)
    for name, a, b in zip("q k v log_i log_f C n m".split(), got, want, strict=True):
        if not carried and name in ("C", "n", "m"):
            b = torch.zeros_like(a) if b is None else b  # a fresh state: nothing flows back
        _close(a, b)


def test_mlstm_checkpoints_are_the_plain_loops_states():
    """The forward's saved tensors are the plain loop's own states: C
    before every K-th step, n and m after every step, n . q and h in
    float32 (K = 3 < S = 40, not dividing it)."""
    rng = np.random.default_rng(5)
    (q, k, v, i_pre, f_pre), state = mlstm_np(rng, 40, True)
    args = [torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre, *state)]
    args[4] = F.logsigmoid(args[4])
    _, _, _, _, (ck, n_all, m_all, nq_all, h32) = ref.ref_mlstm_fwd_saved(*args, 3)
    assert ck.shape[0] == 14 and n_all.shape[2] == 41 and h32.shape == q.shape
    assert torch.equal(ck[0], args[5]) and torch.equal(n_all[:, :, 0], args[6])
    assert torch.equal(m_all[:, :, 0], args[7])
    for t in range(1, 41):
        _, C, n, m = ref.ref_mlstm_scan(args[0][:, :, :t], args[1][:, :, :t],
                                        args[2][:, :, :t], args[3][:, :, :t],
                                        args[4][:, :, :t], *args[5:])
        if t % 3 == 0 and t < 40:
            assert torch.equal(ck[t // 3], C)
        assert torch.equal(n_all[:, :, t], n) and torch.equal(m_all[:, :, t], m)


def _jax_mlstm(q, k, v, i_pre, f_pre, C, n, m):
    h, (C, n, m, _) = JS.mlstm_scan(q, k, v, i_pre, f_pre, (C, n, m, jnp.zeros(())))
    return h, C, n, m


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_mlstm_function_backward_matches_jax_vjp(S, carried, monkeypatch):
    """``models.ssm.mlstm_scan`` through ``xlstm_scan.MLSTM`` (its plain
    forward-with-saves and ``ref_mlstm_bwd`` on the CPU) against
    ``jax.vjp`` of the reference's ``mlstm_scan``: the output, the final
    state and the gradients of q, k, v, both gate preactivations and the
    carried state."""
    monkeypatch.setattr(xs, "mlstm", xs.MLSTM.apply)
    rng = np.random.default_rng(S * 10 + carried + 100)
    inputs, state = mlstm_np(rng, S, carried)
    out_j, vjp = jax.vjp(_jax_mlstm, *(jnp.asarray(a) for a in (*inputs, *state)))
    cots = [rand(rng, *o.shape) for o in out_j]
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [_leaf(a) for a in (*inputs, *state)]
    h, (C, n, m, _) = TS.mlstm_scan(*leaves[:5], tuple(leaves[5:]))
    out_t = (h, C, n, m)
    got = _grads(out_t, leaves, [torch.from_numpy(c) for c in cots])
    for a, b in zip(out_t, out_j, strict=True):
        _close(a.detach(), b)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not carried and i == 7:  # the -inf stabiliser: 0 here, undefined in JAX
            assert torch.equal(a, torch.zeros_like(a))
            continue
        _close(a, b)


def _slstm_np(rng, S, carried):
    D_model = H * D
    x = rand(rng, B, S, D_model)
    p = {k: rand(rng, D_model, D_model, scale=D_model ** -0.5)
         for k in ("wz", "wi", "wf", "wo", "wout")}
    p |= {k: rand(rng, H, D, D, scale=D ** -0.5) for k in ("rz", "ri", "rf", "ro")}
    if carried:
        state = (rand(rng, B, H, D), np.abs(rand(rng, B, H, D)) + 0.5,
                 rand(rng, B, H, D, scale=0.5), rand(rng, B, H))
    else:
        z = np.zeros((B, H, D), np.float32)
        state = (z, z, z, np.full((B, H), -np.inf, np.float32))
    return x, p, state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_slstm_plain_backward_matches_autograd(S, carried):
    """``ref_slstm_bwd`` against autograd of ``ref_slstm_scan``: the
    gradients of the four preactivations, r and the state."""
    rng = np.random.default_rng(S * 10 + carried + 200)
    _, _, state = _slstm_np(rng, S, carried)
    leaves = [_leaf(rand(rng, B, S, H, D)) for _ in range(4)]
    leaves += [_leaf(rand(rng, H, D, 4 * D, scale=D ** -0.5))] + [_leaf(a) for a in state]
    out = ref.ref_slstm_scan(*leaves)
    cots = [torch.from_numpy(rand(rng, *o.shape)) for o in out]
    want = _grads(out, leaves, cots)
    with torch.no_grad():
        *fwd, saved = ref.ref_slstm_fwd_saved(*leaves)
        got = ref.ref_slstm_bwd(leaves[4], saved, *cots)
    for a, b in zip(fwd, out, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(got, want, strict=True):
        _close(a, torch.zeros_like(a) if b is None else b)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_slstm_function_backward_matches_jax_vjp(S, carried, monkeypatch):
    """``models.ssm.slstm_block`` through ``xlstm_scan.SLSTM`` (its plain
    forward-with-saves and ``ref_slstm_bwd`` on the CPU) against
    ``jax.vjp`` of the reference's ``slstm_block``: the output, the final
    state and the gradients of x, every parameter and the carried state."""
    monkeypatch.setattr(xs, "slstm", xs.SLSTM.apply)
    rng = np.random.default_rng(S * 10 + carried + 300)
    x, p, state = _slstm_np(rng, S, carried)
    names = list(p)

    def jfn(x, *rest):
        ps = dict(zip(names, rest[:len(names)]))
        y, st = JS.slstm_block(x, ps, num_heads=H, state=tuple(rest[len(names):]))
        return (y, *st)

    out_j, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, *p.values(), *state)))
    cots = [rand(rng, *o.shape) for o in out_j]
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [_leaf(a) for a in (x, *p.values(), *state)]
    ps = dict(zip(names, leaves[1:1 + len(names)]))
    y, st = TS.slstm_block(leaves[0], ps, num_heads=H, state=tuple(leaves[1 + len(names):]))
    out_t = (y, *st)
    got = _grads(out_t, leaves, [torch.from_numpy(c) for c in cots])
    for a, b in zip(out_t, out_j, strict=True):
        _close(a.detach(), b)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not carried and i == len(leaves) - 1:  # the -inf stabiliser
            assert torch.equal(a, torch.zeros_like(a))
            continue
        _close(a, b)


def _no_build(*_):
    raise AssertionError("a host tensor reached the kernel library")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_and_meta_tensors_take_the_plain_loop(device, monkeypatch):
    """On CPU and ``meta`` tensors both entry points run the plain loop
    (the same values, on the CPU, as ``ref.py``'s), record ordinary
    autograd (no Function of the wrapper), never load the kernel library
    and count no launch: the dry run traces the step on ``meta``."""
    monkeypatch.setattr(_build, "lib", _no_build)
    before = dict(xs.launches)
    rng = np.random.default_rng(7)
    (q, k, v, i_pre, f_pre), state = mlstm_np(rng, 7, True)
    args = [torch.from_numpy(a).to(device).requires_grad_(True)
            for a in (q, k, v, i_pre, f_pre, *state)]
    got = xs.mlstm(*args)
    assert got[0].shape == q.shape and got[1].shape == state[0].shape
    assert "MLSTM" not in type(got[0].grad_fn).__name__
    zx = [torch.from_numpy(rand(rng, B, 7, H, D)).to(device) for _ in range(4)]
    r = torch.from_numpy(rand(rng, H, D, 4 * D)).to(device)
    _, _, sst = _slstm_np(rng, 7, True)
    sargs = [*zx, r, *(torch.from_numpy(a).to(device) for a in sst)]
    sgot = xs.slstm(*sargs)
    assert sgot[0].shape == zx[0].shape and len(sgot) == 5
    if device == "cpu":
        for a, b in zip(got, ref.ref_mlstm_scan(*args), strict=True):
            assert torch.equal(a, b)
        for a, b in zip(sgot, ref.ref_slstm_scan(*sargs), strict=True):
            assert torch.equal(a, b)
    assert xs.launches == before


# ---------------------------------------------------------------------------
# the forward kernels' algorithms, as plain torch mirrors
# ---------------------------------------------------------------------------


def _rel_close(got, want, tol=REL):
    """Infinities (a fresh stabiliser) in the same places, the rest within
    a relative L2 of ``tol``."""
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(np.array(want))
    assert got.shape == want.shape
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
    got, want = got[fin].double(), want[fin].double()
    err = float((got - want).norm() / want.norm().clamp(min=1e-30))
    assert err <= tol, err


def chunkwise_mlstm_fwd(q, k, v, log_i, log_f, C, n, m, chunk, defect=None):
    """The mLSTM forward kernel's algorithm (``csrc/mlstm_scan.cu``) in
    plain torch, with ``ref_mlstm_fwd_saved``'s outputs and saves. A chunk
    of steps from the state (C0, n0, m0), with D_ts the sum of log_f over
    the steps (s, t] of the chunk (never a difference of two cumulative
    sums, which cancels) and F_t = D_t,-1:
    m_t = max(F_t + m0, max_{s<=t} D_ts + log_i_s); w_ts = exp(D_ts + log_i_s
    - m_t); c_t = exp(F_t + m0 - m_t), 0 when m0 = -inf; then
    h_t = (sum_s w_ts (q_t . k_s) v_s + c_t q_t C0) / max(|nq_t|, exp(-m_t)),
    nq_t = sum_s w_ts (q_t . k_s) + c_t q_t . n0, n_t = c_t n0 + sum_s w_ts k_s
    and the chunk's exit C = c_last C0 + K^T (w_last V). ``defect`` makes it
    a known-wrong variant, for the checks' own tests (``DEFECTS``)."""
    S = q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    ck, ns, ms, nqs, h32 = [], [n], [m], [], []
    for t0 in range(0, S, chunk):
        t1 = min(S, t0 + chunk)
        r = torch.arange(t1 - t0)
        causal = r[:, None] >= r[None, :]
        li, lf = log_i[..., t0:t1], log_f[..., t0:t1]
        inside = (r[None, None, :] > r[None, :, None]) & (r[None, None, :] <= r[:, None, None])
        D = torch.where(inside, lf[..., None, None, :], 0.0).sum(-1)  # [.., t, s]: (s, t]
        F_t = torch.cumsum(lf, -1)
        if defect == "cancel":
            D = F_t[..., :, None] - F_t[..., None, :]
        e = torch.where(causal, D + li[..., None, :], -math.inf)
        fresh = torch.isinf(m)[..., None]
        m_t = torch.maximum(F_t + m[..., None], e.amax(-1))
        c = torch.where(fresh, 0.0, torch.exp(F_t + m[..., None] - m_t))
        w = torch.exp(e - m_t[..., None])
        Q, K, V = qf[..., t0:t1, :], kf[..., t0:t1, :], vf[..., t0:t1, :]
        if defect == "w_bf16":
            w = w.bfloat16().float()
        if defect == "tf32":  # 10 bits of mantissa, as the tensor cores' TF32 takes
            Q, K, V = ((x.view(torch.int32) & ~0x1FFF).view(torch.float32) for x in (Q, K, V))
        P = w * (Q @ K.transpose(-1, -2))
        nq = P.sum(-1) + c * (Q @ n[..., None])[..., 0]
        den = torch.maximum(nq.abs(), torch.exp(-m_t))
        h32.append((P @ V + c[..., None] * (Q @ C)) / den[..., None])
        n_rows = c[..., None] * n[..., None, :] + w @ K
        ck.append(C)
        C = c[..., -1, None, None] * C + K.transpose(-1, -2) @ (w[..., -1, :, None] * V)
        n, m = n_rows[..., -1, :], m_t[..., -1]
        ns += n_rows.unbind(2)
        ms += m_t.unbind(2)
        nqs.append(nq)
    h32 = torch.cat(h32, 2)
    saved = (torch.stack(ck), torch.stack(ns, 2), torch.stack(ms, 2), torch.cat(nqs, 2), h32)
    return h32.to(q.dtype), C, n, m, saved


# known-wrong variants of the mirror, for the row check's own tests
DEFECTS = {"cancel": "D_ts as the difference F_t - F_s of two cumulative sums",
           "w_bf16": "the in-chunk weights w rounded to bfloat16",
           "tf32": "q, k and v rounded to TF32 for the products"}


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", MLSTM_SEQS)
def test_chunkwise_mlstm_matches_the_plain_loop_and_jax(S, carried, extreme):
    """The chunkwise mirror in chunks of the checkpoint interval against
    ``ref_mlstm_fwd_saved`` (h, the state and every save) and the
    reference's ``mlstm_scan`` (h and the state), at a relative L2 of 1e-4:
    S below, at and past one chunk and a ragged 3L + 5; a fresh state (m =
    -inf) and a carried one; normal gates and gates at their extremes (where
    h, ill-conditioned, is held row by row to the float64 loop instead:
    ``torch_xlstm_cases.py``)."""
    args, np_args = mlstm_case(S, carried, extreme)
    got = chunkwise_mlstm_fwd(*args, L)
    want = ref.ref_mlstm_fwd_saved(*args, L)
    out_j = _jax_mlstm(*(jnp.asarray(a) for a in np_args))
    names = ("h", "C", "n", "m", "ck", "n_all", "m_all", "nq", "h32")
    apart = {"h", "h32"} if extreme else set()  # then held to the float64 loop below
    for name, a, b in zip(names, (*got[:4], *got[4]), (*want[:4], *want[4]), strict=True):
        if name not in apart:
            _rel_close(a, b)
    for name, a, b in zip(names, got[:4], out_j):
        if name not in apart:
            _rel_close(a, b)
    if extreme:
        assert (check_rows(args, got[4][4], want[4][4]) > 0) == ((S, carried) in EXTREME_CASES)


@pytest.mark.parametrize("S,carried,defect", [
    (L + 1, False, "w_bf16"), (L + 1, False, "tf32"), (3 * L + 5, False, "tf32"),
    (3 * L + 5, True, "w_bf16"), (3 * L + 5, True, "tf32")])
def test_the_extreme_row_check_rejects_wrong_orders_on_ill_conditioned_rows(S, carried, defect):
    """The row check's looser branch has teeth: on the ill-conditioned rows
    of h alone (where each float32 order is more than 1e-4 of the row off
    float64), a known-wrong variant of the mirror is more than ``FACTOR``
    times the float32 plain loop's own error off float64, while the mirror
    is held within it (the test above)."""
    args, want = extreme_case(S, carried)
    err, own, row = rows(args, chunkwise_mlstm_fwd(*args, L, defect=defect)[4][4], want[4][4])
    loose = own > REL * row
    assert loose.any() and (err[loose] > FACTOR * own[loose]).any(), DEFECTS[defect]


def chunkwise_slstm_fwd(zx, ix, fx, ox, r, c, n, h, m):
    """The sLSTM forward kernel's algorithm (``csrc/slstm_scan.cu``) in
    plain torch, with ``ref_slstm_fwd_saved``'s outputs and saves: the
    per-head gate means as mean(ix) + h . wi and mean(fx) + h . wf, wi and
    wf the recurrent matrices r_i and r_f summed over their columns, and
    only the z and o columns of r in the product."""
    hd = zx.shape[-1]
    wi, wf = (r[..., (1 + g) * hd:(2 + g) * hd].sum(-1) for g in (0, 1))  # [H, hd]
    rzo = torch.cat([r[..., :hd], r[..., 3 * hd:]], dim=-1)
    keep = {k: [v] for k, v in (("h", h), ("c", c), ("n", n), ("m", m))}
    keep |= {k: [] for k in ("z", "o", "li", "pf")}
    for zt, it, ft, ot in zip(zx.float().unbind(1), ix.float().unbind(1),
                              fx.float().unbind(1), ox.float().unbind(1)):
        zr, orr = torch.einsum("bhd,hde->bhe", h, rzo).split(hd, dim=-1)
        li = (it.sum(-1) + (h * wi).sum(-1)) / hd
        pf = (ft.sum(-1) + (h * wf).sum(-1)) / hd
        z, o = torch.tanh(zt + zr), torch.sigmoid(ot + orr)
        m, i_s, f_s = ref._gates(li, F.logsigmoid(pf), m)
        c = f_s[..., None] * c + i_s[..., None] * z
        n = f_s[..., None] * n + i_s[..., None]
        h = o * c / torch.clamp(n, min=1.0)
        for key, val in (("h", h), ("c", c), ("n", n), ("m", m), ("z", z), ("o", o),
                         ("li", li), ("pf", pf)):
            keep[key].append(val)
    saved = tuple(torch.stack(keep[key], dim=1)
                  for key in ("h", "c", "n", "z", "o", "li", "pf", "m"))
    return saved[0][:, 1:].to(zx.dtype), c, n, h, m, saved


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_slstm_gate_means_from_summed_columns_match_plain_and_jax(S, carried, extreme):
    """The sLSTM mirror (gate means from wi and wf) against
    ``ref_slstm_fwd_saved`` (every output and save) and the reference's
    ``slstm_block`` (its output and final state), at a relative L2 of 1e-4;
    ``extreme`` scales the input and forget preactivations by 30."""
    rng = np.random.default_rng(S * 4 + carried * 2 + extreme + 600)
    x, p, state = _slstm_np(rng, S, carried)
    if extreme:
        p["wi"], p["wf"] = p["wi"] * 30, p["wf"] * 30
    Dm = H * D
    pre = [torch.from_numpy(x @ p[w]).view(B, S, H, D) for w in ("wz", "wi", "wf", "wo")]
    r = torch.from_numpy(np.concatenate([p[w] for w in ("rz", "ri", "rf", "ro")], axis=-1))
    args = [*pre, r, *(torch.from_numpy(a) for a in state)]
    got = chunkwise_slstm_fwd(*args)
    want = ref.ref_slstm_fwd_saved(*args)
    for a, b in zip((*got[:5], *got[5]), (*want[:5], *want[5]), strict=True):
        _rel_close(a, b)
    y_j, st_j = JS.slstm_block(jnp.asarray(x), {k: jnp.asarray(a) for k, a in p.items()},
                               num_heads=H, state=tuple(jnp.asarray(a) for a in state))
    _rel_close(got[0].reshape(B, S, Dm) @ torch.from_numpy(p["wout"]), y_j)
    for a, b in zip(got[1:5], st_j, strict=True):
        _rel_close(a, b)


# ---------------------------------------------------------------------------
# the backward kernels' algorithms, as plain torch mirrors held to float64
# ---------------------------------------------------------------------------

BWD_SEQS = [1, 40, 100]


def _rel(got, want) -> float:
    """The relative L2 error of ``got`` against ``want`` over ``want``'s
    finite entries, after checking the infinities match."""
    got, want = got.detach(), want.detach()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin].double(),
                                                                 want[~fin].double())
    got, want = got[fin].double(), want[fin].double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _hold_to_float64(got, plain, exact, loose: bool):
    """Each gradient of a mirror (``got``, float32) within a relative L2 of
    ``REL`` of the plain backward run in float64 (``exact``); with ``loose``
    (gates at +-30, where the gradients inherit h's ill-conditioned rows and
    every float32 order of the sums is off float64 by more than ``REL``)
    within twice the float32 plain backward's (``plain``) own error where
    that is the larger."""
    for i, (a, b, c) in enumerate(zip(got, plain, exact, strict=True)):
        tol = max(REL, 2.0 * _rel(b, c)) if loose else REL
        err = _rel(a, c)
        assert err <= tol, (i, err, tol)


def backward_case(kind, S, carried, extreme):
    """One case of the backward mirrors: (the mirror's gradients, the
    float32 plain backward's, the plain backward's run in float64), all on
    the same float32 inputs, saves and cotangents (the float64 run on its
    own float64 saves). The mLSTM's value columns in blocks of 8, so the
    first block's ds and dn terms and the blocks' partials are exercised;
    ``extreme``: gates at +-30 (the sLSTM's input and forget
    preactivations scaled by 30)."""
    if kind == "mlstm":
        args, _ = mlstm_case(S, carried, extreme)
        *out, saved = ref.ref_mlstm_fwd_saved(*args, L)
        rng = np.random.default_rng(S * 4 + carried * 2 + extreme + 900)
        cots = [torch.from_numpy(rand(rng, *o.shape)) for o in out]
        got = chunkwise_mlstm_bwd(*args[:5], saved, *cots, L, block=8)
        plain = ref.ref_mlstm_bwd(*args[:5], saved, *cots, L)
        d64 = [a.double() for a in args]
        with float64_plain():
            *_, saved64 = ref.ref_mlstm_fwd_saved(*d64, L)
            exact = ref.ref_mlstm_bwd(*d64[:5], saved64, *(c.double() for c in cots), L)
        return got, plain, exact
    rng = np.random.default_rng(S * 4 + carried * 2 + extreme + 700)
    x, p, state = _slstm_np(rng, S, carried)
    if extreme:
        p["wi"], p["wf"] = p["wi"] * 30, p["wf"] * 30
    pre = [torch.from_numpy(x @ p[w]).view(B, S, H, D) for w in ("wz", "wi", "wf", "wo")]
    r = torch.from_numpy(np.concatenate([p[w] for w in ("rz", "ri", "rf", "ro")], axis=-1))
    args = [*pre, r, *(torch.from_numpy(a) for a in state)]
    *out, saved = ref.ref_slstm_fwd_saved(*args)
    cots = [torch.from_numpy(rand(rng, *o.shape)) for o in out]
    got = reformulated_slstm_bwd(r, saved, *cots)
    plain = ref.ref_slstm_bwd(r, saved, *cots)
    d64 = [a.double() for a in args]
    with float64_plain():
        *_, saved64 = ref.ref_slstm_fwd_saved(*d64)
        exact = ref.ref_slstm_bwd(d64[4], saved64, *(c.double() for c in cots))
    return got, plain, exact


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", BWD_SEQS)
def test_chunkwise_mlstm_backward_matches_float64(S, carried, extreme):
    """The chunkwise mLSTM backward mirror (``torch_xlstm_cases.py``; chunks
    of 32, value blocks of 8) against ``ref_mlstm_bwd`` run in float64:
    every gradient within a relative L2 of 1e-4; at gates of +-30 within
    twice the float32 plain backward's own error where that exceeds 1e-4
    (ill-conditioned there, as h is: ``torch_xlstm_cases.py``). S of one
    step, past a chunk and ragged; a fresh state and a carried one."""
    got, plain, exact = backward_case("mlstm", S, carried, extreme)
    assert all(g.dtype == q.dtype and g.shape == q.shape
               for g, q in zip(got, plain, strict=True))
    _hold_to_float64(got, plain, exact, extreme)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", BWD_SEQS)
def test_reformulated_slstm_backward_matches_float64(S, carried, extreme):
    """The sLSTM backward mirror (``torch_xlstm_cases.py``: dh_{t-1} through
    rz, ro, wi and wf, the matvec over the z and o columns alone; dr's i and
    f blocks one broadcast sum each) against ``ref_slstm_bwd`` run in
    float64: every gradient, dr and the state's included, within a relative
    L2 of 1e-4, also with the gate means at +-30 (``extreme``)."""
    got, plain, exact = backward_case("slstm", S, carried, extreme)
    assert all(g.dtype == q.dtype and g.shape == q.shape
               for g, q in zip(got, plain, strict=True))
    _hold_to_float64(got, plain, exact, False)


CHAIN_CASES = ["fresh", "carried", "tie", "shut"]


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_scaled_stabiliser_step_matches_the_plain_step(case):
    """The stabiliser chain's step from di i_s and df f_s (the chunkwise
    mLSTM backward's ``gates_bwd_scaled``) against ``ref._gates_bwd`` from
    di and df, in float64: the same gradients of log_i, log_f and the
    previous m from a fresh stabiliser (m = -inf), a carried one, a tie of
    the max (half the gradient each way), and forget gates shut (log_f =
    -100: f_s far below float32's range, never divided by)."""
    rng = np.random.default_rng(CHAIN_CASES.index(case))
    li, lf, m = (torch.from_numpy(rng.standard_normal(64)) for _ in range(3))
    lf = -lf.abs() - (100.0 if case == "shut" else 0.0)
    if case == "fresh":
        m = torch.full_like(m, -math.inf)
    if case == "tie":
        li = lf + m
    m_new = ref._gates(li, lf, m)[0]
    di, df, dm = (torch.from_numpy(rng.standard_normal(64)) for _ in range(3))
    i_s, f_s = ref._gates_at(li, lf, m, m_new)
    want = ref._gates_bwd(li, lf, m, m_new, di, df, dm)
    got = gates_bwd_scaled(li, lf, m, di * i_s, df * f_s, dm)
    for a, b in zip(got, want, strict=True):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)
