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
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

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

TOL = 1e-5
B, H, D = 2, 4, 16
SEQS = [1, 7, 40]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _mlstm_np(rng, S, carried):
    q, k, v = (_rand(rng, B, H, S, D) for _ in range(3))
    i_pre, f_pre = _rand(rng, B, H, S), _rand(rng, B, H, S) + 1.0
    if carried:
        state = (_rand(rng, B, H, D, D, scale=0.3), _rand(rng, B, H, D, scale=0.3),
                 _rand(rng, B, H))
    else:
        state = (np.zeros((B, H, D, D), np.float32), np.zeros((B, H, D), np.float32),
                 np.full((B, H), -np.inf, np.float32))
    return (q, k, v, i_pre, f_pre), state


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
    (q, k, v, i_pre, f_pre), state = _mlstm_np(rng, S, carried)
    leaves = [_leaf(a) for a in (q, k / math.sqrt(D), v, i_pre)]
    leaves.append(_leaf(F.logsigmoid(torch.from_numpy(f_pre)).numpy()))
    leaves += [_leaf(a) for a in state]
    out = ref.ref_mlstm_scan(*leaves)
    cots = [torch.from_numpy(_rand(rng, *o.shape)) for o in out]
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
    (q, k, v, i_pre, f_pre), state = _mlstm_np(rng, 40, True)
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
    inputs, state = _mlstm_np(rng, S, carried)
    out_j, vjp = jax.vjp(_jax_mlstm, *(jnp.asarray(a) for a in (*inputs, *state)))
    cots = [_rand(rng, *o.shape) for o in out_j]
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
    x = _rand(rng, B, S, D_model)
    p = {k: _rand(rng, D_model, D_model, scale=D_model ** -0.5)
         for k in ("wz", "wi", "wf", "wo", "wout")}
    p |= {k: _rand(rng, H, D, D, scale=D ** -0.5) for k in ("rz", "ri", "rf", "ro")}
    if carried:
        state = (_rand(rng, B, H, D), np.abs(_rand(rng, B, H, D)) + 0.5,
                 _rand(rng, B, H, D, scale=0.5), _rand(rng, B, H))
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
    leaves = [_leaf(_rand(rng, B, S, H, D)) for _ in range(4)]
    leaves += [_leaf(_rand(rng, H, D, 4 * D, scale=D ** -0.5))] + [_leaf(a) for a in state]
    out = ref.ref_slstm_scan(*leaves)
    cots = [torch.from_numpy(_rand(rng, *o.shape)) for o in out]
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
    cots = [_rand(rng, *o.shape) for o in out_j]
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
    (q, k, v, i_pre, f_pre), state = _mlstm_np(rng, 7, True)
    args = [torch.from_numpy(a).to(device).requires_grad_(True)
            for a in (q, k, v, i_pre, f_pre, *state)]
    got = xs.mlstm(*args)
    assert got[0].shape == q.shape and got[1].shape == state[0].shape
    assert "MLSTM" not in type(got[0].grad_fn).__name__
    zx = [torch.from_numpy(_rand(rng, B, 7, H, D)).to(device) for _ in range(4)]
    r = torch.from_numpy(_rand(rng, H, D, 4 * D)).to(device)
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
