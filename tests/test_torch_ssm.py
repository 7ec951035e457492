"""The port's recurrent and state-space functions (``models/ssm.py``)
against the JAX package's, function for function, on the same inputs made
from a numpy seed: from a zero state and from a carried one (the JAX
function's state after a prefix), in float32 and bfloat16, and their
gradients; then the reference's own consistency checks on the port.

Tolerances (atol = rtol):
* float32: 1e-5, sums taken in another order by XLA and by torch;
* bfloat16: 2e-2. Both packages round the same values to bf16 at the same
  points (the key scale, each step's output, the SSD input), but a product
  rounded to bf16 can land one bf16 ulp (2**-8 relative, 4e-3) apart, and
  the recurrences carry it; measured at most 8.3e-3 of 1 + |JAX's value|
  here (float32: 7.2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.bridge import cache_from_numpy, cache_to_numpy
from repro_torch.models import ssm as TS

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = list(TOL)
B, H, S, D = 2, 2, 9, 8


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype`` (the
    same values: both round float32 to bfloat16 to nearest even)."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(t, j, tol):
    for a, b in zip(jax.tree_util.tree_leaves(cache_to_numpy(t)),
                    jax.tree_util.tree_leaves(j), strict=True):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=tol, rtol=tol)


def _state(jstate, like):
    """A JAX state tree, carried into the port's state ``like``."""
    return cache_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), like)


def _params(rng, shapes, dtype):
    p = {k: _rand(rng, *s, scale=0.3) for k, s in shapes.items()}
    return ({k: _pair(v, dtype)[0] for k, v in p.items()},
            {k: _pair(v, dtype)[1] for k, v in p.items()})


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_scan_matches_jax(dtype, carried):
    rng = np.random.default_rng(1)
    q, k, v = (_pair(_rand(rng, B, H, S, D), dtype) for _ in range(3))
    i, f = (_pair(_rand(rng, B, H, S), dtype) for _ in range(2))
    jstate = None
    if carried:
        pre = [_pair(_rand(rng, B, H, 4, D), dtype)[0] for _ in range(3)]
        _, jstate = JS.mlstm_scan(*pre, *(_pair(_rand(rng, B, H, 4), dtype)[0]
                                          for _ in range(2)))
    jh, jst = JS.mlstm_scan(q[0], k[0], v[0], i[0], f[0], jstate)
    th, tst = TS.mlstm_scan(q[1], k[1], v[1], i[1], f[1],
                            _state(jstate, TS.mlstm_init_state(B, H, D, "cpu"))
                            if carried else None)
    assert th.dtype == q[1].dtype and all(x.dtype == torch.float32 for x in tst)
    _close(th, jh, TOL[dtype])
    _close(tst, jst, TOL[dtype])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_block_matches_jax(dtype, carried):
    rng = np.random.default_rng(2)
    Dm = H * D
    jp, tp = _params(rng, {"wq": (Dm, Dm), "wk": (Dm, Dm), "wv": (Dm, Dm), "wi": (Dm, H),
                           "wf": (Dm, H), "ogate": (Dm, Dm), "wo": (Dm, Dm)}, dtype)
    x = _pair(_rand(rng, B, S, Dm), dtype)
    jstate = None
    if carried:
        _, jstate = JS.mlstm_block(_pair(_rand(rng, B, 5, Dm), dtype)[0], jp, num_heads=H)
    jy, jst = JS.mlstm_block(x[0], jp, num_heads=H, state=jstate)
    ty, tst = TS.mlstm_block(x[1], tp, num_heads=H, state=_state(
        jstate, TS.mlstm_init_state(B, H, D, "cpu")) if carried else None)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_block_matches_jax(dtype, carried):
    rng = np.random.default_rng(3)
    Dm = H * D
    shapes = {k: (Dm, Dm) for k in ("wz", "wi", "wf", "wo", "wout")}
    shapes.update({k: (H, D, D) for k in ("rz", "ri", "rf", "ro")})
    jp, tp = _params(rng, shapes, dtype)
    x = _pair(_rand(rng, B, S, Dm), dtype)
    jstate = None
    if carried:
        _, jstate = JS.slstm_block(_pair(_rand(rng, B, 5, Dm), dtype)[0], jp, num_heads=H)
    jy, jst = JS.slstm_block(x[0], jp, num_heads=H, state=jstate)
    ty, tst = TS.slstm_block(x[1], tp, num_heads=H, state=_state(
        jstate, TS.slstm_init_state(B, H, D, "cpu")) if carried else None)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


def _ssd_inputs(rng, dtype, S=S, P=4, N=3):
    x = _pair(_rand(rng, B, S, H, P), dtype)
    b, c = (_pair(_rand(rng, B, S, H, N), dtype) for _ in range(2))
    la = -np.logaddexp(_rand(rng, B, S, H), 0.0).astype(np.float32)  # -softplus
    return x, b, c, (jnp.asarray(la), torch.from_numpy(la))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_jax(dtype, carried):
    """S = 9 in chunks of 4: a padded last chunk."""
    rng = np.random.default_rng(4)
    x, b, c, la = _ssd_inputs(rng, dtype)
    st = _rand(rng, B, H, 4, 3) if carried else None
    jy, jh = JS.ssd_chunked(x[0], b[0], c[0], la[0], chunk=4,
                            state=None if st is None else jnp.asarray(st))
    ty, th = TS.ssd_chunked(x[1], b[1], c[1], la[1], chunk=4,
                            state=None if st is None else torch.from_numpy(st))
    assert ty.dtype == x[1].dtype and th.dtype == torch.float32
    _close(ty, jy, TOL[dtype])
    _close(th, jh, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x, b, c, la = _ssd_inputs(rng, dtype, S=1)
    st = _rand(rng, B, H, 4, 3)
    jy, jst = JS.ssd_decode_step(x[0][:, 0], b[0][:, 0], c[0][:, 0], la[0][:, 0],
                                 jnp.asarray(st))
    ty, tst = TS.ssd_decode_step(x[1][:, 0], b[1][:, 0], c[1][:, 0], la[1][:, 0],
                                 torch.from_numpy(st))
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


@pytest.mark.parametrize("mode", ["full", "carried", "decode"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_matches_jax(dtype, mode):
    """The hymba Mamba branch: a sequence from a zero or a carried state,
    and one decode step. a_log and d_skip stay float32 in every dtype."""
    rng = np.random.default_rng(6)
    Dm, Hm, P, N = 16, 2, 4, 3
    Di = Hm * P
    jp, tp = _params(rng, {"win": (Dm, 2 * Di + 2 * Hm * N + Hm), "wout": (Di, Dm)}, dtype)
    for name in ("a_log", "d_skip"):
        a = _rand(rng, Hm, scale=0.5)
        jp[name], tp[name] = jnp.asarray(a), torch.from_numpy(a)
    seq = 1 if mode == "decode" else S
    x = _pair(_rand(rng, B, seq, Dm), dtype)
    st = None if mode == "full" else _rand(rng, B, Hm, P, N)
    kw = dict(num_heads=Hm, ssm_state=N, chunk=4, decode=mode == "decode")
    jy, jst = JS.mamba_block(x[0], jp, state=None if st is None else jnp.asarray(st), **kw)
    ty, tst = TS.mamba_block(x[1], tp, state=None if st is None else torch.from_numpy(st),
                             **kw)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


def test_init_states_match_jax():
    for got, want in ((TS.mlstm_init_state(2, 3, 4, "cpu"), JS.mlstm_init_state(2, 3, 4)),
                      (TS.slstm_init_state(2, 3, 4, "cpu"), JS.slstm_init_state(2, 3, 4)),
                      (TS.mamba_init_state(2, 3, 4, 5, "cpu"), JS.mamba_init_state(2, 3, 4, 5))):
        tl, jl = jax.tree_util.tree_leaves(cache_to_numpy(got)), jax.tree_util.tree_leaves(want)
        assert [a.shape for a in tl] == [b.shape for b in jl]
        assert all(a.dtype == np.float32 and np.array_equal(a, b) for a, b in zip(tl, jl))
    assert np.isneginf(cache_to_numpy(TS.mlstm_init_state(1, 1, 1, "cpu"))[2]).all()


def _grads_match(jfn, tfn, arrays, tol=1e-5):
    """Gradients of sum(outputs) w.r.t. every input, JAX against torch."""
    def jloss(*a):
        return sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(jfn(*a)))

    jg = jax.grad(jloss, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    live = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = tfn(*live)
    tg = torch.autograd.grad(sum(x.sum() for x in _tensors(out)), live)
    for a, b in zip(tg, jg, strict=True):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


def _tensors(tree):
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def test_mlstm_scan_grads_match_jax():
    """Through the -inf stabiliser of the first step: finite, and JAX's."""
    rng = np.random.default_rng(7)
    arrays = [_rand(rng, B, H, S, D) for _ in range(3)] + [_rand(rng, B, H, S) for _ in range(2)]
    _grads_match(lambda *a: JS.mlstm_scan(*a)[0], lambda *a: TS.mlstm_scan(*a)[0], arrays)


def test_slstm_block_grads_match_jax():
    rng = np.random.default_rng(8)
    Dm = H * D
    names = ["wz", "wi", "wf", "wo", "wout", "rz", "ri", "rf", "ro"]
    shapes = [(Dm, Dm)] * 5 + [(H, D, D)] * 4
    arrays = [_rand(rng, B, S, Dm)] + [_rand(rng, *s, scale=0.3) for s in shapes]

    def run(mod):
        return lambda x, *w: mod.slstm_block(x, dict(zip(names, w)), num_heads=H)[0]

    _grads_match(run(JS), run(TS), arrays)


def test_ssd_chunked_grads_match_jax():
    rng = np.random.default_rng(9)
    arrays = [_rand(rng, B, S, H, 4), _rand(rng, B, S, H, 3), _rand(rng, B, S, H, 3),
              -np.logaddexp(_rand(rng, B, S, H), 0.0).astype(np.float32)]
    _grads_match(lambda *a: JS.ssd_chunked(*a, chunk=4), lambda *a: TS.ssd_chunked(*a, chunk=4),
                 arrays)


def test_ssd_long_chunk_grads_are_finite():
    """A 256-token chunk whose decay sums past 88: the reference's masked
    corner holds exp(+) = inf and its gradient is NaN; the port's is finite
    and equals the reference's at chunks of 64 (the same function, no
    overflow)."""
    rng = np.random.default_rng(10)
    S_ = 256
    arrays = [_rand(rng, 1, S_, H, 4), _rand(rng, 1, S_, H, 3), _rand(rng, 1, S_, H, 3),
              np.full((1, S_, H), -0.7, np.float32)]

    def jloss(*a):
        y, h = JS.ssd_chunked(*a, chunk=S_)
        return jnp.sum(y) + jnp.sum(h)

    nan = jax.grad(jloss, argnums=(1,))(*map(jnp.asarray, arrays))[0]
    assert bool(jnp.isnan(nan).any())  # the reference's fault
    _grads_match(lambda *a: JS.ssd_chunked(*a, chunk=64),
                 lambda *a: TS.ssd_chunked(*a, chunk=S_), arrays, tol=1e-4)


def test_mlstm_state_decode_equals_scan():
    """tests/test_models.py's check on the port: the scan over S steps
    equals S one-step scans with the state carried."""
    g = torch.Generator().manual_seed(0)
    Bs, Hs, Ss, d = 2, 2, 10, 8
    q, k, v = (torch.randn(Bs, Hs, Ss, d, generator=g) for _ in range(3))
    i = torch.randn(Bs, Hs, Ss, generator=g)
    f = torch.randn(Bs, Hs, Ss, generator=g) + 2.0
    h_all, _ = TS.mlstm_scan(q, k, v, i, f)
    state, outs = None, []
    for t in range(Ss):
        h_t, state = TS.mlstm_scan(q[:, :, t:t + 1], k[:, :, t:t + 1], v[:, :, t:t + 1],
                                   i[:, :, t:t + 1], f[:, :, t:t + 1], state=state)
        outs.append(h_t)
    torch.testing.assert_close(h_all, torch.cat(outs, dim=2), atol=1e-5, rtol=1e-5)


def test_ssd_chunked_matches_stepwise():
    """tests/test_models.py's check on the port: chunked SSD equals the
    one-token recurrence, outputs and final state."""
    g = torch.Generator().manual_seed(0)
    Bs, Ss, Hs, P, N = 1, 12, 2, 4, 3
    x = torch.randn(Bs, Ss, Hs, P, generator=g)
    b, c = (torch.randn(Bs, Ss, Hs, N, generator=g) for _ in range(2))
    la = -torch.nn.functional.softplus(torch.randn(Bs, Ss, Hs, generator=g))
    y_chunk, hf = TS.ssd_chunked(x, b, c, la, chunk=4)
    state, ys = torch.zeros(Bs, Hs, P, N), []
    for t in range(Ss):
        y_t, state = TS.ssd_decode_step(x[:, t], b[:, t], c[:, t], la[:, t], state)
        ys.append(y_t[:, None])
    torch.testing.assert_close(y_chunk, torch.cat(ys, dim=1), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hf, state, atol=1e-4, rtol=1e-4)
