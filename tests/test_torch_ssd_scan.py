"""SSD's chunk loop and decode step: the plain versions (``kernels/ref.py``)
and the wrapper (``kernels/ssd_scan.py``) on the CPU, at smoke size in
float32 (B=2, 4 heads, P=4, N=3; S in {1, 9, 40} in chunks of 4 and of
S), from a zero state and a carried one:

* the plain backward ``ref_ssd_bwd`` (the CUDA kernels' algorithm)
  against torch autograd of ``ref_ssd_chunked``, and, through the
  wrapper's autograd Function ``SSD``, against ``jax.vjp`` of the
  reference's ``ssd_chunked`` on the same numpy inputs;
* the long chunk whose decay overflows the reference's gradient: the
  backward finite and equal to the plain loop's autograd (1e-4);
* the decode step against the reference's ``ssd_decode_step`` (also on
  the strided views ``mamba_block`` hands it, which the kernel reads in
  place), its gradient against ``jax.vjp`` of it, and a one-token chunk
  through ``SSD`` against it;
* CPU and ``meta`` tensors reach the plain loop, and launch nothing.

Tolerance 1e-5 (atol = rtol): float32 sums in another order, as in
``test_torch_ssm.py``. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import _build, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm as TS
import torch_ssd_cases as SC
from torch_xlstm_cases import float64_plain

TOL = 1e-5
B, H, P, N = 2, 4, 4, 3
CASES = [(S, chunk) for S in (1, 9, 40) for chunk in (4, S)]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _inputs(rng, S, carried):
    """x, b, c, log_a (-softplus of a normal: a decay in (0, 1)) and the
    state (zeros when not carried)."""
    x, b, c = _rand(rng, B, S, H, P), _rand(rng, B, S, H, N), _rand(rng, B, S, H, N)
    log_a = -np.logaddexp(_rand(rng, B, S, H), 0.0).astype(np.float32)
    state = _rand(rng, B, H, P, N) if carried else np.zeros((B, H, P, N), np.float32)
    return x, b, c, log_a, state


def _grads(out, leaves, cots):
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    return torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", CASES)
def test_plain_backward_matches_autograd(S, chunk, carried):
    """``ref_ssd_bwd``, recomputing each chunk from the state saved at its
    start, against autograd of ``ref_ssd_chunked``: the gradients of x, b,
    c, log_a and the state. ``ref_ssd_fwd_saved`` gives the plain loop's
    own outputs, and its saves are the loop's states at the chunk starts."""
    rng = np.random.default_rng(S * 10 + chunk + carried)
    leaves = [_leaf(a) for a in _inputs(rng, S, carried)]
    out = ref.ref_ssd_chunked(*leaves[:4], chunk=chunk, state=leaves[4])
    cots = [torch.from_numpy(_rand(rng, *o.shape)) for o in out]
    want = _grads(out, leaves, cots)
    with torch.no_grad():
        y, h, saved = ref.ref_ssd_fwd_saved(*leaves, chunk)
        got = ref.ref_ssd_bwd(*leaves[:4], saved, *cots, chunk)
    assert torch.equal(y, out[0]) and torch.equal(h, out[1])
    assert saved.shape == (-(-S // chunk), B, H, P, N) and torch.equal(saved[0], leaves[4])
    for k in range(1, saved.shape[0]):
        t = k * chunk
        _, hk = ref.ref_ssd_chunked(*(a[:, :t] for a in leaves[:4]), chunk=chunk,
                                    state=leaves[4])
        assert torch.equal(saved[k], hk)
    for name, a, b in zip(("x", "b", "c", "log_a", "state"), got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _close(a, b)


def _jax_ssd(chunk, carried):
    def f(x, b, c, log_a, *state):
        return JS.ssd_chunked(x, b, c, log_a, chunk=chunk,
                              state=state[0] if carried else None)
    return f


def _through_function(x, b, c, log_a, *, chunk, state=None):
    """The wrapper's CUDA route on CPU tensors: the ``SSD`` Function, whose
    forward and backward are ``ref.py``'s forward-with-saves and backward."""
    if state is None:
        state = torch.zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]))
    return ss.SSD.apply(x, b, c, log_a, state, chunk)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", CASES)
def test_function_backward_matches_jax_vjp(S, chunk, carried, monkeypatch):
    """``models.ssm.ssd_chunked`` through ``ssd_scan.SSD`` against
    ``jax.vjp`` of the reference's ``ssd_chunked`` (finite here: no chunk's
    decay reaches the overflow): y, the final state, and the gradients of
    x, b, c, log_a and the carried state."""
    monkeypatch.setattr(ss, "ssd_chunked", _through_function)
    rng = np.random.default_rng(S * 10 + chunk + carried + 100)
    arrays = _inputs(rng, S, carried)[:5 if carried else 4]
    out_j, vjp = jax.vjp(_jax_ssd(chunk, carried), *map(jnp.asarray, arrays))
    cots = [_rand(rng, *o.shape) for o in out_j]
    want = vjp(tuple(map(jnp.asarray, cots)))
    leaves = [_leaf(a) for a in arrays]
    out_t = TS.ssd_chunked(*leaves[:4], chunk=chunk, state=leaves[4] if carried else None)
    assert "SSD" in type(out_t[0].grad_fn).__name__
    got = _grads(out_t, leaves, [torch.from_numpy(c) for c in cots])
    for a, b in zip(out_t, out_j, strict=True):
        _close(a.detach(), b)
    for a, b in zip(got, want, strict=True):
        assert np.isfinite(np.asarray(b)).all()
        _close(a, b)


def test_long_chunk_backward_is_finite():
    """``test_ssd_long_chunk_grads_are_finite``'s input: one chunk of 256
    at a decay of -0.7 a step, where the reference's gradient is NaN. The
    ``SSD`` Function's backward (the kernels' algorithm) is finite and
    equals the port's plain autograd within 1e-4."""
    rng = np.random.default_rng(10)
    S_, Hl = 256, 2
    arrays = [_rand(rng, 1, S_, Hl, 4), _rand(rng, 1, S_, Hl, 3), _rand(rng, 1, S_, Hl, 3),
              np.full((1, S_, Hl), -0.7, np.float32)]
    runs = []
    for fn in (_through_function, ref.ref_ssd_chunked):
        leaves = [_leaf(a) for a in arrays]
        y, h = fn(*leaves, chunk=S_)
        runs.append(torch.autograd.grad(y.sum() + h.sum(), leaves))
    for a, b in zip(*runs, strict=True):
        assert torch.isfinite(a).all()
        _close(a, b, 1e-4)


@pytest.mark.parametrize("carried", [False, True])
def test_decode_step_matches_jax(carried):
    """``models.ssm.ssd_decode_step`` (the wrapper's plain path on the CPU)
    against the reference's ``ssd_decode_step``: y and the new state."""
    rng = np.random.default_rng(20 + carried)
    x, b, c, log_a, state = _inputs(rng, 1, carried)
    x, b, c, log_a = (a[:, 0] for a in (x, b, c, log_a))
    jy, jst = JS.ssd_decode_step(*map(jnp.asarray, (x, b, c, log_a, state)))
    ty, tst = TS.ssd_decode_step(*map(torch.from_numpy, (x, b, c, log_a, state)))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("layout", ["mamba", "all-strided"])
@pytest.mark.parametrize("carried", [False, True])
def test_decode_step_on_strided_views_matches_jax(carried, layout):
    """The decode step on the views ``mamba_block`` hands it: b and c the
    halves of ``bc.chunk(2)`` of the fused projection at the one position,
    [B, H, N] views whose rows are the projection's (2 Di + 2 H N + H
    wide), x * dt and log_a fresh; with ``all-strided`` x and log_a views
    into wider tensors too. The port's ``models.ssm.ssd_decode_step`` (the
    plain step on the CPU; on the card the kernel reads these views through
    their strides) against the reference's on the same values, at 1e-5."""
    rng = np.random.default_rng(50 + carried)
    Di = H * P
    fused = torch.from_numpy(_rand(rng, B, 1, 2 * Di + 2 * H * N + H))
    _, _, bc, _ = fused.split([Di, Di, 2 * H * N, H], dim=-1)
    b, c = (t.view(B, 1, H, N)[:, 0] for t in bc.chunk(2, dim=-1))
    assert b.stride() == c.stride() == (fused.shape[-1], N, 1)
    x, _, _, log_a, state = (torch.from_numpy(a) for a in _inputs(rng, 1, carried))
    x, log_a = x[:, 0], log_a[:, 0]
    if layout == "all-strided":
        x = torch.cat([x, x.flip(-1)], dim=-1)[..., :P]
        log_a = torch.stack([log_a, -log_a], dim=-1)[..., 0]
        assert not (x.is_contiguous() or log_a.is_contiguous())
    args = (x, b, c, log_a, state)
    jy, jst = JS.ssd_decode_step(*(jnp.asarray(t.contiguous().numpy()) for t in args))
    ty, tst = TS.ssd_decode_step(*args)
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("carried", [False, True])
def test_decode_step_gradient_matches_jax_vjp(carried):
    """The reference's ``ssd_decode_step`` is plain jnp that ``jax.grad``
    differentiates. The port's plain step (the wrapper's path on the CPU,
    and what ``SSDDecode``'s backward recomputes on the card) with torch
    autograd against ``jax.vjp`` of it: every input's gradient."""
    rng = np.random.default_rng(40 + carried)
    x, b, c, log_a, state = _inputs(rng, 1, carried)
    arrays = [a[:, 0] for a in (x, b, c, log_a)] + [state]
    out_j, vjp = jax.vjp(JS.ssd_decode_step, *map(jnp.asarray, arrays))
    cots = [_rand(rng, *o.shape) for o in out_j]
    want = vjp(tuple(map(jnp.asarray, cots)))
    leaves = [_leaf(a) for a in arrays]
    got = _grads(ss.ssd_decode(*leaves), leaves, [torch.from_numpy(c) for c in cots])
    for a, b in zip(got, want, strict=True):
        _close(a, b)


def test_decode_as_one_token_chunk_matches_decode_step():
    """``SSD`` over a one-token chunk is the decode step: on the CPU it
    gives the decode step's y and state, and its gradients are autograd's
    of the plain decode step."""
    rng = np.random.default_rng(30)
    x, b, c, log_a, state = _inputs(rng, 1, True)
    runs = []
    for how in ("chunk", "decode"):
        leaves = [_leaf(a) for a in (x[:, 0], b[:, 0], c[:, 0], log_a[:, 0], state)]
        if how == "chunk":
            y, h = _through_function(*(t[:, None] for t in leaves[:4]), chunk=1,
                                     state=leaves[4])
            y = y[:, 0]
        else:
            y, h = ref.ref_ssd_decode_step(*leaves)
        cots = [torch.from_numpy(_rand(np.random.default_rng(31), *t.shape)) for t in (y, h)]
        runs.append([y, h, *_grads((y, h), leaves, cots)])
    for a, b in zip(*runs, strict=True):
        _close(a.detach(), b.detach())


def _no_build(*_):
    raise AssertionError("a host tensor reached the kernel library")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_and_meta_tensors_take_the_plain_loop(device, monkeypatch):
    """On CPU and ``meta`` tensors both entry points run the plain loop
    (the same values, on the CPU, as ``ref.py``'s), record ordinary
    autograd (no Function of the wrapper), never load the kernel library
    and count no launch: the dry run traces the step on ``meta``."""
    monkeypatch.setattr(_build, "lib", _no_build)
    before = dict(ss.launches)
    rng = np.random.default_rng(7)
    arrays = _inputs(rng, 9, True)
    args = [torch.from_numpy(a).to(device).requires_grad_(True) for a in arrays]
    y, h = ss.ssd_chunked(*args[:4], chunk=4, state=args[4])
    assert y.shape == arrays[0].shape and h.shape == arrays[4].shape
    assert "SSD" not in type(y.grad_fn).__name__
    step = [a[:, 0] for a in args[:4]] + [args[4]]
    dy, dh = ss.ssd_decode(*step)
    assert dy.shape == (B, H, P) and dh.shape == (B, H, P, N)
    assert "SSD" not in type(dy.grad_fn).__name__
    if device == "cpu":
        for a, b in zip((y, h), ref.ref_ssd_chunked(*args[:4], chunk=4, state=args[4]),
                        strict=True):
            assert torch.equal(a, b)
        for a, b in zip((dy, dh), ref.ref_ssd_decode_step(*step), strict=True):
            assert torch.equal(a, b)
    assert ss.launches == before


# ---------------------------------------------------------------------------
# the chunk kernels' algorithm, mirrored in plain torch (tests/torch_ssd_cases.py)
# ---------------------------------------------------------------------------

MIRROR_PARTS = {"kernel": {}, "small": {"fblock": 2, "bblock": 2, "tile_n": 2, "cluster": 2}}
EXACT = 1e-7  # the float64 mirror unsplit: the plain loop's d log_a is float32
JAX_REL = 1e-5  # the reference's float32 is 2.2e-6 from float64 at S = 300


def _as(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("parts", list(MIRROR_PARTS))
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", SC.CASES)
def test_tiled_mirror_matches_plain_in_float64(S, chunk, carried, parts):
    """The kernels' algorithm (``torch_ssd_cases.tiled_fwd``/``tiled_bwd``:
    strips, 16 x 16 tiles, the state walked per CTA, the CTAs' partials)
    against ``ref_ssd_fwd_saved`` and ``ref_ssd_bwd`` run in float64: y, h,
    the saves and every gradient. Unsplit, within EXACT; with the products'
    bf16 hi + lo parts, within a relative L2 of REL_SPLIT. ``small`` value
    blocks and state tiles of 2 run the partials' sums (P = 4, N = 3), and
    clusters of 2 chunks the walk over groups (3 chunks at S = 40)."""
    arrays, cots = SC.inputs(S, carried)
    args, cots = _as(arrays, torch.float64), _as(cots, torch.float64)
    with float64_plain():
        want = SC.run_plain(args, cots, chunk)
    for split, limit in ((False, EXACT), (True, SC.REL_SPLIT)):
        got = SC.run_mirror(args, cots, chunk, split=split, **MIRROR_PARTS[parts])
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            assert a.shape == b.shape and SC.rel(a, b) <= limit, (i, split, SC.rel(a, b))


def _jax_outputs(arrays, cots, chunk, carried):
    out, vjp = jax.vjp(_jax_ssd(chunk, carried), *map(jnp.asarray, arrays[:5 if carried else 4]))
    grads = vjp(tuple(map(jnp.asarray, cots)))
    return [np.asarray(o) for o in (*out, *grads)]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", SC.CASES)
def test_tiled_mirror_matches_jax(S, chunk, carried):
    """The kernels' algorithm in float64 on the float32 inputs against the
    reference's ``ssd_chunked`` and ``jax.vjp`` of it: y, the final state
    and the gradients of x, b, c, log_a (and the carried state), each
    within a relative L2 of JAX_REL wherever the reference's is finite (its
    gradient is NaN in part once a 256-token chunk's summed decay passes
    88, as it does here at S = 300)."""
    arrays, cots = SC.inputs(S, carried)
    got = SC.run_mirror(_as(arrays, torch.float64), _as(cots, torch.float64), chunk, split=False)
    want = [torch.from_numpy(np.array(a)) for a in _jax_outputs(arrays, cots, chunk, carried)]
    SC.hold_where_finite(got[:2] + got[3:8 if carried else 7], want, JAX_REL)


def test_tiled_mirror_strong_decay():
    """A decay of -0.7 a step: a 256-token chunk's summed decay is 179, past
    float32's exp range. The kernels' algorithm in float32 with the split
    products gives finite outputs and gradients, within REL_SPLIT of the
    port's plain loop, and of the reference's forward and ``jax.vjp``
    wherever those are finite (its gradient is NaN here)."""
    arrays, cots = SC.inputs(300, True, strong=True)
    args, c32 = _as(arrays, torch.float32), _as(cots, torch.float32)
    got = SC.run_mirror(args, c32, 256)
    SC.hold_where_finite(got, SC.run_plain(args, c32, 256), SC.REL_SPLIT)
    jax_out = [torch.from_numpy(np.array(a)) for a in _jax_outputs(arrays, cots, 256, True)]
    assert not all(torch.isfinite(a).all() for a in jax_out)
    SC.hold_where_finite(got[:2] + got[3:], jax_out, SC.REL_SPLIT)


def test_factored_decay_is_rejected():
    """The known-wrong variant, the decay factored as exp(la_t) exp(-la_s):
    on the strong-decay case exp(-la_s) overflows float32, and the check
    that holds the kernels' algorithm rejects it."""
    arrays, cots = SC.inputs(300, True, strong=True)
    args, c32 = _as(arrays, torch.float32), _as(cots, torch.float32)
    got = SC.run_mirror(args, c32, 256, decay="factored")
    with pytest.raises(AssertionError):
        SC.hold_where_finite(got, SC.run_plain(args, c32, 256), SC.REL_SPLIT)
