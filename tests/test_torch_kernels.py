"""The port's kernel modules on the CPU (their plain PyTorch versions)
against the JAX package: the ring step bit for bit against the jnp oracle
and the Pallas kernel in interpret mode, attention allclose against the jnp
oracles and the interpret-mode Pallas kernels (the tolerances of
tests/test_kernels.py, compared in f32). Inputs are made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cmp_ring import cmp_ring_step as pallas_ring_step
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro_torch.kernels import cmp_ring, flash_attention, ops, paged_attention, ref

_jax_ring = jax.jit(jref.ref_ring_step, static_argnames=("k", "window"))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# cmp_ring: bit-exact
# ---------------------------------------------------------------------------


def _ring_trajectory(n, k, window, reqs):
    """Drive the port's ring through ``reqs`` on the CPU; at every step the
    JAX oracle sees the same input and must give the same four arrays."""
    state = torch.zeros(n, dtype=torch.int32)
    cycle = torch.zeros(n, dtype=torch.int32)
    meta = torch.zeros(2, dtype=torch.int32)
    inputs = []
    for req in reqs:
        inputs.append((state, cycle, meta, req))
        state, cycle, meta, claimed = cmp_ring.cmp_ring_step(
            state, cycle, meta, req, k=k, window=window)
        want = _jax_ring(*(jnp.asarray(t.numpy()) for t in inputs[-1][:3]),
                         jnp.asarray(req, jnp.int32), k=k, window=window)
        for name, a, b in zip(("state", "cycle", "meta", "claimed"),
                              (state, cycle, meta, claimed), want):
            assert a.dtype == torch.int32
            assert torch.equal(a, torch.from_numpy(np.array(b))), (req, name)
    return inputs


@pytest.mark.parametrize("n,k", [(16, 4), (32, 8), (64, 4), (128, 64)])
def test_ring_step_matches_jax_oracle(n, k):
    rng = np.random.default_rng(n * 31 + k)
    reqs = [(int(rng.integers(0, n // 2 + 1)), int(rng.integers(0, k + 1)))
            for _ in range(40)]
    inputs = _ring_trajectory(n, k, n // 4, reqs)
    assert any(int(s[2][1]) > 0 for s in inputs), "trajectory never claimed"


@pytest.mark.parametrize("n,k", [(16, 4), (32, 8)])
def test_ring_step_matches_pallas_interpret(n, k):
    rng = np.random.default_rng(n * 7 + k)
    window = n // 4
    reqs = [(int(rng.integers(0, n)), int(rng.integers(0, k + 1))) for _ in range(8)]
    for state, cycle, meta, req in _ring_trajectory(n, k, window, reqs):
        got = cmp_ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
        want = pallas_ring_step(jnp.asarray(state.numpy()), jnp.asarray(cycle.numpy()),
                                jnp.asarray(meta.numpy()), jnp.asarray(req, jnp.int32),
                                k=k, window=window, interpret=True)
        for a, b in zip(got, want):
            assert torch.equal(a, torch.from_numpy(np.array(b)))


def test_ring_step_recycles_and_rejects():
    """The ring protocol through the port's ops wrapper (mirrors
    tests/test_kernels.py): a full ring accepts only the contiguous FREE
    prefix, claims come in ascending cycle order, and claimed slots recycle
    once the frontier moves a window past them."""
    n, k, window = 16, 4, 4
    s = torch.zeros(n, dtype=torch.int32)
    c = torch.zeros(n, dtype=torch.int32)
    m = torch.zeros(2, dtype=torch.int32)
    s, c, m, cl = ops.ring_step(s, c, m, (n, 0), k=k, window=window)
    assert int(m[0]) == n and int((cl >= 0).sum()) == 0
    s, c, m, cl = ops.ring_step(s, c, m, (5, 0), k=k, window=window)
    assert int(m[0]) == n, "push into a full ring must reject"
    seen = []
    for _ in range(n // k):
        s, c, m, cl = ops.ring_step(s, c, m, (0, k), k=k, window=window)
        seen += [int(x) for x in cl if x >= 0]
    assert seen == list(range(1, n + 1))
    assert int(m[1]) == n
    s, c, m, cl = ops.ring_step(s, c, m, (n, 0), k=k, window=window)
    assert int(m[0]) - n == n - window - 1


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """No silent fallback: a device that is neither the CPU nor CUDA, or a
    claim width past the ring, raises instead of running anything."""
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cmp_ring.cmp_ring_step(z, z, torch.zeros(2, dtype=torch.int32), (1, 1),
                               k=9, window=2)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        paged_attention.paged_attention(
            torch.empty(1, 2, 8, device=meta), torch.empty(4, 1, 4, 8, device=meta),
            torch.empty(4, 1, 4, 8, device=meta),
            torch.empty(1, 2, dtype=torch.int32, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(*(torch.empty(1, 2, 4, 8, device=meta),) * 3)
    assert cmp_ring.launches == paged_attention.launches == flash_attention.launches == 0


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,hd,page,P,pps", [
    (2, 4, 2, 32, 8, 16, 4),
    (3, 8, 8, 64, 16, 32, 6),   # MHA pages
    (4, 16, 1, 16, 4, 24, 5),   # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax(B, H, KV, hd, page, P, pps, dtype):
    rng = np.random.default_rng(B * 100 + H + hd)
    qj, qt = _both(rng.standard_normal((B, H, hd), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((P, KV, page, hd), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((P, KV, page, hd), np.float32), dtype)
    bt = rng.integers(0, P, (B, pps)).astype(np.int32)
    sl = rng.integers(2, pps * page + 1, B).astype(np.int32)
    sl[0] = 1
    if B > 1:
        sl[1] = 0  # an empty sequence: the Pallas kernel gives zeros
    got = ops.paged_attention(qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(sl))
    assert got.dtype == qt.dtype and got.shape == (B, H, hd)
    tol = 2e-5 if dtype == "float32" else 4e-2
    pallas = jops.paged_attention(qj, kj, vj, jnp.asarray(bt), jnp.asarray(sl))
    _close(got, pallas, tol)
    live = sl > 0  # the jnp oracle averages V over an empty sequence
    oracle = jref.ref_paged_attention(qj, kj, vj, jnp.asarray(bt), jnp.asarray(sl))
    _close(got[torch.from_numpy(live)], np.asarray(oracle, np.float32)[live], tol)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 4, 7, 9])
def test_paged_split_combine_matches_jax(pages_per_split):
    """The CUDA kernel's split-K partition and combine, mirrored in plain
    PyTorch, against the JAX oracle, with splits of ``pages_per_split``
    pages of 4 tokens: seq_lens at 1, inside a page, at a page edge, at a
    split edge, one past it, and the full table, so some splits lie wholly
    past seq_len and one split is cut short by pps. At seq_len 0 (the JAX
    oracle's known fault) the port's plain version is the yardstick:
    zeros."""
    B, H, KV, hd, page, P, pps = 7, 8, 2, 32, 4, 40, 8
    rng = np.random.default_rng(pages_per_split)
    q = rng.standard_normal((B, H, hd), np.float32)
    kp = rng.standard_normal((P, KV, page, hd), np.float32)
    vp = rng.standard_normal((P, KV, page, hd), np.float32)
    bt = rng.integers(0, P, (B, pps)).astype(np.int32)
    chunk = pages_per_split * page
    sl = np.array([0, 1, 3, page, chunk, chunk + 1, pps * page], np.int32)
    got = ref.ref_paged_attention_split(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, sl)), chunk)
    live = sl > 0
    oracle = jref.ref_paged_attention(*(jnp.asarray(x) for x in (q, kp, vp, bt, sl)))
    _close(got[torch.from_numpy(live)], np.asarray(oracle, np.float32)[live], 2e-5)
    plain = paged_attention.plain(*(torch.from_numpy(x) for x in (q, kp, vp, bt, sl)))
    assert torch.equal(got[~torch.from_numpy(live)], plain[~torch.from_numpy(live)])
    assert not got[~torch.from_numpy(live)].any()


def test_paged_split_count_comes_from_the_table_width():
    """The host picks the split from the page size and pages_per_seq only,
    64 token positions a split: the main path's 64 pages of 16 give 16
    splits and two launches a call; a table that fits one split is one
    launch; a page of 128 is two splits; pages of 24 straddle splits."""
    assert paged_attention.SPLIT_TOKENS == 64
    assert paged_attention.num_splits(64, 16) == 16
    assert paged_attention.launches_per_call(64, 16) == 2
    assert paged_attention.num_splits(4, 16) == 1
    assert paged_attention.launches_per_call(4, 16) == 1
    assert paged_attention.num_splits(1, 128) == 2
    assert paged_attention.num_splits(8, 256) == 32
    assert paged_attention.num_splits(5, 4) == 1  # 20 tokens in one split
    assert paged_attention.num_splits(3, 24) == 2  # 72 tokens: 64 + 8
    assert paged_attention.num_splits(2, 48) == 2  # a page boundary inside split 0


@pytest.mark.parametrize("page,pps", [(8, 9), (24, 5), (32, 4), (48, 3), (128, 2),
                                      (256, 1)])
def test_paged_token_splits_match_jax_at_any_page_size(page, pps):
    """The 64-token split at page sizes that divide 64, that do not (24,
    48: a page straddles two splits), and that exceed it (128, 256: a page
    is several splits), mirrored in plain PyTorch with a softcap on and
    off, against the JAX oracle (the reference's cache attention for the
    capped case); seq_lens at 1, at page and split edges, and the full
    table."""
    B, H, KV, hd = 6, 4, 2, 16
    P = B * pps + 1
    rng = np.random.default_rng(page)
    q = rng.standard_normal((B, H, hd), np.float32)
    kp = rng.standard_normal((P, KV, page, hd), np.float32)
    vp = rng.standard_normal((P, KV, page, hd), np.float32)
    bt = (1 + rng.permutation(B * pps)).reshape(B, pps).astype(np.int32)
    T = pps * page
    sl = np.array([1, page, min(64, T), min(65, T), T - 1, T], np.int32)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, sl)]
    oracle = jref.ref_paged_attention(*(jnp.asarray(x) for x in (q, kp, vp, bt, sl)))
    _close(ref.ref_paged_attention_split(*args, paged_attention.SPLIT_TOKENS), oracle, 2e-5)
    kg = kp[bt].transpose(0, 1, 3, 2, 4).reshape(B, T, KV, hd)
    vg = vp[bt].transpose(0, 1, 3, 2, 4).reshape(B, T, KV, hd)
    k_pos = np.where(np.arange(T)[None] < sl[:, None], np.arange(T)[None], -1)
    capped = JL.cache_attention(jnp.asarray(q[:, None]), jnp.asarray(kg), jnp.asarray(vg),
                                jnp.asarray(sl[:, None] - 1), jnp.asarray(k_pos),
                                softcap=5.0)[:, 0]
    got = ref.ref_paged_attention_split(*args, paged_attention.SPLIT_TOKENS, softcap=5.0)
    _close(got, capped, 2e-5)
    _close(paged_attention.plain(*args, softcap=5.0), capped, 2e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _flash_inputs(B, H, KV, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal(shape, np.float32), dtype)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 4, 4, 128, 32),    # MHA
    (2, 8, 2, 256, 64),    # GQA 4:1
    (1, 16, 1, 192, 64),   # MQA, ragged S
    (2, 4, 2, 100, 16),    # non-multiple of block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_oracle(B, H, KV, S, hd, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, H, KV, S, hd, dtype, S + H)
    got = flash_attention.flash_attention(qt, kt, vt, causal=True)
    tol = 2e-5 if dtype == "float32" else 3e-2
    _close(got, jref.ref_flash_attention(qj, kj, vj, causal=True), tol)


@pytest.mark.parametrize("causal,window,dtype", [
    (True, 0, "float32"), (True, 0, "bfloat16"), (True, 32, "float32"),
    (True, 128, "float32"), (False, 0, "float32"), (False, 0, "bfloat16")])
def test_flash_attention_matches_pallas_interpret(causal, window, dtype):
    B, H, KV, S, hd = 1, 4, 2, 100, 32
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, H, KV, S, hd, dtype, window + 3)
    got = flash_attention.flash_attention(qt, kt, vt, causal=causal,
                                          sliding_window=window)
    want = pallas_flash(qj, kj, vj, causal=causal, sliding_window=window,
                        block_q=64, block_k=64, interpret=True)
    _close(got, want, 2e-5 if dtype == "float32" else 3e-2)
    _close(got, jref.ref_flash_attention(qj, kj, vj, causal=causal,
                                         sliding_window=window),
           2e-5 if dtype == "float32" else 3e-2)


def test_flash_attention_model_layout_matches_jax_ops():
    """ops.flash_attention in the model layout [B, S, H, hd] against the
    JAX package's ops wrapper (the Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 40, 8, 16), np.float32)
    k = rng.standard_normal((2, 40, 2, 16), np.float32)
    v = rng.standard_normal((2, 40, 2, 16), np.float32)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    want = jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    assert tuple(got.shape) == (2, 40, 8, 16)
    _close(got, jax.device_get(want), 2e-5)


@pytest.mark.parametrize("S,window", [(17, 0), (40, 8)])
def test_flash_softcap_matches_jax(S, window):
    """The flash kernel's plain version with a softcap against the
    reference's self-attention with the same cap (f32, 2e-5), in the
    model layout the prefill passes."""
    B, H, KV, hd, cap = 2, 4, 2, 16, 3.0
    rng = np.random.default_rng(S)
    q = rng.standard_normal((B, S, H, hd), np.float32) * 3
    k = rng.standard_normal((B, S, KV, hd), np.float32) * 3
    v = rng.standard_normal((B, S, KV, hd), np.float32)
    want = JL.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             sliding_window=window, softcap=cap)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                              sliding_window=window, softcap=cap)
    _close(got, want, 2e-5)
