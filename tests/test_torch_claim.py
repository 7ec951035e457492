"""The port's k-way earliest-cycle claim against the JAX package's, on the
CPU: ``repro_torch.kernels.ops.claim`` (the plain version) against
``repro.kernels.ops.claim`` (the Pallas kernels in interpret mode), and
``slotpool.claim`` against the JAX pool. Inputs are made with numpy from a
seed; the stated tolerance is bit-exact (``np.array_equal``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import slotpool as jsp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import slotpool as tsp
from repro_torch.kernels import cmp_claim, ops
from repro_torch.kernels import ref as tref

INT_MAX = np.iinfo(np.int32).max


def _claim_both(state: np.ndarray, cycle: np.ndarray, k: int, block_n=None):
    """Both packages' ops.claim on the same input; asserts they agree bit for
    bit and returns the port's (new_state, ids) as numpy."""
    got = ops.claim(torch.from_numpy(state), torch.from_numpy(cycle), k=k,
                    block_n=block_n)
    want = jops.claim(jnp.asarray(state), jnp.asarray(cycle), k=k, block_n=block_n)
    for name, g, w in zip(("new_state", "ids"), got, want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), np.asarray(w)), (name, g, w)
    return got[0].numpy(), got[1].numpy()


def _random_pool(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return (rng.choice([0, 1, 2], size=n).astype(np.int32),
            rng.permutation(n).astype(np.int32))


# mirrors of tests/test_kernels.py's claim tests


@pytest.mark.parametrize("n,k", [(16, 1), (64, 5), (128, 16)])
def test_claim_sweep_matches_jax(n, k):
    state, cycle = _random_pool(n * 1000 + k, n)
    _claim_both(state, cycle, k)


def test_claim_empty_pool_matches_jax():
    state = np.full(32, 2, np.int32)  # everything CLAIMED
    new_state, ids = _claim_both(state, np.arange(32, dtype=np.int32), 4)
    assert np.all(ids == 32) and np.array_equal(new_state, state)


@pytest.mark.parametrize("n,k,block_n", [
    (300, 7, 128), (257, 4, 64), (1024, 16, 256), (129, 3, 128)])
def test_claim_tiled_matches_jax(n, k, block_n):
    state, cycle = _random_pool(n * 7 + k, n)
    _claim_both(state, cycle, k, block_n)


@pytest.mark.parametrize("n,k", [(384, 5), (500, 9)])
def test_claim_tiled_matches_single_tile(n, k):
    """The port's tiled and single-tile dispatches give the JAX package's
    single-block result."""
    state, cycle = _random_pool(n + k, n)
    tiled = _claim_both(state, cycle, k, 128)
    fused = _claim_both(state, cycle, k, n)
    for a, b in zip(tiled, fused):
        assert np.array_equal(a, b)


def test_claim_tiled_sparse_and_empty_blocks():
    n = 512
    state = np.zeros(n, np.int32)
    state[130] = state[400] = 1
    new_state, ids = _claim_both(state, np.arange(n, dtype=np.int32), 6, 128)
    assert ids[:2].tolist() == [130, 400] and np.all(ids[2:] == n)
    assert new_state[130] == 2 and new_state[400] == 2


def test_claim_ties_break_by_lowest_id():
    n = 256
    _, ids = _claim_both(np.ones(n, np.int32), np.full(n, 5, np.int32), 4, 64)
    assert ids.tolist() == [0, 1, 2, 3]


def test_slotpool_claim_dispatches_to_tiled_path():
    """n = 3000 > the default tile: slotpool.claim takes the tiled path and
    gives the JAX pool, deque_cycle and retire_cycle included."""
    tp, jp = tsp.make(3000, "cpu"), jsp.make(3000)
    (tp, _, _), (jp, _, _) = tsp.produce(tp, 12), jsp.produce(jp, 12)
    (tp, tid, tv), (jp, jid, jv) = tsp.claim(tp, 5), jsp.claim(jp, 5)
    assert tid.tolist() == [0, 1, 2, 3, 4] and bool(tv.all())
    assert int(tp.deque_cycle) == 5
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    for f in tsp.SlotPool._fields:
        assert np.array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))), f


# cases beyond the reference tests: k > N, INT32_MAX and negative cycles


@pytest.mark.parametrize("n,k,block_n", [
    (4, 6, None), (7, 10, None), (1, 3, None), (40, 45, 16), (33, 40, 8)])
def test_claim_k_above_n_pads_with_n(n, k, block_n):
    state, cycle = _random_pool(n + 31 * k, n)
    new_state, ids = _claim_both(state, cycle, k, block_n)
    avail = int((state == 1).sum())
    assert np.all(ids[avail:] == n) and np.all(ids[:avail] < n)


@pytest.mark.parametrize("block_n", [None, 16])
def test_claim_never_takes_int32_max_cycles(block_n):
    rng = np.random.default_rng(5)
    n = 60
    state = np.ones(n, np.int32)
    cycle = rng.permutation(n).astype(np.int32)
    cycle[rng.random(n) < 0.4] = INT_MAX  # AVAILABLE, but never claimable
    new_state, ids = _claim_both(state, cycle, n + 2, block_n)
    finite = int((cycle != INT_MAX).sum())
    assert np.all(cycle[ids[:finite]] != INT_MAX) and np.all(ids[finite:] == n)
    assert np.array_equal(new_state == 2, cycle != INT_MAX)


@pytest.mark.parametrize("block_n", [None, 8])
def test_claim_orders_negative_and_tied_cycles(block_n):
    rng = np.random.default_rng(9)
    n = 50
    state = rng.choice([0, 1, 2], size=n, p=[0.2, 0.6, 0.2]).astype(np.int32)
    cycle = rng.integers(-4, 4, size=n).astype(np.int32)
    _, ids = _claim_both(state, cycle, 12, block_n)
    taken = ids[ids < n]
    keys = list(zip(cycle[taken], taken))
    assert keys == sorted(keys) and cycle[taken].min() < 0


@pytest.mark.parametrize("n,k", [(16, 3), (100, 16), (64, 64)])
def test_plain_matches_jax_ref_claim(n, k):
    """The plain version against the JAX oracle where that takes k (k <= N:
    ``lax.top_k`` refuses more); the valid lanes too."""
    state, cycle = _random_pool(3 * n + k, n)
    got = tref.ref_claim(torch.from_numpy(state), torch.from_numpy(cycle), k)
    want = jref.ref_claim(jnp.asarray(state), jnp.asarray(cycle), k)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_wrapper_rejects_k_below_one():
    state = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cmp_claim.cmp_claim(state, state.clone(), k=0)


# the slot pool's invariants under any op sequence (test_slotpool.py's
# property test, on the port's pool)

OPS = st.lists(
    st.one_of(
        st.tuples(st.just("produce"), st.integers(1, 6)),
        st.tuples(st.just("claim"), st.integers(1, 6)),
        st.tuples(st.just("reclaim"), st.integers(0, 8)),   # window size
        st.tuples(st.just("advance"), st.integers(0, 5)),   # cycle delta
    ),
    min_size=1, max_size=40,
)


@pytest.mark.slow
@settings(max_examples=60, deadline=None)
@given(ops_=OPS, n=st.integers(4, 24))
def test_slotpool_invariants_hold_for_any_sequence(ops_, n):
    pool = tsp.make(n, "cpu")
    claimed_order = []
    for op, arg in ops_:
        if op == "produce":
            pool, _, _ = tsp.produce(pool, arg)
        elif op == "claim":
            before = pool.cycle
            pool, ids, valid = tsp.claim(pool, arg)
            claimed_order += before[ids[valid].long()].tolist()
        elif op == "reclaim":
            before = tsp.counts(pool)
            pool, _ = tsp.reclaim(pool, arg)
            assert tsp.counts(pool)["available"] == before["available"]
            safe = max(0, int(pool.deque_cycle) - arg)
            held = pool.cycle[pool.state == tsp.CLAIMED]
            assert bool((held >= safe).all()) or safe == 0
        else:  # the paper's clock: deque_cycle never passes issued cycles
            pool = tsp.advance(pool, torch.minimum(pool.deque_cycle + arg,
                                                   pool.enq_cycle))
        tsp.check_invariants(pool, 8)
    assert claimed_order == sorted(claimed_order)  # strict FIFO
    assert int(pool.deque_cycle) <= int(pool.enq_cycle)
