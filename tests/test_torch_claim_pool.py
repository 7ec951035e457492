"""The port's fused slot-pool claim (``cmp_claim.claim_pool``: the claim and
``slotpool.claim``'s epilogue, one launch on the card) against the JAX
package's ``slotpool.claim``, on the CPU through the plain version. Inputs
are made with numpy from a seed; the tolerance is bit-exact on all five
outputs (new_state, ids, valid, retire_cycle, deque_cycle).

The JAX claim runs its Pallas kernels in interpret mode, which unroll one
argmin a lane; at k = N + 3 above a few slots that takes minutes, so there
the JAX side is its plain reference (``repro.kernels.ref.ref_claim`` at k =
N, padded with invalid lanes) with ``slotpool.claim``'s epilogue written out
in jnp over ``repro.core.domain.publish_boundary``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import domain as jdomain
from repro.core import slotpool as jsp
from repro.kernels import ref as jref
from repro_torch.core import slotpool as tsp
from repro_torch.kernels import cmp_claim

INT_MAX = np.iinfo(np.int32).max


def _pools(n: int, seed: int) -> dict:
    """(state, cycle, retire_cycle, deque_cycle) per case."""
    rng = np.random.default_rng(seed)
    state = rng.choice([0, 1, 2], size=n).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    retire = rng.integers(-50, 50, size=n).astype(np.int32)
    mixed = rng.integers(-1000, 1000, size=n).astype(np.int32)
    mixed[rng.random(n) < 0.05] = INT_MAX
    return {
        "random": (state, perm, retire, 3),
        # nothing AVAILABLE: every lane invalid, the boundary publishes 0
        "none_valid": (np.where(state == 1, 2, state).astype(np.int32), perm, retire, -5),
        # the boundary already above every claimed cycle: a no-op publish
        "deque_above": (state, perm, retire, n + 100),
        # negative and INT32_MAX cycles, boundary below them all
        "negative_int_max": (np.ones(n, np.int32), mixed, retire, -2000),
        "tied": (state, np.full(n, 7, np.int32), retire, 0),
    }


def _jax_reference(state, cycle, retire, deque, k):
    """``repro.core.slotpool.claim``'s outputs at k > N without the interpret-mode
    kernel: ``ref_claim`` at k = N, padded, and the epilogue of slotpool.claim."""
    n = state.shape[0]
    new_state, ids, valid = jref.ref_claim(jnp.asarray(state), jnp.asarray(cycle), n)
    ids = jnp.concatenate([ids, jnp.full((k - n,), n, jnp.int32)])
    valid = jnp.concatenate([valid, jnp.zeros((k - n,), bool)])
    cyc = jnp.asarray(cycle)
    claimed_max = jnp.max(jnp.where(valid, cyc[jnp.clip(ids, 0, n - 1)], 0)).astype(jnp.int32)
    dq = jdomain.publish_boundary(jnp.int32(deque), claimed_max)
    new_retire = jnp.asarray(retire).at[ids].set(dq, mode="drop")
    return new_state, ids, valid, new_retire, dq


def _jax_claim(state, cycle, retire, deque, k):
    n = state.shape[0]
    if k > n and n > 16:
        return _jax_reference(state, cycle, retire, deque, k)
    pool = jsp.SlotPool(state=jnp.asarray(state), cycle=jnp.asarray(cycle),
                        retire_cycle=jnp.asarray(retire), enq_cycle=jnp.int32(n),
                        deque_cycle=jnp.int32(deque))
    pool, ids, valid = jsp.claim(pool, k)
    return pool.state, ids, valid, pool.retire_cycle, pool.deque_cycle


@pytest.mark.parametrize("k", ["1", "64", "n+3"])
@pytest.mark.parametrize("n", [1, 7, 2047, 2048, 2049, 5000])
def test_claim_pool_plain_matches_jax_slotpool_claim(n, k):
    k = n + 3 if k == "n+3" else int(k)
    for case, (state, cycle, retire, deque) in _pools(n, n * 31 + k).items():
        got = cmp_claim.claim_pool(
            torch.from_numpy(state), torch.from_numpy(cycle), torch.from_numpy(retire),
            torch.tensor(deque, dtype=torch.int32), k=k)
        want = _jax_claim(state, cycle, retire, deque, k)
        names = ("new_state", "ids", "valid", "retire_cycle", "deque_cycle")
        for name, g, w in zip(names, got, want):
            w = np.asarray(w)
            assert g.dtype == (torch.bool if name == "valid" else torch.int32), name
            assert tuple(g.shape) == w.shape, (case, name)
            assert np.array_equal(g.numpy(), w), (case, name)
        if case == "none_valid":
            assert not got[2].any() and int(got[4]) == 0
        if case == "deque_above":
            assert int(got[4]) == deque


@pytest.mark.parametrize("n,k", [(2049, 64), (5000, 5003)])
def test_slotpool_claim_is_claim_pool(n, k):
    """slotpool.claim on the CPU is the fused entry's plain version, bit for
    bit: the pool it returns holds claim_pool's outputs."""
    state, cycle, retire, deque = _pools(n, 7)["negative_int_max"]
    pool = tsp.SlotPool(state=torch.from_numpy(state), cycle=torch.from_numpy(cycle),
                        retire_cycle=torch.from_numpy(retire),
                        enq_cycle=torch.tensor(n, dtype=torch.int32),
                        deque_cycle=torch.tensor(deque, dtype=torch.int32))
    new, ids, valid = tsp.claim(pool, k)
    want = cmp_claim.plain_pool(pool.state, pool.cycle, pool.retire_cycle,
                                pool.deque_cycle, k=k)
    for g, w in zip((new.state, ids, valid, new.retire_cycle, new.deque_cycle), want):
        assert torch.equal(g, w)
    assert torch.equal(new.cycle, pool.cycle) and torch.equal(new.enq_cycle, pool.enq_cycle)
