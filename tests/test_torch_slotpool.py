"""The port's slot pool (repro_torch.core.slotpool) against the JAX
package's: the same random op sequences give bit-identical pools."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import slotpool as jsp
from repro_torch.core import slotpool as tsp

FIELDS = ("state", "cycle", "retire_cycle", "enq_cycle", "deque_cycle")


def _same(tpool, jpool):
    for f in FIELDS:
        t, j = getattr(tpool, f), np.asarray(getattr(jpool, f))
        assert t.dtype == torch.int32, f
        assert tuple(t.shape) == j.shape and np.array_equal(t.numpy(), j), f


def _same_out(t, j):
    assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(6))
def test_random_op_sequences_match_jax(seed):
    """produce / produce_with_reclaim / claim / claim_ids / advance /
    reclaim / reclaim_retired in random order, compared after every op.
    claim (the earliest-cycle claim kernel's plain version) over-asks too,
    and retires at the new boundary; claim_ids
    takes a random subset of the live slots plus at least one sentinel
    lane, which the JAX scatters drop (mode="drop") and the port masks."""
    rng = np.random.default_rng(seed)
    n = (5, 8, 13)[seed % 3]
    tp, jp = tsp.make(n, "cpu"), jsp.make(n)
    for _ in range(60):
        op = rng.choice(["produce", "pwr", "claim", "claim_ids", "advance",
                         "reclaim", "reclaim_retired"])
        if op == "produce":
            k = int(rng.choice([1, 3, n + 2]))  # over-asks pad with invalid lanes
            tp, tid, tv = tsp.produce(tp, k)
            jp, jid, jv = jsp.produce(jp, k)
            _same_out(tid, jid), _same_out(tv, jv)
        elif op == "pwr":
            k, w = int(rng.choice([2, 4])), int(rng.choice([0, 3]))
            tp, tid, tv = tsp.produce_with_reclaim(tp, k, w)
            jp, jid, jv = jsp.produce_with_reclaim(jp, k, w)
            _same_out(tid, jid), _same_out(tv, jv)
        elif op == "claim":
            k = int(rng.choice([1, 3, n + 2]))
            tp, tid, tv = tsp.claim(tp, k)
            jp, jid, jv = jsp.claim(jp, k)
            _same_out(tid, jid), _same_out(tv, jv)
        elif op == "claim_ids":
            live = np.flatnonzero(np.asarray(jp.state) == jsp.AVAILABLE)
            pick = rng.permutation(live)[:int(rng.integers(0, len(live) + 1))]
            ids = np.concatenate([pick, np.full(int(rng.integers(1, 3)), n)])
            ids = ids.astype(np.int32)
            valid = ids < n
            tp = tsp.claim_ids(tp, torch.from_numpy(ids), torch.from_numpy(valid))
            jp = jsp.claim_ids(jp, jnp.asarray(ids), jnp.asarray(valid))
        elif op == "advance":
            obs = int(jp.deque_cycle) + int(rng.integers(0, 5))
            tp, jp = tsp.advance(tp, obs), jsp.advance(jp, jnp.int32(obs))
        elif op == "reclaim":
            w = int(rng.choice([0, 2, 5]))
            (tp, tn), (jp, jn) = tsp.reclaim(tp, w), jsp.reclaim(jp, w)
            assert int(tn) == int(jn)
        else:
            w = int(rng.choice([0, 2, 5]))
            (tp, tn), (jp, jn) = tsp.reclaim_retired(tp, w), jsp.reclaim_retired(jp, w)
            assert int(tn) == int(jn)
        _same(tp, jp)
        assert tsp.counts(tp) == jsp.counts(jp)
        if int(tp.deque_cycle) <= int(tp.enq_cycle):  # the paper's clock
            tsp.check_invariants(tp, 8)


def test_produce_is_lowest_index_first():
    pool = tsp.make(8, "cpu")
    pool, ids, valid = tsp.produce(pool, 3)
    assert ids.tolist() == [0, 1, 2] and valid.all()
    pool = tsp.claim_ids(pool, torch.tensor([1], dtype=torch.int32),
                         torch.tensor([True]))
    pool = tsp.advance(pool, 100)
    pool, _ = tsp.reclaim_retired(pool, 4)
    pool, ids, valid = tsp.produce(pool, 2)
    assert ids.tolist() == [1, 3] and pool.cycle.tolist()[:4] == [1, 4, 3, 5]


def test_produce_with_reclaim_relieves_pressure():
    pool = tsp.make(4, "cpu")
    pool, ids, valid = tsp.produce(pool, 4)
    assert bool(valid.all())
    pool = tsp.claim_ids(pool, ids, valid)
    pool = tsp.advance(pool, int(pool.deque_cycle) + 100)  # window expires
    pool, ids2, valid2 = tsp.produce_with_reclaim(pool, 2, window=8)
    assert bool(valid2.all()), "allocation failure should trigger reclamation"


def test_window_blocks_reuse():
    """A slot retired at boundary c is not reusable until deque_cycle - c > W."""
    pool = tsp.make(6, "cpu")
    pool, ids, valid = tsp.produce(pool, 6)
    pool = tsp.advance(pool, 6)
    pool = tsp.claim_ids(pool, ids[:3], valid[:3])  # retire_cycle = 6
    for dc, freed in ((9, 0), (10, 0), (11, 3)):
        pool = tsp.advance(pool, dc)
        pool2, n = tsp.reclaim_retired(pool, 4)
        assert int(n) == freed, (dc, int(n))
    assert tsp.counts(pool2)["free"] == 3 and tsp.counts(pool2)["available"] == 3
