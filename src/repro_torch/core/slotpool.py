"""Device-side CMP: a cyclic slot pool as a functional torch structure.

The torch embodiment of the unified protection domain
(:mod:`repro_torch.core.domain`): state constants, window math and both
reclamation predicates come from there, so the host queue and this pool
share one protocol.

* three-state lifecycle  FREE -> AVAILABLE -> CLAIMED -> (window) -> FREE,
* immutable monotone ``cycle`` assigned when a slot becomes AVAILABLE,
* monotone ``deque_cycle`` published by claims (max-publish),
* reclamation predicate  (state == CLAIMED) & (cycle < deque_cycle - W).

Two reclamation predicates are provided (both defined in the domain core):

* ``reclaim``         — the paper's: enqueue-cycle vs window (FIFO lifetimes).
* ``reclaim_retired`` — for non-FIFO lifetimes (paged KV blocks): the window
                        counts from the *retire* cycle.

Every op takes a pool and returns a new one; the input tensors are never
written. State is int32 throughout, with 0-d int32 tensors for
``enq_cycle``/``deque_cycle``, so a pool compares bit for bit with the JAX
package's. Invalid lanes carry ``id == num_slots``; the scatters here drop
them explicitly (``_set_drop``), as ``.at[].set(mode="drop")`` does in JAX.

The k-way earliest-cycle ``claim`` (strict FIFO) runs the ``cmp_claim``
kernel (:func:`repro_torch.kernels.ops.claim`: CUDA on the card, its plain
version on the CPU) and reads nothing back to the host.
:class:`~repro_torch.serving.kv_cache.PagedKVPool` uses ``claim_ids``
(claim *specific* slots) instead.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import domain
from repro_torch.core.domain import AVAILABLE, CLAIMED, FREE
from repro_torch.kernels import ops as kops

_INT_MAX = torch.iinfo(torch.int32).max


class SlotPool(NamedTuple):
    state: torch.Tensor         # [N] int32 in {FREE, AVAILABLE, CLAIMED}
    cycle: torch.Tensor         # [N] int32 — cycle at AVAILABLE-transition
    retire_cycle: torch.Tensor  # [N] int32 — deque_cycle observed at claim
    enq_cycle: torch.Tensor     # []  int32 — global monotone enqueue counter
    deque_cycle: torch.Tensor   # []  int32 — highest claimed cycle

    @property
    def num_slots(self) -> int:
        return self.state.shape[-1]


def make(num_slots: int, device="cuda") -> SlotPool:
    z = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    s = torch.zeros((), dtype=torch.int32, device=device)
    return SlotPool(state=z, cycle=z.clone(), retire_cycle=z.clone(),
                    enq_cycle=s, deque_cycle=s.clone())


def _set_drop(arr: torch.Tensor, ids: torch.Tensor, values) -> torch.Tensor:
    """``arr.at[ids].set(values, mode="drop")`` for ids in ``[0, n]``: the
    sentinel ``n`` lands in a spare trailing slot that is cut off, so it
    is dropped without a host read and without an out-of-bounds write."""
    ext = torch.cat([arr, arr.new_zeros(1)])
    ext[ids.long()] = values
    return ext[:-1]


# ---------------------------------------------------------------------------
# produce: FREE -> AVAILABLE (enqueue / block allocation)
# ---------------------------------------------------------------------------


def produce(pool: SlotPool, k: int) -> Tuple[SlotPool, torch.Tensor, torch.Tensor]:
    """Move up to ``k`` FREE slots to AVAILABLE, assigning fresh cycles.

    Returns (pool', ids[k], valid[k]). Lowest-index-first selection: the
    key of a FREE slot is its own index, so sorting the keys lists the FREE
    ids in ascending order (the keys are unique, so ``torch.sort`` gives the
    order ``lax.top_k`` does, ties to the lower index included).
    """
    n = pool.num_slots
    idx = torch.arange(n, dtype=torch.int32, device=pool.state.device)
    key = torch.where(pool.state == FREE, idx, _INT_MAX)
    head = torch.sort(key).values[:min(k, n)]
    if k > n:  # over-ask: pad with invalid lanes
        head = torch.cat([head, head.new_full((k - n,), _INT_MAX)])
    valid = head != _INT_MAX
    ids = torch.where(valid, head, n).to(torch.int32)
    # Paper Phase 1: each produced slot gets the next monotone cycle.
    counts = valid.to(torch.int32)
    new_cycles = (pool.enq_cycle + torch.cumsum(counts, 0)).to(torch.int32)
    state = _set_drop(pool.state, ids, AVAILABLE)
    cycle = _set_drop(pool.cycle, ids, new_cycles)
    enq_cycle = (pool.enq_cycle + counts.sum()).to(torch.int32)
    return pool._replace(state=state, cycle=cycle, enq_cycle=enq_cycle), ids, valid


# ---------------------------------------------------------------------------
# claim: AVAILABLE -> CLAIMED (dequeue / block release)
# ---------------------------------------------------------------------------


def claim(pool: SlotPool, k: int) -> Tuple[SlotPool, torch.Tensor, torch.Tensor]:
    """Claim up to ``k`` earliest-cycle AVAILABLE slots (strict FIFO).

    The earliest-claim property (paper §3.7 FIFO invariant 3) comes from
    the claim kernel, which fuses the selection with the AVAILABLE ->
    CLAIMED transition; ``deque_cycle`` then advances by the domain's
    monotone max-publish (dequeue Phase 5), and the claimed slots retire at
    the *new* boundary (``claim_ids`` writes the old one). Returns (pool',
    ids[k], valid[k]); no value is read back to the host.
    """
    n = pool.num_slots
    state, ids = kops.claim(pool.state, pool.cycle, k=k)
    valid = ids < n
    seen = pool.cycle[ids.clamp(0, n - 1).long()]
    claimed_max = torch.where(valid, seen, 0).max().to(torch.int32)
    deque_cycle = domain.publish_boundary(pool.deque_cycle, claimed_max).to(torch.int32)
    retire = _set_drop(pool.retire_cycle, ids, deque_cycle)
    return pool._replace(state=state, retire_cycle=retire,
                         deque_cycle=deque_cycle), ids, valid


# ---------------------------------------------------------------------------
# claim_ids: AVAILABLE -> CLAIMED for given slots (block release)
# ---------------------------------------------------------------------------


def claim_ids(pool: SlotPool, ids: torch.Tensor, valid: torch.Tensor) -> SlotPool:
    """Claim *specific* slots (e.g. a finishing request retiring its KV
    blocks). Invalid lanes must carry id == num_slots."""
    n = pool.num_slots
    if ids.numel() == 0:
        return pool
    ids = torch.where(valid, ids, n).to(torch.int32)
    state = _set_drop(pool.state, ids, CLAIMED)
    retire = _set_drop(pool.retire_cycle, ids, pool.deque_cycle)
    seen = pool.cycle[ids.clamp(0, n - 1).long()]
    claimed_max = torch.where(valid, seen, 0).max().to(torch.int32)
    deque_cycle = domain.publish_boundary(pool.deque_cycle, claimed_max)
    return pool._replace(state=state, retire_cycle=retire,
                         deque_cycle=deque_cycle.to(torch.int32))


# ---------------------------------------------------------------------------
# boundary publish + reclamation (domain predicates)
# ---------------------------------------------------------------------------


def advance(pool: SlotPool, observed_cycle) -> SlotPool:
    """Unilateral monotone boundary publish (paper dequeue Phase 5)."""
    observed = torch.as_tensor(observed_cycle, dtype=torch.int32,
                               device=pool.deque_cycle.device)
    dc = domain.publish_boundary(pool.deque_cycle, observed)
    return pool._replace(deque_cycle=dc.to(torch.int32))


def reclaim(pool: SlotPool, window: int) -> Tuple[SlotPool, torch.Tensor]:
    """Paper §3.6 predicate (domain.reclaim_enqueue_mask):
    (state == CLAIMED) & (cycle < deque_cycle - W).

    Returns (pool', num_reclaimed). AVAILABLE slots are absolutely
    protected.
    """
    mask = domain.reclaim_enqueue_mask(pool.state, pool.cycle,
                                       pool.deque_cycle, window)
    state = torch.where(mask, FREE, pool.state).to(torch.int32)
    return pool._replace(state=state), mask.to(torch.int32).sum()


def reclaim_retired(pool: SlotPool, window: int) -> Tuple[SlotPool, torch.Tensor]:
    """Predicate for non-FIFO lifetimes (paged KV blocks,
    domain.reclaim_retired_mask): (state == CLAIMED) & (retire_cycle <
    deque_cycle - W)."""
    mask = domain.reclaim_retired_mask(pool.state, pool.retire_cycle,
                                       pool.deque_cycle, window)
    state = torch.where(mask, FREE, pool.state).to(torch.int32)
    return pool._replace(state=state), mask.to(torch.int32).sum()


def produce_with_reclaim(pool: SlotPool, k: int, window: int):
    """Paper Alg 1 Phase 1: allocation failure triggers immediate reclamation
    and a retry — automatic memory-pressure relief. The JAX package's
    ``lax.cond`` is a Python ``if`` here, on one host read of ``valid``.

    As in the reference, the retry runs on the pool *after* the first
    produce, so the slots of a partial first grab stay AVAILABLE without
    being returned to the caller (kept for parity; see ROADMAP Queue 3)."""
    pool, ids, valid = produce(pool, k)
    if bool(valid.all()):
        return pool, ids, valid
    pool, _ = reclaim_retired(pool, window)
    return produce(pool, k)


# ---------------------------------------------------------------------------
# diagnostics / invariants
# ---------------------------------------------------------------------------


def counts(pool: SlotPool) -> dict:
    return {
        "free": int((pool.state == FREE).sum()),
        "available": int((pool.state == AVAILABLE).sum()),
        "claimed": int((pool.state == CLAIMED).sum()),
        "enq_cycle": int(pool.enq_cycle),
        "deque_cycle": int(pool.deque_cycle),
    }


def check_invariants(pool: SlotPool, window: int) -> None:
    """Raises AssertionError if any CMP invariant is violated (delegates to
    the domain's quiesced checker shared with the host queue)."""
    domain.check_quiesced(pool.state.cpu().numpy(), pool.cycle.cpu().numpy(),
                          int(pool.enq_cycle), int(pool.deque_cycle), window)
