"""The unified CMP protection domain (DESIGN.md §1) — single source of truth
for the paper's mechanism, shared by every embodiment in this framework.

The paper's central claim is that one simple protocol replaces every
coordination scheme:

  * a three-state slot/node lifecycle  FREE -> AVAILABLE -> CLAIMED,
  * an immutable monotone ``cycle`` assigned at enqueue/produce time,
  * a unilaterally published monotone boundary ``deque_cycle`` (fetch-max,
    no handshakes),
  * a sliding protection window  P = [deque_cycle - W, deque_cycle]: a slot
    is reclaimable iff it is CLAIMED and its cycle fell behind the window.

This module holds that protocol once. The three embodiments layer on it:

  * :mod:`repro.core.cmp`       — host shared-memory queue (Algorithms 1/3/4);
    atomics are CAS/FAA cells, the lifecycle runs AVAILABLE -> CLAIMED on
    linked nodes (FREE is the type-stable pool).
  * :mod:`repro.core.slotpool`  — device slot pool; the claim CAS becomes a
    deterministic earliest-cycle selection, everything else is identical.
  * :class:`repro.serving.kv_cache.PagedKVPool` — paged KV blocks on the slot
    pool with the *retire-cycle* reclamation predicate (non-FIFO lifetimes).

Every function below is substrate-generic: it accepts Python ints (host hot
path — no array-library dispatch cost) and ``jax.numpy`` arrays/tracers
(device hot path — fully jittable) through the same arithmetic.
"""

from __future__ import annotations

from typing import Optional

# ---------------------------------------------------------------------------
# state constants — the lifecycle FREE -> AVAILABLE -> CLAIMED -> (window) -> FREE
# ---------------------------------------------------------------------------

FREE = 0        # reclaimed / never produced (device pools; host: node in NodePool)
AVAILABLE = 1   # produced, holds live data, claimable
CLAIMED = 2    # consumed; protected until the window slides past its cycle

STATE_NAMES = {FREE: "FREE", AVAILABLE: "AVAILABLE", CLAIMED: "CLAIMED"}

# ---------------------------------------------------------------------------
# window arithmetic (paper §3.1) — W = max(MIN_WINDOW, OPS x R)
# ---------------------------------------------------------------------------

MIN_WINDOW = 64


def compute_window(ops_per_sec: float, resilience_s: float,
                   min_window: int = MIN_WINDOW) -> int:
    """W = max(MIN_WINDOW, OPS x R), rounded up to an integer cycle count.

    OPS is the expected dequeue/claim rate (ops/s) and R the resilience — the
    maximum tolerated stall of any participant, in seconds. The same formula
    sizes every embodiment: host data-pipeline queues (OPS = batches/s,
    R = tolerated producer/consumer stall), paged KV pools (OPS = decode
    steps/s, R = max request-preemption latency), async checkpoint buffers
    (OPS = checkpoint events/s, R = max writer lag).
    """
    if ops_per_sec < 0 or resilience_s < 0:
        raise ValueError("ops_per_sec and resilience_s must be non-negative")
    w = int(ops_per_sec * resilience_s + 0.5)
    return max(int(min_window), w)


def retained_bytes(window: int, node_size_bytes: int) -> int:
    """Upper bound on memory retained by the protection window."""
    return int(window) * int(node_size_bytes)


def max_reclaim_delay_cycles(window: int, gc_period: int) -> int:
    """A CLAIMED node is recycled within at most W + N dequeue cycles
    (window plus the conditional-reclamation trigger period)."""
    return int(window) + int(gc_period)


# ---------------------------------------------------------------------------
# protection boundary + reclamation predicates (paper §3.6)
# ---------------------------------------------------------------------------


def safe_cycle(deque_cycle, window):
    """Reclamation boundary max(0, deque_cycle - W).

    Written as ``s * (s > 0)`` so one definition serves Python ints (host)
    and jnp arrays/tracers (device) without an array-library dispatch.
    """
    s = deque_cycle - window
    return s * (s > 0)


def publish_boundary(current, observed):
    """Unilateral monotone max-publish of the protection boundary (dequeue
    Phase 5). Pure-value form for the device embodiment; the host embodiment
    applies the same max through ``AtomicCell.fetch_max``."""
    grow = observed > current
    return current + (observed - current) * grow


def reclaim_enqueue_mask(state, cycle, deque_cycle, window):
    """The paper's reclamation predicate (FIFO lifetimes — queue nodes, MoE
    capacity slots, microbatch buffers):

        reclaimable  iff  (state == CLAIMED) and (cycle < deque_cycle - W)

    AVAILABLE slots are absolutely protected; the window counts from the
    *enqueue* cycle.
    """
    return (state == CLAIMED) & (cycle < safe_cycle(deque_cycle, window))


def reclaim_retired_mask(state, retire_cycle, deque_cycle, window):
    """Generalized predicate for non-FIFO lifetimes (paged KV blocks): the
    window counts from the *retire* cycle (the boundary observed at claim
    time), preserving the guarantee that any actor which observed the slot
    live gets >= W cycles of grace. Documented adaptation (DESIGN.md §2)."""
    return (state == CLAIMED) & (retire_cycle < safe_cycle(deque_cycle, window))


def window_admit(position, window):
    """Bounded-capacity admission: the j-th claim on a resource is admitted
    iff j < W. This is the protection window read as a capacity bound — MoE
    expert capacity slots (drop beyond capacity) and checkpoint write-behind
    buffers (drop beyond writer lag) are both this predicate."""
    return position < window


# ---------------------------------------------------------------------------
# quiesced invariant checkers (shared by tests of every embodiment)
# ---------------------------------------------------------------------------


def check_quiesced(state, cycle, enq_cycle: int, deque_cycle: int,
                   window: int, retire_cycle=None) -> None:
    """Assert the CMP invariants on a quiesced snapshot.

    ``state``/``cycle`` (and optionally ``retire_cycle``) are parallel
    sequences/arrays over slots; scalars are the global counters. Raises
    AssertionError on any violation:

      1. boundary sanity: deque_cycle <= enq_cycle (the boundary can only be
         published from cycles that were actually issued);
      2. AVAILABLE slots carry issued cycles (cycle <= enq_cycle);
      3. live (AVAILABLE) cycles are unique — monotone assignment;
      4. retire monotonicity: retire_cycle <= deque_cycle everywhere.
    """
    import numpy as np

    state = np.asarray(state)
    cycle = np.asarray(cycle)
    dc, eq = int(deque_cycle), int(enq_cycle)
    assert dc <= eq, f"deque_cycle {dc} ran ahead of enq_cycle {eq}"
    avail = state == AVAILABLE
    if avail.any():
        assert cycle[avail].max() <= eq, "AVAILABLE slot carries unissued cycle"
    av_cycles = cycle[avail]
    assert len(set(av_cycles.tolist())) == len(av_cycles), "duplicate live cycles"
    if retire_cycle is not None:
        rc = np.asarray(retire_cycle)
        assert (rc <= dc).all(), "retire_cycle published past the boundary"


def snapshot(state, cycle, enq_cycle: int, deque_cycle: int, window: int,
             min_linked_cycle: Optional[int] = None) -> dict:
    """Uniform diagnostic snapshot used by every embodiment's tests."""
    import numpy as np

    state = np.asarray(state)
    sc = int(safe_cycle(deque_cycle, window))
    return {
        "deque_cycle": int(deque_cycle),
        "enq_cycle": int(enq_cycle),
        "safe_cycle": sc,
        "min_linked_cycle": min_linked_cycle,
        "free": int((state == FREE).sum()),
        "available": int((state == AVAILABLE).sum()),
        "claimed": int((state == CLAIMED).sum()),
    }
