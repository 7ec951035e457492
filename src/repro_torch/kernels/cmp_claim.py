"""k-way earliest-cycle claim over the CMP slot pool: the CUDA kernel
(``csrc/cmp_claim.cu``) and its wrappers.

Replaces the Pallas kernels of ``repro/kernels/cmp_claim.py``: the
single-block ``_claim_kernel`` and the tiled ``_claim_block_kernel`` with its
cross-block merge. The claim takes the ``k`` AVAILABLE slots of smallest
(cycle, id), AVAILABLE -> CLAIMED, and returns their ids in that order;
``ids == N`` marks a lane past the claimable slots. On the card every call is
one launch at every N: the kernel tiles the pool itself (512 slots a CTA) and
its last CTA merges the tiles' candidates. The result never depends on
``block_n``, which stays in the signatures for parity with
``repro.kernels.ops.claim``.

``cmp_claim`` returns (new_state, ids); ``claim_pool`` also runs
``slotpool.claim``'s epilogue (valid lanes, the max-publish of
``deque_cycle``, the claimed slots' retire cycles) in the same launch.

On a CPU tensor a wrapper runs its plain version (``plain``,
``plain_pool``); on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches of both wrappers.
"""

from __future__ import annotations

import torch

from repro_torch.core import domain
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_claim, set_drop

TILE = 512  # slots one CTA takes (kTile in csrc/cmp_claim.cu)

STREAMS = 1024  # streams a device can claim on (one arrival counter each)

launches = 0
_blocks = {}    # device -> int32 [STREAMS]: arrival counters, zeroed outside any capture
_counters = {}  # (device, stream) -> int32 [1] of its device's block, left at 0 by each call


def plain(state: torch.Tensor, cycle: torch.Tensor, *, k: int, block_n=None):
    """``ref.ref_claim`` with the wrapper's signature and outputs; the claim
    does not depend on ``block_n``."""
    new_state, ids, _ = ref_claim(state, cycle, k)
    return new_state, ids


def plain_pool(state, cycle, retire_cycle, deque_cycle, *, k: int):
    """The claim and ``slotpool.claim``'s epilogue in torch ops: ``valid =
    ids < N``; ``deque_cycle`` max-published with the largest claimed cycle
    (0 for an invalid lane); the retire cycle of each claimed slot set to the
    new boundary (ids == N dropped)."""
    n = state.shape[0]
    new_state, ids, _ = ref_claim(state, cycle, k)
    valid = ids < n
    seen = cycle[ids.clamp(0, n - 1).long()]
    claimed_max = torch.where(valid, seen, 0).max().to(torch.int32)
    new_deque = domain.publish_boundary(deque_cycle, claimed_max).to(torch.int32)
    return new_state, ids, valid, set_drop(retire_cycle, ids, new_deque), new_deque


def _check_slots(what: str, n: int, k: int, tensors) -> None:
    _build.require(n >= 1 and k >= 1, f"{what}: N={n} and k={k} must be >= 1")
    dev = tensors[0][1].device
    _build.require(dev.type == "cuda", f"{what}: unsupported device {dev}")
    for name, t, shape in tensors:
        _build.require(t.device == dev and t.dtype == torch.int32
                       and tuple(t.shape) == shape and t.is_contiguous(),
                       f"{what}: {name} must be a contiguous int32 {shape} tensor "
                       f"on {dev}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def arrival_counter(dev, stream) -> torch.Tensor:
    """The arrival counter of calls on ``stream``. A device's counters are
    made and zeroed together at its first call, which must not be under
    CUDA-graph capture: a fill captured into a graph would not run until the
    graph is replayed. A stream first seen under capture takes a counter of
    the zeroed block."""
    counter = _counters.get((dev, stream))
    if counter is None:
        block = _blocks.get(dev)
        if block is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("cmp_claim: the first call on a device is under "
                                   "CUDA-graph capture; call it once before capturing")
            block = _blocks[dev] = torch.zeros(STREAMS, dtype=torch.int32, device=dev)
            torch.cuda.synchronize(dev)  # zeroed before a call on any stream reads it
        used = sum(d == dev for d, _ in _counters)
        if used == STREAMS:
            raise RuntimeError(f"cmp_claim: more than {STREAMS} streams on {dev}")
        counter = _counters[(dev, stream)] = block[used:used + 1]
    return counter


def _run(state, cycle, k, retire=None, deque=None):
    """One launch; returns (new_state, ids, valid, new_retire, new_deque),
    the last three None without a pool."""
    global launches
    n, dev = state.shape[0], state.device
    stream = _build.stream_ptr(dev)
    new_state = torch.empty_like(state)
    ids = torch.empty((k,), dtype=torch.int32, device=dev)
    slots = [state, cycle, new_state]
    valid = new_retire = new_deque = None
    if retire is not None:
        valid = torch.empty((k,), dtype=torch.bool, device=dev)
        new_retire = torch.empty_like(retire)
        new_deque = torch.empty_like(deque)
        slots += [retire, new_retire]
    cand = counter = None
    nb = -(-n // TILE)
    if nb > 1:
        cand = torch.empty((nb * min(k, TILE),), dtype=torch.int64, device=dev)
        counter = arrival_counter(dev, stream)
    vec = all(t.data_ptr() % 16 == 0 for t in slots)
    err = _build.lib().rt_cmp_claim(state.data_ptr(), cycle.data_ptr(), new_state.data_ptr(),
                  ids.data_ptr(), _ptr(retire), _ptr(new_retire), _ptr(deque),
                  _ptr(new_deque), _ptr(valid), _ptr(cand), _ptr(counter), n, k,
                  int(vec), stream)
    _build.check(err, "cmp_claim")
    launches += 1
    return new_state, ids, valid, new_retire, new_deque


def cmp_claim(state: torch.Tensor, cycle: torch.Tensor, *, k: int, block_n=None):
    """Claim the ``k`` earliest-cycle AVAILABLE slots.

    Args:
      state, cycle: int32 [N] slot arrays (domain constants / cycle stamps).
      k: lanes of ``ids``, any k >= 1 (k > N pads with N).
      block_n: the JAX package's tile (>= 1 when given); the result does not
        depend on it, and on the card the kernel picks its own.
    Returns (new_state [N], ids [k]).
    """
    n = state.shape[0]
    _build.require(not block_n or block_n >= 1,
                   f"cmp_claim: block_n={block_n} must be >= 1")
    if state.device.type == "cpu":
        _build.require(n >= 1 and k >= 1, f"cmp_claim: N={n} and k={k} must be >= 1")
        return plain(state, cycle, k=k)
    _check_slots("cmp_claim", n, k, (("state", state, (n,)), ("cycle", cycle, (n,))))
    return _run(state, cycle, k)[:2]


def claim_pool(state, cycle, retire_cycle, deque_cycle, *, k: int):
    """``slotpool.claim`` on the pool's arrays in one launch.

    Args:
      state, cycle, retire_cycle: int32 [N]; deque_cycle: int32 0-d.
      k: lanes, any k >= 1.
    Returns (new_state [N], ids [k], valid [k] bool, new_retire_cycle [N],
    new_deque_cycle 0-d); the inputs are not written.
    """
    n = state.shape[0]
    if state.device.type == "cpu":
        _build.require(n >= 1 and k >= 1, f"claim_pool: N={n} and k={k} must be >= 1")
        return plain_pool(state, cycle, retire_cycle, deque_cycle, k=k)
    _check_slots("claim_pool", n, k,
                 (("state", state, (n,)), ("cycle", cycle, (n,)),
                  ("retire_cycle", retire_cycle, (n,)), ("deque_cycle", deque_cycle, ())))
    return _run(state, cycle, k, retire_cycle, deque_cycle)
