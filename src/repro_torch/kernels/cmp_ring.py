"""Fused CMP admission-ring step: CUDA kernel (``csrc/cmp_ring.cu``) and
its wrapper.

Replaces the Pallas kernel ``repro/kernels/cmp_ring.py`` (``_ring_kernel``).
One call runs window reclaim, the batched contiguous-prefix enqueue, the
k-way earliest-cycle claim and the monotone frontier publish over an int32
ring ``state``/``cycle`` [N] and ``meta`` [2] = [enq_cycle, deque_cycle].
``push_n`` and ``want`` are host ints, passed to the kernel as arguments,
so a call needs no host read before it launches. The kernel is one CTA
for rings of up to ``rt_cmp_ring_max_n()`` = 16,384 slots (the engine's
ring at ``max_batch`` 1,024); it claims by ring position when the slots
hold the cycles an enqueue gives them, and by a sort of the keys otherwise,
exact either way. A larger ring takes the grid path, a thread a slot: a
scan, an enqueue, the claim kernel of ``csrc/cmp_claim.cu`` (gated on the
card: it runs only for states that break the enqueue invariant) and a
publish that otherwise claims by ring position; four launches (three when
nothing can be claimed), exact for any input.

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_ring_step``); on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cmp_claim
from repro_torch.kernels.ref import ref_ring_step as plain

launches = 0
GRID_THREADS = 256  # slots a CTA of the grid path takes (kGridThreads in csrc/cmp_ring.cu)


def cmp_ring_step(state: torch.Tensor, cycle: torch.Tensor, meta: torch.Tensor,
                  req, *, k: int, window: int):
    """One fused admission step over the ring.

    Args:
      state, cycle: int32 [N] slot arrays (domain constants / cycle stamps).
      meta: int32 [2] = [enq_cycle, deque_cycle].
      req: (push_n, want) host ints; push_n is clamped to N.
    Returns (new_state, new_cycle, new_meta, claimed_cycles[k]): claimed
    entries are cycle numbers in ascending order, -1 marks an unfilled
    lane. The number of accepted pushes is ``new_meta[0] - meta[0]``.
    """
    global launches
    n = state.shape[0]
    push_n, want = min(int(req[0]), n), int(req[1])
    _build.require(n >= 1 and 0 <= k <= n,
                   f"cmp_ring_step: need N >= 1 and k in [0, N], got N={n}, k={k}")
    if state.device.type == "cpu":
        return plain(state, cycle, meta, (push_n, want), k=k, window=window)
    _build.require(state.is_cuda, f"cmp_ring_step: unsupported device {state.device}")
    for name, t, shape in (("state", state, (n,)), ("cycle", cycle, (n,)),
                           ("meta", meta, (2,))):
        _build.require(t.device == state.device and t.dtype == torch.int32
                       and tuple(t.shape) == shape and t.is_contiguous(),
                       f"cmp_ring_step: {name} must be a contiguous int32 "
                       f"{shape} tensor on {state.device}")
    new_state = torch.empty_like(state)
    new_cycle = torch.empty_like(cycle)
    new_meta = torch.empty_like(meta)
    claimed = torch.empty((k,), dtype=torch.int32, device=state.device)
    lib = _build.lib()
    stream = _build.stream_ptr(state.device)
    if n <= lib.rt_cmp_ring_max_n():  # one CTA
        err = lib.rt_cmp_ring_step(
            state.data_ptr(), cycle.data_ptr(), meta.data_ptr(), new_state.data_ptr(),
            new_cycle.data_ptr(), new_meta.data_ptr(), claimed.data_ptr(),
            n, k, int(window), push_n, want, stream)
        _build.check(err, "cmp_ring_step")
        launches += 1
        return new_state, new_cycle, new_meta, claimed
    lanes = min(k, want) if k >= 1 and want >= 1 else 0
    mid_state = torch.empty_like(state)
    ids = torch.empty((max(lanes, 1),), dtype=torch.int32, device=state.device)
    cand = torch.empty((-(-n // cmp_claim.TILE) * min(max(lanes, 1), cmp_claim.TILE),),
                       dtype=torch.int64, device=state.device)
    words = torch.empty((2 + 2 * -(-n // GRID_THREADS),), dtype=torch.int32,
                        device=state.device)
    counter = cmp_claim.arrival_counter(state.device, stream)
    vec = all(t.data_ptr() % 16 == 0 for t in (mid_state, new_cycle, new_state))
    err = lib.rt_cmp_ring_step_grid(
        state.data_ptr(), cycle.data_ptr(), meta.data_ptr(), new_state.data_ptr(),
        new_cycle.data_ptr(), new_meta.data_ptr(), claimed.data_ptr(), mid_state.data_ptr(),
        ids.data_ptr(), cand.data_ptr(), counter.data_ptr(), words.data_ptr(),
        n, k, int(window), push_n, want, lanes, int(vec), stream)
    _build.check(err, "cmp_ring_step")
    launches += grid_launches(k, want)
    return new_state, new_cycle, new_meta, claimed


def grid_launches(k: int, want: int) -> int:
    """Kernel launches of one grid-path call (N above the one-CTA limit):
    scan, enqueue, publish, and the claim when any lane can be claimed."""
    return 4 if k >= 1 and want >= 1 else 3
