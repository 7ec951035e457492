"""Fused CMP admission-ring step: CUDA kernel (``csrc/cmp_ring.cu``) and
its wrapper.

Replaces the Pallas kernel ``repro/kernels/cmp_ring.py`` (``_ring_kernel``).
One call runs window reclaim, the batched contiguous-prefix enqueue, the
k-way earliest-cycle claim and the monotone frontier publish over an int32
ring ``state``/``cycle`` [N] and ``meta`` [2] = [enq_cycle, deque_cycle].
``push_n`` and ``want`` are host ints, passed to the kernel as arguments,
so a call needs no host read before it launches.

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_ring_step``); on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_ring_step as plain

launches = 0


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
    _build.require(0 <= k <= n, f"cmp_ring_step: k={k} must be in [0, N={n}]")
    if state.device.type == "cpu":
        return plain(state, cycle, meta, (push_n, want), k=k, window=window)
    _build.require(state.is_cuda, f"cmp_ring_step: unsupported device {state.device}")
    for name, t, shape in (("state", state, (n,)), ("cycle", cycle, (n,)),
                           ("meta", meta, (2,))):
        _build.require(t.device == state.device and t.dtype == torch.int32
                       and tuple(t.shape) == shape and t.is_contiguous(),
                       f"cmp_ring_step: {name} must be a contiguous int32 "
                       f"{shape} tensor on {state.device}")
    lib = _build.lib()
    _build.require(n <= lib.rt_cmp_ring_max_n(),
                   f"cmp_ring_step: N={n} exceeds {lib.rt_cmp_ring_max_n()}")
    new_state = torch.empty_like(state)
    new_cycle = torch.empty_like(cycle)
    new_meta = torch.empty_like(meta)
    claimed = torch.empty((k,), dtype=torch.int32, device=state.device)
    err = lib.rt_cmp_ring_step(
        state.data_ptr(), cycle.data_ptr(), meta.data_ptr(), new_state.data_ptr(),
        new_cycle.data_ptr(), new_meta.data_ptr(), claimed.data_ptr(),
        n, k, int(window), push_n, want, _build.stream_ptr(state.device))
    _build.check(err, "cmp_ring_step")
    launches += 1
    return new_state, new_cycle, new_meta, claimed
