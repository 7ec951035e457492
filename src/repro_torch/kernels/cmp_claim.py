"""k-way earliest-cycle claim over the CMP slot pool: CUDA kernels
(``csrc/cmp_claim.cu``) and their wrapper.

Replaces the Pallas kernels of ``repro/kernels/cmp_claim.py``: the
single-block ``_claim_kernel`` and the tiled ``_claim_block_kernel`` with its
cross-block merge. The claim takes the ``k`` AVAILABLE slots of smallest
(cycle, id), AVAILABLE -> CLAIMED, and returns their ids in that order;
``ids == N`` marks a lane past the claimable slots. Dispatch is the JAX
package's: a pool of at most ``block_n`` slots (default 2048) is one tile and
one launch; a larger pool is tiled, one launch for the tiles' candidates and
one for the merge. The result does not depend on ``block_n``.

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_claim``); on a CUDA tensor it launches the kernels or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_claim

DEFAULT_BLOCK = 2048  # the JAX package's tile (kernels/cmp_claim.py)

launches = 0


def plain(state: torch.Tensor, cycle: torch.Tensor, *, k: int, block_n=None):
    """``ref.ref_claim`` with the wrapper's signature and outputs; the claim
    does not depend on ``block_n``."""
    new_state, ids, _ = ref_claim(state, cycle, k)
    return new_state, ids


def cmp_claim(state: torch.Tensor, cycle: torch.Tensor, *, k: int, block_n=None):
    """Claim the ``k`` earliest-cycle AVAILABLE slots.

    Args:
      state, cycle: int32 [N] slot arrays (domain constants / cycle stamps).
      k: lanes of ``ids``, any k >= 1 (k > N pads with N).
      block_n: tile of the tiled path (default 2048); on the card the tile
        one CTA sorts, min(N, block_n), is at most
        ``rt_cmp_claim_max_block()``.
    Returns (new_state [N], ids [k]).
    """
    global launches
    n = state.shape[0]
    bn = block_n or DEFAULT_BLOCK
    _build.require(n >= 1 and k >= 1 and bn >= 1,
                   f"cmp_claim: N={n}, k={k} and block_n={bn} must be >= 1")
    if state.device.type == "cpu":
        return plain(state, cycle, k=k)
    _build.require(state.is_cuda, f"cmp_claim: unsupported device {state.device}")
    for name, t in (("state", state), ("cycle", cycle)):
        _build.require(t.device == state.device and t.dtype == torch.int32
                       and tuple(t.shape) == (n,) and t.is_contiguous(),
                       f"cmp_claim: {name} must be a contiguous int32 ({n},) "
                       f"tensor on {state.device}")
    lib = _build.lib()
    max_block = lib.rt_cmp_claim_max_block()
    _build.require(min(n, bn) <= max_block,
                   f"cmp_claim: a tile of min(N={n}, block_n={bn}) slots exceeds "
                   f"the {max_block} one CTA holds")
    new_state = torch.empty_like(state)
    ids = torch.empty((k,), dtype=torch.int32, device=state.device)
    stream = _build.stream_ptr(state.device)
    if n <= bn:
        err = lib.rt_cmp_claim_tiles(state.data_ptr(), cycle.data_ptr(),
                                     new_state.data_ptr(), ids.data_ptr(), None,
                                     n, k, bn, stream)
        _build.check(err, "cmp_claim")
        launches += 1
        return new_state, ids
    nb, m = -(-n // bn), min(k, bn)
    cand = torch.empty((nb * m,), dtype=torch.int64, device=state.device)
    err = lib.rt_cmp_claim_tiles(state.data_ptr(), cycle.data_ptr(),
                                 new_state.data_ptr(), ids.data_ptr(),
                                 cand.data_ptr(), n, k, bn, stream)
    _build.check(err, "cmp_claim tiles")
    launches += 1
    err = lib.rt_cmp_claim_merge(cand.data_ptr(), new_state.data_ptr(),
                                 ids.data_ptr(), n, k, nb, m, stream)
    _build.check(err, "cmp_claim merge")
    launches += 1
    return new_state, ids
