"""Distributed-optimization building blocks on ``torch.distributed``.

* int8 error-feedback gradient compression for the cross-pod axis — the pod
  interconnect is the scarcest bandwidth at 1000+ nodes; 4x compression
  with error feedback keeps convergence while quartering those bytes.
* ring all-gather matmul — compute/comm overlap: each TP shard multiplies
  while the next weight chunk is in flight (``batch_isend_irecv``).

The JAX package's ``parallel/collectives.py`` with its ``shard_map``
bodies run by every rank on its own tensors over a process group (a
``DeviceMesh`` dim's group, or the default group), with the reference's
numbers: the error feedback, the quantizer and the reduction of the
dequantized float32 values divided by the group size.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): one scale for the whole tensor, kept with x's rank
    (``keepdims``), as the reference."""
    scale = torch.amax(torch.abs(x)).reshape((1,) * x.dim()) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``group`` (every rank calls it).

    Returns (mean-reduced gradient, new error residual). As in the
    reference, the dequantized float32 values are what is summed (the
    roofline models the payload as int8): an int8 sum would overflow."""
    g32 = g.to(torch.float32) + err
    q, scale = quantize_int8(g32)
    deq = dequantize_int8(q, scale)
    new_err = g32 - deq
    dist.all_reduce(deq, group=group)
    n = float(dist.get_world_size(group))
    return (deq / n).to(g.dtype), new_err


def cross_pod_grad_reduce(grads: Any, err: Any, mesh) -> Tuple[Any, Any]:
    """Apply compressed_psum leaf-wise over the mesh's 'pod' group (each
    rank's own tensors); the inputs come back unchanged on a mesh without
    one."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        return grads, err
    group = mesh.get_group("pod")
    out = [compressed_psum(g, e, group)
           for g, e in zip(T.tree_leaves(grads), T.tree_leaves(err), strict=True)]
    return (T.tree_unflatten(grads, iter([o[0] for o in out])),
            T.tree_unflatten(err, iter([o[1] for o in out])))


# ---------------------------------------------------------------------------
# overlapped all-gather matmul (ring)
# ---------------------------------------------------------------------------


def ring_ag_matmul(x: torch.Tensor, w: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """y = x @ all_gather(w) computed as a ring: at each of n steps,
    multiply the resident shard while passing it on to rank (idx+1) % n of
    ``group`` — the matmul hides the transfer (compute/comm overlap).

    Layout: w sharded on its first dim (k) over the group, x [m, k_total]
    replicated; w [k_local, n] is this rank's shard. Each step multiplies
    the matching x chunk with the resident w shard. The last step's shard
    is not passed on (the reference's last permute is discarded), so at
    n = 1 there is no exchange: send/recv to self is not the identity
    ``ppermute`` gives there."""
    n_dev = dist.get_world_size(group)
    idx = dist.get_rank(group)
    k_local = w.shape[0]

    def peer(i: int) -> int:
        return i if group is None else dist.get_global_rank(group, i)

    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=w.dtype, device=w.device)
    w_cur = w.contiguous()
    for i in range(n_dev):
        reqs, w_nxt = [], None
        if i + 1 < n_dev:
            w_nxt = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_cur, peer((idx + 1) % n_dev), group),
                dist.P2POp(dist.irecv, w_nxt, peer((idx - 1) % n_dev), group)])
        src = (idx - i) % n_dev  # whose shard we currently hold
        acc = acc + x[:, src * k_local:(src + 1) * k_local] @ w_cur
        for r in reqs:
            r.wait()
        w_cur = w_nxt
    return acc
