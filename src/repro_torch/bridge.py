"""Carry the JAX package's parameters and decode caches into the port.

:func:`params_from_numpy` takes the JAX params tree as nested dicts of
numpy arrays (the caller does ``tree_map(np.asarray, params)`` on the JAX
side, so this module never sees a JAX array) and returns the port's tree
with the same key paths. Floating leaves go through float32, which holds
every bfloat16 value exactly (numpy has no bfloat16), then to ``dtype``,
except the leaves the reference keeps in float32 in every model (the MoE
router, ``moe.router``; hymba's ``mamba.a_log`` and ``mamba.d_skip``),
which stay float32.

:func:`cache_from_numpy` does the same for a decode cache (the tree of
``init_cache`` / ``prefill`` / ``decode_step``) into the structure of a
port cache it is given, keeping each leaf's own dtype, and
:func:`cache_to_numpy` goes back, so a decode can move between the
packages mid-sequence.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as T

F32_LEAVES = {"router", "a_log", "d_skip"}  # leaf names the reference keeps in float32


def params_from_numpy(tree: Any, *, dtype: torch.dtype, device) -> Any:
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dtype=torch.float32 if k in F32_LEAVES
                                     else dtype, device=device)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(np.array(arr)).to(device)
    f32 = torch.from_numpy(np.array(arr, dtype=np.float32))
    return f32.to(device=device, dtype=dtype)


def cache_from_numpy(tree: Any, like: Any) -> Any:
    """A JAX cache tree of numpy leaves as a port cache of ``like``'s
    structure (``init_cache``'s or an ``*_init_state``'s), whose node types
    (``KVCache`` for the reference's NamedTuple of the same fields) and
    devices it takes. A bfloat16 leaf (``dtype.name == "bfloat16"``)
    becomes a bfloat16 tensor, every other leaf a tensor of its own dtype
    (``-inf`` stabilisers included)."""
    arrays, refs = T.tree_leaves(tree), T.tree_leaves(like)
    if len(arrays) != len(refs):
        raise ValueError(f"a cache of {len(arrays)} leaves into one of {len(refs)}")
    out = []
    for arr, ref in zip(arrays, refs):
        arr = np.asarray(arr)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"a leaf of shape {arr.shape} into one of {tuple(ref.shape)}")
        if arr.dtype.name == "bfloat16":
            out.append(torch.from_numpy(np.array(arr, dtype=np.float32)).to(
                device=ref.device, dtype=torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(arr)).to(ref.device))
    return T.tree_unflatten(like, iter(out))


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def cache_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`cache_from_numpy`, on the host: the same
    structure with numpy leaves, bfloat16 ones as float32 (which holds them
    exactly)."""
    return T.tree_map(_host, tree)
