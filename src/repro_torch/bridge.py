"""Carry the JAX package's parameters into the port.

:func:`params_from_numpy` takes the JAX params tree as nested dicts of
numpy arrays (the caller does ``tree_map(np.asarray, params)`` on the JAX
side, so this module never sees a JAX array) and returns the port's tree
with the same key paths. Floating leaves go through float32, which holds
every bfloat16 value exactly (numpy has no bfloat16), then to ``dtype``,
except the leaves the reference keeps in float32 in every model (the MoE
router, ``moe.router``), which stay float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


F32_LEAVES = {"router"}  # leaf names the reference keeps in float32


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
