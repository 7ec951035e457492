"""Flash attention forward (causal or not, sliding window, GQA): CUDA
kernel (``csrc/flash_attention.cu``) and its wrapper.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel``). Layouts are the JAX package's: q [B, H, S, hd], k/v
[B, KV, T, hd] -> [B, H, S, hd], query head h reading KV head h % KV. The
kernel masks ragged S and T itself, so nothing is padded. It reads its
inputs through their strides (only head_dim must be contiguous), and the
output it returns is a [B, H, S, hd] view of a [B, S, H, hd] buffer, so
the model-layout wrapper in ``ops`` moves no data either way.

On a CPU tensor the wrapper runs the plain version, ``plain`` (=
``ref.ref_flash_attention``); on a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention as plain

launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, sliding_window=sliding_window)
    _build.require(q.is_cuda, f"flash_attention: unsupported device {q.device}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    _build.require(q.dtype in _build.DTYPE_CODES,
                   f"flash_attention: dtype {q.dtype} not float32/bfloat16")
    _build.require(tuple(k.shape) == (B, KV, T, hd) and tuple(v.shape) == tuple(k.shape),
                   "flash_attention: k/v must be [B, KV, T, hd]")
    _build.require(KV > 0 and H % KV == 0, "flash_attention: need H % KV == 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t.device == q.device and t.dtype == q.dtype and t.stride(-1) == 1,
                       f"flash_attention: {name} must be {q.dtype} on {q.device} "
                       "with a contiguous head_dim")
    lib = _build.lib()
    _build.require(hd <= lib.rt_flash_attention_max_hd(),
                   f"flash_attention: head_dim {hd} > {lib.rt_flash_attention_max_hd()}")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or S == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
        B, H, KV, S, T, hd, int(causal), int(sliding_window),
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches += 1
    return out
