"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The build
happens at first use, into ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, where ``<hash>`` covers the sources and the flags, so
an edited kernel is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc``, a failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (all return int, a cudaError_t).
SIGNATURES = {
    "rt_cmp_ring_step": [_P] * 7 + [_I] * 5 + [_P],
    "rt_cmp_ring_step_grid": [_P] * 12 + [_I] * 7 + [_P],
    "rt_paged_attention": [_P] * 8 + [_I] * 7 + [_F, _P],
    "rt_flash_attention": [_P] * 5 + [_I] * 9 + [_F, _P],
    "rt_cmp_claim": [_P] * 11 + [_I] * 3 + [_P],
    "rt_mlstm_fwd": [_P] * 17 + [_I] * 5 + [_P],
    "rt_mlstm_bwd": [_P] * 28 + [_I] * 5 + [_P],
    "rt_slstm_fwd": [_P] * 22 + [_I] * 5 + [_P],
    "rt_slstm_bwd": [_P] * 24 + [_I] * 5 + [_P],
    "rt_ssd_fwd": [_P] * 9 + [_I] * 7 + [_P],
    "rt_ssd_bwd": [_P] * 16 + [_I] * 7 + [_P],
    "rt_ssd_decode": [_P] * 8 + [_I] * 6 + [_P],
    "rt_cache_attention": [_P] * 7 + [_I] * 8 + [_F, _P],
    "rt_rms_norm": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    "rt_rope_write": [_P] * 10 + [_I] * 9 + [_P],
    "rt_cmp_ring_max_n": [],
    "rt_paged_attention_max_rep_hd": [],
    "rt_flash_attention_max_hd": [],
    "rt_mlstm_max_d": [],
    "rt_mlstm_block_v": [],
    "rt_mlstm_chunk": [],
    "rt_slstm_max_hd": [],
    "rt_ssd_max_chunk": [],
    "rt_ssd_block_n": [],
    "rt_ssd_block_p": [],
    "rt_cache_attention_max_hd": [],
    "rt_rms_norm_max_d": [],
    "rt_rope_write_max_hd": [],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{out_dir.name}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    objs = [tmp / (p.stem + ".o") for p in cus]
    cmds = [[nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            for src, obj in zip(cus, objs)]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        logs = list(pool.map(_run, cmds))
    logs.append(_run([nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                      *map(str, objs)]))
    (tmp / "build.log").write_text("\n".join(logs))
    try:
        os.replace(tmp, out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.rt_error_string.argtypes = [ctypes.c_int]
        handle.rt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib().rt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the C functions take it."""
    return torch.cuda.current_stream(device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper: raise rather than launch on
    what the kernel does not take."""
    if not cond:
        raise ValueError(msg)


def on_host(t: torch.Tensor) -> bool:
    """A tensor a wrapper hands to its plain version: on the CPU or ``meta``."""
    return t.device.type in ("cpu", "meta")


def records(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def check_args(what: str, dev, tensors: dict, dtype) -> None:
    """A CUDA ``dev``, a ``dtype`` the kernels take, and each of ``tensors``
    (name -> (tensor, shape, dtype)) as given, on ``dev``; else raise."""
    require(dev.type == "cuda", f"{what}: unsupported device {dev}")
    require(dtype in DTYPE_CODES, f"{what}: dtype {dtype} not float32/bfloat16")
    for name, (t, shape, dt) in tensors.items():
        require(t.device == dev and t.dtype == dt and tuple(t.shape) == tuple(shape),
                f"{what}: {name} must be {dt} {tuple(shape)} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def contiguous(*ts):
    return [t.contiguous() for t in ts]


def empty(*shape, like, dtype=torch.float32):
    """An uninitialised tensor on ``like``'s device (float32 by default)."""
    return torch.empty(shape, dtype=dtype, device=like.device)
