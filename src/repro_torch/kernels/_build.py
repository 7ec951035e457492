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

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (all return int, a cudaError_t).
SIGNATURES = {
    "rt_cmp_ring_step": [_P] * 7 + [_I] * 5 + [_P],
    "rt_paged_attention": [_P] * 6 + [_I] * 7 + [_P],
    "rt_flash_attention": [_P] * 5 + [_I] * 9 + [_P],
    "rt_cmp_claim_tiles": [_P] * 5 + [_I] * 3 + [_P],
    "rt_cmp_claim_merge": [_P] * 3 + [_I] * 4 + [_P],
    "rt_cmp_ring_max_n": [],
    "rt_paged_attention_max_rep_hd": [],
    "rt_flash_attention_max_hd": [],
    "rt_cmp_claim_max_block": [],
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
