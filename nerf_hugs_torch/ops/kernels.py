"""Build and load the hand-written CUDA kernels of csrc/ (ctypes binding).

The sources are compiled with nvcc at first use into a shared library with
a plain C interface under nerf_hugs_torch/_build/, named by a hash of the
source and the flags so an edited source rebuilds. Loading needs no
PyTorch headers, which keeps a build to seconds. Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "hashgrid.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the hash-grid kernels build on "
                           "a machine with the CUDA toolkit")
    return path


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = os.path.join(_BUILD_DIR, f"libhashgrid_{digest[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """Build (once per source) and dlopen the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        lib = ctypes.CDLL(_build())
        vp, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_uint32)
        # (table|pos, pos|grad_out, out|grad_table, n, num_levels, num_dims,
        #  hash_mask, hash_add, levels, stream)
        for fn in (lib.hashgrid_fwd, lib.hashgrid_bwd):
            fn.argtypes = [vp, vp, vp, i64, i32, i32, u32, i32, vp, vp]
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {status}")
