"""Build and load the hand-written CUDA kernels of csrc/ (ctypes binding).

Every csrc/*.cu source is compiled with nvcc at first use into its own
shared library with a plain C interface under nerf_hugs_torch/_build/,
named by a hash of the source and the flags so an edited source rebuilds;
the sources build in parallel, one nvcc each. Loading needs no PyTorch
headers, which keeps a build to seconds. Nothing here runs at import time:
the CPU tests import every module on machines without nvcc. The counters
of utils/trace.py: `kernels.builds`, the nvcc runs, and `kernels.load_s`,
the seconds of the first `load` (builds and dlopen).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types
from typing import Dict, Optional

from nerf_hugs_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_vp, _i64, _i32, _u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_uint32)
# Every entry point of the libraries, with its argument types. Pointers and
# the stream are c_void_p: ctypes would pass a bare int as 32 bits.
SIGNATURES = {
    # (table|pos, pos|grad_out, out|grad_table, n, num_levels, num_dims,
    #  hash_mask, hash_add, levels, stream)
    "hashgrid_fwd": [_vp, _vp, _vp, _i64, _i32, _i32, _u32, _i32, _vp, _vp],
    "hashgrid_bwd": [_vp, _vp, _vp, _i64, _i32, _i32, _u32, _i32, _vp, _vp],
    # (x, host array of weight pointers, host int32 dims, num_layers, n,
    #  out, dtype 0 = float32 / 1 = bfloat16, stream)
    "fused_mlp_fwd": [_vp, _vp, _vp, _i32, _i64, _vp, _i32, _vp],
    # (v0, v1, v2, v3, w, w row stride, out, n, stream)
    "planar_accum": [_vp, _vp, _vp, _vp, _vp, _i64, _vp, _i64, _vp],
    # (mean, var, out, n, d, num_deg, min_deg, dtype 0 = float32 /
    #  1 = bfloat16, stream)
    "ipe_fwd": [_vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp],
    # (mean, var, grad_out, grad_mean, grad_var, n, d, num_deg, min_deg,
    #  grad_out's dtype, stream)
    "ipe_bwd": [_vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32, _i32, _i32, _vp],
}

_lib: Optional[types.SimpleNamespace] = None
_lock = threading.Lock()
# nvcc's ptxas report (registers, shared memory, spills) per source built
# in this process.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels of "
                           "nerf_hugs_torch/csrc build on a machine with the "
                           "CUDA toolkit")
    return path


def sources() -> list:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _lib_path(src: str) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def _build_all() -> list:
    """Start one nvcc per source that has no library yet, all at once, and
    wait for every one; returns the library paths in source order."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths, running = [], []
    for src in sources():
        path = _lib_path(src)
        paths.append(path)
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            trace.count("kernels.builds")
            running.append((src, path, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    errors = []
    for src, path, tmp, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}{err}")
            continue
        build_log[os.path.basename(src)] = out + err
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load() -> types.SimpleNamespace:
    """Build (once per source) and dlopen every kernel library; returns the
    entry points of SIGNATURES as attributes."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once built
        return _lib
    with _lock, trace.timed("kernels.load_s"):
        if _lib is not None:
            return _lib
        fns = {}
        for path in _build_all():
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
        missing = set(SIGNATURES) - set(fns)
        if missing:
            raise RuntimeError(f"no csrc library exports {sorted(missing)}")
        _lib = types.SimpleNamespace(**fns)
        return _lib


_SAME_DEVICE = contextlib.nullcontext()


def on_device(index: int):
    """A context that makes CUDA device `index` the current device for a
    launch: nothing where it already is (the usual case, and the cheap one
    on the host's launch path), torch.cuda.device otherwise. The current
    device is read through PyTorch's raw accessor; the caller holds a CUDA
    tensor, so CUDA is initialised."""
    import torch
    if index == torch._C._cuda_getDevice():
        return _SAME_DEVICE
    return torch.cuda.device(index)


def current_stream(index: int) -> int:
    """The cudaStream_t of CUDA device `index`'s current stream, as an int,
    from PyTorch's raw accessor (no Stream object is made)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launch."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {status}")
