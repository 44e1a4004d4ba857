"""ctypes binding for the native threaded ray-batch sampler (libraysampler).

The port's copy of nerf_hugs_tpu/data/native_sampler.py, over its own copy
of the source (nerf_hugs_torch/native/raysampler.cc). Builds on demand with
g++ into nerf_hugs_torch/_build/; data.base falls back to its numpy path
when the toolchain or build is unavailable. The
sampler keeps zero-copy views of the per-image float32 planes and fills
flat batch buffers with a thread pool — replacing the per-step numpy
fancy-indexing of the producer thread (see native/raysampler.cc).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native", "raysampler.cc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libraysampler.so")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH) and
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    # Built under a per-process name and renamed into place, so processes
    # that build at once never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load_library():
    """Build + dlopen the sampler; returns None when unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.rs_create_scene.restype = ctypes.c_void_p
        lib.rs_destroy_scene.argtypes = [ctypes.c_void_p]
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rs_add_image.argtypes = [ctypes.c_void_p, f32p, f32p, f32p, f32p,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32]
        lib.rs_num_images.argtypes = [ctypes.c_void_p]
        lib.rs_num_images.restype = ctypes.c_int32
        lib.rs_sample_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p, i32p, i32p, f32p, f32p, f32p, f32p]
        lib.rs_sample_batch.restype = ctypes.c_int32
        _lib = lib
        return _lib


def _f32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeSampler:
    """Owns a native Scene with zero-copy image views. The numpy arrays
    passed to __init__ MUST stay alive and contiguous for this object's
    lifetime (the Dataset holds them)."""

    def __init__(self, images: List[np.ndarray], masks: List[np.ndarray],
                 nears: List[np.ndarray], fars: List[np.ndarray],
                 embed_idxs, num_threads: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native raysampler unavailable")
        self._lib = lib
        self._scene = lib.rs_create_scene()
        self._keepalive = []
        self.num_threads = num_threads or min(8, os.cpu_count() or 4)
        # For degenerate-patch validation in sample(): the smallest usable
        # image extents across the scene.
        self._min_height = min(int(i.shape[0]) for i in images)
        self._min_width = min(int(i.shape[1]) for i in images)
        for img, mask, near, far, embed in zip(images, masks, nears, fars,
                                               embed_idxs):
            img = np.ascontiguousarray(img, np.float32)
            mask = np.ascontiguousarray(mask, np.float32)
            near = np.ascontiguousarray(near, np.float32)
            far = np.ascontiguousarray(far, np.float32)
            self._keepalive.extend([img, mask, near, far])
            lib.rs_add_image(self._scene, _f32ptr(img), _f32ptr(mask),
                             _f32ptr(near), _f32ptr(far), img.shape[0],
                             img.shape[1], int(embed))

    def __del__(self):
        if getattr(self, "_scene", None) and self._lib is not None:
            self._lib.rs_destroy_scene(self._scene)
            self._scene = None

    def sample(self, seed: int, n_patches: int, patch_size: int,
               patch_dilation: int, image_num_per_batch: int,
               half_image: bool = False):
        """Returns flat arrays (pix_x, pix_y, cam_idx, embed_idx, rgb, mask,
        near, far) of length n_patches * patch_size^2."""
        span = (patch_size - 1) * patch_dilation
        min_w = self._min_width // 2 if half_image else self._min_width
        if span >= min_w or span >= self._min_height:
            raise ValueError(
                f"patch span {span + 1} (patch_size {patch_size} x dilation "
                f"{patch_dilation}) does not fit the smallest image "
                f"({self._min_height}x{min_w}{' half' if half_image else ''})")
        n_rays = n_patches * patch_size * patch_size
        # zeros, not empty: if the native side ever skips a patch, the batch
        # must not contain uninitialized cam/pix indices.
        pix_x = np.zeros(n_rays, np.int32)
        pix_y = np.zeros(n_rays, np.int32)
        cam_idx = np.zeros(n_rays, np.int32)
        embed_idx = np.zeros(n_rays, np.int32)
        rgb = np.zeros((n_rays, 3), np.float32)
        mask = np.zeros(n_rays, np.float32)
        near = np.zeros(n_rays, np.float32)
        far = np.zeros(n_rays, np.float32)
        status = self._lib.rs_sample_batch(
            self._scene, ctypes.c_uint64(seed), n_patches, patch_size,
            patch_dilation, image_num_per_batch, int(half_image),
            self.num_threads, _i32ptr(pix_x), _i32ptr(pix_y),
            _i32ptr(cam_idx), _i32ptr(embed_idx), _f32ptr(rgb),
            _f32ptr(mask), _f32ptr(near), _f32ptr(far))
        if status == -3:
            raise RuntimeError(
                "rs_sample_batch: patch does not fit an image "
                "(degenerate patch span)")
        if status != 0:
            raise RuntimeError(f"rs_sample_batch failed with {status}")
        return pix_x, pix_y, cam_idx, embed_idx, rgb, mask, near, far
