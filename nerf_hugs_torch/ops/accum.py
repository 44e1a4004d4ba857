"""Weighted planar accumulation of four paired-corner gathers.

Twin of `_accum_kernel` (tools/bench_fwd_copies.py:94-120), candidate C of
the hash grid's dense-level forward microbenchmark: four [n, 2F] fp32
gather outputs v_c (a row holds F features of one corner, then F of its
pair) and weights w [8, n] give
    o[:, j] = sum_{c < 4} w[c] * v_c[:, j] + w[c + 4] * v_c[:, F + j]
for j < F = 2, accumulated in that order from zero in fp32.

On CUDA tensors `planar_accum` launches the hand-written kernel of
csrc/accum.cu, counted in utils/trace.py's `planar_accum.launches`; on CPU
tensors it is the plain version below.
"""

from __future__ import annotations

import torch

from nerf_hugs_torch.ops import kernels
from nerf_hugs_torch.utils import trace

F = 2  # features per level; a gathered row is 2F = 4 floats (16 bytes)


def planar_accum_plain(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                       v3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, term for term the Pallas kernel: [n, 2F] x4
    and [8, n] -> [n, F]."""
    vs = (v0, v1, v2, v3)
    accs = []
    for j in range(F):
        acc = torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
        for c in range(4):
            acc = acc + w[c] * vs[c][:, j] + w[c + 4] * vs[c][:, F + j]
        accs.append(acc)
    return torch.stack(accs, dim=-1)


def _check_kernel_args(vs, w: torch.Tensor) -> int:
    """Type, shape and layout checks of the kernel's arguments; returns n."""
    n = vs[0].shape[0] if vs[0].dim() == 2 else -1
    for name, t in [(f"v{c}", v) for c, v in enumerate(vs)] + [("w", w)]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for c, v in enumerate(vs):
        if tuple(v.shape) != (n, 2 * F):
            raise ValueError(f"v{c} must be [n, {2 * F}] like v0 (F = {F}), "
                             f"got {tuple(v.shape)}")
        # The kernel reads each row as one float4.
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"v{c} must be contiguous with 16-byte rows")
    if tuple(w.shape) != (8, n) or (n > 1 and w.stride(1) != 1):
        raise ValueError(f"w must be [8, {n}] with unit column stride, got "
                         f"{tuple(w.shape)} strides {w.stride()}")
    return n


def planar_accum(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                 v3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The accumulation: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. `w` may be a column slice of a wider [8, m] tensor."""
    vs = (v0, v1, v2, v3)
    if not any(t.is_cuda for t in vs + (w,)):
        return planar_accum_plain(*vs, w)
    if not all(t.is_cuda and t.device == w.device for t in vs):
        raise ValueError("v0..v3 and w must be CUDA tensors on one device")
    n = _check_kernel_args(vs, w)
    out = torch.empty((n, F), dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    lib = kernels.load()
    with torch.cuda.device(w.device):
        status = lib.planar_accum(
            v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), v3.data_ptr(),
            w.data_ptr(), w.stride(0), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(status, "planar_accum")
    trace.count("planar_accum.launches")
    return out
