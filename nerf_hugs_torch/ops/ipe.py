"""Integrated positional encoding of the Mip-NeRF 360 MLPs in one kernel.

`integrated_pos_enc(mean, var, min_deg, max_deg, out_dtype)` is
core/coord.py::integrated_pos_enc followed by a cast to `out_dtype`, the
first thing models/mlp.py::PosEncMLP does with the features. On CPU tensors
it is exactly that composition (the plain version). On CUDA tensors it
launches the hand-written kernel of csrc/ipe.cu, which computes the same
features bit for bit (the eager passes' operations, in their order, in
fp32) and writes them once, in `out_dtype` (float32 or bfloat16); d, the
number of frequencies and the dtype come from the arguments. Where the
mean or the variance requires a gradient, an autograd.Function adds the
gradient kernel, the closed form of `integrated_pos_enc_grad_plain`.

Launches are counted in utils/trace.py's counters `ipe.launches` (forward)
and `ipe_bwd.launches` (gradient).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nerf_hugs_torch.core import coord
from nerf_hugs_torch.core import math as nh_math
from nerf_hugs_torch.ops import kernels
from nerf_hugs_torch.utils import trace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def integrated_pos_enc_plain(mean: torch.Tensor, var: torch.Tensor,
                             min_deg: int, max_deg: int,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """The eager composition the kernel computes: [..., d] -> [..., 2 L d]
    in `out_dtype`, L = max_deg - min_deg."""
    return coord.integrated_pos_enc(mean, var, min_deg, max_deg).to(out_dtype)


def integrated_pos_enc_grad_plain(mean: torch.Tensor, var: torch.Tensor,
                                  grad: torch.Tensor, min_deg: int,
                                  max_deg: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient kernel's closed form, in fp32: with x the argument of a
    feature's sine (mean s, plus pi/2 in the cosine half) and damp =
    exp(-var s^2 / 2),
        d/dmean = sum g damp cos(R(x)) s,  d/dvar = sum g (-s^2 / 2) feature
    over the frequencies and both halves; R is the range reduction, whose
    slope is 1 where x is finite and 0 elsewhere."""
    num_deg = max_deg - min_deg
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=torch.float32,
                                 device=mean.device)[:, None]
    x0 = mean[..., None, :] * scales                              # [..., L, d]
    x1 = x0 + 0.5 * math.pi
    damp = torch.exp(-0.5 * (var[..., None, :] * scales ** 2))
    g = grad.float().reshape(mean.shape[:-1] + (2, num_deg, mean.shape[-1]))
    g0, g1 = g[..., 0, :, :] * damp, g[..., 1, :, :] * damp
    r0, r1 = nh_math._range_reduce(x0), nh_math._range_reduce(x1)
    c0 = torch.where(torch.isfinite(x0), torch.cos(r0), 0.0)
    c1 = torch.where(torch.isfinite(x1), torch.cos(r1), 0.0)
    grad_mean = ((g0 * c0 + g1 * c1) * scales).sum(-2)
    grad_var = ((g0 * torch.sin(r0) + g1 * torch.sin(r1))
                * (scales ** 2 * -0.5)).sum(-2)
    return grad_mean, grad_var


def _check_args(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                max_deg: int) -> Tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks of the kernels' inputs;
    returns (rows, d, number of frequencies)."""
    index = mean.get_device()
    if index < 0 or var.get_device() != index:
        raise ValueError(f"mean and var must be CUDA tensors on one device, "
                         f"got {mean.device} and {var.device}")
    for name, t in (("mean", mean), ("var", var)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mean.shape != var.shape or mean.dim() == 0:
        raise ValueError(f"mean {tuple(mean.shape)} and var "
                         f"{tuple(var.shape)} must be one [..., d] shape")
    num_deg = max_deg - min_deg
    # The kernels build 2^e from its exponent bits: e in [-126, 127].
    if num_deg <= 0 or min_deg < -126 or max_deg > 128:
        raise ValueError(f"degrees [{min_deg}, {max_deg}) are not taken")
    d = mean.shape[-1]
    return mean.numel() // max(d, 1), d, num_deg


def ipe_fwd(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
            max_deg: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The forward kernel, without autograd, on CUDA tensors."""
    n, d, num_deg = _check_args(mean, var, min_deg, max_deg)
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    out = torch.empty(mean.shape[:-1] + (2 * num_deg * d,), dtype=out_dtype,
                      device=mean.device)
    if out.numel() == 0:
        return out
    # The kernel stores 16 bytes at a time from the start of `out`, which
    # the caching allocator starts on 512 bytes.
    lib = kernels.load()
    index = mean.get_device()
    with kernels.on_device(index):
        status = lib.ipe_fwd(mean.data_ptr(), var.data_ptr(), out.data_ptr(),
                             n, d, num_deg, min_deg, _DTYPE_CODES[out_dtype],
                             kernels.current_stream(index))
    kernels.check(status, "ipe_fwd")
    trace.count("ipe.launches")
    return out


def ipe_bwd(mean: torch.Tensor, var: torch.Tensor, grad: torch.Tensor,
            min_deg: int, max_deg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient kernel on CUDA tensors: (d/dmean, d/dvar), fp32."""
    n, d, num_deg = _check_args(mean, var, min_deg, max_deg)
    if grad.dtype not in _DTYPE_CODES or not grad.is_contiguous() \
            or grad.device != mean.device \
            or grad.shape != mean.shape[:-1] + (2 * num_deg * d,):
        raise ValueError(f"grad must be a contiguous float32 or bfloat16 "
                         f"[..., {2 * num_deg * d}] tensor beside mean, got "
                         f"{grad.dtype} {tuple(grad.shape)} on {grad.device}")
    grad_mean, grad_var = torch.empty_like(mean), torch.empty_like(var)
    if mean.numel() == 0:
        return grad_mean, grad_var
    lib = kernels.load()
    index = mean.get_device()
    with kernels.on_device(index):
        status = lib.ipe_bwd(mean.data_ptr(), var.data_ptr(), grad.data_ptr(),
                             grad_mean.data_ptr(), grad_var.data_ptr(), n, d,
                             num_deg, min_deg, _DTYPE_CODES[grad.dtype],
                             kernels.current_stream(index))
    kernels.check(status, "ipe_bwd")
    trace.count("ipe_bwd.launches")
    return grad_mean, grad_var


class _IntegratedPosEnc(torch.autograd.Function):
    """Forward kernel + gradient kernel."""

    @staticmethod
    def forward(ctx, mean, var, min_deg, max_deg, out_dtype):
        ctx.degrees = (min_deg, max_deg)
        ctx.save_for_backward(mean, var)
        return ipe_fwd(mean, var, min_deg, max_deg, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        mean, var = ctx.saved_tensors
        grad_mean, grad_var = ipe_bwd(mean, var, grad.contiguous(),
                                      *ctx.degrees)
        return grad_mean, grad_var, None, None, None


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor, min_deg: int,
                       max_deg: int, out_dtype: torch.dtype) -> torch.Tensor:
    """IPE features of [..., d] lifted means and variances, frequencies
    2^[min_deg, max_deg), as [..., 2 d (max_deg - min_deg)] in `out_dtype`:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if not mean.is_cuda and not var.is_cuda:
        return integrated_pos_enc_plain(mean, var, min_deg, max_deg,
                                        out_dtype)
    if torch.is_grad_enabled() and (mean.requires_grad or var.requires_grad):
        return _IntegratedPosEnc.apply(mean, var, min_deg, max_deg,
                                       out_dtype)
    return ipe_fwd(mean, var, min_deg, max_deg, out_dtype)
