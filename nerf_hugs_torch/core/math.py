"""Elementwise math and interpolation on tensors.

Twin of nerf_hugs_tpu/core/math.py (reference: MipNeRF360/internal/
math.py). The TPU version interpolates with a dense broadcast compare to
avoid gathers; on the GPU a binary search (`torch.searchsorted`) plus a
gather gives the same brackets without the [..., m, n] intermediate.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# Trig arguments are range-reduced into this window first
# (nerf_hugs_tpu/core/math.py:18): the features are periodic anyway.
_TRIG_PERIOD_CAP = 100.0 * math.pi


def matmul_hp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's precision=HIGHEST matmul: a plain fp32 matmul,
    TF32 being pinned off (utils/device.py)."""
    return torch.matmul(a, b)


def _range_reduce(x: torch.Tensor) -> torch.Tensor:
    """x where |x| < cap, else x mod cap (the sign of the divisor, as
    jnp's `%`), 0 where that overflows to a non-finite value."""
    reduced = torch.fmod(x, _TRIG_PERIOD_CAP)
    reduced = torch.where(reduced < 0, reduced + _TRIG_PERIOD_CAP, reduced)
    reduced = torch.where(torch.isfinite(reduced), reduced,
                          torch.zeros_like(reduced))
    return torch.where(torch.abs(x) < _TRIG_PERIOD_CAP, x, reduced)


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) with the argument range-reduced."""
    return torch.sin(_range_reduce(x))


def safe_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) with the argument range-reduced."""
    return torch.cos(_range_reduce(x))


class _SafeExp(torch.autograd.Function):
    """exp(min(x, 88)) with the unclamped slope exp(min(x, 88)) * dx."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, max=88.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return y * dy


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) clamped to stay finite in fp32, keeping a finite gradient."""
    return _SafeExp.apply(x)


def log_lerp(t, v0: float, v1: float):
    """Log-linear interpolation from v0 (t=0) to v1 (t=1); t clipped to [0,1]."""
    if v0 <= 0 or v1 <= 0:
        raise ValueError(f"log_lerp endpoints must be positive, got {v0}, {v1}")
    lv0, lv1 = math.log(v0), math.log(v1)
    return math.exp(min(max(t, 0.0), 1.0) * (lv1 - lv0) + lv0)


def learning_rate_decay(step, lr_init, lr_final, max_steps,
                        lr_delay_steps=0, lr_delay_mult=1.0) -> float:
    """Exponential decay from lr_init to lr_final with optional sine warmup
    (host-side float; MipNeRF360/internal/math.py:57-98)."""
    if lr_delay_steps > 0:
        ease = math.sin(0.5 * math.pi * min(max(step / lr_delay_steps, 0.0),
                                            1.0))
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * ease
    else:
        delay = 1.0
    return delay * log_lerp(step / max_steps, lr_init, lr_final)


def _bracket(xp: torch.Tensor, x: torch.Tensor):
    """(count of xp <= x) along the last axis, for sorted xp."""
    return torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)


def sorted_interp(x, xp, fp):
    """Piecewise-linear interp of sorted x into ascending (xp, fp).

    Same brackets as the TPU broadcast-compare form: lo = index of the last
    xp <= x (clamped to 0), hi = the next one (clamped to n-1)."""
    n = xp.shape[-1]
    count = _bracket(xp, x)
    lo = torch.clamp(count - 1, min=0)
    hi = torch.clamp(count, max=n - 1)
    xp_lo, xp_hi = torch.gather(xp, -1, lo), torch.gather(xp, -1, hi)
    fp_lo, fp_hi = torch.gather(fp, -1, lo), torch.gather(fp, -1, hi)
    frac = torch.clamp(torch.nan_to_num((x - xp_lo) / (xp_hi - xp_lo),
                                        nan=0.0), 0.0, 1.0)
    return fp_lo + frac * (fp_hi - fp_lo)


def interp(x, xp, fp, fused: bool = False):
    """`jnp.interp` batched over leading dims: constant extrapolation,
    zero-width intervals take the left value. With `fused`, fp0 + q * df
    rounds once, as the fused multiply-add XLA emits on the CPU."""
    n = xp.shape[-1]
    i = torch.clamp(_bracket(xp, x), 1, n - 1)
    xp0, xp1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fp0, fp1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = xp1 - xp0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    q = (x - xp0) / torch.where(dx0, 1.0, dx)
    if fused:
        # The float32 product is exact in float64: one rounding at the end.
        f = (fp0.double() + q.double() * (fp1 - fp0).double()).to(fp.dtype)
    else:
        f = fp0 + q * (fp1 - fp0)
    f = torch.where(dx0, fp0, f)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)
