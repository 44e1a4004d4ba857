"""Coordinate-space warps and positional encodings.

Scene contraction and its inverse, Gaussians pushed through the
contraction, metric <-> normalized ray-distance bijections, and the
(integrated) positional encodings. Twin of nerf_hugs_tpu/core/coord.py
(MipNeRF360/internal/coord.py:21-147).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerf_hugs_torch.core import math as nh_math

_EPS = float(np.finfo(np.float32).eps)


def contract(x):
    """Mip-NeRF 360 scene contraction (Eq. 10, arxiv 2111.12077).

    Identity inside the unit ball; points outside map to radius 2 - 1/|x|."""
    x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=_EPS)
    scale = (2.0 * torch.sqrt(x_mag_sq) - 1.0) / x_mag_sq
    return torch.where(x_mag_sq <= 1.0, x, scale * x)


def inv_contract(z):
    """Inverse of contract(); valid for |z| < 2."""
    z_mag_sq = torch.clamp(torch.sum(z ** 2, dim=-1, keepdim=True), min=_EPS)
    return torch.where(z_mag_sq <= 1.0, z,
                       z / (2.0 * torch.sqrt(z_mag_sq) - z_mag_sq))


def _contract_jacobian(x):
    """[..., 3, 3] Jacobian of contract() at x: the identity inside the
    unit ball, s I + x grad(s)^T outside it, with s = (2|x| - 1) / |x|^2
    and grad(s) = 2 (|x|^-4 - |x|^-3) x."""
    x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=_EPS)
    scale = (2.0 * torch.sqrt(x_mag_sq) - 1.0) / x_mag_sq
    slope = 2.0 * (x_mag_sq ** -2 - x_mag_sq ** -1.5)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    jac = (scale[..., None] * eye
           + slope[..., None] * x[..., :, None] * x[..., None, :])
    return torch.where((x_mag_sq <= 1.0)[..., None], eye, jac)


def track_linearize(fn, mean, cov):
    """Push a Gaussian (mean, full cov) through fn, the one warp there is
    (contract), by linearizing at the mean: (fn(mean), J cov J^T) with
    J = dfn/dx at the mean. JAX builds the product with jax.linearize and
    two vmapped JVPs; here J comes in closed form, [..., 3, 3] per
    sample, and autograd differentiates through it (to the mean as well
    as the covariance)."""
    if len(mean.shape) + 1 != len(cov.shape):
        raise ValueError("track_linearize needs a full (non-diagonal) "
                         "covariance")
    if fn is not contract:
        raise ValueError(f"no Jacobian for warp {fn!r}")
    jac = _contract_jacobian(mean)
    return fn(mean), jac @ cov @ jac.transpose(-1, -2)


_INVERSES = {
    "reciprocal": torch.reciprocal,
    "log": torch.exp,
    "exp": torch.log,
    "sqrt": torch.square,
    "square": torch.sqrt,
}


def construct_ray_warps(fn, t_near, t_far):
    """Bijection between metric distance t and normalized s in [0, 1].

    fn is None (linear), 'piecewise' (linear below t=1, 1/x above) or one
    of torch.reciprocal / log / exp / sqrt / square."""
    if fn is None:
        fwd, inv = (lambda x: x), (lambda x: x)
    elif fn == "piecewise":
        fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
        inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
    else:
        fwd, inv = fn, _INVERSES[fn.__name__]
    s_near, s_far = fwd(t_near), fwd(t_far)
    t_to_s = lambda t: (fwd(t) - s_near) / (s_far - s_near)
    s_to_t = lambda s: inv(s * s_far + (1 - s) * s_near)
    return t_to_s, s_to_t


def expected_sin(mean, var):
    """E[sin(x)] for x ~ N(mean, var): damped sine, -> 0 as var grows."""
    return torch.exp(-0.5 * var) * nh_math.safe_sin(mean)


def _scales(min_deg: int, max_deg: int, like: torch.Tensor):
    return 2.0 ** torch.arange(min_deg, max_deg, dtype=like.dtype,
                               device=like.device)


def integrated_pos_enc(mean, var, min_deg, max_deg):
    """IPE: expected sinusoid features of a diagonal Gaussian, frequencies
    2^[min_deg, max_deg), cos as sin(x + pi/2); 2 d (max_deg - min_deg)
    features. The damping exp(-var/2) is computed once and tiled over the
    sin and cos halves, as JAX does (nerf_hugs_tpu/core/coord.py:81-100)."""
    scales = _scales(min_deg, max_deg, mean)
    shape = mean.shape[:-1] + (-1,)
    sm = torch.reshape(mean[..., None, :] * scales[:, None], shape)
    sv = torch.reshape(var[..., None, :] * scales[:, None] ** 2, shape)
    damp = torch.exp(-0.5 * sv)
    return (torch.cat([damp, damp], dim=-1)
            * nh_math.safe_sin(torch.cat([sm, sm + 0.5 * math.pi], dim=-1)))


def lift_and_diagonalize(mean, cov, basis):
    """Project mean/cov onto the basis columns, keeping the diagonal of
    the projected covariance."""
    out_mean = nh_math.matmul_hp(mean, basis)
    out_var = torch.sum(basis * nh_math.matmul_hp(cov, basis), dim=-2)
    return out_mean, out_var


def pos_enc(x, min_deg, max_deg):
    """NeRF positional encoding with frequencies 2^[min_deg, max_deg),
    after the input itself (JAX's append_identity=True, the form every
    caller uses)."""
    scales = _scales(min_deg, max_deg, x)
    shape = x.shape[:-1] + (-1,)
    sx = torch.reshape(x[..., None, :] * scales[:, None], shape)
    feats = torch.sin(torch.cat([sx, sx + 0.5 * math.pi], dim=-1))
    return torch.cat([x, feats], dim=-1)
