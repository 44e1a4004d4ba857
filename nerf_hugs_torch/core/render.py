"""Volumetric rendering math: frustum Gaussians and alpha compositing.

Twin of nerf_hugs_tpu/core/render.py (MipNeRF360/internal/render.py: cone
and cylinder moments :44-100, cast_rays :103-127, alpha weights :130-182,
compositing :185-273).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_hugs_torch.core import stepfun

_EPS = float(np.finfo(np.float32).eps)


def lift_gaussian(d, t_mean, t_var, r_var):
    """Along-ray moments -> a 3-D Gaussian with full covariance for ray
    direction d (which need not be normalized): t_var along d, r_var
    isotropic across it."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True),
                           min=1e-10)
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    cov = (t_var[..., None, None] * d_outer[..., None, :, :]
           + r_var[..., None, None] * null_outer[..., None, :, :])
    return mean, cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
    """Moments of a conical frustum (mip-NeRF Eq. 7), `base_radius` the
    cone's radius at distance 1, in the (mid, half-width) form that does
    not cancel in fp32 (JAX's stable=True)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=_EPS)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = (hw ** 2 / 3
             - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) / denom ** 2)
    r_var = mu ** 2 / 4 + (5 / 12) * hw ** 2 - (4 / 15) * hw ** 4 / denom
    return lift_gaussian(d, t_mean, t_var, r_var * base_radius ** 2)


def cylinder_to_gaussian(d, t0, t1, radius):
    """Moments of a cylinder segment along the ray (exact)."""
    t_mean = (t0 + t1) / 2
    t_var = (t1 - t0) ** 2 / 12
    r_var = radius ** 2 / 4
    return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(tdist, origins, directions, radii, ray_shape):
    """Ray sections [tdist_i, tdist_i+1) as Gaussians with full
    covariances (JAX's diag=False, the only form the model uses): (means
    shifted by the ray origins, covariances)."""
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(
            f"ray_shape must be 'cone' or 'cylinder', got {ray_shape}")
    means, covs = gaussian_fn(directions, t0, t1, radii)
    return means + origins[..., None, :], covs


def compute_alpha_weights(density, tdist, dirs, opaque_background=False,
                          cumulative_from_first=False):
    """Density -> compositing weights via transmittance.

    weights_i = alpha_i * T_i with T the exclusive cumulative transmittance.
    opaque_background makes the last interval infinitely wide so acc == 1.
    cumulative_from_first reproduces the torch reference's delta quirk
    (every interval measured from the first bin)."""
    lo = tdist[..., :1] if cumulative_from_first else tdist[..., :-1]
    delta = (tdist[..., 1:] - lo) * torch.linalg.norm(dirs[..., None, :],
                                                      dim=-1)
    density_delta = density * delta
    if opaque_background:
        density_delta = torch.cat(
            [density_delta[..., :-1],
             torch.full_like(density_delta[..., -1:], float("inf"))], dim=-1)
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]),
         torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    return alpha * trans, alpha, trans


def compute_dual_alpha_weights(density_s, density_t, tdist, dirs,
                               opaque_background=False,
                               cumulative_from_first=False):
    """NeRF-W static + transient compositing: one transmittance from the
    summed density, per-component alphas; returns (weights_static,
    weights_transient, weights_combined). The switches are those of
    compute_alpha_weights."""
    lo = tdist[..., :1] if cumulative_from_first else tdist[..., :-1]
    delta = (tdist[..., 1:] - lo) * torch.linalg.norm(dirs[..., None, :],
                                                      dim=-1)
    dd_s, dd_t = density_s * delta, density_t * delta
    dd_sum = (density_s + density_t) * delta
    if opaque_background:
        inf_tail = lambda x: torch.cat(
            [x[..., :-1], torch.full_like(x[..., -1:], float("inf"))], dim=-1)
        dd_s, dd_t, dd_sum = inf_tail(dd_s), inf_tail(dd_t), inf_tail(dd_sum)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(dd_sum[..., :1]),
         torch.cumsum(dd_sum[..., :-1], dim=-1)], dim=-1))
    w_s = (1.0 - torch.exp(-dd_s)) * trans
    w_t = (1.0 - torch.exp(-dd_t)) * trans
    w = (1.0 - torch.exp(-dd_sum)) * trans
    return w_s, w_t, w


def composite_combined_color(rgbs_static, rgbs_transient, bg_rgbs,
                             weights_static, weights_transient,
                             weights_combined):
    """Static + transient colours over one transmittance, the background
    behind what the combined weights leave; returns (rgb_combined,
    rgb_static_part, rgb_transient_part)."""
    acc = weights_combined.sum(dim=-1)
    bg_w = torch.clamp(1 - acc[..., None], min=0)
    rgb_s = (weights_static[..., None] * rgbs_static).sum(dim=-2)
    rgb_t = (weights_transient[..., None] * rgbs_transient).sum(dim=-2)
    return rgb_s + rgb_t + bg_w * bg_rgbs, rgb_s, rgb_t


def volumetric_rendering(rgbs, weights, tdist, bg_rgbs, t_far,
                         compute_extras):
    """Alpha-composite colors; with compute_extras also the accumulated
    opacity, the log-space mean distance and the 5/50/95 distance
    percentiles."""
    rendering = {}
    acc = weights.sum(dim=-1)
    bg_w = torch.clamp(1 - acc[..., None], min=0)
    rendering["rgb"] = (weights[..., None] * rgbs).sum(dim=-2) + bg_w * bg_rgbs
    if compute_extras:
        rendering["acc"] = acc
        t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
        mean = ((weights * torch.log(t_mids)).sum(dim=-1)
                / torch.clamp(acc, min=_EPS))
        rendering["distance_mean"] = torch.clamp(
            torch.nan_to_num(torch.exp(mean), nan=float("inf")),
            tdist[..., 0], tdist[..., -1])
        # Percentiles need a proper distribution: the leftover background
        # mass sits on a far-plane fencepost so the weights sum to 1.
        t_aug = torch.cat([tdist, t_far], dim=-1)
        w_aug = torch.cat([weights, bg_w], dim=-1)
        ps = [5, 50, 95]
        pct = stepfun.weighted_percentile(t_aug, w_aug, ps)
        for i, p in enumerate(ps):
            name = "median" if p == 50 else f"percentile_{p}"
            rendering[f"distance_{name}"] = pct[..., i]
    return rendering
