"""Alpha compositing of densities and colors along rays.

Twin of nerf_hugs_tpu/core/render.py:85-173 (MipNeRF360/internal/
render.py:130-244).
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_hugs_torch.core import stepfun

_EPS = float(np.finfo(np.float32).eps)


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
