"""Visualization suite for renders: depth colormaps, ray strips, mattes.

Twin of nerf_hugs_tpu/utils/vis.py (MipNeRF360/internal/vis.py:22-267) in
torch, on the device of the tensors it is given. The colormaps are looked
up as matplotlib's Colormap.__call__ does for floats, without matplotlib:
entry floor(x * 256) of 256, x == 1 taking the last, values below 0 the
first and above 1 the last, NaN matplotlib's "bad" colour (0, 0, 0); turbo
is utils/turbo.py's table, gray entry i is i / 255.
visualize_rays keeps the arguments visualize_suite passes: JAX's
`accumulate` and `renormalize` options have no caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerf_hugs_torch.core import math as nh_math
from nerf_hugs_torch.core import stepfun
from nerf_hugs_torch.utils.turbo import TURBO

_EPS = float(np.finfo(np.float32).eps)
_GRAY = np.repeat(np.arange(256)[:, None] / 255, 3, axis=1)


def weighted_percentile(x, w, ps):
    """Weighted percentiles `ps` (in [0, 100]) of one flattened vector: the
    sorted values at the weights' cumulative sum (not stepfun's
    step-function percentile)."""
    x, w = x.reshape(-1), w.reshape(-1)
    order = torch.argsort(x, stable=True)
    # The depth triplet has three values a pixel and one weight: JAX's
    # gather clamps the indices past the weights to the last one.
    x, w = x[order], w[torch.clamp(order, max=w.numel() - 1)]
    acc_w = stepfun.cumsum_blocked(w)
    q = torch.tensor(ps, dtype=acc_w.dtype, device=acc_w.device)
    return nh_math.interp(q * (acc_w[-1] / 100), acc_w, x)


def sinebow(h):
    """Cyclic uniform colormap (basecase.org/env/on-rainbows)."""
    f = lambda x: torch.sin(math.pi * x) ** 2
    return torch.stack([f(3 / 6 - h), f(5 / 6 - h), f(7 / 6 - h)], -1)


def _lookup(table: np.ndarray, value):
    """RGB of float `value` in a 256-entry colormap table."""
    lut = torch.cat([torch.as_tensor(table, dtype=torch.float32),
                     torch.zeros(1, 3)]).to(value.device)
    xa = value.float() * 256
    xa = torch.where(xa == 256, 255.0, xa)
    idx = torch.nan_to_num(xa, nan=0.0).clamp(-1, 256).to(torch.int64)
    idx = torch.where(xa < 0, 0, torch.where(xa >= 256, 255, idx))
    return lut[torch.where(torch.isnan(xa), 256, idx)]


def turbo(value):
    return _lookup(TURBO, value)


def gray(value):
    return _lookup(_GRAY, value)


def matte(vis, acc, dark=0.8, light=1.0, width=8):
    """Composite over a checkerboard where accumulation is low."""
    check = lambda n: (torch.arange(n, device=acc.device)
                       % (2 * width) // width).bool()
    bg_mask = torch.logical_xor(check(acc.shape[0])[:, None],
                                check(acc.shape[1])[None, :])
    bg = torch.where(bg_mask, light, dark)
    return vis * acc[:, :, None] + (bg * (1 - acc))[:, :, None]


def visualize_cmap(value, weight, colormap, lo=None, hi=None,
                   percentile=99.0, curve_fn=lambda x: x, modulus=None,
                   matte_background=True):
    """Colormap a scalar map normalized by weighted percentiles; with
    `colormap` None, `value` is already [h, w, 3]."""
    lo_auto, hi_auto = weighted_percentile(
        value, weight, [50 - percentile / 2, 50 + percentile / 2])
    as_t = lambda v: torch.as_tensor(v, dtype=value.dtype,
                                     device=value.device)
    lo = as_t(lo) if lo is not None else (lo_auto - _EPS)
    hi = as_t(hi) if hi is not None else (hi_auto + _EPS)
    value, lo, hi = [curve_fn(x) for x in [value, lo, hi]]
    if modulus:
        value = torch.remainder(value, modulus) / modulus
    else:
        value = torch.nan_to_num(torch.clamp(
            (value - torch.minimum(lo, hi)) / torch.abs(hi - lo), 0, 1))
    if colormap:
        colorized = colormap(value)
    else:
        if value.ndim != 3 or value.shape[-1] != 3:
            raise ValueError(f"value must be [h, w, 3], got "
                             f"{tuple(value.shape)}")
        colorized = value
    return matte(colorized, weight) if matte_background else colorized


def visualize_coord_mod(coords, acc):
    """Position of each termination point within its unit cell."""
    return matte(torch.remainder(coords + 1, 2) / 2, acc)


def visualize_rays(dist, dist_range, weights, rgbs, resolution=2048,
                   bg_color=0.8):
    """Strip chart of per-level ray histograms (vis.py:115-168): each of
    the R rays is a band of its levels' strips, each repeated to fill about
    `resolution` rows, with an empty row between rays. dist, weights and
    rgbs hold one [R, n+1], [R, n] and [R, n, C] tensor per level."""
    dist_vis = torch.linspace(*dist_range, resolution + 1,
                              device=dist[0].device)
    vis_rgb, vis_alpha = [], []
    for d, w, r in zip(dist, weights, rgbs):
        vis_rgb.append(stepfun.resample(dist_vis, d[:, None], r.transpose(
            -1, -2), use_avg=True).transpose(-1, -2))
        vis_alpha.append(stepfun.resample(dist_vis, d, w, use_avg=True))
    vis_rgb = torch.stack(vis_rgb, dim=1)         # [R, levels, res, C]
    vis_alpha = torch.stack(vis_alpha, dim=1)     # [R, levels, res]

    if resolution > vis_rgb.shape[0]:
        rays, levels = vis_rgb.shape[:2]
        rep = resolution // (rays * levels + 1)
        stride = rep * levels
        vis_rgb = vis_rgb.repeat(1, 1, rep, 1).reshape(
            (-1, stride) + vis_rgb.shape[2:])
        vis_alpha = vis_alpha.repeat(1, 1, rep).reshape(
            (-1, stride) + vis_alpha.shape[2:])
        vis_rgb = torch.cat([vis_rgb, torch.zeros_like(vis_rgb[:, :1])],
                            dim=1).reshape((-1,) + vis_rgb.shape[2:])
        vis_alpha = torch.cat([vis_alpha, torch.zeros_like(vis_alpha[:, :1])],
                              dim=1).reshape((-1,) + vis_alpha.shape[2:])

    vis = (vis_rgb * vis_alpha[..., None]
           + (bg_color * (1 - vis_alpha))[..., None])
    return vis[:-1], vis_alpha[:-1]


def visualize_suite(rendering, rays):
    """The standard channels (vis.py:170-267): colour, acc, depths, coords,
    the ray strips when `rendering` holds the ray bags (`ray_sdist`,
    `ray_weights`, `ray_rgbs`: lists over levels), and the transient
    layers when present."""
    depth_curve_fn = lambda x: -torch.log(x + _EPS)
    rgb, acc = rendering["rgb"], rendering["acc"]
    distance_mean = rendering["distance_mean"]
    distance_median = rendering["distance_median"]
    distance_p5 = rendering["distance_percentile_5"]
    distance_p95 = rendering["distance_percentile_95"]
    acc = torch.where(torch.isnan(distance_mean), torch.zeros_like(acc), acc)

    coords = rays.origins + rays.directions * distance_mean[:, :, None]
    vis_depth_mean, vis_depth_median = [
        visualize_cmap(x, acc, turbo, curve_fn=depth_curve_fn)
        for x in [distance_mean, distance_median]]
    vis_depth_triplet = visualize_cmap(
        torch.stack([2 * distance_median - distance_p5, distance_median,
                     distance_p95], dim=-1),
        acc, None, curve_fn=lambda x: torch.log(x + _EPS))

    vis = {
        "color": rgb,
        "acc": acc,
        "color_matte": matte(rgb, acc),
        "depth_mean": vis_depth_mean,
        "depth_median": vis_depth_median,
        "depth_triplet": vis_depth_triplet,
        "coords_mod": visualize_coord_mod(coords, acc),
    }

    if "ray_sdist" in rendering:
        dist = rendering["ray_sdist"]
        weights = rendering["ray_weights"]
        rgbs = [torch.clamp(r, 0, 1) for r in rendering["ray_rgbs"]]
        vis["ray_colors"] = visualize_rays(dist, (0, 1), weights, rgbs)[0]
        sqrt_weights = [torch.sqrt(w) for w in weights]
        sqrt_ray_weights, ray_alpha = visualize_rays(
            dist, (0, 1), [torch.ones_like(w) for w in sqrt_weights],
            [w[..., None] for w in sqrt_weights], bg_color=0)
        sqrt_ray_weights = sqrt_ray_weights[..., 0]
        null_color = torch.tensor([1.0, 0.0, 0.0], device=rgb.device)
        vis["ray_weights"] = torch.where(
            ray_alpha[:, :, None] == 0, null_color[None, None],
            visualize_cmap(sqrt_ray_weights, torch.ones_like(sqrt_ray_weights),
                           gray, lo=0, hi=1, matte_background=False))

    for key, out_key in [("rgb_cc", "color_corrected"),
                         ("rgb_combined", "color_combined"),
                         ("rgb_static", "color_static"),
                         ("rgb_transient", "color_transient"),
                         ("implicit_mask", "implicit_mask")]:
        if key in rendering:
            vis[out_key] = rendering[key]
    return vis
