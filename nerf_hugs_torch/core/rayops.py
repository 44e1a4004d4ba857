"""Ray-primitive intersections on the host, in numpy.

A copy of nerf_hugs_tpu/core/rayops.py (jax-free there too; the
reference's nerfacto/utils/ray_utils.py:7-38). The loaders clip each ray's
near and far to the scene's box with it (enable_clip_near_far,
nerfacto/datasets/base.py:111-136).
"""

from __future__ import annotations

import types

import numpy as np


def intersect_aabb(aabb, rays_o, rays_d, xnp: types.ModuleType = np):
    """Ray vs axis-aligned box [2, 3] -> (is_intersect [n,1], near, far)."""
    eps = xnp.finfo(rays_d.dtype if hasattr(rays_d, "dtype")
                    else xnp.float32).eps
    inv_d = 1.0 / xnp.where(xnp.abs(rays_d) >= eps, rays_d, eps)
    t = (aabb[None] - rays_o[:, None, :]) * inv_d[:, None, :]  # [n, 2, 3]
    near = xnp.max(xnp.min(t, axis=1), axis=-1, keepdims=True)
    far = xnp.min(xnp.max(t, axis=1), axis=-1, keepdims=True)
    return near <= far, near, far


def intersect_sphere(center, radius, rays_o, rays_d,
                     xnp: types.ModuleType = np):
    """Ray vs sphere -> (is_intersect [n,1], near, far)."""
    a = xnp.sum(rays_d**2, axis=-1, keepdims=True)
    b = 2 * xnp.sum(rays_d * (rays_o - center), axis=-1, keepdims=True)
    c = xnp.sum((rays_o - center) ** 2, axis=-1, keepdims=True) - radius**2
    disc = b**2 - 4 * a * c
    is_intersect = disc >= 0
    sq = xnp.sqrt(xnp.where(disc >= 0, disc, 0))
    return is_intersect, (-b - sq) / (2 * a), (-b + sq) / (2 * a)


def clip_near_far_to_aabb(origins, directions, near, far, bound: float):
    """Clip per-ray near/far to the [-bound, bound]^3 box, keeping the
    original values for rays that miss (datasets/base.py:111-136)."""
    aabb = np.array([[-bound] * 3, [bound] * 3], np.float32)
    hit, box_near, box_far = intersect_aabb(aabb, origins, directions)
    new_near = np.where(hit, np.maximum(near, box_near), near)
    new_far = np.where(hit, np.minimum(far, np.maximum(box_far, new_near)),
                       far)
    return new_near.astype(np.float32), new_far.astype(np.float32)
