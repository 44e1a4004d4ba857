"""Scene contraction and metric <-> normalized ray-distance warps.

Twin of nerf_hugs_tpu/core/coord.py:18-73 (MipNeRF360/internal/coord.py).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def contract(x):
    """Mip-NeRF 360 scene contraction (Eq. 10, arxiv 2111.12077).

    Identity inside the unit ball; points outside map to radius 2 - 1/|x|."""
    x_mag_sq = torch.clamp(torch.sum(x ** 2, dim=-1, keepdim=True), min=_EPS)
    scale = (2.0 * torch.sqrt(x_mag_sq) - 1.0) / x_mag_sq
    return torch.where(x_mag_sq <= 1.0, x, scale * x)


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
