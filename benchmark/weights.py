"""Initial parameters drawn from the seed on the device, in one call: a
uniform draw in [-1, 1) over every leaf at once, each leaf's slice scaled
to the half-width its reference gives (0: zeros)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def draw(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for [(name, shape, half-width)] specs."""
    sizes = [math.prod(shape) if limit > 0 else 0
             for _, shape, limit in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2).sub_(1)
    out, offset = {}, 0
    for (name, shape, limit), n in zip(specs, sizes):
        if limit > 0:
            out[name] = flat[offset:offset + n].mul_(limit).view(shape)
        else:
            out[name] = torch.zeros(shape, device=device)
        offset += n
    return out
