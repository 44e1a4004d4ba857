"""Chunked full-image rendering.

Twin of nerf_hugs_tpu/train/render_image.py for one device: the image's
rays go through the model in chunks of config.render_chunk_size without
gradient, on the deterministic path (rng=None) with the embeddings zeroed
as config.enable_render_zero_glo / enable_render_zero_tra say (the JAX
render fn, train/step.py:273-278), and the final level's buffers come back
to the host as [H, W, ...] numpy arrays. `ray_*` keys (Mip-NeRF 360's
visualization bags) are not image buffers: each comes back as a list of
every level's rays, subsampled to config.vis_num_rays by a permutation
seeded with 0. JAX draws it with jax.random.permutation(PRNGKey(0)),
which torch cannot reproduce, so the port keeps other rays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nerf_hugs_torch.utils import structs


@torch.no_grad()
def render_image(model, rays: structs.Rays, train_frac: float, config,
                 device) -> Dict[str, np.ndarray]:
    """rays: [H, W, ...] host arrays -> {name: [H, W, ...] array, ray_*:
    [per-level array]}."""
    height, width = rays.origins.shape[:2]
    num_rays = height * width
    rays = rays.map(lambda r: np.asarray(r).reshape(num_rays, -1))
    host = lambda v: v.float().cpu().numpy()
    chunk = config.render_chunk_size
    chunks = []
    for i0 in range(0, num_rays, chunk):
        chunk_rays = rays.map(lambda r: r[i0:i0 + chunk]).to(device)
        renderings, _ = model(chunk_rays, train_frac, compute_extras=True,
                              rng=None, zero_glo=config.enable_render_zero_glo,
                              zero_tra=config.enable_render_zero_tra)
        out = {k: host(v) for k, v in renderings[-1].items()
               if not k.startswith("ray_")}
        for k in renderings[0]:
            if k.startswith("ray_"):
                out[k] = [host(r[k]) for r in renderings]
        chunks.append(out)
    rendering = {}
    for k, first in chunks[0].items():
        if k.startswith("ray_"):
            rendering[k] = [np.concatenate([c[k][i] for c in chunks])
                            for i in range(len(first))]
        else:
            rendering[k] = np.concatenate([c[k] for c in chunks]).reshape(
                (height, width) + first.shape[1:])
    ray_keys = [k for k in rendering if k.startswith("ray_")]
    if ray_keys:
        n = rendering[ray_keys[0]][0].shape[0]
        idx = torch.randperm(n, generator=torch.Generator().manual_seed(0)
                             )[:config.vis_num_rays].numpy()
        for k in ray_keys:
            rendering[k] = [r[idx] for r in rendering[k]]
    return rendering
