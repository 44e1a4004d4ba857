"""Chunked full-image rendering.

Twin of nerf_hugs_tpu/train/render_image.py for one device: the image's
rays go through the model in chunks of config.render_chunk_size without
gradient, on the deterministic path (rng=None) with the embeddings zeroed
as config.enable_render_zero_glo / enable_render_zero_tra say (the JAX
render fn, train/step.py:273-278), and the final level's buffers come back
to the host as [H, W, ...] numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nerf_hugs_torch.utils import structs


@torch.no_grad()
def render_image(model, rays: structs.Rays, train_frac: float, config,
                 device) -> Dict[str, np.ndarray]:
    """rays: [H, W, ...] host arrays -> {name: [H, W, ...] array}."""
    height, width = rays.origins.shape[:2]
    num_rays = height * width
    rays = rays.map(lambda r: np.asarray(r).reshape(num_rays, -1))
    chunk = config.render_chunk_size
    chunks = []
    for i0 in range(0, num_rays, chunk):
        chunk_rays = rays.map(lambda r: r[i0:i0 + chunk]).to(device)
        renderings, _ = model(chunk_rays, train_frac, compute_extras=True,
                              rng=None, zero_glo=config.enable_render_zero_glo,
                              zero_tra=config.enable_render_zero_tra)
        chunks.append({k: v.float().cpu().numpy()
                       for k, v in renderings[-1].items()})
    return {k: np.concatenate([c[k] for c in chunks]).reshape(
        (height, width) + chunks[0][k].shape[1:]) for k in chunks[0]}
