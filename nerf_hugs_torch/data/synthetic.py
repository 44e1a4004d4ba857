"""In-memory procedural dataset: lookat cameras around a shaded sphere.

Twin of nerf_hugs_tpu/data/synthetic.py (`Synthetic`,
`SyntheticDistractor`, `SyntheticAppearance`): the same images, cameras,
held-out test views, distractor squares and per-image tints, generated
from fixed seeds with no disk access, so a NeRF can fit them at any
configured resolution. With render_path the split's cameras give way to
a render path (base.Dataset._apply_render_path).
"""

from __future__ import annotations

import numpy as np

from nerf_hugs_torch.cameras import camera_utils
from nerf_hugs_torch.data import base
from nerf_hugs_torch.utils import structs


def _sphere_world_color(origins: np.ndarray, dirs: np.ndarray,
                        radius: float = 0.5) -> np.ndarray:
    """Analytic render of a diffuse normal-colored sphere over white."""
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b = np.sum(origins * d, axis=-1)
    c = np.sum(origins * origins, axis=-1) - radius * radius
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    point = origins + t[..., None] * d
    normal = point / np.maximum(1e-6, np.linalg.norm(point, axis=-1,
                                                     keepdims=True))
    albedo = 0.5 + 0.5 * normal
    shade = np.clip(normal @ np.array([0.5, 0.7, 0.5]), 0.1, 1.0)[..., None]
    return np.where(hit[..., None], albedo * shade, 1.0).astype(np.float32)


class Synthetic(base.Dataset):
    """config.synthetic_{num_images,height,width} images (divided by
    config.factor), cameras on a ring at height 1.2 looking at the origin;
    test views sit between the train azimuths. With DISTRACTORS (the
    `synthetic_distractor` loader) every train image gets a random opaque
    square, a view-inconsistent transient, marked 0 in its static mask."""

    DISTRACTORS = False

    def _load_renderings(self, config):
        n = config.synthetic_num_images
        h, w = config.synthetic_height, config.synthetic_width
        if config.factor > 1:
            h, w = h // config.factor, w // config.factor
        rng = np.random.RandomState(42)
        scale = config.synthetic_world_scale
        held_out = self.split == structs.DataSplit.TEST
        theta_offset = np.pi / n if held_out else 0.0

        self.images, self.static_masks, self.nears, self.fars = [], [], [], []
        c2ws, p2cs = [], []
        for i in range(n):
            theta = 2 * np.pi * i / n + theta_offset
            z_jitter = 0.0 if held_out else 0.1 * rng.randn()
            position = scale * np.array([2.5 * np.cos(theta),
                                         2.5 * np.sin(theta),
                                         1.2 + z_jitter])
            c2w = camera_utils.viewmatrix(camera_utils.normalize(position),
                                          np.array([0.0, 0, 1]), position)
            pixtocam = camera_utils.get_pixtocam(0.9 * w, w, h)
            xg, yg = camera_utils.pixel_coordinates(w, h)
            origins, dirs, _, _ = camera_utils.pixels_to_rays(
                xg, yg, pixtocam, c2w)
            image = _sphere_world_color(origins, dirs, radius=0.5 * scale)
            static_mask = np.ones((h, w, 1), np.float32)
            if self.DISTRACTORS and not held_out:
                sz = max(3, h // 4)
                y0 = rng.randint(0, h - sz)
                x0 = rng.randint(0, w - sz)
                image[y0:y0 + sz, x0:x0 + sz] = rng.rand(3)
                static_mask[y0:y0 + sz, x0:x0 + sz] = 0.0
            self.images.append(image)
            self.static_masks.append(static_mask)
            self.nears.append(np.full((h, w, 1), self.near, np.float32))
            self.fars.append(np.full((h, w, 1), self.far, np.float32))
            c2ws.append(c2w)
            p2cs.append(pixtocam)
        self.heights = np.full(n, h)
        self.widths = np.full(n, w)
        self.embed_idxs = np.arange(n)
        self.camtoworlds = np.stack(c2ws, axis=0)
        self.pixtocams = np.stack(p2cs, axis=0)
        self.distortion_params = [None] * n
        self.camtypes = [camera_utils.ProjectionType.PERSPECTIVE] * n
        self._apply_render_path(config)


class SyntheticDistractor(Synthetic):
    """The synthetic scene with a transient square in every train image."""
    DISTRACTORS = True


class SyntheticAppearance(Synthetic):
    """The synthetic scene with one multiplicative colour tint per image
    (the per-photo appearance that appearance embeddings model), and a
    distinct embedding row for every image: train images take rows
    [0, n), test images [n, 2n), so the test appearances are learnt only
    by the finetune stage."""

    def _load_renderings(self, config):
        super()._load_renderings(config)
        if self.images is None:
            # A render path: no images to tint, and index 0 throughout.
            return
        n = len(self.images)
        offset = n if self.split == structs.DataSplit.TEST else 0
        self.embed_idxs = self.embed_idxs + offset
        tint_rng = np.random.RandomState(7)
        tints = 0.25 + 0.75 * tint_rng.rand(2 * n, 3).astype(np.float32)
        self.images = [img * tints[offset + i]
                       for i, img in enumerate(self.images)]
