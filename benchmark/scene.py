"""The benchmark's kubric capture, written from the seed: a procedural
sphere world (a diffuse, normal-coloured sphere over white) in the kubric
layout that the program's kubric loader reads. One lens with small radial
and tangential distortion for every frame; the cameras ring the origin at
height 1.2 and radius 2.5 times the world scale, each lifted by a seeded
jitter, and each train frame carries an opaque square of a seeded colour
at a seeded place (a distractor). With static_masks, each train frame also
has HuGS's static mask, as the loader reads it (static_masks/{id}.png at
the image's size, 255 static): 0 on exactly that frame's square.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from benchmark.reference import cameras

LENS = {"radial_distortion": [-0.02, 0.004, 0.0],
        "tangential_distortion": [0.001, -0.0005]}


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _orientation(position):
    """World-to-camera rotation of an OpenCV camera at `position` looking
    at the origin, z up."""
    forward = -position / np.linalg.norm(position)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward])


def sphere_color(origins, dirs, radius: float) -> np.ndarray:
    """[..., 3] colours of rays against the sphere world."""
    d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b = np.sum(origins * d, axis=-1)
    c = np.sum(origins * origins, axis=-1) - radius * radius
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0))
    point = origins + t[..., None] * d
    normal = point / np.maximum(1e-6, np.linalg.norm(point, axis=-1,
                                                     keepdims=True))
    shade = np.clip(normal @ np.array([0.5, 0.7, 0.5]), 0.1, 1.0)[..., None]
    return np.where((disc > 0)[..., None], (0.5 + 0.5 * normal) * shade,
                    1.0).astype(np.float32)


def write_kubric_scene(root: str, seed: int, num_train: int, size: int,
                       factor: int, world_scale: float,
                       static_masks: bool = False) -> str:
    """The capture under `root`: num_train frames of size x size at
    rgb/{factor}x/ (the camera's full resolution is size x factor), no
    test frames; near 0.1, far 2 after the loader's widening. The masks
    take no draw of the seed's: the frames are the same with or without
    them."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    full = size * factor
    _write_json(os.path.join(root, "scene_gt.json"), {
        "center": [0.0, 0.0, 0.0], "scale": 1.0, "near": 0.1,
        "far": 2.0 / cameras.FAR_SCALE})
    names = [f"{i:05d}" for i in range(num_train)]
    _write_json(os.path.join(root, "dataset.json"), {"train_ids": names})
    _write_json(os.path.join(root, "freeze-test", "dataset.json"),
                {"val_ids": []})
    image_dir = os.path.join(root, "rgb", f"{factor}x")
    os.makedirs(image_dir, exist_ok=True)
    mask_dir = os.path.join(root, cameras.MASK_DIR)
    if static_masks:
        os.makedirs(mask_dir, exist_ok=True)
    plane = dx = dy = None
    for i, name in enumerate(names):
        theta = 2 * np.pi * i / num_train
        position = world_scale * np.array(
            [2.5 * np.cos(theta), 2.5 * np.sin(theta),
             1.2 + 0.1 * rng.standard_normal()])
        camera_path = os.path.join(root, "camera-gt", f"{name}.json")
        _write_json(camera_path, {
            "orientation": _orientation(position).tolist(),
            "position": position.tolist(), "focal_length": 0.9 * full,
            "principal_point": [full / 2, full / 2], "skew": 0.0,
            "pixel_aspect_ratio": 1.0, "image_size": [full, full], **LENS})
        pixtocam, c2w, lens = cameras.camera_from_json(camera_path, factor)
        if plane is None:  # one lens and one intrinsic matrix for all
            x, y = np.meshgrid(np.arange(size, dtype=np.float64),
                               np.arange(size, dtype=np.float64),
                               indexing="xy")
            plane = cameras.camera_plane(pixtocam, lens, x, y)
            dx = cameras.camera_plane(pixtocam, lens, x + 1, y)
            dy = cameras.camera_plane(pixtocam, lens, x, y + 1)
        origins, dirs, _, _ = cameras.rays_from_plane(c2w, plane, dx, dy)
        image = sphere_color(origins, dirs, 0.5 * world_scale)
        sz = size // 4
        y0, x0 = rng.integers(0, size - sz, 2)
        image[y0:y0 + sz, x0:x0 + sz] = rng.random(3)
        Image.fromarray(np.round(image * 255).astype(np.uint8)).save(
            os.path.join(image_dir, f"{name}.png"))
        if static_masks:
            mask = np.full((size, size), 255, np.uint8)
            mask[y0:y0 + sz, x0:x0 + sz] = 0
            Image.fromarray(mask).save(os.path.join(mask_dir, f"{name}.png"))
    return root
