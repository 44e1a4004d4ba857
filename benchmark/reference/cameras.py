"""Plain rays of a kubric capture: its camera files read as the kubric
layout defines them, the OpenCV lens inverted by Newton's method, and a
pixel's ray with the base radius of its cone (Mip-NeRF 360's
camera_utils), in float64 and then float32; beside each ray its image's
index, its pixel's normalised centre and its static mask.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from PIL import Image

# The kubric loader widens the shipped far plane by this factor.
FAR_SCALE = 1.2
# HuGS's static masks of the train frames: MASK_DIR/{id}.png, 1 static.
MASK_DIR = "static_masks"


def camera_from_json(path: str, factor: int):
    """(pixtocam [3, 3], camtoworld [3, 4], lens dict) of one kubric camera
    file at a downsampling factor."""
    with open(path) as f:
        cam = json.load(f)
    focal = cam["focal_length"]
    pp = np.asarray(cam["principal_point"])
    sx, sy = focal, focal * cam["pixel_aspect_ratio"]
    skew = cam["skew"]
    pixtocam = np.array([[1 / sx, -skew / sx, -pp[0] / sx],
                         [0, 1 / sy, -pp[1] / sy],
                         [0, 0, 1]], dtype=np.float32)
    if factor > 1:
        pixtocam = pixtocam @ np.diag([factor, factor, 1.0])
    radial = cam["radial_distortion"]
    tangential = cam["tangential_distortion"]
    lens = {"k1": radial[0], "k2": radial[1], "k3": radial[2],
            "p1": tangential[0], "p2": tangential[1]}
    c2w = np.concatenate([np.asarray(cam["orientation"]).T,
                          np.asarray(cam["position"]).reshape(3, 1)], axis=1)
    # OpenCV (right, down, forward) to (right, up, back).
    return pixtocam, c2w @ np.diag([1, -1, -1, 1]), lens


def undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, p1=0.0, p2=0.0,
              iterations: int = 10):
    """The undistorted camera-plane point of a distorted one: ten Newton
    steps on the radial and tangential model."""
    x, y = np.array(xd), np.array(yd)
    for _ in range(iterations):
        r = x * x + y * y
        d = 1.0 + r * (k1 + r * (k2 + r * k3))
        fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
        fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
        d_r = k1 + r * (2 * k2 + r * 3 * k3)
        d_x, d_y = 2 * x * d_r, 2 * y * d_r
        fx_x = d + d_x * x + 2 * p1 * y + 6 * p2 * x
        fx_y = d_y * x + 2 * p1 * x + 2 * p2 * y
        fy_x = d_x * y + 2 * p2 * y + 2 * p1 * x
        fy_y = d + d_y * y + 2 * p2 * x + 6 * p1 * y
        denom = fy_x * fx_y - fx_x * fy_y
        safe = np.abs(denom) > 1e-9
        x = x + np.where(safe, (fx * fy_y - fy * fx_y) / denom, 0.0)
        y = y + np.where(safe, (fy * fx_x - fx * fy_x) / denom, 0.0)
    return x, y


def camera_plane(pixtocam, lens, x, y):
    """[..., 2] undistorted camera-plane points through the centres of
    pixels (x, y)."""
    pix = np.stack([x + 0.5, y + 0.5, np.ones_like(x, dtype=np.float64)], -1)
    cam = np.matmul(pixtocam, pix[..., None])[..., 0]
    return np.stack(undistort(cam[..., 0], cam[..., 1], **lens), -1)


def rays_from_plane(c2w, plane, plane_dx, plane_dy):
    """(origins, directions, viewdirs, radii) of camera-plane points and
    their +x and +y pixel neighbours' points; c2w [..., 3, 4]."""
    flip = np.diag([1.0, -1.0, -1.0])
    to_world = lambda xy: np.matmul(
        c2w[..., :3, :3],
        (np.concatenate([xy, np.ones_like(xy[..., :1])], -1) @ flip)[..., None]
    )[..., 0]
    d, dx, dy = to_world(plane), to_world(plane_dx), to_world(plane_dy)
    origins = np.broadcast_to(c2w[..., :3, 3], d.shape)
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    radii = 0.5 * (np.linalg.norm(dx - d, axis=-1)
                   + np.linalg.norm(dy - d, axis=-1))[..., None] \
        * 2 / np.sqrt(12)
    return origins, d, viewdirs, radii


def read_png(path: str) -> np.ndarray:
    """[h, w, c] float32 in [0, 1] of an 8-bit PNG."""
    with Image.open(path) as im:
        a = np.asarray(im, np.float32) / 255.0
    return a if a.ndim == 3 else a[..., None]


class KubricScene:
    """The train split of a kubric capture on disk, read plainly. A
    frame's embedding index is its place in dataset.json's train_ids (the
    train split's rows come first); its static mask is MASK_DIR/{id}.png
    at the image's own size, or ones where the capture has none."""

    def __init__(self, root: str, factor: int):
        with open(os.path.join(root, "scene_gt.json")) as f:
            scene = json.load(f)
        with open(os.path.join(root, "dataset.json")) as f:
            names = [str(i) for i in json.load(f)["train_ids"]]
        center = np.asarray(scene["center"], np.float64)
        self.near = float(scene["near"])
        self.far = float(scene["far"]) * FAR_SCALE
        self.embed_idxs = np.arange(len(names), dtype=np.int32)
        self.pixtocams, self.c2ws, self.lenses = [], [], []
        self.images, self.masks = [], []
        for name in names:
            p2c, c2w, lens = camera_from_json(
                os.path.join(root, "camera-gt", f"{name}.json"), factor)
            c2w = c2w.copy()
            c2w[:3, 3] = (c2w[:3, 3] - center) * scene["scale"]
            self.pixtocams.append(p2c)
            self.c2ws.append(c2w)
            self.lenses.append(lens)
            image = read_png(os.path.join(root, "rgb", f"{factor}x",
                                          f"{name}.png"))[..., :3]
            self.images.append(image)
            mask_path = os.path.join(root, MASK_DIR, f"{name}.png")
            if os.path.exists(mask_path):
                mask = read_png(mask_path)[..., :1]
                if mask.shape[:2] != image.shape[:2]:
                    raise ValueError(f"{mask_path} is {mask.shape[:2]}, its "
                                     f"image {image.shape[:2]}")
            else:
                mask = np.ones(image.shape[:2] + (1,), np.float32)
            self.masks.append(mask)

    def rays(self, cam_idx: np.ndarray, x: np.ndarray, y: np.ndarray,
             device) -> dict:
        """The rays, pixel fields and target colours of pixels (x, y) of
        cameras cam_idx, as tensors on `device`: float32, and embed_idx
        [n, 1] int32. pix_coords are the pixel centres over the image's
        size, from float32 centres divided in float64 (the loader's
        dtypes), then float32."""
        out = {k: [] for k in ("origins", "directions", "viewdirs", "radii",
                               "rgb", "pix_coords", "static_mask")}
        centre = lambda a: (a.astype(np.float32) + np.float32(0.5)
                            ).astype(np.float64)
        order = np.argsort(cam_idx, kind="stable")
        for c in np.unique(cam_idx):
            sel = cam_idx == c
            xs, ys = x[sel].astype(np.float64), y[sel].astype(np.float64)
            p2c, lens = self.pixtocams[c], self.lenses[c]
            o, d, v, r = rays_from_plane(
                self.c2ws[c], camera_plane(p2c, lens, xs, ys),
                camera_plane(p2c, lens, xs + 1, ys),
                camera_plane(p2c, lens, xs, ys + 1))
            h, w = self.images[c].shape[:2]
            pix = np.stack([centre(x[sel]) / w, centre(y[sel]) / h], -1)
            for k, a in zip(out, (o, d, v, r, self.images[c][y[sel], x[sel]],
                                  pix, self.masks[c][y[sel], x[sel]])):
                out[k].append(a)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        rays = {k: torch.tensor(np.concatenate(v)[inverse], dtype=torch.float32,
                                device=device) for k, v in out.items()}
        n = len(cam_idx)
        rays["near"] = torch.full((n, 1), self.near, device=device)
        rays["far"] = torch.full((n, 1), self.far, device=device)
        rays["embed_idx"] = torch.tensor(self.embed_idxs[cam_idx][:, None],
                                         device=device)
        return rays
