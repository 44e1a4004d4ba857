"""Kubric scenes (synthetic scenes with distractors).

Twin of nerf_hugs_tpu/data/kubric.py (the reference's
MipNeRF360/internal/datasets.py:985-1112). Layout:
  scene_gt.json              {center, scale, near, far}
  dataset.json               {train_ids}
  freeze-test/dataset.json   {val_ids}
  rgb/{factor}x/{id}.png                       train images
  freeze-test/static-rgb/{factor}x/{id}.png    test images
  camera-gt/{id}.json, freeze-test/camera-gt/  per-image cameras
  {static_mask_dir_name}/{id}.png              optional HuGS static masks
                                               (freeze-test/... for test)
The shipped far plane is too tight; it is scaled by 1.2 as the reference
does (datasets.py:999). RGBA images keep their alpha for the nerfacto
dialect (the loss composites the target over the model's background) and
are composited over white for mipnerf360. Test images take the embedding
rows after the train images'. With render_path the split's cameras give
way to a render path (base.Dataset._apply_render_path).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_hugs_torch.cameras import camera_utils
from nerf_hugs_torch.data import base
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils import structs


def _camera_from_json(path: str, factor: int):
    """Kubric/nerfies camera json -> (pixtocam, camtoworld, distortion)."""
    with open(path, "r") as f:
        cam = json.load(f)
    focal = cam["focal_length"]
    pp = np.asarray(cam["principal_point"])
    skew = cam["skew"]
    aspect = cam["pixel_aspect_ratio"]
    radial = np.asarray(cam["radial_distortion"])
    tangential = np.asarray(cam["tangential_distortion"])

    sx, sy = focal, focal * aspect
    pixtocam = np.array([
        [1 / sx, -skew / sx, -pp[0] / sx],
        [0, 1 / sy, -pp[1] / sy],
        [0, 0, 1],
    ], dtype=np.float32)
    if factor > 1:
        pixtocam = pixtocam @ np.diag([factor, factor, 1.0])

    distortion = {"k1": radial[0], "k2": radial[1], "k3": radial[2],
                  "p1": tangential[0], "p2": tangential[1]}
    orientation = np.asarray(cam["orientation"])  # world-to-camera rotation
    position = np.asarray(cam["position"])
    camtoworld = np.concatenate([orientation.T, position.reshape(3, 1)],
                                axis=1)
    # OpenCV (right, down, forward) -> NeRF (right, up, back).
    camtoworld = camtoworld @ np.diag([1, -1, -1, 1])
    return pixtocam, camtoworld, distortion


class Kubric(base.Dataset):
    """Kubric scenes: json cameras with lens distortion, 1.2x far plane."""

    def _load_renderings(self, config):
        factor = config.factor if config.factor > 0 else 1
        with open(os.path.join(self.data_dir, "scene_gt.json")) as f:
            scene = json.load(f)
        scene_center = np.array(scene["center"])
        scene_scale = scene["scale"]
        scene_near = scene["near"]
        scene_far = scene["far"] * 1.2

        with open(os.path.join(self.data_dir, "dataset.json")) as f:
            train_names = [str(i) for i in json.load(f)["train_ids"]]
        with open(os.path.join(self.data_dir,
                               "freeze-test/dataset.json")) as f:
            val_names = [str(i) for i in json.load(f)["val_ids"]]

        if self.split == structs.DataSplit.TRAIN:
            image_dir = os.path.join(self.data_dir, f"rgb/{factor}x")
            mask_dir = os.path.join(self.data_dir, config.static_mask_dir_name)
            camera_dir = os.path.join(self.data_dir, "camera-gt")
            names, embed_offset = train_names, 0
        else:
            image_dir = os.path.join(self.data_dir,
                                     f"freeze-test/static-rgb/{factor}x")
            mask_dir = os.path.join(
                self.data_dir, f"freeze-test/{config.static_mask_dir_name}")
            camera_dir = os.path.join(self.data_dir, "freeze-test/camera-gt")
            names, embed_offset = val_names, len(train_names)

        (self.images, self.static_masks, self.nears, self.fars,
         self.distortion_params, self.camtypes) = [], [], [], [], [], []
        heights, widths, c2ws, p2cs = [], [], [], []
        for name in names:
            pixtocam, camtoworld, distortion = _camera_from_json(
                os.path.join(camera_dir, f"{name}.json"), factor)
            camtoworld = camtoworld.copy()
            camtoworld[:3, 3] -= scene_center
            camtoworld[:3, 3] *= scene_scale

            image = nh_io.load_img(os.path.join(image_dir,
                                                f"{name}.png")) / 255.0
            if image.shape[-1] == 4 and config.model_type == "mipnerf360":
                image = (image[..., :3] * image[..., -1:]
                         + (1.0 - image[..., -1:]))
            height, width = image.shape[:2]

            mask_path = os.path.join(mask_dir, f"{name}.png")
            if os.path.exists(mask_path):
                static_mask = base.load_static_mask(mask_path, height, width)
            else:
                static_mask = np.ones((height, width, 1), np.float32)

            self.images.append(image.astype(np.float32))
            self.static_masks.append(static_mask)
            self.nears.append(np.full((height, width, 1), scene_near,
                                      np.float32))
            self.fars.append(np.full((height, width, 1), scene_far,
                                     np.float32))
            self.distortion_params.append(distortion)
            self.camtypes.append(camera_utils.ProjectionType.PERSPECTIVE)
            heights.append(height)
            widths.append(width)
            c2ws.append(camtoworld)
            p2cs.append(pixtocam)

        self.image_names = list(names)
        self.heights = np.array(heights)
        self.widths = np.array(widths)
        self.embed_idxs = embed_offset + np.arange(len(names))
        self.camtoworlds = np.stack(c2ws, axis=0)
        self.pixtocams = np.stack(p2cs, axis=0)
        self._apply_render_path(config)
