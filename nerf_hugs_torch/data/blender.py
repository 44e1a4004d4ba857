"""Blender (NeRF-synthetic) scenes.

Twin of nerf_hugs_tpu/data/blender.py (the reference's
MipNeRF360/internal/datasets.py:552-630). Layout:
  transforms_{train,test}.json   camera_angle_x and per-frame
                                 {file_path, transform_matrix}
  {file_path}.png                RGBA frames
  {static_mask_dir_name}/{file_path}.png   optional HuGS masks
Frames shrink by config.factor with an area filter. The mipnerf360 dialect
composites them over white at load; the nerfacto dialect keeps RGBA, and
its loss composites the target over the model's background. Test frames
take the embedding rows after the train frames'. A render path is refused,
as in JAX.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_hugs_torch.cameras import camera_utils
from nerf_hugs_torch.data import base
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.utils import io as nh_io


class Blender(base.Dataset):

    def _load_renderings(self, config):
        if config.render_path:
            raise ValueError("render_path is not supported for blender data")

        embed_offsets, offset = {}, 0
        for split_name in ["train", "test"]:
            with open(os.path.join(self.data_dir,
                                   f"transforms_{split_name}.json")) as f:
                embed_offsets[split_name] = offset
                offset += len(json.load(f)["frames"])
        with open(os.path.join(
                self.data_dir, f"transforms_{self.split.value}.json")) as f:
            meta = json.load(f)

        self.images, self.static_masks, self.nears, self.fars = [], [], [], []
        heights, widths, c2ws, p2cs = [], [], [], []
        mask_dir = os.path.join(self.data_dir, config.static_mask_dir_name)
        for frame in meta["frames"]:
            image = nh_io.load_img(os.path.join(
                self.data_dir, frame["file_path"] + ".png")) / 255.0
            if config.factor > 1:
                image = nh_image.downsample(image, config.factor)
            if image.shape[-1] == 4 and config.model_type == "mipnerf360":
                rgb, alpha = image[..., :3], image[..., -1:]
                image = rgb * alpha + (1.0 - alpha)
            height, width = image.shape[:2]
            mask_path = os.path.join(mask_dir, f"{frame['file_path']}.png")
            if os.path.exists(mask_path):
                static_mask = base.load_static_mask(mask_path, height, width)
            else:
                static_mask = np.ones((height, width, 1), np.float32)
            focal = 0.5 * width / np.tan(0.5 * float(meta["camera_angle_x"]))
            self.images.append(image.astype(np.float32))
            self.static_masks.append(static_mask)
            self.nears.append(np.full((height, width, 1), self.near,
                                      np.float32))
            self.fars.append(np.full((height, width, 1), self.far,
                                     np.float32))
            heights.append(height)
            widths.append(width)
            c2ws.append(np.array(frame["transform_matrix"],
                                 np.float32)[:3, :4])
            p2cs.append(camera_utils.get_pixtocam(focal, width, height))

        n = len(meta["frames"])
        self.image_names = [os.path.basename(f["file_path"])
                            for f in meta["frames"]]
        self.heights = np.array(heights)
        self.widths = np.array(widths)
        self.embed_idxs = embed_offsets[self.split.value] + np.arange(n)
        self.camtoworlds = np.stack(c2ws, axis=0)
        self.pixtocams = np.stack(p2cs, axis=0)
        self.distortion_params = [None] * n
        self.camtypes = [camera_utils.ProjectionType.PERSPECTIVE] * n
