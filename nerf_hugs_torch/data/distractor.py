"""RobustNeRF "distractor" scenes (COLMAP captures with distractors).

Twin of nerf_hugs_tpu/data/distractor.py (the reference's
MipNeRF360/internal/datasets.py:1264-1399). Layout:
  0/sparse/0/          COLMAP model
  0/images[_factor]/   images, already downscaled by the factor
  0/data_split.json    {train: [...], test: [...]}
  0/static_masks/      optional HuGS masks
Poses are PCA-aligned, centred on the SfM points and scaled into the unit
cube; the per-image near is the 0.1-percentile depth of the points in the
camera's frustum x 0.8 (the reference's margin), the far is the config's.
Embedding indices follow train + test order, so the test split's come
after the train split's. With render_path the split's cameras give way to
a render path (base.Dataset._apply_render_path).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_hugs_torch.cameras import camera_utils, scene_manager
from nerf_hugs_torch.data import base
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils import structs


class Distractor(base.Dataset):

    def _load_renderings(self, config):
        factor = config.factor if config.factor > 0 else 1
        image_dir_suffix = f"_{config.factor}" if config.factor > 0 else ""

        colmap_dir = os.path.join(self.data_dir, "0/sparse/0")
        (image_names, poses, pixtocams, distortion_params, camtypes,
         pts3d) = scene_manager.load_colmap_scene(colmap_dir)

        with open(os.path.join(self.data_dir, "0/data_split.json")) as f:
            split_data = json.load(f)
        train_names, test_names = split_data["train"], split_data["test"]
        all_names = train_names + test_names
        selected = (train_names if self.split == structs.DataSplit.TRAIN
                    else test_names)

        lut = {n: i for i, n in enumerate(image_names)}
        order = [lut[n] for n in all_names]
        poses = poses[order]
        pixtocams = pixtocams[order]
        distortion_params = [distortion_params[i] for i in order]
        camtypes = [camtypes[i] for i in order]
        image_names = all_names

        pixtocams = (pixtocams @ np.diag([factor, factor, 1.0])).astype(
            np.float32)
        focals = 1.0 / pixtocams[:, 0, 0]

        poses, transform = camera_utils.transform_poses_pca(poses)
        pts3d = np.concatenate([pts3d, np.ones_like(pts3d[..., :1])], -1)
        pts3d = pts3d @ transform.T
        center_transform = np.eye(4)
        center_transform[:3, 3] = -pts3d[:, :3].mean(0)
        poses = camera_utils.unpad_poses(
            center_transform @ camera_utils.pad_poses(poses))
        pts3d = pts3d @ center_transform.T
        transform = center_transform @ transform
        scale_factor = 1.0 / np.max(np.abs(poses[:, :3, 3]))
        poses[:, :3, 3] *= scale_factor
        pts3d[:, :3] *= scale_factor
        self.colmap_to_world_transform = (
            np.diag([scale_factor] * 3 + [1]) @ transform)
        self.poses = poses
        self.pts3d = pts3d

        (self.images, self.static_masks, self.nears, self.fars,
         self.distortion_params, self.camtypes) = [], [], [], [], [], []
        heights, widths, focals_out, embeds, c2ws, p2cs = \
            [], [], [], [], [], []

        image_dir = os.path.join(self.data_dir,
                                 f"0/images{image_dir_suffix}")
        mask_dir = os.path.join(self.data_dir,
                                f"0/{config.static_mask_dir_name}")
        name_to_idx = {n: i for i, n in enumerate(image_names)}
        eps = np.finfo(np.float64).eps
        for image_name in selected:
            image_idx = name_to_idx[image_name]
            image = nh_io.load_img(
                os.path.join(image_dir, image_name))[..., :3] / 255.0
            height, width = image.shape[:2]
            mask_path = os.path.join(
                mask_dir, f"{image_name.split('.')[0]}.png")
            if os.path.exists(mask_path):
                static_mask = base.load_static_mask(mask_path, height, width)
            else:
                static_mask = np.ones((height, width, 1), np.float32)

            # Near plane from the 0.1-percentile depth of in-frustum points,
            # scaled by 0.8 (datasets.py:1363-1379).
            pose = camera_utils.pad_poses(
                poses[image_idx]) @ np.diag([1, -1, -1, 1])
            w2c = np.linalg.inv(pose)
            pts_cam = (pts3d @ w2c.T)[:, :3]
            pts_cam = pts_cam[pts_cam[:, 2] >= 0]
            pts_uv = (pts_cam @ np.linalg.inv(pixtocams[image_idx]).T
                      ) / np.maximum(pts_cam[:, 2:], eps)
            in_cone = ((pts_uv[:, 0] <= width) & (pts_uv[:, 0] >= 0) &
                       (pts_uv[:, 1] <= height) & (pts_uv[:, 1] >= 0))
            pts_cam = pts_cam[in_cone]
            near = np.percentile(pts_cam[:, 2], 0.1) * 0.8
            far = self.far

            self.images.append(image.reshape(height, width, 3).astype(
                np.float32))
            self.static_masks.append(static_mask)
            self.nears.append(np.full((height, width, 1), near, np.float32))
            self.fars.append(np.full((height, width, 1), far, np.float32))
            self.distortion_params.append(distortion_params[image_idx])
            self.camtypes.append(camtypes[image_idx])
            heights.append(height)
            widths.append(width)
            focals_out.append(focals[image_idx])
            embeds.append(image_idx)
            c2ws.append(poses[image_idx])
            p2cs.append(pixtocams[image_idx])

        self.image_names = [n.split(".")[0] for n in selected]
        self.heights = np.array(heights)
        self.widths = np.array(widths)
        self.focals = np.array(focals_out)
        self.embed_idxs = np.array(embeds)
        self.camtoworlds = np.stack(c2ws, axis=0)
        self.pixtocams = np.stack(p2cs, axis=0)
        self._apply_render_path(config)
