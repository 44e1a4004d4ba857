"""Phototourism (IMC-PT) scenes: internet photo collections with COLMAP.

Twin of nerf_hugs_tpu/data/phototourism.py (the reference's
MipNeRF360/internal/datasets.py:1115-1261). Layout:
  dense/sparse/         COLMAP model
  dense/images/         images at their own resolutions
  {scene}.tsv           train/test split table
  dense/static_masks/   optional HuGS masks
Poses are recentred on the average pose and the SfM points' centroid and
scaled by the scene's published radius (PHOTOTOURISM_BOUND_DICT, keyed by
the data directory's name). Per-image near/far are the 0.1/99.9
percentiles of the SfM points' depths in front of the camera. With a
downsample factor, images shrink bilinearly with half-pixel centres
(base.resize_bilinear; JAX calls cv2.resize, which computes the same
within 1e-6). Each image keeps its own intrinsics; PINHOLE cameras cast
rays with no undistortion. With render_path the split's cameras give way to
a render path (base.Dataset._apply_render_path).
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

import numpy as np

from nerf_hugs_torch.cameras import camera_utils, scene_manager
from nerf_hugs_torch.data import base
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils import structs

PHOTOTOURISM_BOUND_DICT = {
    "brandenburg_gate": 24,
    "sacre_coeur": 11,
    "taj_mahal": 16,
    "trevi_fountain": 35,
}


def read_tsv_split(data_dir: str):
    """Parse the scene's .tsv into (train_names, test_names)."""
    tsv_files = sorted(Path(data_dir).glob("*.tsv"))
    if not tsv_files:
        raise FileNotFoundError(f"no .tsv split file under {data_dir}")
    train_names, test_names = [], []
    with open(tsv_files[0], "r") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            if row["split"] == "train":
                train_names.append(row["filename"])
            elif row["split"] == "test":
                test_names.append(row["filename"])
    return train_names, test_names


class Phototourism(base.Dataset):

    def _load_renderings(self, config):
        factor = config.factor if config.factor > 0 else 1
        colmap_dir = os.path.join(self.data_dir, "dense/sparse")
        (image_names, poses, pixtocams, distortion_params, camtypes,
         pts3d) = scene_manager.load_colmap_scene(colmap_dir)

        train_names, test_names = read_tsv_split(self.data_dir)
        all_names = train_names + test_names
        selected = (train_names if self.split == structs.DataSplit.TRAIN
                    else test_names)

        # Reorder camera tables into tsv order (embed indices follow it).
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

        # Recenter on the average pose, then on the SfM point centroid, then
        # normalize by the scene's published bound radius.
        poses, transform = camera_utils.recenter_poses(poses)
        pts3d = np.concatenate([pts3d, np.ones_like(pts3d[..., :1])], -1)
        pts3d = pts3d @ transform.T
        center_transform = np.eye(4)
        center_transform[:3, 3] = -pts3d[:, :3].mean(0)
        poses = camera_utils.unpad_poses(
            center_transform @ camera_utils.pad_poses(poses))
        pts3d = pts3d @ center_transform.T
        transform = center_transform @ transform

        bound = PHOTOTOURISM_BOUND_DICT[Path(self.data_dir).name]
        scale_factor = 2.0 / bound
        poses[..., :3, 3] *= scale_factor
        pts3d = pts3d @ np.diag([scale_factor] * 3 + [1]).T
        self.colmap_to_world_transform = (
            np.diag([scale_factor] * 3 + [1]) @ transform)
        self.poses = poses
        self.pts3d = pts3d

        (self.images, self.static_masks, self.nears, self.fars,
         self.distortion_params, self.camtypes) = [], [], [], [], [], []
        heights, widths, focals_out, embeds, c2ws, p2cs = \
            [], [], [], [], [], []

        image_dir = os.path.join(self.data_dir, "dense/images")
        mask_dir = os.path.join(self.data_dir,
                                f"dense/{config.static_mask_dir_name}")
        name_to_idx = {n: i for i, n in enumerate(image_names)}
        for image_name in selected:
            image_idx = name_to_idx[image_name]
            image = nh_io.load_img(
                os.path.join(image_dir, image_name))[..., :3] / 255.0
            height, width = image.shape[:2]
            mask_path = os.path.join(
                mask_dir, f"{image_name.split('.')[0]}.png")
            if factor > 1:
                height, width = height // factor, width // factor
                image = base.resize_bilinear(image, height, width)
            if os.path.exists(mask_path):
                static_mask = base.load_static_mask(mask_path, height, width)
            else:
                static_mask = np.ones((height, width, 1), np.float32)

            # Per-image near/far from visible point depth percentiles
            # (back in the COLMAP-facing frame, datasets.py:1234-1241).
            pose = camera_utils.pad_poses(
                poses[image_idx]) @ np.diag([1, -1, -1, 1])
            w2c = np.linalg.inv(pose)
            pts_cam = (pts3d @ w2c.T)[:, :3]
            pts_cam = pts_cam[pts_cam[:, 2] > 0]
            near = np.percentile(pts_cam[:, 2], 0.1)
            far = np.percentile(pts_cam[:, 2], 99.9)

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
