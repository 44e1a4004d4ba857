"""LLFF loader: COLMAP-posed captures, forward-facing or 360.

Twin of nerf_hugs_tpu/data/llff.py (the reference's
MipNeRF360/internal/datasets.py:633-785). Layout:
  sparse/0/            COLMAP model
  images/              full-resolution (COLMAP) images
  images_{factor}/     downsampled images, matched to images/ by sorted
                       order
  poses_bounds.npy     optional near/far bounds (forward-facing)
  static_masks/        optional HuGS masks
A forward-facing capture (config.forward_facing) is scaled by its nearest
bound, recentred on its average pose and cast to NDC, with a spiral render
path; any other is PCA-aligned into the unit cube, with an ellipse render
path. Every llffhold-th image (alphabetical order) is the test split.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from nerf_hugs_torch.cameras import camera_utils, scene_manager
from nerf_hugs_torch.data import base
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils import structs


class LLFF(base.Dataset):

    def _load_renderings(self, config):
        factor = config.factor if config.factor > 0 else 1
        image_dir_suffix = f"_{config.factor}" if config.factor > 0 else ""

        colmap_dir = os.path.join(self.data_dir, "sparse/0/")
        if not os.path.exists(colmap_dir):
            raise FileNotFoundError(f"missing COLMAP model at {colmap_dir}")
        (image_names, poses, pixtocams, distortion_params, camtypes,
         _) = scene_manager.load_colmap_scene(colmap_dir)

        if config.load_alphabetical:
            order = np.argsort(image_names)
            image_names = [image_names[i] for i in order]
            poses = poses[order]
            pixtocams = pixtocams[order]
            distortion_params = [distortion_params[i] for i in order]
            camtypes = [camtypes[i] for i in order]

        pixtocams = (pixtocams @ np.diag([factor, factor, 1.0])).astype(
            np.float32)

        colmap_image_dir = os.path.join(self.data_dir, "images")
        image_dir = os.path.join(self.data_dir, "images" + image_dir_suffix)
        for d in (image_dir, colmap_image_dir):
            if not os.path.exists(d):
                raise FileNotFoundError(f"image folder {d} does not exist")
        colmap_files = sorted(os.listdir(colmap_image_dir))
        image_files = sorted(os.listdir(image_dir))
        colmap_to_image = dict(zip(colmap_files, image_files))
        images = [nh_io.load_img(
            os.path.join(image_dir, colmap_to_image[f]))[..., :3] / 255.0
            for f in image_names]

        mask_dir = os.path.join(self.data_dir, config.static_mask_dir_name)
        static_masks = []
        for idx, f in enumerate(image_names):
            height, width = images[idx].shape[:2]
            mask_path = os.path.join(
                mask_dir, f"{Path(colmap_to_image[f]).stem}.png")
            if os.path.exists(mask_path):
                static_masks.append(
                    base.load_static_mask(mask_path, height, width))
            else:
                static_masks.append(np.ones((height, width, 1), np.float32))

        posefile = os.path.join(self.data_dir, "poses_bounds.npy")
        bounds = (np.load(posefile)[:, -2:] if os.path.exists(posefile)
                  else np.array([0.01, 1.0]))
        self.colmap_to_world_transform = np.eye(4)

        if config.forward_facing:
            self.pixtocam_ndc = pixtocams.reshape(-1, 3, 3)[0]
            scale = 1.0 / (bounds.min() * 0.75)
            poses[:, :3, 3] *= scale
            self.colmap_to_world_transform = np.diag([scale] * 3 + [1])
            bounds = bounds * scale
            poses, transform = camera_utils.recenter_poses(poses)
            self.colmap_to_world_transform = (
                transform @ self.colmap_to_world_transform)
            self.render_poses = camera_utils.generate_spiral_path(
                poses, bounds, n_frames=config.render_path_frames)
        else:
            poses, transform = camera_utils.transform_poses_pca(poses)
            self.colmap_to_world_transform = transform
            self.render_poses = camera_utils.generate_ellipse_path(
                poses, n_frames=config.render_path_frames,
                z_variation=config.z_variation, z_phase=config.z_phase)
        self.poses = poses

        all_indices = np.arange(poses.shape[0])
        train_indices = (all_indices if config.llff_use_all_images_for_training
                         else all_indices[all_indices % config.llffhold != 0])
        split_indices = {
            structs.DataSplit.TEST:
                all_indices[all_indices % config.llffhold == 0],
            structs.DataSplit.TRAIN: train_indices,
        }
        indices = split_indices[self.split]

        self.pixtocams = pixtocams[indices]
        self.distortion_params = [distortion_params[i] for i in indices]
        self.camtypes = [camtypes[i] for i in indices]
        self.embed_idxs = np.array(indices)
        self.image_names = [Path(colmap_to_image[image_names[i]]).stem
                            for i in indices]
        self.images = [images[i].astype(np.float32) for i in indices]
        self.static_masks = [static_masks[i] for i in indices]
        shape = lambda img: (*img.shape[:2], 1)
        self.heights = np.array([img.shape[0] for img in self.images])
        self.widths = np.array([img.shape[1] for img in self.images])
        self.nears = [np.full(shape(img), self.near, np.float32)
                      for img in self.images]
        self.fars = [np.full(shape(img), self.far, np.float32)
                     for img in self.images]
        self.camtoworlds = poses[indices]
        # The spiral or ellipse came from every pose, before the split, as
        # the reference's LLFF flow does (datasets.py:728-745).
        self._apply_render_path(config, render_poses=self.render_poses)
