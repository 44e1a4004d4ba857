"""Dataset base: host-side numpy ray-batch producer with a prefetch thread.

Twin of nerf_hugs_tpu/data/base.py for one process: a daemon producer
thread fills a queue.Queue(3) with Batches of numpy arrays; the train loop
moves each batch to the device. Training batches are random dilated
patches, gathered by the native threaded sampler (the port's copy of
native/raysampler.cc, nerf_hugs_torch/native/) when g++ can build it, else
by numpy. With sample_from_half_image (the finetune stage on the test
split) patches come from the left half of each image only, leaving the
right half for evaluation. With render_path (the render driver) a loader
swaps its split's cameras for a generated path (_apply_render_path) and
the batches carry no images; with enable_clip_near_far every ray's near
and far are clipped to the scene's box (core/rayops.py).
"""

from __future__ import annotations

import abc
import dataclasses
import queue
import threading
from typing import List, Optional

import numpy as np
import torch
from torch.nn import functional as F

from nerf_hugs_torch.cameras import camera_utils
from nerf_hugs_torch.core import rayops
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils import structs


class Dataset(threading.Thread, metaclass=abc.ABCMeta):
    """Infinite iterator of Batches (train: random rays; test: images).

    Subclasses implement _load_renderings(config) and set images,
    static_masks, nears, fars (lists of [H, W, c] float arrays), heights,
    widths, embed_idxs ([N] arrays), camtoworlds [N, 3, 4],
    pixtocams [N, 3, 3], distortion_params and camtypes (lists), and
    pixtocam_ndc [3, 3] for NDC rays (forward-facing llff)."""

    def __init__(self, split: str, is_training: bool,
                 sample_from_half_image: bool, batch_size: int,
                 patch_size: int, patch_dilation: int,
                 image_num_per_batch: int, data_dir: str, config):
        super().__init__()
        self._queue = queue.Queue(3)
        self.daemon = True
        self._patch_size = max(patch_size, 1)
        self._batch_size = batch_size
        self._image_num_per_batch = max(1, image_num_per_batch)
        self._patch_dilation = patch_dilation
        if self._image_num_per_batch * self._patch_size ** 2 > batch_size:
            raise ValueError(
                f"image_num_per_batch={self._image_num_per_batch} * "
                f"patch_size={self._patch_size}^2 exceeds batch size "
                f"{batch_size}")
        self._test_camera_idx = 0
        self._rng = np.random.default_rng(
            np.random.SeedSequence([config.seed, 0, int(is_training)]))
        self.split = structs.DataSplit(split)
        self.is_training = is_training
        self.sample_from_half_image = sample_from_half_image
        self.data_dir = data_dir
        self.near = config.near
        self.far = config.far
        self.render_path = config.render_path
        self._enable_clip_near_far = config.enable_clip_near_far
        self._bound = config.bound
        self.pixtocam_ndc: Optional[np.ndarray] = None

        self.images: List[np.ndarray] = None
        self.static_masks: List[np.ndarray] = None
        self.nears: List[np.ndarray] = None
        self.fars: List[np.ndarray] = None
        self.heights = self.widths = self.embed_idxs = None
        self.camtoworlds: np.ndarray = None
        self.pixtocams: np.ndarray = None
        self.distortion_params: Optional[List] = None
        self.camtypes: Optional[List] = None
        self.image_names: Optional[List[str]] = None
        self._load_renderings(config)

        self._n_examples = self.camtoworlds.shape[0]
        if self.image_names is None:
            self.image_names = [f"{i:03d}" for i in range(self._n_examples)]
        self.cameras = (self.pixtocams, self.camtoworlds, self.pixtocam_ndc)

        # The native sampler gathers fixed 3-float rgb rows from cameras
        # that share distortion (compared as key-sorted items) and
        # projection.
        self._native = None
        distortion_key = lambda d: None if d is None else tuple(
            sorted(d.items()))
        one_lens = (len({distortion_key(d)
                         for d in self.distortion_params}) == 1
                    and len(set(self.camtypes)) == 1)
        homogeneous = one_lens and all(im.shape[-1] == 3
                                       for im in self.images or [])
        if is_training and not self.render_path and homogeneous:
            from nerf_hugs_torch.data import native_sampler
            try:
                self._native = native_sampler.NativeSampler(
                    self.images, self.static_masks, self.nears, self.fars,
                    self.embed_idxs)
            except (RuntimeError, OSError):
                self._native = None  # no g++: the numpy path below
            self._native_seed = int(self._rng.integers(0, 2 ** 62))
            self._native_calls = 0

        # Cameras that share one pixtocam, lens and image size (kubric's)
        # undistort the pixel grid once: the per-ray Newton solve would
        # otherwise take most of a batch's host time.
        self._undistorted = None
        if (one_lens and self.distortion_params[0] is not None
                and len(set(self.heights)) == len(set(self.widths)) == 1
                and np.all(self.pixtocams == self.pixtocams[0])):
            self._undistorted = camera_utils.undistorted_grid(
                self.pixtocams[0], self.distortion_params[0],
                int(self.widths[0]), int(self.heights[0]))

        self._next_fn = self._next_train if is_training else self._next_test
        # Seed one batch so __next__ cannot race thread startup.
        self._queue.put(self._next_fn())
        self.start()

    def __iter__(self):
        return self

    def __next__(self) -> structs.Batch:
        return self._queue.get()

    def run(self):
        while True:
            self._queue.put(self._next_fn())

    @property
    def size(self) -> int:
        return self._n_examples

    def image_name(self, cam_idx: int) -> str:
        """The image's file stem (eval --original_name)."""
        return self.image_names[cam_idx]

    @abc.abstractmethod
    def _load_renderings(self, config):
        ...

    def _apply_render_path(self, config,
                           render_poses: Optional[np.ndarray] = None):
        """With config.render_path, swap this split's cameras for a render
        path (nerf_hugs_tpu/data/base.py:163-228); loaders call it at the
        end of _load_renderings. The poses come from, in this order:
          1. config.render_path_file, an .npy of [n, 3|4, 4] camera-to-world
             poses in this loader's world frame;
          2. config.render_spline_keyframes, a spline through the named
             keyframes (camera_utils.create_render_spline_path);
          3. `render_poses` from the caller (llff's spiral or ellipse);
          4. an ellipse fit to this split's poses.
        Intrinsics, near, far and lens are camera 0's; render_resolution
        (width, height) rescales its pixtocam and fills near and far with
        camera 0's extremes. The frames have no images, masks of ones and
        embedding index 0."""
        if not self.render_path:
            return
        if config.render_path_file:
            with open(config.render_path_file, "rb") as fp:
                poses = np.load(fp)
            if poses.shape[-2:] == (4, 4):
                poses = poses[:, :3, :]
        elif config.render_spline_keyframes:
            self.spline_indices, poses = \
                camera_utils.create_render_spline_path(
                    config, self.image_names
                    or [f"{i:03d}" for i in range(len(self.camtoworlds))],
                    self.camtoworlds)
        elif render_poses is not None:
            poses = render_poses
        else:
            poses = camera_utils.generate_ellipse_path(
                self.camtoworlds, n_frames=config.render_path_frames,
                z_variation=config.z_variation, z_phase=config.z_phase)
        n = poses.shape[0]
        self.render_poses = poses
        self.camtoworlds = np.asarray(poses, np.float32)
        height, width = int(self.heights[0]), int(self.widths[0])
        pixtocam = self.pixtocams[0]
        near0, far0 = self.nears[0], self.fars[0]
        if config.render_resolution is not None:
            new_w, new_h = config.render_resolution
            pixtocam = pixtocam @ np.diag(
                [width / new_w, height / new_h, 1.0]).astype(pixtocam.dtype)
            height, width = int(new_h), int(new_w)
            near0 = np.full((height, width, 1), float(near0.min()),
                            np.float32)
            far0 = np.full((height, width, 1), float(far0.max()), np.float32)
        self.pixtocams = np.repeat(pixtocam[None], n, axis=0)
        self.heights = np.full(n, height, self.heights.dtype)
        self.widths = np.full(n, width, self.widths.dtype)
        self.distortion_params = [self.distortion_params[0]] * n
        self.camtypes = [self.camtypes[0]] * n
        self.nears = [near0] * n
        self.fars = [far0] * n
        self.static_masks = [np.ones((height, width, 1), np.float32)] * n
        self.embed_idxs = np.zeros(n, self.embed_idxs.dtype)
        self.images = None
        self.image_names = [f"{i:03d}" for i in range(n)]

    def _maybe_clip_near_far(self, rays: structs.Rays) -> structs.Rays:
        """With enable_clip_near_far, each ray's near and far clipped to
        the [-bound, bound]^3 box (nerf_hugs_tpu/data/base.py:252-263)."""
        if not self._enable_clip_near_far:
            return rays
        flat = lambda a, d: a.reshape(-1, d)
        near, far = rayops.clip_near_far_to_aabb(
            flat(rays.origins, 3), flat(rays.directions, 3),
            flat(rays.near, 1), flat(rays.far, 1), self._bound)
        return dataclasses.replace(rays, near=near.reshape(rays.near.shape),
                                   far=far.reshape(rays.far.shape))

    def _make_ray_batch(self, pix_x_int: np.ndarray, pix_y_int: np.ndarray,
                        cam_idx: int) -> structs.Batch:
        """Pixel coords of one camera -> cast Rays (+ gt rgb)."""
        bscalar = lambda x: np.broadcast_to(x, pix_x_int.shape)[..., None]
        pixels = structs.Pixels(
            pix_x_int=pix_x_int, pix_y_int=pix_y_int,
            lossmult=bscalar(np.float32(1.0)),
            static_mask=self.static_masks[cam_idx][pix_y_int, pix_x_int],
            near=self.nears[cam_idx][pix_y_int, pix_x_int],
            far=self.fars[cam_idx][pix_y_int, pix_x_int],
            embed_idx=bscalar(self.embed_idxs[cam_idx]).astype(np.int32),
            cam_idx=bscalar(cam_idx).astype(np.int32))
        rays = camera_utils.cast_ray_batch(
            self.cameras, pixels, self.heights, self.widths,
            self.distortion_params[cam_idx], self.camtypes[cam_idx],
            self._undistorted)
        rgb = (None if self.images is None
               else self.images[cam_idx][pix_y_int, pix_x_int])
        return structs.Batch(rays=self._maybe_clip_near_far(rays), rgb=rgb)

    def _next_train(self) -> structs.Batch:
        """Random dilated patches from image_num_per_batch random images,
        flattened to [batch_size, ...]."""
        if self._native is not None:
            return self._next_train_native()
        p = self._patch_size
        n_patches = (self._batch_size // self._image_num_per_batch) // p ** 2
        span = (p - 1) * self._patch_dilation
        dx, dy = camera_utils.pixel_coordinates(p, p)
        parts = []
        for _ in range(self._image_num_per_batch):
            cam_idx = int(self._rng.integers(0, self._n_examples))
            width = self.widths[cam_idx]
            if self.sample_from_half_image:
                width = width // 2
            x0 = self._rng.integers(0, width - span, (n_patches, 1, 1))
            y0 = self._rng.integers(0, self.heights[cam_idx] - span,
                                    (n_patches, 1, 1))
            parts.append(self._make_ray_batch(x0 + dx * self._patch_dilation,
                                              y0 + dy * self._patch_dilation,
                                              cam_idx))
        flat = lambda x: x.reshape(-1, x.shape[-1])
        rays = structs.Rays(**{
            f.name: flat(np.concatenate([getattr(b.rays, f.name)
                                         for b in parts]))
            for f in dataclasses.fields(structs.Rays)})
        return structs.Batch(rays=rays, rgb=flat(np.concatenate(
            [b.rgb for b in parts])))

    def _next_train_native(self) -> structs.Batch:
        """Threaded pixel gather in C++, then one vectorized ray cast with
        per-ray camera gathers."""
        p = self._patch_size
        n_patches = (self._batch_size // self._image_num_per_batch
                     ) // p ** 2 * self._image_num_per_batch
        self._native_calls += 1
        (pix_x, pix_y, cam_idx, embed_idx, rgb, mask, near, far
         ) = self._native.sample(
            self._native_seed + self._native_calls, n_patches, p,
            self._patch_dilation, self._image_num_per_batch,
            half_image=self.sample_from_half_image)
        pixels = structs.Pixels(
            pix_x_int=pix_x.astype(np.int64),
            pix_y_int=pix_y.astype(np.int64),
            lossmult=np.ones((len(pix_x), 1), np.float32),
            static_mask=mask[:, None], near=near[:, None], far=far[:, None],
            embed_idx=embed_idx[:, None], cam_idx=cam_idx[:, None])
        rays = camera_utils.cast_ray_batch(
            self.cameras, pixels, self.heights, self.widths,
            self.distortion_params[0], self.camtypes[0], self._undistorted)
        return structs.Batch(rays=self._maybe_clip_near_far(rays), rgb=rgb)

    def generate_ray_batch(self, cam_idx: int) -> structs.Batch:
        """All rays of one camera, as an [H, W, ...] batch (eval)."""
        pix_x_int, pix_y_int = camera_utils.pixel_coordinates(
            self.widths[cam_idx], self.heights[cam_idx])
        return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx)

    def _next_test(self) -> structs.Batch:
        cam_idx = self._test_camera_idx
        self._test_camera_idx = (self._test_camera_idx + 1) % self._n_examples
        return self.generate_ray_batch(cam_idx)


def resize_bilinear(image: np.ndarray, height: int,
                    width: int) -> np.ndarray:
    """[h, w, c] -> [height, width, c], bilinear with half-pixel centres
    and clamped edges and no antialiasing (OpenCV's INTER_LINEAR, which the
    JAX loaders call). It interpolates in float64 and returns the image's
    own dtype: torch's float32 source coordinates drift by up to 5e-5 at a
    non-integer scale (767 -> 383 rows)."""
    t = torch.from_numpy(np.ascontiguousarray(image, np.float64))
    return F.interpolate(t.permute(2, 0, 1)[None], size=(height, width),
                         mode="bilinear", align_corners=False
                         )[0].permute(1, 2, 0).numpy().astype(image.dtype)


def load_static_mask(path: str, height: int, width: int) -> np.ndarray:
    """A HuGS static-mask PNG as [H, W, 1] float32 in [0, 1], resized with
    resize_bilinear when its size differs from the image's."""
    mask = nh_io.load_img(path) / 255.0
    if mask.ndim == 2:
        mask = mask[..., None]
    if mask.shape[:2] != (height, width):
        mask = resize_bilinear(mask.astype(np.float32), height, width)
    return mask[..., :1].reshape(height, width, 1).astype(np.float32)
