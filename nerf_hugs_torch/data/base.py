"""Dataset base: host-side numpy ray-batch producer with a prefetch thread.

Twin of nerf_hugs_tpu/data/base.py for one process: a daemon producer
thread fills a queue.Queue(3) with Batches of numpy arrays; the train loop
moves each batch to the device. Training batches are random dilated
patches, gathered by the native threaded sampler (native/raysampler.cc,
reused as it is) when g++ can build it, else by numpy.
"""

from __future__ import annotations

import abc
import dataclasses
import queue
import threading
from typing import List, Optional

import numpy as np

from nerf_hugs_torch.cameras import camera_utils
from nerf_hugs_torch.utils import structs


class Dataset(threading.Thread, metaclass=abc.ABCMeta):
    """Infinite iterator of Batches (train: random rays; test: images).

    Subclasses implement _load_renderings(config) and set images,
    static_masks, nears, fars (lists of [H, W, c] float arrays), heights,
    widths, embed_idxs ([N] arrays), camtoworlds [N, 3, 4],
    pixtocams [N, 3, 3], distortion_params and camtypes (lists)."""

    def __init__(self, split: str, is_training: bool, batch_size: int,
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
        if config.enable_clip_near_far:
            raise NotImplementedError(
                "enable_clip_near_far waits for core/rayops.py "
                "(ROADMAP.md Queue 1 item 5)")
        self._test_camera_idx = 0
        self._rng = np.random.default_rng(
            np.random.SeedSequence([config.seed, 0, int(is_training)]))
        self.split = structs.DataSplit(split)
        self.is_training = is_training
        self.data_dir = data_dir
        self.near = config.near
        self.far = config.far

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
        self.cameras = (self.pixtocams, self.camtoworlds, None)

        # The native sampler gathers fixed 3-float rgb rows from cameras
        # that share distortion and projection.
        self._native = None
        homogeneous = (len({repr(d) for d in self.distortion_params}) == 1
                       and len(set(self.camtypes)) == 1
                       and all(im.shape[-1] == 3 for im in self.images))
        if is_training and homogeneous:
            from nerf_hugs_tpu.data import native_sampler
            try:
                self._native = native_sampler.NativeSampler(
                    self.images, self.static_masks, self.nears, self.fars,
                    self.embed_idxs)
            except (RuntimeError, OSError):
                self._native = None  # no g++: the numpy path below
            self._native_seed = int(self._rng.integers(0, 2 ** 62))
            self._native_calls = 0

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
            self.distortion_params[cam_idx], self.camtypes[cam_idx])
        return structs.Batch(rays=rays,
                             rgb=self.images[cam_idx][pix_y_int, pix_x_int])

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
            x0 = self._rng.integers(0, self.widths[cam_idx] - span,
                                    (n_patches, 1, 1))
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
            self._patch_dilation, self._image_num_per_batch)
        pixels = structs.Pixels(
            pix_x_int=pix_x.astype(np.int64),
            pix_y_int=pix_y.astype(np.int64),
            lossmult=np.ones((len(pix_x), 1), np.float32),
            static_mask=mask[:, None], near=near[:, None], far=far[:, None],
            embed_idx=embed_idx[:, None], cam_idx=cam_idx[:, None])
        rays = camera_utils.cast_ray_batch(
            self.cameras, pixels, self.heights, self.widths,
            self.distortion_params[0], self.camtypes[0])
        return structs.Batch(rays=rays, rgb=rgb)

    def generate_ray_batch(self, cam_idx: int) -> structs.Batch:
        """All rays of one camera, as an [H, W, ...] batch (eval)."""
        pix_x_int, pix_y_int = camera_utils.pixel_coordinates(
            self.widths[cam_idx], self.heights[cam_idx])
        return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx)

    def _next_test(self) -> structs.Batch:
        cam_idx = self._test_camera_idx
        self._test_camera_idx = (self._test_camera_idx + 1) % self._n_examples
        return self.generate_ray_batch(cam_idx)
