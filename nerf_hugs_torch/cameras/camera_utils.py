"""Pixel -> ray casting on the host, in numpy.

The numpy-only subset of nerf_hugs_tpu/cameras/camera_utils.py that the
synthetic scene and the patch sampler need (the `xnp=np` path there):
pinhole intrinsics, lookat poses, pixel grids, perspective ray casting
without lens distortion or NDC.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np

from nerf_hugs_torch.utils import structs


class ProjectionType(enum.Enum):
    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
    """Right-handed lookat camera-to-world [3, 4]."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def get_pixtocam(focal, width, height) -> np.ndarray:
    """Inverse intrinsics of a centered pinhole camera."""
    return np.linalg.inv(np.array([[focal, 0, width * 0.5],
                                   [0, focal, height * 0.5],
                                   [0, 0, 1.0]]))


def pixel_coordinates(width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params: Optional[dict] = None,
                   pixtocam_ndc: Optional[np.ndarray] = None,
                   camtype: ProjectionType = ProjectionType.PERSPECTIVE):
    """Pixel indices -> (origins, directions, viewdirs, radii).

    Casts through pixel centers; the +x and +y neighbour rays give the
    pixel footprint from which the cone base radius derives."""
    if distortion_params is not None or pixtocam_ndc is not None \
            or camtype != ProjectionType.PERSPECTIVE:
        raise NotImplementedError(
            "lens distortion, NDC and fisheye cameras wait for the remaining "
            "loaders (ROADMAP.md Queue 1 item 11)")

    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    pixel_dirs = np.stack([
        pix_to_dir(pix_x_int, pix_y_int),
        pix_to_dir(pix_x_int + 1, pix_y_int),
        pix_to_dir(pix_x_int, pix_y_int + 1),
    ], axis=0)
    mat_vec = lambda a, b: np.matmul(a, b[..., None])[..., 0]

    camera_dirs = mat_vec(pixtocams, pixel_dirs)
    # OpenCV -> OpenGL axis flip, then rotate into world space.
    camera_dirs = np.matmul(camera_dirs, np.diag(np.array([1.0, -1.0, -1.0])))
    directions, dx, dy = mat_vec(camtoworlds[..., :3, :3], camera_dirs)

    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    dx_norm = np.linalg.norm(dx - directions, axis=-1)
    dy_norm = np.linalg.norm(dy - directions, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    return origins, directions, viewdirs, radii


def cast_ray_batch(cameras: Tuple[np.ndarray, ...], pixels: structs.Pixels,
                   heights: np.ndarray, widths: np.ndarray,
                   distortion_params: Optional[dict],
                   camtype: ProjectionType = ProjectionType.PERSPECTIVE
                   ) -> structs.Rays:
    """Pixels batch + camera table -> Rays batch; per-ray cameras are
    gathered by pixels.cam_idx."""
    pixtocams, camtoworlds, pixtocam_ndc = cameras
    cam_idx = pixels.cam_idx[..., 0]
    batch_index = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]

    origins, directions, viewdirs, radii = pixels_to_rays(
        pixels.pix_x_int, pixels.pix_y_int, batch_index(pixtocams),
        batch_index(camtoworlds), distortion_params=distortion_params,
        pixtocam_ndc=pixtocam_ndc, camtype=camtype)

    h, w = heights[cam_idx], widths[cam_idx]
    pix_coords = np.stack([
        (pixels.pix_x_int.astype(np.float32) + 0.5) / w,
        (pixels.pix_y_int.astype(np.float32) + 0.5) / h,
    ], axis=-1)
    return structs.Rays(
        pix_coords=pix_coords, origins=origins, directions=directions,
        viewdirs=viewdirs, radii=radii, lossmult=pixels.lossmult,
        static_mask=pixels.static_mask, near=pixels.near, far=pixels.far,
        embed_idx=pixels.embed_idx, cam_idx=pixels.cam_idx)
