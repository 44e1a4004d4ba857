"""Camera poses, render paths and pixel -> ray casting on the host, in
numpy.

The numpy subset of nerf_hugs_tpu/cameras/camera_utils.py that the loaders,
the patch sampler and the render driver need (the `xnp=np` path there):
pose padding, the average-pose recentring and the PCA alignment of a
COLMAP capture, the render paths (spiral, ellipse, keyframe spline),
pinhole intrinsics, lookat poses, pixel grids, ray casting with OpenCV
radial + tangential lens distortion, fisheye cameras and NDC for
forward-facing captures. The pose and path functions are copies of
multinerf's (the reference vendors them; their outputs define the frames
and paths of released checkpoints and renders), kept output-compatible.
JAX's cast_pinhole_rays and cast_spherical_rays are not ported: no path
of either package reaches them.
"""

from __future__ import annotations

import enum
import os
from typing import List, Optional, Tuple

import numpy as np
import scipy.interpolate
import torch

from nerf_hugs_torch.core import stepfun
from nerf_hugs_torch.utils import structs


class ProjectionType(enum.Enum):
    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def pad_poses(p: np.ndarray) -> np.ndarray:
    """Append the homogeneous [0,0,0,1] row to [..., 3, 4] poses."""
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p: np.ndarray) -> np.ndarray:
    return p[..., :3, :4]


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
    """Right-handed lookat camera-to-world [3, 4]."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean position/viewing-direction/up pose of a capture."""
    return viewmatrix(poses[:, :3, 2].mean(0), poses[:, :3, 1].mean(0),
                      poses[:, :3, 3].mean(0))


def recenter_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter the capture around its average pose; returns (poses, T)."""
    transform = np.linalg.inv(pad_poses(average_pose(poses)))
    return unpad_poses(transform @ pad_poses(poses)), transform


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Least-squares point closest to all camera optical axes."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate/scale the capture so position PCA axes align with XYZ and all
    camera centers fit in [-1, 1]^3 (multinerf's camera_utils, which the
    reference vendors; its outputs define the frames of released
    checkpoints, so it is kept output-compatible)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    centered = t - t_mean

    eigval, eigvec = np.linalg.eig(centered.T @ centered)
    order = np.argsort(eigval)[::-1]
    rot = eigvec[:, order].T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot

    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_out = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

    # Keep +y of the average camera pointing up (+z world).
    if poses_out.mean(axis=0)[2, 1] < 0:
        poses_out = np.diag(np.array([1, -1, -1])) @ poses_out
        transform = np.diag(np.array([1, -1, -1, 1])) @ transform

    scale = 1.0 / np.max(np.abs(poses_out[:, :3, 3]))
    poses_out[:, :3, 3] *= scale
    transform = np.diag(np.array([scale] * 3 + [1])) @ transform
    return poses_out, transform


NEAR_STRETCH = 0.9
FAR_STRETCH = 5.0
FOCUS_DISTANCE = 0.75


def generate_spiral_path(poses: np.ndarray, bounds: np.ndarray,
                         n_frames: int = 120, n_rots: int = 2,
                         zrate: float = 0.5) -> np.ndarray:
    """Forward-facing spiral render path (camera_utils.py:159-186)."""
    near_bound = bounds.min() * NEAR_STRETCH
    far_bound = bounds.max() * FAR_STRETCH
    focal = 1 / ((1 - FOCUS_DISTANCE) / near_bound
                 + FOCUS_DISTANCE / far_bound)
    positions = poses[:, :3, 3]
    radii = np.concatenate([np.percentile(np.abs(positions), 90, 0), [1.0]])
    cam2world = average_pose(poses)
    up = poses[:, :3, 1].mean(0)
    out = []
    for theta in np.linspace(0.0, 2 * np.pi * n_rots, n_frames,
                             endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate),
                     1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        out.append(viewmatrix(position - lookat, up, position))
    return np.stack(out, axis=0)


def _linspace_from_zero(stop: float, num: int) -> np.ndarray:
    """jnp.linspace(0, stop, num) in float32 as XLA computes it: the index
    times float32(stop * float32(1 / (num - 1))), the end point exact.
    torch.linspace rounds up to one ulp apart, which turns an ellipse
    path's angles by about 1e-6 at radius 2.5."""
    r = np.float32(np.float32(1) / np.float32(num - 1))
    step = np.float32(np.float32(stop) * r)
    return np.concatenate([np.arange(num - 1, dtype=np.float32) * step,
                           [np.float32(stop)]])


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          const_speed: bool = True, z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """Elliptical orbit around the capture's focus point
    (camera_utils.py:230-278). The constant-speed resampling inverts the
    CDF of the segment lengths in float32 at JAX's float32 stratification,
    as JAX's jnp stepfun.sample(None, ...) does."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2] *
                           (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    if const_speed:
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        theta = stepfun.invert_cdf(
            f32(_linspace_from_zero(1.0 - np.finfo(np.float32).eps,
                                    n_frames + 1)),
            f32(theta), f32(np.log(lengths))).numpy()
        positions = get_positions(theta)
    positions = positions[:-1]

    avg_up = normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def generate_interpolated_path(poses: np.ndarray, n_interp: int,
                               spline_degree: int = 5,
                               smoothness: float = 0.03,
                               rot_weight: float = 0.1) -> np.ndarray:
    """Smooth B-spline through keyframe poses (camera_utils.py:280-326),
    splined in (position, lookat point, up point) space so that rotations
    interpolate sanely."""
    def poses_to_points(p, dist):
        pos = p[:, :3, -1]
        lookat = pos - dist * p[:, :3, 2]
        up = pos + dist * p[:, :3, 1]
        return np.stack([pos, lookat, up], 1)

    def points_to_poses(points):
        return np.array([viewmatrix(p - l, u - p, p) for p, l, u in points])

    def interp(points, n, k, s):
        sh = points.shape
        pts = np.reshape(points, (sh[0], -1))
        k = min(k, sh[0] - 1)
        tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=s)
        u = np.linspace(0, 1, n, endpoint=False)
        new_points = np.array(scipy.interpolate.splev(u, tck))
        return np.reshape(new_points.T, (n, sh[1], sh[2]))

    points = poses_to_points(poses, dist=rot_weight)
    new_points = interp(points, n_interp * (points.shape[0] - 1),
                        k=spline_degree, s=smoothness)
    return points_to_poses(new_points)


def create_render_spline_path(config, image_names: List[str],
                              poses: np.ndarray):
    """Spline render path through the keyframe poses that
    config.render_spline_keyframes names (a directory of images or a text
    file of names; camera_utils.py:330-378). Returns (keyframe indices,
    poses)."""
    source = config.render_spline_keyframes
    if os.path.isdir(source):
        keyframe_names = sorted(os.listdir(source))
    else:
        with open(source, "r") as f:
            keyframe_names = f.read().splitlines()
    spline_indices = np.array(
        [i for i, name in enumerate(image_names) if name in keyframe_names])
    if len(spline_indices) < 2:
        raise ValueError(
            f"need >=2 keyframes from {source}, matched {len(spline_indices)}")
    render_poses = generate_interpolated_path(
        poses[spline_indices],
        n_interp=config.render_spline_n_interp,
        spline_degree=config.render_spline_degree,
        smoothness=config.render_spline_smoothness,
        rot_weight=0.1)
    return spline_indices, render_poses


def interpolate_1d(x: np.ndarray, n_interp: int, spline_degree: int,
                   smoothness: float) -> np.ndarray:
    """Spline-upsample a 1-D signal by n_interp (e.g. per-frame
    exposure)."""
    t = np.linspace(0, 1, len(x), endpoint=True)
    tck = scipy.interpolate.splrep(t, x, s=smoothness, k=spline_degree)
    u = np.linspace(0, 1, n_interp * (len(x) - 1), endpoint=False)
    return scipy.interpolate.splev(u, tck)


def intrinsic_matrix(fx, fy, cx, cy) -> np.ndarray:
    """OpenCV-convention pinhole intrinsics."""
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def get_pixtocam(focal, width, height) -> np.ndarray:
    """Inverse intrinsics of a centered pinhole camera."""
    return np.linalg.inv(intrinsic_matrix(focal, focal, width * 0.5,
                                          height * 0.5))


def pixel_coordinates(width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.meshgrid(np.arange(width), np.arange(height), indexing="xy")


def _distortion_residual_and_jacobian(x, y, xd, yd, k1=0.0, k2=0.0, k3=0.0,
                                      k4=0.0, p1=0.0, p2=0.0):
    """Residual of the OpenCV radial+tangential model and its 2x2 Jacobian."""
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2 * k2 + r * (3 * k3 + r * 4 * k4))
    d_x, d_y = 2 * x * d_r, 2 * y * d_r
    fx_x = d + d_x * x + 2 * p1 * y + 6 * p2 * x
    fx_y = d_y * x + 2 * p1 * x + 2 * p2 * y
    fy_x = d_x * y + 2 * p2 * y + 2 * p1 * x
    fy_y = d + d_y * y + 2 * p2 * x + 6 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, k4=0.0,
                                    p1=0.0, p2=0.0, eps=1e-9,
                                    max_iterations=10):
    """Invert the distortion model with a fixed 10-iteration Newton solve."""
    x, y = np.array(xd), np.array(yd)
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _distortion_residual_and_jacobian(
            x, y, xd, yd, k1=k1, k2=k2, k3=k3, k4=k4, p1=p1, p2=p2)
        denom = fy_x * fx_y - fx_x * fy_y
        safe = np.abs(denom) > eps
        x = x + np.where(safe, (fx * fy_y - fy * fx_y) / denom, 0.0)
        y = y + np.where(safe, (fy * fx_x - fx * fy_x) / denom, 0.0)
    return x, y


def undistorted_grid(pixtocam: np.ndarray, distortion_params: dict,
                     width: int, height: int) -> np.ndarray:
    """[height + 1, width + 1, 2]: the undistorted camera-plane (x, y) of
    every pixel centre of one camera, one column and one row past the last
    included (the +x and +y neighbours of the cone footprint). A split whose
    cameras share one pixtocam and lens solves it once; pixels_to_rays then
    gathers from it instead of solving for every ray."""
    x, y = pixel_coordinates(width + 1, height + 1)
    pixel_dirs = np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)
    camera_dirs = np.matmul(pixtocam, pixel_dirs[..., None])[..., 0]
    return np.stack(radial_and_tangential_undistort(
        camera_dirs[..., 0], camera_dirs[..., 1], **distortion_params), -1)


def convert_to_ndc(origins, directions, pixtocam, near: float = 1.0):
    """Map rays to NDC for forward-facing scenes (NeRF Appendix C).

    Origins shift to the near plane first, so the NDC near and far planes
    are z = -1 and z = +1; directions_ndc spans origin -> infinity
    projections."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions
    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)
    xmult = 1.0 / pixtocam[0, 2]
    ymult = 1.0 / pixtocam[1, 2]
    origins_ndc = np.stack(
        [xmult * ox / oz, ymult * oy / oz, -np.ones_like(oz)], axis=-1)
    infinity_ndc = np.stack(
        [xmult * dx / dz, ymult * dy / dz, np.ones_like(oz)], axis=-1)
    return origins_ndc, infinity_ndc - origins_ndc


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params: Optional[dict] = None,
                   pixtocam_ndc: Optional[np.ndarray] = None,
                   camtype: ProjectionType = ProjectionType.PERSPECTIVE,
                   undistorted: Optional[np.ndarray] = None):
    """Pixel indices -> (origins, directions, viewdirs, radii).

    Casts through pixel centers, undistorted when `distortion_params`
    (k1..k4, p1, p2) are given, or gathered from `undistorted` (the
    undistorted_grid of the cameras' shared pixtocam and lens) when it is;
    a fisheye camera then bends the undistorted plane point onto the
    sphere (angle from the axis = its radius, up to pi). The +x and +y
    neighbour rays give the pixel footprint from which the cone base radius
    derives; with `pixtocam_ndc` the rays and that footprint are taken to
    NDC (forward-facing captures)."""

    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    pixel_dirs = np.stack([
        pix_to_dir(pix_x_int, pix_y_int),
        pix_to_dir(pix_x_int + 1, pix_y_int),
        pix_to_dir(pix_x_int, pix_y_int + 1),
    ], axis=0)
    mat_vec = lambda a, b: np.matmul(a, b[..., None])[..., 0]

    if undistorted is not None:
        xy = np.stack([undistorted[pix_y_int, pix_x_int],
                       undistorted[pix_y_int, pix_x_int + 1],
                       undistorted[pix_y_int + 1, pix_x_int]], axis=0)
        camera_dirs = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
    else:
        camera_dirs = mat_vec(pixtocams, pixel_dirs)
        if distortion_params is not None:
            x, y = radial_and_tangential_undistort(
                camera_dirs[..., 0], camera_dirs[..., 1], **distortion_params)
            camera_dirs = np.stack([x, y, np.ones_like(x)], -1)
    if camtype == ProjectionType.FISHEYE:
        theta = np.sqrt(np.sum(np.square(camera_dirs[..., :2]), axis=-1))
        theta = np.minimum(np.pi, theta)
        sin_ratio = np.sin(theta) / theta
        camera_dirs = np.stack([camera_dirs[..., 0] * sin_ratio,
                                camera_dirs[..., 1] * sin_ratio,
                                np.cos(theta)], axis=-1)
    # OpenCV -> OpenGL axis flip, then rotate into world space.
    camera_dirs = np.matmul(camera_dirs, np.diag(np.array([1.0, -1.0, -1.0])))
    directions, dx, dy = mat_vec(camtoworlds[..., :3, :3], camera_dirs)

    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    if pixtocam_ndc is None:
        dx_norm = np.linalg.norm(dx - directions, axis=-1)
        dy_norm = np.linalg.norm(dy - directions, axis=-1)
    else:
        origins_dx, _ = convert_to_ndc(origins, dx, pixtocam_ndc)
        origins_dy, _ = convert_to_ndc(origins, dy, pixtocam_ndc)
        origins, directions = convert_to_ndc(origins, directions,
                                             pixtocam_ndc)
        dx_norm = np.linalg.norm(origins_dx - origins, axis=-1)
        dy_norm = np.linalg.norm(origins_dy - origins, axis=-1)
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    return origins, directions, viewdirs, radii


def cast_ray_batch(cameras: Tuple[np.ndarray, ...], pixels: structs.Pixels,
                   heights: np.ndarray, widths: np.ndarray,
                   distortion_params: Optional[dict],
                   camtype: ProjectionType = ProjectionType.PERSPECTIVE,
                   undistorted: Optional[np.ndarray] = None
                   ) -> structs.Rays:
    """Pixels batch + camera table -> Rays batch; per-ray cameras are
    gathered by pixels.cam_idx (`undistorted`: see pixels_to_rays)."""
    pixtocams, camtoworlds, pixtocam_ndc = cameras
    cam_idx = pixels.cam_idx[..., 0]
    batch_index = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]

    origins, directions, viewdirs, radii = pixels_to_rays(
        pixels.pix_x_int, pixels.pix_y_int, batch_index(pixtocams),
        batch_index(camtoworlds), distortion_params=distortion_params,
        pixtocam_ndc=pixtocam_ndc, camtype=camtype, undistorted=undistorted)

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
