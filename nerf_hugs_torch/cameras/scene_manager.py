"""COLMAP sparse model -> NeRF camera tables.

The port's copy of nerf_hugs_tpu/cameras/scene_manager.py (the
reference's NeRFSceneManager, MipNeRF360/internal/datasets.py:78-185, on
the port's own COLMAP reader). Returns, in COLMAP image-record order:
  names:      image basenames
  poses:      [N, 3, 4] camera-to-world in the NeRF frame (right, up, back)
  pixtocams:  [N, 3, 3] inverse intrinsics
  distortion_params: per-image dict (k1/k2/k3/p1/p2 or fisheye k1..k4) or
              None (PINHOLE and SIMPLE_PINHOLE: no undistortion at all)
  camtypes:   per-image ProjectionType
  pts3d:      [M, 3] world points (NeRF frame not applied; matches reference)
"""

from __future__ import annotations

from typing import List

import numpy as np

from nerf_hugs_torch.cameras import camera_utils, colmap


def _intrinsics_and_distortion(cam: colmap.Camera):
    """COLMAP camera model params -> (fx, fy, cx, cy, distortion, camtype)."""
    p = cam.params
    perspective = camera_utils.ProjectionType.PERSPECTIVE
    if cam.model == "SIMPLE_PINHOLE":
        return p[0], p[0], p[1], p[2], None, perspective
    if cam.model == "PINHOLE":
        return p[0], p[1], p[2], p[3], None, perspective
    zeros = lambda keys: {k: 0.0 for k in keys}
    if cam.model == "SIMPLE_RADIAL":
        d = zeros(["k1", "k2", "k3", "p1", "p2"])
        d["k1"] = p[3]
        return p[0], p[0], p[1], p[2], d, perspective
    if cam.model == "RADIAL":
        d = zeros(["k1", "k2", "k3", "p1", "p2"])
        d["k1"], d["k2"] = p[3], p[4]
        return p[0], p[0], p[1], p[2], d, perspective
    if cam.model == "OPENCV":
        d = zeros(["k1", "k2", "k3", "p1", "p2"])
        d["k1"], d["k2"], d["p1"], d["p2"] = p[4], p[5], p[6], p[7]
        return p[0], p[1], p[2], p[3], d, perspective
    if cam.model == "OPENCV_FISHEYE":
        d = zeros(["k1", "k2", "k3", "k4"])
        d["k1"], d["k2"], d["k3"], d["k4"] = p[4], p[5], p[6], p[7]
        return p[0], p[1], p[2], p[3], d, camera_utils.ProjectionType.FISHEYE
    raise NotImplementedError(f"unsupported COLMAP camera model {cam.model}")


def load_colmap_scene(colmap_dir: str):
    """Read and postprocess a COLMAP sparse model directory."""
    cameras, images, points3d = colmap.read_model(colmap_dir)

    names: List[str] = []
    w2c_mats, pixtocams, distortions, camtypes = [], [], [], []
    bottom = np.array([[0, 0, 0, 1.0]])
    for im in images.values():
        rot = im.qvec2rotmat()
        trans = im.tvec.reshape(3, 1)
        w2c_mats.append(np.concatenate(
            [np.concatenate([rot, trans], 1), bottom], axis=0))
        fx, fy, cx, cy, dist, camtype = _intrinsics_and_distortion(
            cameras[im.camera_id])
        pixtocams.append(np.linalg.inv(
            camera_utils.intrinsic_matrix(fx, fy, cx, cy)))
        distortions.append(dist)
        camtypes.append(camtype)
        names.append(im.name)

    poses = np.linalg.inv(np.stack(w2c_mats, axis=0))[:, :3, :4]
    # COLMAP (right, down, fwd) -> NeRF (right, up, back).
    poses = poses @ np.diag([1, -1, -1, 1])
    pixtocams = np.stack(pixtocams, axis=0)
    pts3d = (np.stack([pt.xyz for pt in points3d.values()], axis=0)
             if points3d else np.zeros((0, 3)))
    return names, poses, pixtocams, distortions, camtypes, pts3d


def sfm_points_per_image(colmap_dir: str):
    """Per-image 2-D features with their 3-D track lengths (HuGS SfM
    heuristic input, HuGS/generate_static_mask.py:293-309). Returns
    {image_name: (xys [n,2], track_lengths [n])}."""
    _, images, points3d = colmap.read_model(colmap_dir)
    track_len = {pid: len(pt.image_ids) for pid, pt in points3d.items()}
    out = {}
    for im in images.values():
        lengths = np.array([track_len.get(int(pid), 0)
                            for pid in im.point3D_ids])
        out[im.name] = (im.xys, lengths)
    return out
