"""Self-contained COLMAP sparse-model reader and writer (binary and text).

The port's copy of nerf_hugs_tpu/cameras/colmap.py. Parses cameras,
images and points3D into plain dataclasses, without the pycolmap
submodule the reference leaves unvendored. The format follows COLMAP's
src/base/reconstruction.cc; the behaviour follows HuGS/colmap_utils.py:
38-295. A binary file is read into one buffer and parsed with
struct.unpack_from, and np.frombuffer for the variable-length tracks. The
binary writers serve the round-trip tests and the generated scenes.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params); COLMAP's camera model registry.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray          # [n, 2] feature pixel coords
    point3D_ids: np.ndarray  # [n] int64, -1 where unmatched

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Hamilton-convention (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z) quaternion via the Shepperd eigen-solve."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    q = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return -q if q[0] < 0 else q


# ---------------------------------------------------------------------------
# Binary readers (one buffer, moving offset).
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    (count,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    cameras = {}
    for _ in range(count):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        name, n_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(buf, dtype="<f8", count=n_params, offset=off)
        off += 8 * n_params
        cameras[cam_id] = Camera(cam_id, name, width, height, params.copy())
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    with open(path, "rb") as f:
        buf = f.read()
    (count,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    images = {}
    for _ in range(count):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        img_id, camera_id = vals[0], vals[8]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (n_pts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(buf, dtype="<f8", count=3 * n_pts, offset=off
                            ).reshape(n_pts, 3)
        xys = rec[:, :2].copy()
        pt_ids = rec[:, 2:].copy().view("<i8").reshape(n_pts)
        off += 24 * n_pts
        images[img_id] = Image(img_id, qvec, tvec, camera_id, name, xys, pt_ids)
    return images


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    (count,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    points = {}
    for _ in range(count):
        pt_id, x, y, z, r, g, b, error = struct.unpack_from("<QdddBBBd", buf, off)
        off += 43
        (track_len,) = struct.unpack_from("<Q", buf, off)
        off += 8
        track = np.frombuffer(buf, dtype="<i4", count=2 * track_len, offset=off
                              ).reshape(track_len, 2)
        off += 8 * track_len
        points[pt_id] = Point3D(pt_id, np.array([x, y, z]), np.array([r, g, b]),
                                error, track[:, 0].copy(), track[:, 1].copy())
    return points


# ---------------------------------------------------------------------------
# Text readers.
# ---------------------------------------------------------------------------

def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        cameras[cam_id] = Camera(cam_id, parts[1], int(parts[2]), int(parts[3]),
                                 np.array([float(p) for p in parts[4:]]))
    return cameras


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    lines = list(_data_lines(path))
    for head, feat in zip(lines[0::2], lines[1::2]):
        parts = head.split()
        img_id = int(parts[0])
        qvec = np.array([float(v) for v in parts[1:5]])
        tvec = np.array([float(v) for v in parts[5:8]])
        camera_id, name = int(parts[8]), parts[9]
        fvals = feat.split()
        xys = np.array([[float(x), float(y)]
                        for x, y in zip(fvals[0::3], fvals[1::3])]
                       ).reshape(-1, 2)
        pt_ids = np.array([int(v) for v in fvals[2::3]], dtype=np.int64)
        images[img_id] = Image(img_id, qvec, tvec, camera_id, name, xys, pt_ids)
    return images


def read_points3D_text(path: str) -> Dict[int, Point3D]:
    points = {}
    for line in _data_lines(path):
        parts = line.split()
        pt_id = int(parts[0])
        points[pt_id] = Point3D(
            pt_id,
            np.array([float(v) for v in parts[1:4]]),
            np.array([int(v) for v in parts[4:7]]),
            float(parts[7]),
            np.array([int(v) for v in parts[8::2]]),
            np.array([int(v) for v in parts[9::2]]))
    return points


def read_model(path: str, ext: str = None
               ) -> Tuple[Dict[int, Camera], Dict[int, Image], Dict[int, Point3D]]:
    """Read a COLMAP sparse model dir; autodetects .bin vs .txt if ext=None."""
    if ext is None:
        ext = ".bin" if os.path.exists(os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3D_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3D_text(os.path.join(path, "points3D.txt")))


# ---------------------------------------------------------------------------
# Binary writers (round-trip tests + synthetic fixtures).
# ---------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            f.write(struct.pack("<iiQQ", cam.id, _MODEL_IDS[cam.model],
                                cam.width, cam.height))
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            rec = np.empty((n, 3), dtype="<f8")
            rec[:, :2] = im.xys
            rec[:, 2:] = np.asarray(im.point3D_ids, dtype="<i8"
                                    ).view("<f8").reshape(n, 1)
            f.write(rec.tobytes())


def write_points3D_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<QdddBBBd", pt.id, *pt.xyz,
                                *np.asarray(pt.rgb, dtype=np.uint8), pt.error))
            n = len(pt.image_ids)
            f.write(struct.pack("<Q", n))
            track = np.empty((n, 2), dtype="<i4")
            track[:, 0] = pt.image_ids
            track[:, 1] = pt.point2D_idxs
            f.write(track.tobytes())
