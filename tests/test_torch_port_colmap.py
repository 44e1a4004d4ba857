"""nerf_hugs_torch's COLMAP reader, scene manager, pose alignment, fisheye
cameras and the `distractor` and `phototourism` loaders against
nerf_hugs_tpu's, on the COLMAP models of the JAX tests
(tests/test_colmap_loaders.py::write_colmap_model) and on the procedural
captures the smoke run writes (hashgrid_inputs.write_colmap_scene)."""

import json
import os

import numpy as np
import pytest
from test_colmap_loaders import write_colmap_model, write_images

import torch_port_util as tu
from nerf_hugs_tpu.cameras import camera_utils as jcam
from nerf_hugs_tpu.cameras import colmap as jcolmap
from nerf_hugs_tpu.cameras import scene_manager as jsm
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_torch.cameras import camera_utils as tcam
from nerf_hugs_torch.cameras import colmap as tcolmap
from nerf_hugs_torch.cameras import scene_manager as tsm
from nerf_hugs_torch.data import base as tbase
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.tools import hashgrid_inputs

# A bilinear resize rounds its weights in another order than OpenCV:
# float32 rounding of values in [0, 1].
RESIZE_TOL = 1e-6
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "pix_coords",
              "near", "far", "lossmult", "static_mask", "embed_idx",
              "cam_idx")
SMALL = {"batch_size": 64, "patch_size": 4, "num_img_per_batch": 2}
FISHEYE = np.array([15.0, 15.0, 8.0, 6.0, 0.05, -0.01, 0.002, -0.0005])
OPENCV = np.array([15.0, 14.0, 8.0, 6.0, -0.03, 0.004, 0.001, -0.0005])


def set_camera(model_dir, model: str, params: np.ndarray) -> None:
    """Replace write_colmap_model's PINHOLE camera by another model."""
    cams = tcolmap.read_cameras_binary(f"{model_dir}/cameras.bin")
    cams = {k: tcolmap.Camera(k, model, c.width, c.height, params)
            for k, c in cams.items()}
    tcolmap.write_cameras_binary(cams, f"{model_dir}/cameras.bin")


def assert_batches_equal(got, want):
    np.testing.assert_allclose(np.asarray(got.rgb), np.asarray(want.rgb),
                               rtol=0, atol=RESIZE_TOL)
    for name in RAY_FIELDS:
        np.testing.assert_allclose(
            getattr(got.rays, name), getattr(want.rays, name), rtol=1e-12,
            atol=RESIZE_TOL if name == "static_mask" else 1e-12,
            err_msg=name)


def assert_datasets_equal(config, data_dir, num_train: int):
    """Every per-image array, every image's rays and the first random
    train batch of both loaders, train and test split; returns the port's
    train split."""
    out = None
    for split, training in (("train", True), ("test", False)):
        ours = load_dataset(split, data_dir, config, is_training=training)
        theirs = jax_load_dataset(split, data_dir, config,
                                  is_training=training)
        assert ours.size == theirs.size
        assert ours.image_names == theirs.image_names
        np.testing.assert_array_equal(ours.embed_idxs, theirs.embed_idxs)
        if not training:     # test rows follow the train rows
            assert int(ours.embed_idxs[0]) == num_train
        for name in ("images", "static_masks", "nears", "fars"):
            for a, b in zip(getattr(ours, name), getattr(theirs, name)):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_allclose(a, b, rtol=0, atol=RESIZE_TOL,
                                           err_msg=name)
        for name in ("camtoworlds", "pixtocams", "heights", "widths",
                     "focals"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name), name)
        for name in ("poses", "pts3d", "colmap_to_world_transform"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name), name)
        assert ours.distortion_params == theirs.distortion_params
        assert [c.value for c in ours.camtypes] == [
            c.value for c in theirs.camtypes]
        for idx in range(ours.size):
            assert_batches_equal(ours.generate_ray_batch(idx),
                                 theirs.generate_ray_batch(idx))
        if training:  # same seeds -> the same first random batch
            assert (ours._native is None) == (theirs._native is None)
            assert_batches_equal(next(ours), next(theirs))
            out = ours
    return out


def test_colmap_binary_and_text_models_read_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    model_dir = str(tmp_path / "bin")
    write_colmap_model(model_dir, 5, rng)
    set_camera(model_dir, "OPENCV", OPENCV)
    ours, theirs = tcolmap.read_model(model_dir), jcolmap.read_model(
        model_dir)
    # A text model of the same scene, written by hand in COLMAP's format.
    txt = tmp_path / "txt"
    txt.mkdir()
    cams, images, points = ours
    num = lambda v: repr(float(v))
    with open(txt / "cameras.txt", "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(map(num, c.params)) + "\n")
    with open(txt / "images.txt", "w") as f:
        for im in images.values():
            f.write(" ".join(str(v) for v in (im.id, *map(num, im.qvec),
                                              *map(num, im.tvec),
                                              im.camera_id, im.name)) + "\n")
            f.write(" ".join(f"{num(x)} {num(y)} {int(p)}" for (x, y), p in
                             zip(im.xys, im.point3D_ids)) + "\n")
    with open(txt / "points3D.txt", "w") as f:
        for pt in points.values():
            track = " ".join(f"{i} {j}" for i, j in zip(pt.image_ids,
                                                        pt.point2D_idxs))
            f.write(f"{pt.id} " + " ".join(map(num, pt.xyz)) + " "
                    + " ".join(str(int(v)) for v in pt.rgb)
                    + f" {num(pt.error)} {track}\n")
    for path in (model_dir, str(txt)):
        ours, theirs = tcolmap.read_model(path), jcolmap.read_model(path)
        for a, b in zip(ours, theirs):
            assert a.keys() == b.keys()
            for k in a:
                for field in a[k].__dataclass_fields__:
                    np.testing.assert_array_equal(
                        getattr(a[k], field), getattr(b[k], field),
                        err_msg=f"{path} {k} {field}")
    # The port's binary writers round-trip.
    out = tmp_path / "again"
    out.mkdir()
    tcolmap.write_cameras_binary(cams, str(out / "cameras.bin"))
    tcolmap.write_images_binary(images, str(out / "images.bin"))
    tcolmap.write_points3D_binary(points, str(out / "points3D.bin"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (out / name).read_bytes() == open(
            os.path.join(model_dir, name), "rb").read()
    q = tcolmap.rotmat2qvec(tcolmap.qvec2rotmat(images[1].qvec))
    np.testing.assert_allclose(q, jcolmap.rotmat2qvec(
        jcolmap.qvec2rotmat(images[1].qvec)), atol=1e-15)


@pytest.mark.parametrize("model, params", [
    ("PINHOLE", None), ("SIMPLE_RADIAL", np.array([15.0, 8, 6, 0.01])),
    ("RADIAL", np.array([15.0, 8, 6, 0.01, -0.002])), ("OPENCV", OPENCV),
    ("OPENCV_FISHEYE", FISHEYE)])
def test_load_colmap_scene_matches_jax(tmp_path, model, params):
    rng = np.random.RandomState(1)
    names = write_colmap_model(str(tmp_path), 6, rng)
    if params is not None:
        set_camera(str(tmp_path), model, params)
    ours, theirs = tsm.load_colmap_scene(str(tmp_path)), \
        jsm.load_colmap_scene(str(tmp_path))
    assert ours[0] == theirs[0] == names
    for i in (1, 2, 5):
        np.testing.assert_array_equal(ours[i], theirs[i])
    assert ours[3] == theirs[3]
    assert [c.value for c in ours[4]] == [c.value for c in theirs[4]]
    assert (ours[3][0] is None) == (model == "PINHOLE")
    with pytest.raises(NotImplementedError, match="FOV"):
        set_camera(str(tmp_path), "FOV", np.ones(5))
        tsm.load_colmap_scene(str(tmp_path))


def test_pose_alignment_matches_jax():
    rs = np.random.RandomState(2)
    poses = np.stack([tcam.viewmatrix(rs.randn(3), np.array([0, 0, 1.0]),
                                      rs.randn(3) * 2) for _ in range(9)])
    for fn in ("recenter_poses", "transform_poses_pca"):
        for a, b in zip(getattr(tcam, fn)(poses), getattr(jcam, fn)(poses)):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    for fn in ("average_pose", "focus_point_fn", "pad_poses"):
        np.testing.assert_array_equal(getattr(tcam, fn)(poses),
                                      getattr(jcam, fn)(poses), err_msg=fn)


def test_fisheye_rays_match_jax():
    pixtocam = tcam.get_pixtocam(20.0, 40, 30)
    c2w = tcam.viewmatrix(np.array([0.3, 0.2, 1.0]), np.array([0.0, 0, 1]),
                          np.array([1.0, 2.0, 0.5]))
    xg, yg = tcam.pixel_coordinates(40, 30)
    dist = {"k1": 0.05, "k2": -0.01, "k3": 0.002, "k4": -0.0005}
    fisheye = tcam.ProjectionType.FISHEYE
    for d in (None, dist):
        got = tcam.pixels_to_rays(xg, yg, pixtocam, c2w, d, camtype=fisheye)
        want = jcam.pixels_to_rays(xg, yg, pixtocam, c2w, d,
                                   camtype=jcam.ProjectionType.FISHEYE,
                                   xnp=np)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    grid = tcam.undistorted_grid(pixtocam, dist, 40, 30)
    gathered = tcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist,
                                   camtype=fisheye, undistorted=grid)
    for g, w in zip(gathered, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    perspective = tcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist)[1]
    assert np.abs(perspective - got[1]).max() > 1e-3


@pytest.mark.parametrize("camera", ["PINHOLE", "OPENCV", "OPENCV_FISHEYE"])
def test_distractor_loader_matches_jax(tmp_path, camera):
    rng = np.random.RandomState(2)
    names = write_colmap_model(str(tmp_path / "0/sparse/0"), 8, rng)
    if camera != "PINHOLE":
        set_camera(str(tmp_path / "0/sparse/0"), camera,
                   OPENCV if camera == "OPENCV" else FISHEYE)
    write_images(str(tmp_path / "0/images"), names, rng)
    os.makedirs(tmp_path / "0/static_masks")
    mask = (rng.rand(6, 8) * 255).astype(np.uint8)   # resized to 12x16
    from PIL import Image
    Image.fromarray(mask).save(tmp_path / "0/static_masks/img_001.png")
    with open(tmp_path / "0/data_split.json", "w") as f:
        json.dump({"train": names[:6], "test": names[6:]}, f)
    config = tu.tiny_config(base={**SMALL, "dataset_type": "distractor",
                                  "near": 0.2, "far": 1e6,
                                  "downsample_factor": 0})
    train = assert_datasets_equal(config, str(tmp_path), 6)
    assert np.all(np.stack(train.nears) > 0)
    assert np.all(np.stack(train.fars) == 1e6)
    assert 0 < train.static_masks[1].min() < train.static_masks[1].max() < 1
    assert train.camtypes[0].value == ("fisheye" if camera == "OPENCV_FISHEYE"
                                       else "perspective")
    # One lens and pixtocam: the grid is undistorted once.
    assert (train._undistorted is not None) == (camera != "PINHOLE")


@pytest.mark.parametrize("factor", [0, 2])
def test_phototourism_loader_matches_jax(tmp_path, factor):
    rng = np.random.RandomState(3)
    scene_dir = tmp_path / "brandenburg_gate"
    names = write_colmap_model(str(scene_dir / "dense/sparse"), 7, rng,
                               image_ext="jpg")
    write_images(str(scene_dir / "dense/images"), names, rng)
    with open(scene_dir / "brandenburg_gate.tsv", "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i, name in enumerate(names):
            f.write(f"{name}\t{i}\t{'train' if i < 5 else 'test'}\tx\n")
    config = tu.tiny_config(base={**SMALL, "dataset_type": "phototourism",
                                  "near": 1.0, "far": 2.0,
                                  "downsample_factor": factor})
    train = assert_datasets_equal(config, str(scene_dir), 5)
    assert train.images[0].shape == ((6, 8, 3) if factor else (12, 16, 3))
    # PINHOLE: no lens to undo, per ray or on a grid.
    assert train.distortion_params == [None] * 5
    assert train._undistorted is None
    assert np.all(np.stack(train.fars) > np.stack(train.nears))


def test_resize_matches_opencv_within_float_rounding():
    """The deliberate divergence: the phototourism downscale and the
    static-mask resize go through torch's bilinear interpolation, JAX's
    through cv2.resize."""
    import cv2
    rs = np.random.RandomState(4)
    for shape, size in (((24, 32, 3), (12, 16)), ((17, 23, 3), (9, 11)),
                        ((767, 1023, 3), (383, 511)),
                        ((12, 16, 1), (24, 32))):
        image = rs.rand(*shape).astype(np.float32)
        got = tbase.resize_bilinear(image, *size)
        want = cv2.resize(image, size[::-1])
        want = want.reshape(got.shape)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("layout", ["distractor", "phototourism"])
def test_written_colmap_scene_loads_in_both_packages(tmp_path, layout):
    """The smoke run's capture writer at a toy size: both loaders read the
    same images, masks, nears, fars and rays from it; the near/far come
    from the sphere's points; each train frame carries a distractor
    square marked in its mask."""
    data_dir = hashgrid_inputs.write_colmap_scene(
        str(tmp_path), layout, num_train=3, num_test=2, size=32)
    spec = hashgrid_inputs.COLMAP_LAYOUTS[layout]
    config = tu.tiny_config(base={
        **SMALL, "dataset_type": layout, "downsample_factor": spec["factor"],
        "near": 0.01, "far": 1000.0})
    train = assert_datasets_equal(config, data_dir, 3)
    side = 32 if layout == "distractor" else 16
    assert train.images[0].shape == (side, side, 3)
    assert all(0.0 < m.mean() < 1.0 for m in train.static_masks)
    nears = np.array([n[0, 0, 0] for n in train.nears])
    fars = np.array([f[0, 0, 0] for f in train.fars])
    # The cameras sit at about 1 from the sphere of radius ~0.2.
    assert np.all((nears > 0.4) & (nears < 1.0))
    if layout == "phototourism":
        assert np.all((fars > 1.0) & (fars < 1.6))
        assert len({float(p[0, 0]) for p in train.pixtocams}) == 3
    else:
        assert np.all(fars == 1000.0)
        assert train._undistorted is not None
