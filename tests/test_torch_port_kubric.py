"""nerf_hugs_torch's kubric loader, lens distortion and distractor scenes
against nerf_hugs_tpu's, on the fake kubric scene of the JAX tests
(tests/test_data.py::make_fake_kubric_scene) and on the procedural scene
that the smoke run writes in the kubric layout."""

import numpy as np
import pytest
from PIL import Image
from test_data import make_fake_kubric_scene

import torch_port_util as tu
from nerf_hugs_tpu.cameras import camera_utils as jcam
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_torch.cameras import camera_utils as tcam
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.tools import hashgrid_inputs

# Bilinear mask resizing, torch against OpenCV: float32 rounding of
# values in [0, 1].
MASK_TOL = 1e-6
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "pix_coords",
              "near", "far", "lossmult", "static_mask", "embed_idx",
              "cam_idx")
KUBRIC = {"dataset_type": "kubric", "batch_size": 64, "patch_size": 4,
          "num_img_per_batch": 2}


def assert_batches_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.rgb), np.asarray(want.rgb))
    for name in RAY_FIELDS:
        np.testing.assert_allclose(
            getattr(got.rays, name), getattr(want.rays, name), rtol=1e-12,
            atol=MASK_TOL if name == "static_mask" else 1e-12, err_msg=name)


def assert_datasets_equal(config, data_dir):
    """Every per-image array, every image's rays and the first random
    train batch of both loaders, train and test split."""
    for split, training in (("train", True), ("test", False)):
        ours = load_dataset(split, data_dir, config, is_training=training)
        theirs = jax_load_dataset(split, data_dir, config,
                                  is_training=training)
        assert ours.size == theirs.size
        assert ours.image_names == theirs.image_names
        np.testing.assert_array_equal(ours.embed_idxs, theirs.embed_idxs)
        for name in ("images", "static_masks", "nears", "fars"):
            for a, b in zip(getattr(ours, name), getattr(theirs, name)):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                # A resized mask rounds the bilinear weights in another
                # order than OpenCV; everything else is equal.
                np.testing.assert_allclose(a, b, rtol=0, atol=MASK_TOL,
                                           err_msg=name)
        for name in ("camtoworlds", "pixtocams", "heights", "widths"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name), name)
        assert ours.distortion_params == theirs.distortion_params
        for idx in range(ours.size):
            assert_batches_equal(ours.generate_ray_batch(idx),
                                 theirs.generate_ray_batch(idx))
        if training:  # same seeds -> the same first random batch
            assert (ours._native is None) == (theirs._native is None)
            assert_batches_equal(next(ours), next(theirs))
        else:
            assert int(ours.generate_ray_batch(0).rays.embed_idx[0, 0, 0]) \
                == 3  # test rows follow the 3 train rows


@pytest.mark.parametrize("rgba, model_type", [
    (False, "nerfacto"), (True, "nerfacto"), (True, "mipnerf360")])
def test_kubric_loader_matches_jax(tmp_path, rgba, model_type):
    make_fake_kubric_scene(str(tmp_path), rgba=rgba)
    config = tu.tiny_config(base={**KUBRIC, "model_type": model_type})
    assert_datasets_equal(config, str(tmp_path))
    train = load_dataset("train", str(tmp_path), config, is_training=True)
    assert train.images[0].shape[-1] == (4 if rgba and model_type ==
                                         "nerfacto" else 3)
    assert train._undistorted is not None
    # The far plane is the scene's 3.0 scaled by 1.2.
    np.testing.assert_allclose(train.fars[0], 3.6, rtol=1e-6)


def test_kubric_static_masks_match_jax(tmp_path):
    """Masks from static_masks/ (train) and freeze-test/static_masks/
    (test), grey and RGB, at the image's size and at another size, which
    both loaders resize bilinearly (JAX through OpenCV)."""
    h, w = make_fake_kubric_scene(str(tmp_path))
    rs = np.random.RandomState(4)
    masks = {"static_masks/00000.png": (h, w),
             "static_masks/00002.png": (2 * h + 3, w - 7),
             "freeze-test/static_masks/10001.png": (h // 2, 3 * w)}
    for i, (path, shape) in enumerate(masks.items()):
        (tmp_path / path).parent.mkdir(parents=True, exist_ok=True)
        pixels = (rs.rand(*shape, 3) * 255).astype(np.uint8)
        Image.fromarray(pixels[..., 0] if i == 1 else pixels).save(
            tmp_path / path)
    config = tu.tiny_config(base=KUBRIC)
    assert_datasets_equal(config, str(tmp_path))
    train = load_dataset("train", str(tmp_path), config, is_training=True)
    assert train.static_masks[1].min() == 1.0     # no file: all static
    assert train.static_masks[2].shape == (h, w, 1)
    assert 0.0 <= train.static_masks[2].min() < train.static_masks[2].max()


def test_undistort_and_distorted_rays_match_jax():
    rs = np.random.RandomState(0)
    xd, yd = rs.uniform(-0.6, 0.6, (2, 500))
    params = dict(k1=-0.08, k2=0.02, k3=-0.004, k4=0.001, p1=0.003,
                  p2=-0.002)
    got = tcam.radial_and_tangential_undistort(xd, yd, **params)
    want = jcam.radial_and_tangential_undistort(xd, yd, **params, xnp=np)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # Undistorting the distorted point gives the point back.
    x, y = rs.uniform(-0.4, 0.4, (2, 100))
    fx, fy = tcam._distortion_residual_and_jacobian(x, y, 0.0, 0.0,
                                                    **params)[:2]
    back = tcam.radial_and_tangential_undistort(fx, fy, **params)
    np.testing.assert_allclose(back, (x, y), atol=1e-9)

    pixtocam = tcam.get_pixtocam(30.0, 40, 30)
    c2w = tcam.viewmatrix(np.array([0.3, 0.2, 1.0]), np.array([0.0, 0, 1]),
                          np.array([1.0, 2.0, 0.5]))
    xg, yg = tcam.pixel_coordinates(40, 30)
    dist = {"k1": 0.05, "k2": -0.01, "k3": 0.0, "p1": 0.002, "p2": 0.001}
    got = tcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist)
    want = jcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist, xnp=np)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    plain = tcam.pixels_to_rays(xg, yg, pixtocam, c2w)
    assert not np.allclose(plain[1], got[1])
    # NDC (forward-facing llff) casts as JAX does.
    got = tcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist,
                              pixtocam_ndc=pixtocam)
    want = jcam.pixels_to_rays(xg, yg, pixtocam, c2w, dist,
                               pixtocam_ndc=pixtocam, xnp=np)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_undistorted_grid_matches_the_per_ray_solve():
    """A split with one pixtocam and lens gathers its rays' undistorted
    directions from a grid solved once; they equal the per-ray solve."""
    w, h = 23, 17
    pixtocam = tcam.get_pixtocam(19.0, w, h)
    dist = {"k1": -0.04, "k2": 0.01, "k3": 0.002, "p1": 0.003, "p2": -0.001}
    grid = tcam.undistorted_grid(pixtocam, dist, w, h)
    assert grid.shape == (h + 1, w + 1, 2)
    c2w = tcam.viewmatrix(np.array([0.3, 0.2, 1.0]), np.array([0.0, 0, 1]),
                          np.array([1.0, 2.0, 0.5]))
    rs = np.random.RandomState(2)
    px, py = rs.randint(0, w, 200), rs.randint(0, h, 200)
    px[:2], py[:2] = w - 1, h - 1     # the last column and row
    solved = tcam.pixels_to_rays(px, py, pixtocam, c2w, dist)
    gathered = tcam.pixels_to_rays(px, py, pixtocam, c2w, dist,
                                   undistorted=grid)
    for a, b in zip(gathered, solved):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_synthetic_distractor_matches_jax():
    config = tu.tiny_config(base={"dataset_type": "synthetic_distractor"})
    for split, training in (("train", True), ("test", False)):
        ours = load_dataset(split, "", config, is_training=training)
        theirs = jax_load_dataset(split, "", config, is_training=training)
        for name in ("images", "static_masks"):
            for a, b in zip(getattr(ours, name), getattr(theirs, name)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        transient = sum(int((m == 0).sum()) for m in ours.static_masks)
        # One 4x4 square (16 // 4) per train image, none in the test views.
        assert transient == (4 * 16 if training else 0)
        got = next(ours) if training else ours.generate_ray_batch(1)
        want = next(theirs) if training else theirs.generate_ray_batch(1)
        assert_batches_equal(got, want)


def test_registry_names_the_ported_loaders():
    for loader in ("kubric", "synthetic", "synthetic_distractor", "llff",
                   "blender", "synthetic_appearance"):
        assert loader in str(pytest.raises(
            ValueError, load_dataset, "train", "",
            tu.tiny_config(base={"dataset_type": "robust"}),
            is_training=True).value)


def test_written_kubric_scene_loads_in_both_packages(tmp_path):
    """The smoke run's scene writer at a toy size: both loaders read the
    same rays, images and masks from it, its lens bends the rays, and each
    train frame carries one distractor square marked in its mask."""
    root = hashgrid_inputs.write_kubric_scene(str(tmp_path), num_train=3,
                                              num_test=2, size=16)
    config = tu.tiny_config(base={
        **KUBRIC, "downsample_factor": hashgrid_inputs.SCENE_FACTOR})
    assert_datasets_equal(config, root)
    train = load_dataset("train", root, config, is_training=True)
    assert train.images[0].shape == (16, 16, 3)
    assert all(int((m == 0).sum()) == 16 for m in train.static_masks)
    # One lens and pixtocam for every frame: the native sampler, and the
    # pixel grid undistorted once.
    assert train._native is not None and train._undistorted is not None
    np.testing.assert_allclose(train.nears[0], 0.1)
    np.testing.assert_allclose(train.fars[0], 2.0, rtol=1e-6)
    pixtocam = train.pixtocams[0]
    xg, yg = tcam.pixel_coordinates(16, 16)
    bent = tcam.pixels_to_rays(xg, yg, pixtocam, train.camtoworlds[0],
                               train.distortion_params[0])[1]
    straight = tcam.pixels_to_rays(xg, yg, pixtocam, train.camtoworlds[0])[1]
    assert 1e-6 < np.abs(bent - straight).max() < 0.1
