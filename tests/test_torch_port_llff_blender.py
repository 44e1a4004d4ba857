"""The llff and blender loaders, NDC and core/rayops.py of nerf_hugs_torch
against nerf_hugs_tpu: the llff rays of tests/test_colmap_loaders.py:18's
model and of the port's llff writer, forward-facing through NDC and
PCA-aligned (the splits, the images_{factor} name map, static masks,
poses_bounds.npy, llff_use_all_images_for_training), blender on
tests/test_data.py:120's scene in both compositing dialects and at a
downsample factor, the ray-box and ray-sphere intersections and
enable_clip_near_far; then llff_256.gin, 360.gin and blender_256.gin
driven at toy widths through the train and eval drivers, and the render
driver over the llff run with render_config.gin (the spiral path). Rays
within 1e-12, images exactly."""

import os
import pathlib

import numpy as np
import pytest
from PIL import Image

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_torch.cameras import camera_utils as tcam
from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.core import rayops as trayops
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.eval import main as eval_main
from nerf_hugs_torch.metrics import image as timage
from nerf_hugs_torch.render import main as render_main
from nerf_hugs_torch.tools.hashgrid_inputs import (write_blender_scene,
                                                   write_llff_scene)
from nerf_hugs_torch.train import driver
from nerf_hugs_tpu.cameras import camera_utils as jcam
from nerf_hugs_tpu.configs import gin_parser as jgin
from nerf_hugs_tpu.core import rayops as jrayops
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_tpu.metrics import image as jimage
from test_colmap_loaders import write_colmap_model, write_images
from test_data import make_fake_blender_scene

RAY_TOL = 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]
GIN = REPO / "configs" / "mipnerf360"
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "near", "far",
              "pix_coords", "static_mask", "embed_idx", "lossmult")
# Toy widths for the shipped gins (tests/test_torch_port_mipnerf360_
# driver.py's), 2 steps.
TINY = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
        "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
        "NerfMLP.net_width_viewdirs = 16", "PropMLP.net_depth = 2",
        "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
        "Model.num_nerf_samples = 4", "Config.batch_size = 256",
        "Config.render_chunk_size = 512", "Config.max_steps = 2",
        "Config.print_every = 1", "Config.train_render_every = 0",
        "Config.checkpoint_every = 2", "Config.llffhold = 3"]


def both(gins, bindings):
    """(port config, JAX config) of the gin files and bindings."""
    paths = [str(GIN / f"{g}.gin") for g in gins]
    return (tgin.parse_gin_configs(paths, bindings),
            jgin.parse_gin_configs(paths, bindings))


def assert_splits_equal(data_dir: str, tconfig, jconfig):
    for split, training in (("train", True), ("test", False)):
        ours = load_dataset(split, data_dir, tconfig, is_training=training)
        theirs = jax_load_dataset(split, data_dir, jconfig,
                                  is_training=training)
        assert ours.size == theirs.size and ours.size > 0
        assert ours.image_names == theirs.image_names
        np.testing.assert_array_equal(ours.embed_idxs, theirs.embed_idxs)
        np.testing.assert_array_equal(ours.camtoworlds, theirs.camtoworlds)
        for a, b in zip(ours.images, theirs.images):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.static_masks, theirs.static_masks):
            np.testing.assert_array_equal(a, b)
        if theirs.pixtocam_ndc is None:
            assert ours.pixtocam_ndc is None
        else:
            np.testing.assert_array_equal(ours.pixtocam_ndc,
                                          theirs.pixtocam_ndc)
        if training:  # the same seeds: the same first random batch
            got, want = next(ours), next(theirs)
        else:
            got, want = (ours.generate_ray_batch(ours.size - 1),
                         theirs.generate_ray_batch(theirs.size - 1))
        np.testing.assert_array_equal(got.rgb, want.rgb)
        for name in RAY_FIELDS:
            np.testing.assert_allclose(
                getattr(got.rays, name), getattr(want.rays, name),
                rtol=RAY_TOL, atol=RAY_TOL, err_msg=f"{split} {name}")
    return ours


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    """tests/test_colmap_loaders.py's model of 9 images (12 x 16 in
    images/), their halves in images_2/ under other file names, a static
    mask for one of them, and a poses_bounds.npy."""
    root = tmp_path_factory.mktemp("llff")
    rng = np.random.RandomState(1)
    names = write_colmap_model(str(root / "sparse/0"), 9, rng)
    write_images(str(root / "images"), names, rng)
    os.makedirs(root / "images_2")
    os.makedirs(root / "static_masks")
    for i, name in enumerate(sorted(names)):
        img = Image.open(root / "images" / name).resize((8, 6))
        img.save(root / "images_2" / f"frame_{i:02d}.png")
    mask = np.full((6, 8), 255, np.uint8)
    mask[:3, :4] = 0
    Image.fromarray(mask).save(root / "static_masks" / "frame_04.png")
    bounds = np.concatenate([rng.rand(9, 15), np.stack(
        [1.5 + rng.rand(9), 5 + rng.rand(9)], -1)], -1)
    np.save(root / "poses_bounds.npy", bounds)
    return str(root)


@pytest.mark.parametrize("forward_facing", [True, False],
                         ids=["ndc", "pca"])
@pytest.mark.parametrize("factor", [0, 2])
def test_llff_rays_match_jax(colmap_scene, forward_facing, factor):
    tconfig, jconfig = both([], [
        "Config.dataset_loader = 'llff'", f"Config.factor = {factor}",
        f"Config.forward_facing = {forward_facing}", "Config.near = 0.0",
        "Config.far = 1.0", "Config.llffhold = 3", "Config.batch_size = 32",
        "Config.image_num_per_batch = 2", "Config.patch_size = 2"])
    ours = assert_splits_equal(colmap_scene, tconfig, jconfig)
    assert (ours.pixtocam_ndc is not None) == forward_facing
    if factor:
        assert ours.images[0].shape == (6, 8, 3)
        assert ours.image_names[0].startswith("frame_")


def test_llff_all_images_for_training(colmap_scene):
    tconfig, jconfig = both([], [
        "Config.dataset_loader = 'llff'", "Config.llffhold = 3",
        "Config.llff_use_all_images_for_training = True",
        "Config.batch_size = 32", "Config.image_num_per_batch = 2"])
    ours = assert_splits_equal(colmap_scene, tconfig, jconfig)
    assert ours.size == 3
    assert load_dataset("train", colmap_scene, tconfig,
                        is_training=True).size == 9


@pytest.mark.parametrize("forward_facing", [True, False],
                         ids=["ndc", "pca"])
def test_written_llff_capture_matches_jax(tmp_path, forward_facing):
    """The smoke run's writer at a toy size, read by both loaders with
    llff_256.gin (NDC) or 360.gin (PCA)."""
    root = write_llff_scene(str(tmp_path), forward_facing, num_images=8,
                            size=(16, 12))
    gin = "llff_256" if forward_facing else "360"
    tconfig, jconfig = both([gin], ["Config.llffhold = 3",
                                    "Config.batch_size = 32",
                                    "Config.image_num_per_batch = 2"])
    ours = assert_splits_equal(root, tconfig, jconfig)
    rays = ours.generate_ray_batch(0).rays
    if forward_facing:
        # NDC: every ray starts on the near plane z = -1.
        np.testing.assert_allclose(rays.origins[..., 2], -1.0, atol=1e-12)


def test_convert_to_ndc_matches_jax():
    rs = np.random.RandomState(4)
    origins = rs.randn(50, 3) * 0.1
    directions = rs.randn(50, 3) - np.array([0, 0, 2.0])
    pixtocam = tcam.get_pixtocam(40.0, 32, 24)
    for got, want in zip(tcam.convert_to_ndc(origins, directions, pixtocam),
                         jcam.convert_to_ndc(origins, directions, pixtocam,
                                             xnp=np)):
        np.testing.assert_allclose(got, want, rtol=RAY_TOL, atol=RAY_TOL)


@pytest.mark.parametrize("dialect", ["mipnerf360", "nerfacto"])
@pytest.mark.parametrize("factor", [1, 2])
def test_blender_matches_jax(tmp_path, dialect, factor):
    """White compositing at load for mipnerf360, RGBA kept for nerfacto
    (JAX blender.py:46-55), focal from camera_angle_x, train and test
    embedding offsets, the area downsample."""
    h, w = make_fake_blender_scene(str(tmp_path))
    bindings = ["Config.dataset_loader = 'blender'", f"Config.factor = "
                f"{factor}", f"Config.model_type = '{dialect}'",
                "Config.near = 2.0", "Config.far = 6.0",
                "Config.batch_size = 32", "Config.image_num_per_batch = 2"]
    tconfig, jconfig = both([], bindings)
    ours = assert_splits_equal(str(tmp_path), tconfig, jconfig)
    assert ours.images[0].shape == (h // factor, w // factor,
                                    3 if dialect == "mipnerf360" else 4)
    assert list(ours.embed_idxs) == [3, 4]
    with pytest.raises(ValueError, match="render_path"):
        tconfig.render_path = True
        load_dataset("test", str(tmp_path), tconfig, is_training=False)


def test_downsample_matches_jax():
    img = np.random.RandomState(5).rand(12, 16, 4)
    np.testing.assert_array_equal(timage.downsample(img, 4),
                                  np.asarray(jimage.downsample(img, 4)))
    with pytest.raises(ValueError, match="divide"):
        timage.downsample(img, 5)


def test_rayops_match_jax():
    rs = np.random.RandomState(6)
    o = rs.randn(200, 3) * 2
    d = rs.randn(200, 3)
    d[:5, 0] = 0.0      # axis-parallel rays
    aabb = np.array([[-1.0, -0.5, -1.0], [1.0, 0.5, 1.0]])
    for got, want in zip(trayops.intersect_aabb(aabb, o, d),
                         jrayops.intersect_aabb(aabb, o, d)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(trayops.intersect_sphere(np.zeros(3), 0.7, o, d),
                         jrayops.intersect_sphere(np.zeros(3), 0.7, o, d)):
        np.testing.assert_array_equal(got, want)
    near = np.full((200, 1), 0.1)
    far = np.full((200, 1), 8.0)
    got = trayops.clip_near_far_to_aabb(o, d, near, far, 1.0)
    want = jrayops.clip_near_far_to_aabb(o, d, near, far, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.any(got[0] > 0.1) and np.any(got[1] < 8.0)


def test_clip_near_far_matches_jax(tmp_path):
    """enable_clip_near_far on a loader: the same clipped rays as JAX's,
    in the test batches and the train batches (the cameras at radius 4
    look at the box of bound 1)."""
    write_blender_scene(str(tmp_path), 3, 2, 16)
    tconfig, jconfig = both([], [
        "Config.dataset_loader = 'blender'", "Config.near = 0.5",
        "Config.far = 9.0", "Config.enable_clip_near_far = True",
        "Config.bound = 1.0", "Config.batch_size = 32",
        "Config.image_num_per_batch = 2"])
    assert_splits_equal(str(tmp_path), tconfig, jconfig)
    rays = load_dataset("test", str(tmp_path), tconfig,
                        is_training=False).generate_ray_batch(0).rays
    assert np.any(rays.near > 0.5) and np.any(rays.far < 9.0)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("written")
    return {"llff": write_llff_scene(str(root / "llff"), True,
                                     num_images=8, size=(16, 12)),
            "360": write_llff_scene(str(root / "pca"), False, num_images=8,
                                    size=(16, 12)),
            "blender": write_blender_scene(str(root / "blender"), 3, 2, 16)}


def gin_args(gins, data_dir, ckpt, *extra) -> list:
    return [f"--gin_configs={GIN / g}.gin" for g in gins] + [
        f"--gin_bindings=Config.data_dir = '{data_dir}'",
        f"--gin_bindings=Config.checkpoint_dir = '{ckpt}'"] + [
        f"--gin_bindings={b}" for b in TINY + list(extra)] + [
        "--device", "cpu"]


@pytest.mark.parametrize("gin,scene", [("llff_256", "llff"),
                                       ("360", "360"),
                                       ("blender_256", "blender")])
def test_shipped_gins_train_and_evaluate(written, tmp_path, gin, scene,
                                         capsys):
    ckpt = tmp_path / "ckpt"
    extra = ["Config.image_num_per_batch = 1"] if scene == "blender" else []
    driver.main(gin_args([gin], written[scene], ckpt, *extra))
    out = capsys.readouterr().out
    assert "[train] 2/2: loss=" in out and (ckpt / "checkpoint_2.pt").exists()
    eval_main(gin_args([gin], written[scene], ckpt,
                       "Config.eval_dataset_limit = 1", *extra))
    out = capsys.readouterr().out
    assert "mean: psnr=" in out
    assert (ckpt / "test_preds" / "000_color.png").exists()
    if gin != "llff_256":
        return
    # The render driver over the llff run with render_config.gin: the
    # forward-facing spiral of llff.py, render_path_frames frames.
    render_main(gin_args([gin, "render_config"], written[scene], ckpt,
                         "Config.render_path_frames = 3",
                         "Config.render_save_async = False"))
    frames = sorted((ckpt / "render" / "path_renders_step_2").glob(
        "color_*.png"))
    assert [f.name for f in frames] == ["color_000.png", "color_001.png",
                                        "color_002.png"]
    assert np.asarray(Image.open(frames[0])).shape == (12, 16, 3)
