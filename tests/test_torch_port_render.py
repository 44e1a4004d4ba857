"""The render slice of nerf_hugs_torch against nerf_hugs_tpu: the camera
paths (spiral, ellipse, keyframe spline, 1-D spline) on the same poses,
each loader's render-path mode (ellipse, llff's spiral, a path file,
spline keyframes, the resolution override) on the same scenes, and
`python -m nerf_hugs_torch.render` on the CPU: its frames equal the eval
driver's images of the same cameras and checkpoint, it shards frames over
jobs and resumes, it renders a spline path end to end (JAX's
tests/test_render_paths.py:89 scenario), and its model-compat check reads
the directory it restores. Paths within 1e-6 of their scale (their
largest coordinate, at least 1): JAX resamples an ellipse's angles in
float32, where one ulp of 2 pi moves a camera at radius 2.5 by 1.2e-6."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_util as tu
from nerf_hugs_torch.cameras import camera_utils as tcam
from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.eval import main as eval_main
from nerf_hugs_torch.render import main as render_main
from nerf_hugs_torch.tools import hashgrid_inputs
from nerf_hugs_torch.train import driver
from nerf_hugs_tpu.cameras import camera_utils as jcam
from nerf_hugs_tpu.configs import gin_parser as jgin
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_tpu.train import checkpoints as jcheckpoints

PATH_TOL = 1e-6


def assert_path_close(got, want, **kw):
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=PATH_TOL * max(1.0, float(np.abs(want).max())), **kw)


def lookat_poses(n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    poses = []
    for i in range(n):
        theta = 2 * np.pi * i / n + 0.1 * rs.randn()
        position = np.array([2.5 * np.cos(theta), 2.5 * np.sin(theta),
                             1.0 + 0.2 * rs.randn()])
        poses.append(tcam.viewmatrix(tcam.normalize(position),
                                     np.array([0.0, 0, 1]), position))
    return np.stack(poses)


def test_spiral_and_ellipse_paths_match_jax():
    poses = lookat_poses(9, 0)
    bounds = np.array([[0.5, 3.0], [0.7, 4.0]])
    np.testing.assert_allclose(
        tcam.generate_spiral_path(poses, bounds, n_frames=7),
        jcam.generate_spiral_path(poses, bounds, n_frames=7), atol=PATH_TOL)
    for kw in ({}, {"z_variation": 0.4, "z_phase": 0.25},
               {"const_speed": False}):
        got = tcam.generate_ellipse_path(poses, n_frames=11, **kw)
        want = jcam.generate_ellipse_path(poses, n_frames=11, **kw)
        assert got.shape == (11, 3, 4)
        assert_path_close(got, want, err_msg=str(kw))


def test_spline_paths_match_jax(tmp_path):
    poses = lookat_poses(6, 1)
    for k, s in ((5, 0.03), (1, 0.0), (3, 0.1)):
        np.testing.assert_allclose(
            tcam.generate_interpolated_path(poses, 4, spline_degree=k,
                                            smoothness=s),
            jcam.generate_interpolated_path(poses, 4, spline_degree=k,
                                            smoothness=s), atol=PATH_TOL)
    names = [f"{i:03d}" for i in range(6)]
    keyfile = tmp_path / "keys.txt"
    keyfile.write_text("\n".join(names[1:5]))
    config = tgin.parse_gin_configs([], [
        f"Config.render_spline_keyframes = '{keyfile}'",
        "Config.render_spline_n_interp = 3"])
    (idx_t, got), (idx_j, want) = (
        tcam.create_render_spline_path(config, names, poses),
        jcam.create_render_spline_path(config, names, poses))
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(got, want, atol=PATH_TOL)
    # A directory of keyframe images names them too.
    (tmp_path / "keys").mkdir()
    for name in names[:3]:
        (tmp_path / "keys" / name).write_text("")
    config.render_spline_keyframes = str(tmp_path / "keys")
    assert list(tcam.create_render_spline_path(config, names, poses)[0]) \
        == [0, 1, 2]
    with pytest.raises(ValueError, match="keyframes"):
        config.render_spline_keyframes = str(keyfile)
        tcam.create_render_spline_path(config, ["x", "y"], poses)
    x = np.sin(np.linspace(0, 3, 7))
    np.testing.assert_allclose(tcam.interpolate_1d(x, 4, 3, 0.01),
                               jcam.interpolate_1d(x, 4, 3, 0.01),
                               atol=PATH_TOL)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return {
        "kubric": hashgrid_inputs.write_kubric_scene(
            str(root / "kubric"), 3, 3, 16),
        "distractor": hashgrid_inputs.write_colmap_scene(
            str(root / "distractor"), "distractor", 3, 3, 16),
        "phototourism": hashgrid_inputs.write_colmap_scene(
            str(root / "photo"), "phototourism", 3, 3, 24),
        "llff": hashgrid_inputs.write_llff_scene(
            str(root / "llff"), True, num_images=9, size=(20, 14)),
        "llff_pca": hashgrid_inputs.write_llff_scene(
            str(root / "llff_pca"), False, num_images=9, size=(20, 14)),
        "poses": str(root / "poses.npy"), "keys": str(root / "keys.txt"),
    }


# (loader, the base keys of its tiny yaml or its gin file).
LOADERS = {
    "synthetic": {},
    "synthetic_appearance": {"dataset_type": "synthetic_appearance"},
    "kubric": {"dataset_type": "kubric", "downsample_factor": 2},
    "distractor": {"dataset_type": "distractor", "downsample_factor": 8},
    "phototourism": {"dataset_type": "phototourism",
                     "downsample_factor": 2},
    "llff": "llff_256",
    "llff_pca": "360",
}
MODES = {
    "ellipse": [],
    "resolution": ["Config.render_resolution = (12, 10)"],
    "file": ["Config.render_path_file = '{poses}'"],
    "spline": ["Config.render_spline_keyframes = '{keys}'",
               "Config.render_spline_n_interp = 2",
               "Config.render_spline_degree = 1",
               "Config.render_spline_smoothness = 0.0"],
}
CASES = [(loader, "ellipse") for loader in LOADERS] + [
    ("synthetic", "resolution"), ("synthetic", "file"),
    ("synthetic", "spline"), ("kubric", "resolution"),
    ("distractor", "spline"), ("llff", "resolution"), ("llff_pca", "file")]


def configs(loader: str, mode: str, scenes, tmp_path):
    """(port config, JAX config, data dir) of a loader in render-path
    mode: the tiny nerfacto yaml of tests/torch_port_util.py, or an llff
    gin file, with the mode's bindings."""
    bindings = ["Config.render_path = True", "Config.render_path_frames = 5",
                "Config.llffhold = 3"] + [
        b.format(**scenes) for b in MODES[mode]]
    source = LOADERS[loader]
    if isinstance(source, str):
        data = scenes[loader]
        gins = [os.path.join(tu.__file__.rsplit("/", 2)[0], "configs",
                             "mipnerf360", f"{source}.gin")]
        return (tgin.parse_gin_configs(gins, bindings),
                jgin.parse_gin_configs(gins, bindings), data)
    data = scenes.get(loader, "")
    cfg = tu.write_tiny_yaml(str(tmp_path), base=source)
    tconfig = driver.load_config(cfg, data, "ck")
    from nerf_hugs_tpu.configs import yaml_loader as jyaml
    jconfig = jyaml.load_yaml_config(cfg)
    for config in (tconfig, jconfig):
        for b in bindings:
            key, value = b[len("Config."):].split(" = ")
            setattr(config, key, eval(value))
    return tconfig, jconfig, data


@pytest.mark.parametrize("loader,mode", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_render_path_mode_matches_jax(loader, mode, scenes, tmp_path):
    """_apply_render_path on the same scene: the same poses, intrinsics,
    sizes, near and far, no images, and the same rays for a frame."""
    poses = np.tile(np.eye(4)[None], (4, 1, 1))
    poses[:, :3, 3] = np.random.RandomState(0).randn(4, 3) * 0.2
    np.save(scenes["poses"], poses)
    tconfig, jconfig, data = configs(loader, mode, scenes, tmp_path)
    plain = jax_load_dataset("test", data, _no_path(jconfig),
                             is_training=False)
    with open(scenes["keys"], "w") as f:
        f.write("\n".join(plain.image_names[:3]))
    ours = load_dataset("test", data, tconfig, is_training=False)
    theirs = jax_load_dataset("test", data, jconfig, is_training=False)
    assert ours.size == theirs.size
    assert ours.images is None and theirs.images is None
    assert_path_close(ours.camtoworlds, theirs.camtoworlds)
    np.testing.assert_array_equal(ours.pixtocams, theirs.pixtocams)
    np.testing.assert_array_equal(ours.heights, theirs.heights)
    np.testing.assert_array_equal(ours.widths, theirs.widths)
    np.testing.assert_array_equal(ours.embed_idxs, theirs.embed_idxs)
    assert ours.image_names == theirs.image_names
    if mode == "resolution":
        assert (ours.heights[0], ours.widths[0]) == (10, 12)
    frame = min(1, ours.size - 1)
    got, want = ours.generate_ray_batch(frame), theirs.generate_ray_batch(
        frame)
    assert got.rgb is None and want.rgb is None
    for name in ("origins", "directions", "viewdirs", "radii", "near", "far",
                 "static_mask", "embed_idx", "pix_coords"):
        assert_path_close(getattr(got.rays, name),
                          getattr(want.rays, name), err_msg=name)


def _no_path(jconfig):
    import dataclasses
    return dataclasses.replace(jconfig, render_path=False,
                               render_path_file=None,
                               render_spline_keyframes=None)


def tiny_run(tmp_path, base=None, model=None):
    cfg = tu.write_tiny_yaml(str(tmp_path), base={
        "early_exit_steps": 2, "eval_render_every": 0,
        "synthetic_num_images": 5, **(base or {})}, model=model)
    ckpt = tmp_path / "ckpt"
    args = ["--config", cfg, "--data_dir", str(tmp_path), "--save_dir",
            str(ckpt), "--device", "cpu"]
    driver.main(args)
    return args, ckpt


def read_png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def test_render_frames_equal_eval_shard_and_resume(tmp_path, capsys):
    # A run that ends at max_steps: the eval driver's train_frac is then
    # 1.0, the render driver's always.
    args, ckpt = tiny_run(tmp_path, base={"num_steps": 2})
    eval_main(args)
    render_main(args)
    out = capsys.readouterr().out
    assert "Rendering checkpoint at step 2." in out
    assert "render complete" in out
    frames = ckpt / "render" / "test_preds_step_2"
    for i in range(5):
        np.testing.assert_array_equal(
            read_png(frames / f"color_{i:03d}.png"),
            read_png(ckpt / "test_preds" / f"{i:03d}_color.png"))
        for kind in ("acc", "distance_mean", "distance_median"):
            assert (frames / f"{kind}_{i:03d}.tiff").exists()
    # Job 1 of 2 writes the odd frames, and a rerun skips frame 1, whose
    # job's next frame (3) exists.
    sharded = tmp_path / "sharded"
    cfg = tu.write_tiny_yaml(str(tmp_path), base={
        "early_exit_steps": 2, "num_steps": 2, "eval_render_every": 0,
        "synthetic_num_images": 5, "render_num_jobs": 2, "render_job_id": 1,
        "render_dir": str(sharded), "render_save_async": False})
    render_main(["--config", cfg] + args[2:])
    render_main(["--config", cfg] + args[2:])
    out = capsys.readouterr().out
    written = sorted(p.name for p in (sharded / "test_preds_step_2"
                                      ).glob("color_*.png"))
    assert written == ["color_001.png", "color_003.png"]
    assert "Image 1/5 already exists, skipping" in out
    assert "Image 3/5 already exists" not in out


def test_render_takes_train_frac_one_short_of_max_steps(tmp_path,
                                                       monkeypatch):
    """render.py:168 renders every frame at train_frac 1.0, also from a
    checkpoint short of max_steps (here 2 of 10000)."""
    from nerf_hugs_torch.render import driver as render_driver
    args, _ = tiny_run(tmp_path)
    seen = []
    inner = render_driver.render_image

    def spy(model, rays, train_frac, *rest):
        seen.append(train_frac)
        return inner(model, rays, train_frac, *rest)

    monkeypatch.setattr(render_driver, "render_image", spy)
    render_main(args)
    assert seen == [1.0] * 5


def test_render_spline_path_end_to_end(tmp_path):
    """JAX's tests/test_render_paths.py:89 on the port: 2 Mip-NeRF 360
    steps on the synthetic scene, then a 4-frame spline path through 3
    keyframes."""
    ckpt = tmp_path / "ckpt"
    bindings = [
        "Config.dataset_loader = 'synthetic'", "Config.batch_size = 256",
        "Config.patch_size = 1", "Config.image_num_per_batch = 2",
        "Config.near = 0.5", "Config.far = 6.0", "Config.max_steps = 2",
        "Config.checkpoint_every = 2", "Config.train_render_every = 0",
        "Config.render_chunk_size = 256", "Model.num_prop_samples = 8",
        "Model.num_nerf_samples = 4", "Model.num_levels = 2",
        "NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
        "NerfMLP.max_deg_point = 4", "PropMLP.net_depth = 2",
        "PropMLP.net_width = 16", "PropMLP.max_deg_point = 4"]
    argv = [f"--gin_bindings={b}" for b in bindings] + [
        "--data_dir=unused", f"--save_dir={ckpt}", "--device", "cpu"]
    driver.main(argv)
    plain = load_dataset("test", "", tgin.parse_gin_configs([], bindings),
                         is_training=False)
    keyfile = tmp_path / "keys.txt"
    keyfile.write_text("\n".join(plain.image_names[:3]))
    render_main(argv + [
        "--gin_bindings=Config.render_path = True",
        f"--gin_bindings=Config.render_spline_keyframes = '{keyfile}'",
        "--gin_bindings=Config.render_spline_n_interp = 2",
        "--gin_bindings=Config.render_spline_degree = 1",
        "--gin_bindings=Config.render_spline_smoothness = 0.0",
        "--gin_bindings=Config.render_video_fps = 2"])
    frames = sorted((ckpt / "render" / "path_renders_step_2").glob(
        "color_*.png"))
    assert [f.name for f in frames] == [f"color_{i:03d}.png"
                                        for i in range(4)]
    assert read_png(frames[0]).shape == (24, 32, 3)


def test_compat_check_reads_the_restored_directory(tmp_path, capsys):
    """A two-stage run writes a compat sidecar beside each stage's
    checkpoints; the render driver restores finetune/ and checks its
    sidecar, where JAX's render.py:128 checks checkpoint_dir's."""
    model = {"use_appearance_embedding": True,
             "appearance_embedding_dim": 4}
    base = {"dataset_type": "synthetic_appearance", "finetune_enable": True,
            "finetune_num_steps": 1, "finetune_batch_size": 32,
            "finetune_patch_size": 4, "finetune_num_img_per_batch": 2,
            "finetune_params": ["appearance_embedding"]}
    args, ckpt = tiny_run(tmp_path, base=base, model=model)
    sidecar = ckpt / "finetune" / "model_compat.json"
    assert json.loads(sidecar.read_text())["hash_impl"] == "xor"
    eval_main(args)
    render_main(args)
    out = capsys.readouterr().out
    # Finetune steps count on from max_steps, as render.py numbers them.
    config = driver.load_config_from_args(driver.parse_args(args))
    step = 1 + config.max_steps
    assert f"Rendering checkpoint at step {step}." in out
    frames = ckpt / "render" / f"test_preds_step_{step}"
    np.testing.assert_array_equal(read_png(frames / "color_000.png"),
                                  read_png(ckpt / "test_preds" /
                                           "000_color.png"))

    sidecar.write_text(json.dumps({"hash_impl": "add",
                                   "proposal_hash_impls": ["add"]}))
    with pytest.raises(ValueError, match="finetune"):
        render_main(args)
    # JAX's check of checkpoint_dir lets the same run through.
    from nerf_hugs_tpu.configs import yaml_loader as jyaml
    jcheckpoints.check_model_compat(str(ckpt),
                                    jyaml.load_yaml_config(args[1]))


def test_render_driver_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tu.write_tiny_yaml(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_main(["--config", cfg, "--data_dir", str(tmp_path),
                     "--save_dir", str(tmp_path / "ck")])
