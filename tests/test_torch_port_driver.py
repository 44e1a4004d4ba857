"""nerf_hugs_torch's training driver, data layer and import hygiene."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import structs

REPO = pathlib.Path(__file__).resolve().parents[1]
DRIVER_BASE = {"early_exit_steps": 3, "eval_render_every": 100}


def test_python_m_train_runs_checkpoints_and_logs(tmp_path):
    cfg = tu.write_tiny_yaml(str(tmp_path), base=DRIVER_BASE)
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_hugs_torch.train", "--config", cfg,
         "--data_dir", str(tmp_path), "--save_dir", str(ckpt),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for step in (1, 2, 3):
        assert any(line.startswith(f"[train] {step}/3: loss=")
                   and "steps/s" in line and "rays/s" in line
                   for line in lines), proc.stdout
    assert any(line.startswith("[train] 3: eval psnr=") for line in lines)
    assert (ckpt / "checkpoint_3.pt").exists()
    assert json.loads((ckpt / "model_compat.json").read_text()) == {
        "hash_impl": "xor", "proposal_hash_impls": ["xor"]}
    assert "training complete" in (ckpt / "run_log.log").read_text()
    # The run's config snapshot is JAX's config.gin (train.py:113-116).
    from nerf_hugs_tpu.configs import gin_parser, yaml_loader
    want = yaml_loader.load_yaml_config(cfg)
    want.data_dir, want.checkpoint_dir = str(tmp_path), str(ckpt)
    assert (ckpt / "config.gin").read_text() == gin_parser.config_str(want)
    assert not (ckpt / "config.json").exists()


def test_driver_resumes_and_guards_hash_impl(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    run = lambda cfg: driver.main(["--config", cfg, "--data_dir",
                                   str(tmp_path), "--save_dir", ckpt,
                                   "--device", "cpu"])
    run(tu.write_tiny_yaml(str(tmp_path), base={
        "early_exit_steps": 2, "eval_render_every": 0}))
    run(tu.write_tiny_yaml(str(tmp_path), base={
        "early_exit_steps": 4, "eval_render_every": 0}))
    out = capsys.readouterr().out
    assert "[train] 3/4: loss=" in out and "[train] 1/4" not in out
    state = torch.load(os.path.join(ckpt, "checkpoint_4.pt"),
                       weights_only=True)
    assert state["step"] == 4 and state["scheduler"]["last_epoch"] == 4
    assert {float(s["step"]) for s in state["optimizer"]["state"].values()
            } == {4.0}
    with pytest.raises(ValueError, match="hash_impl"):
        run(tu.write_tiny_yaml(str(tmp_path), base=DRIVER_BASE,
                               model={"hash_impl": "add"}))
    # A proposal-only switch is caught too.
    prop = dict(tu.TINY_MODEL["proposal_net_args_list"][0], hash_impl="add")
    with pytest.raises(ValueError, match="proposal_hash_impls"):
        run(tu.write_tiny_yaml(str(tmp_path), base=DRIVER_BASE,
                               model={"proposal_net_args_list": [prop]}))


def test_driver_never_falls_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--config", tu.write_tiny_yaml(str(tmp_path)),
                     "--data_dir", str(tmp_path), "--save_dir",
                     str(tmp_path / "ckpt"), "--device", "cuda"])


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.metrics import main as score_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tu.write_tiny_yaml(str(tmp_path))
    dirs = ["--data_dir", str(tmp_path), "--save_dir", str(tmp_path / "ck")]
    for run in (lambda: driver.main(["--config", cfg] + dirs),
                lambda: eval_main(["--config", cfg] + dirs),
                lambda: score_main(["--experiment_dir", str(tmp_path),
                                    "--scene_names", "ck"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_synthetic_data_matches_jax():
    from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
    config = tu.tiny_config()
    for split, training in (("train", True), ("test", False)):
        ours = load_dataset(split, "", config, is_training=training)
        theirs = jax_load_dataset(split, "", config, is_training=training)
        for a, b in zip(ours.images, theirs.images):
            np.testing.assert_array_equal(a, b)
        got = ours.generate_ray_batch(1)
        want = theirs.generate_ray_batch(1)
        if training:  # same seeds -> the same first random batch
            got, want = next(ours), next(theirs)
        np.testing.assert_array_equal(got.rgb, want.rgb)
        for name in ("origins", "directions", "viewdirs", "radii",
                     "pix_coords", "near", "far", "lossmult", "embed_idx"):
            np.testing.assert_allclose(getattr(got.rays, name),
                                       getattr(want.rays, name), rtol=1e-12,
                                       err_msg=name)


def test_unported_loaders_and_options_raise():
    """The reference's stub loaders raise as JAX's do, a loader neither
    package has raises JAX's ValueError, and enable_clip_near_far, once
    refused, now clips every ray to the scene's box."""
    for loader in ("tat_nerfpp", "tat_fvs", "dtu"):
        with pytest.raises(NotImplementedError, match="stub"):
            load_dataset("train", "", tu.tiny_config(
                base={"dataset_type": loader}), is_training=True)
    with pytest.raises(ValueError, match="unknown dataset_loader"):
        load_dataset("train", "", tu.tiny_config(
            base={"dataset_type": "robust"}), is_training=True)
    clipped = load_dataset("test", "", tu.tiny_config(
        base={"enable_clip_near_far": True, "bound": 0.3}),
        is_training=False).generate_ray_batch(0).rays
    plain = load_dataset("test", "", tu.tiny_config(),
                         is_training=False).generate_ray_batch(0).rays
    assert np.all(clipped.near >= plain.near)
    assert np.any(clipped.near > plain.near)


def test_render_image_is_chunk_invariant():
    config = tu.tiny_config()
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    rays = load_dataset("test", "", config, is_training=False
                        ).generate_ray_batch(0).rays
    out = render_image(model, rays, 0.5, config, "cpu")
    assert out["rgb"].shape == (16, 16, 3)
    assert out["acc"].shape == (16, 16)
    flat = rays.map(lambda r: np.asarray(r).reshape(256, -1)).to("cpu")
    with torch.no_grad():
        want, _ = model(flat, 0.5, True, None)
    np.testing.assert_allclose(out["rgb"].reshape(-1, 3),
                               want[-1]["rgb"].numpy(), rtol=1e-6, atol=1e-6)


# The port imports nothing of the JAX package, not even its jax-free
# modules: it keeps its own copies of what it needs.
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "nerf_hugs_tpu"}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "nerf_hugs_torch").rglob("*.py"))
    assert len(files) > 20
    bad = [f"{path.relative_to(REPO)}: {mod}"
           for path in files + [REPO / "chip_smoke.py"]
           for mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_structs_move_fields_to_float32_tensors():
    arrays = tu.ray_arrays(5, 0)
    arrays["origins"] = arrays["origins"].astype(np.float64)
    rays = structs.Rays(**arrays).to("cpu")
    assert rays.origins.dtype == torch.float32
    assert rays.embed_idx.dtype == torch.int32
    batch = structs.Batch(rays=structs.Rays(**arrays)).to("cpu")
    assert batch.rgb is None and batch.rays.far.shape == (5, 1)
