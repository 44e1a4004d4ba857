"""nerf_hugs_torch's eval slice against nerf_hugs_tpu: SSIM, PSNR, colour
correction, LPIPS, the chunked render of a fused-MLP model, the eval
metric pipeline, the eval driver and the scoring CLI, on the CPU at toy
sizes."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_tpu.configs.config import Config
from nerf_hugs_tpu.metrics import image as jimage
from nerf_hugs_tpu.metrics import lpips as jlpips
from nerf_hugs_tpu.metrics import ssim as jssim
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import render_image as jrender
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_tpu.utils import io as nh_io
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.eval import driver as eval_driver
from nerf_hugs_torch.metrics import image as timage
from nerf_hugs_torch.metrics import lpips as tlpips
from nerf_hugs_torch.metrics import main as score_main
from nerf_hugs_torch.metrics import ssim as tssim
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import driver as train_driver
from nerf_hugs_torch.train.render_image import render_image

REPO = pathlib.Path(__file__).resolve().parents[1]
FUSED_MODEL = {"enable_tcnn_mlp": True, "proposal_net_args_list": [
    dict(tu.TINY_MODEL["proposal_net_args_list"][0], enable_tcnn_mlp=True)]}


def image_pair(seed, h=32, w=40, noise=0.05):
    rs = np.random.RandomState(seed)
    img = rs.rand(h, w, 3).astype(np.float32)
    other = np.clip(img + rs.randn(h, w, 3) * noise, 0, 1).astype(np.float32)
    return img, other


def test_ssim_identity_ordering_and_jax_values():
    # tests/test_metrics.py::test_ssim_identity_and_ordering, carried over.
    rs = np.random.RandomState(1)
    img = rs.rand(32, 32, 3).astype(np.float32)
    assert float(tssim.ssim(img, img)) == pytest.approx(1.0, abs=1e-5)
    near = np.clip(img + rs.randn(32, 32, 3) * 0.02, 0, 1)
    far = np.clip(img + rs.randn(32, 32, 3) * 0.3, 0, 1)
    assert float(tssim.ssim(img, near)) > float(tssim.ssim(img, far))
    for a, b in [(img, near), (img, far), image_pair(2), image_pair(3)]:
        np.testing.assert_allclose(float(tssim.ssim(a, b)),
                                   float(jssim.ssim(a, b)), rtol=0,
                                   atol=1e-6)
    # Per pixel, sigma = E[x^2] - mu^2 cancels, which lifts the fp32
    # differences of the two convolutions' summation orders to ~2e-6.
    gray_a, gray_b = image_pair(4)
    np.testing.assert_allclose(
        tssim.ssim(gray_a[..., 0], gray_b[..., 0], return_map=True).numpy(),
        np.asarray(jssim.ssim(gray_a[..., 0], gray_b[..., 0],
                              return_map=True)), rtol=0, atol=1e-5)
    # Narrower than the window: the JAX twin averages an empty map to NaN,
    # the port refuses the image.
    assert np.isnan(float(jssim.ssim(img[:8], img[:8])))
    with pytest.raises(ValueError, match="at least 11 px"):
        tssim.ssim(img[:8], img[:8])


def test_psnr_roundtrip():
    # tests/test_metrics.py::test_psnr_roundtrip, carried over.
    mse = 1e-3
    psnr = float(timage.mse_to_psnr(mse))
    np.testing.assert_allclose(float(timage.psnr_to_mse(psnr)), mse,
                               rtol=1e-5)
    np.testing.assert_allclose(psnr, 30.0, atol=0.01)
    np.testing.assert_allclose(psnr, float(jimage.mse_to_psnr(mse)),
                               rtol=1e-6)


def test_color_correct_fixes_affine_shift_like_jax():
    # tests/test_metrics.py::test_color_correct_fixes_affine_shift.
    rs = np.random.RandomState(0)
    ref = rs.rand(32, 32, 3).astype(np.float32) * 0.8 + 0.1
    img = np.clip(ref * 0.7 + 0.1, 0, 1).astype(np.float32)
    corrected = timage.color_correct(img, ref)
    before = float(np.mean((img - ref) ** 2))
    after = float(np.mean((corrected - ref) ** 2))
    assert after < before * 0.05
    assert corrected.dtype == np.float32
    np.testing.assert_array_equal(corrected, jimage.color_correct(img, ref))
    rgba = np.concatenate([img, rs.rand(32, 32, 1).astype(np.float32)], -1)
    np.testing.assert_array_equal(timage.composite_alpha(rgba, 0.5),
                                  jimage.composite_alpha(rgba, 0.5))


def test_lpips_random_init_matches_jax():
    rs = np.random.RandomState(0)
    img0 = rs.rand(64, 64, 3).astype(np.float32)
    img1 = rs.rand(64, 64, 3).astype(np.float32)
    ours, theirs = tlpips.LPIPS.random_init(0), jlpips.LPIPS.random_init(0)
    for k, v in theirs.params.items():
        np.testing.assert_array_equal(ours.params[k].numpy(), np.asarray(v))
    np.testing.assert_allclose(float(ours(img0, img0)), 0.0, atol=1e-6)
    for a, b in [(img0, img1), image_pair(5, 64, 72, 0.1)]:
        want = float(theirs(a, b))
        assert want > 0
        np.testing.assert_allclose(float(ours(a, b)), want, rtol=1e-5)


@pytest.mark.parametrize("size", [(16, 20), (6, 40), (30, 30), (31, 33)])
def test_lpips_on_images_below_alexnets_windows_matches_jax(size):
    """Images too small for a pooling window or a kernel leave a feature
    map empty: NaN, as the JAX package's mean over it; one size up the
    maps hold a pixel and the distances agree."""
    rs = np.random.RandomState(1)
    a, b = (rs.rand(*size, 3).astype(np.float32) for _ in range(2))
    ours, theirs = tlpips.LPIPS.random_init(0), jlpips.LPIPS.random_init(0)
    want, got = float(theirs(a, b)), float(ours(a, b))
    if np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_lpips_from_official_state_dict(tmp_path):
    # tests/test_drivers_yaml.py::test_lpips_torch_layout_conversion's
    # official key layout, through both packages' converters.
    rs = np.random.RandomState(0)
    sd, in_ch = {}, 3
    for i, (out_ch, k) in enumerate([(64, 11), (192, 5), (384, 3), (256, 3),
                                     (256, 3)]):
        sd[f"net.slice{i + 1}.{i * 2}.weight"] = torch.from_numpy(
            rs.randn(out_ch, in_ch, k, k).astype(np.float32) * 0.05)
        sd[f"net.slice{i + 1}.{i * 2}.bias"] = torch.zeros(out_ch)
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            np.abs(rs.randn(1, out_ch, 1, 1)).astype(np.float32) * 0.01)
        in_ch = out_ch
    path = str(tmp_path / "lpips.pth")
    torch.save(sd, path)
    ours = tlpips.convert_torch_state_dict(path)
    theirs = jlpips.convert_torch_state_dict(path)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    np.savez(str(tmp_path / "lpips.npz"), **ours)
    a, b = image_pair(6, 64, 64, 0.2)
    want = float(jlpips.LPIPS(theirs)(a, b))
    for p in (path, str(tmp_path / "lpips.npz")):
        np.testing.assert_allclose(float(tlpips.LPIPS.from_weights(p)(a, b)),
                                   want, rtol=1e-5)
    harness = timage.MetricHarness(lpips_weights_path=path)
    assert set(harness(a, b)) == {"psnr", "ssim", "lpips"}


@pytest.fixture(scope="module")
def fused_render():
    """One tiny synthetic test image rendered through both packages with
    the same fused-MLP parameters."""
    config = tu.tiny_config(model=FUSED_MODEL)
    batch = load_dataset("test", "", config, is_training=False
                         ).generate_ray_batch(1)
    rays_j = jstructs.Rays(**{f: jnp.asarray(getattr(batch.rays, f))
                              for f in jstructs.Rays.__dataclass_fields__})
    model_j, variables = jnerf.construct_model(jax.random.PRNGKey(3),
                                               rays_j, config)
    mesh = jmesh.make_mesh(jax.devices()[:1])
    want = jrender.render_image(jstep.create_render_fn(model_j, config, mesh),
                                rays_j, 0.5, variables, config, mesh)
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    params = tu.unflatten(tu.flat_params(variables["params"]))
    model.load_state_dict(convert_nerfacto_params(params))
    got = render_image(model, batch.rays, 0.5, config, "cpu")
    return config, batch, got, want


def test_fused_render_image_matches_jax(fused_render):
    config, _, got, want = fused_render
    assert config.render_chunk_size < 16 * 16  # several chunks
    for key in ("rgb", "acc", "distance_mean"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("quantize,crop", [(True, 0), (False, 2)])
def test_eval_metric_pipeline_matches_jax_eval_steps(fused_render, quantize,
                                                     crop):
    """The port's score_image against the steps of eval.py:169-191 run with
    the JAX package's functions, on the same arrays."""
    config, batch, got, _ = fused_render
    config.eval_quantize_metrics, config.eval_crop_borders = quantize, crop
    rgb = np.clip(np.nan_to_num(got["rgb"]), 0, 1)
    gt = timage.composite_alpha(np.asarray(batch.rgb), 0.5)
    metrics, rgb_cc = eval_driver.score_image(
        rgb, gt, config, timage.MetricHarness())

    harness = jimage.MetricHarness()
    rgb_cc_j = jimage.color_correct(rgb, gt)
    q = (lambda z: np.round(z * 255) / 255) if quantize else (lambda z: z)
    rgb_m, rgb_cc_m, gt_m = q(rgb), q(rgb_cc_j), q(gt)
    if crop:
        rgb_m, rgb_cc_m, gt_m = (z[crop:-crop, crop:-crop]
                                 for z in (rgb_m, rgb_cc_m, gt_m))
    want = harness(jnp.asarray(rgb_m), jnp.asarray(gt_m))
    want.update(harness(jnp.asarray(rgb_cc_m), jnp.asarray(gt_m),
                        lambda s: f"{s}_cc"))
    np.testing.assert_array_equal(rgb_cc, rgb_cc_j)
    assert set(metrics) == set(want) == {"psnr", "ssim", "psnr_cc",
                                         "ssim_cc"}
    for k in want:
        # SSIM of an untrained render sits near 0, hence the absolute term.
        np.testing.assert_allclose(metrics[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_polling_done_matrix():
    # tests/test_misc_units.py::test_eval_polling_done_matrix, carried over.
    done = eval_driver.polling_done
    c = Config(max_steps=100, early_exit_steps=None)
    assert not done(c, False, 99) and done(c, False, 100)
    c = Config(max_steps=100, early_exit_steps=40)
    assert done(c, False, 40) and not done(c, False, 39)
    c = Config(max_steps=100, early_exit_steps=10_000)
    assert done(c, False, 100)
    c = Config(max_steps=100, finetune_enable=True, finetune_max_steps=50)
    assert not done(c, False, 100)
    assert not done(c, True, 49) and done(c, True, 50)


# 24 px wide, so a half_right crop still holds the 11-px SSIM window.
EVAL_BASE = {"early_exit_steps": 4, "eval_render_every": 4,
             "synthetic_num_images": 3, "synthetic_width": 24}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 CPU steps of the tiny fused-MLP config; returns (yaml, ckpt dir,
    the driver's output)."""
    tmp = tmp_path_factory.mktemp("fused_run")
    cfg = tu.write_tiny_yaml(str(tmp), base=EVAL_BASE, model=FUSED_MODEL)
    ckpt = tmp / "exp" / "scene"
    train_driver.main(["--config", cfg, "--data_dir", str(tmp),
                       "--save_dir", str(ckpt), "--device", "cpu"])
    return cfg, ckpt, (ckpt / "run_log.log").read_text()


def test_in_train_eval_reports_psnr_and_ssim(trained):
    _, ckpt, log = trained
    # run_log.log lines carry a timestamp prefix before the printed text.
    evals = re.findall(r"\[train\] (\d+): eval (.*)$", log, re.M)
    assert len(evals) == 1 and evals[0][0] == "4"
    m = re.fullmatch(r"psnr=(\S+) ssim=(\S+)", evals[0][1])
    assert m is not None, evals
    assert np.isfinite(float(m.group(1))) and 0 < float(m.group(2)) <= 1
    # chip_smoke.py reads the PSNR with this pattern.
    assert re.findall(r"\[train\] \d+: eval psnr=(\S+)", log) == [m.group(1)]
    state = torch.load(ckpt / "checkpoint_4.pt", weights_only=True)
    assert "field.mlp_head.w_2" in state["model"]


def test_python_m_eval_writes_images_and_metrics(trained):
    cfg, ckpt, _ = trained
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_hugs_torch.eval", "--config", cfg,
         "--data_dir", "unused", "--save_dir", str(ckpt), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert "Evaluating checkpoint step 4 from" in proc.stdout
    assert "evaluation complete" in proc.stdout
    preds = ckpt / "test_preds"
    names = [f"{i:03d}" for i in range(3)]
    assert sorted(p.name for p in preds.glob("*_color.png")) == [
        f"{n}_color.png" for n in names]
    for n in names:
        for suffix in ("_gt.png", "_color_cc.png", "_depth.tiff",
                       "_metrics.txt"):
            assert (preds / f"{n}{suffix}").exists(), n + suffix
    assert nh_io.load_img(str(preds / "000_color.png")).shape == (16, 24, 3)
    per_image = [dict(line.split() for line in
                      (preds / f"{n}_metrics.txt").read_text().splitlines())
                 for n in names]
    summary = dict(line.split() for line in
                   (ckpt / "metrics_test_4.txt").read_text().splitlines())
    assert set(summary) == {"psnr", "ssim", "psnr_cc", "ssim_cc"}
    for k, v in summary.items():
        np.testing.assert_allclose(
            float(v), np.mean([float(m[k]) for m in per_image]), rtol=1e-6)
    assert 0 < float(summary["ssim"]) <= 1

    # The scoring CLI over the same PNGs, against the JAX package's.
    import metrics as jax_metrics
    out = ckpt.parent / "scores"
    got = score_main(["--experiment_dir", str(ckpt.parent), "--scene_names",
                      "scene", "--save", "--output_dir", str(out),
                      "--device", "cpu"])
    saved = json.loads((out / "metrics_results.json").read_text())
    assert saved == json.loads(json.dumps(got))
    assert set(saved["scene"]) == set(names) | {"mean"}
    for image_type in ("whole", "half_right"):
        want = jax_metrics.main(str(ckpt.parent), ["scene"], image_type,
                                False, None)
        if image_type != "whole":
            got = score_main(["--experiment_dir", str(ckpt.parent),
                              "--scene_names", "scene", "--image_type",
                              image_type, "--device", "cpu"])
        # XLA's CPU mean sums the squared errors in fp32 in order (relative
        # error up to ~1e-5 of the MSE at these sizes); SSIM sits near 0.
        for name in names + ["mean"]:
            for k, tol in (("psnr", dict(rtol=1e-5)),
                           ("ssim", dict(rtol=1e-6, atol=1e-6))):
                np.testing.assert_allclose(got["scene"][name][k],
                                           want["scene"][name][k], **tol,
                                           err_msg=f"{image_type} {name} {k}")
        np.testing.assert_allclose(got["mean"]["psnr"], want["mean"]["psnr"],
                                   rtol=1e-5)


def test_eval_only_pred_gt_original_names_and_polling(trained, tmp_path):
    """--original_name --only_pred_gt writes the HuGS pairs alone; polling
    mode stops after the run's last checkpoint; render interval and dataset
    limit pick the images."""
    cfg, ckpt, _ = trained
    run = tmp_path / "scene"
    shutil.copytree(ckpt, run, ignore=shutil.ignore_patterns("test_preds"))
    poll_cfg = tu.write_tiny_yaml(str(tmp_path), base={
        **EVAL_BASE, "eval_only_once": False, "eval_render_interval": 2,
        "eval_dataset_limit": 3}, model=FUSED_MODEL)
    eval_driver.main(["--config", poll_cfg, "--data_dir", "unused",
                      "--save_dir", str(run), "--device", "cpu",
                      "--original_name", "--only_pred_gt"])
    assert sorted(p.name for p in (run / "test_preds").iterdir()) == [
        "000_color.png", "000_gt.png", "002_color.png", "002_gt.png"]
    assert (run / "metrics_test_4.txt").exists()
    assert "evaluation complete" in (run / "run_log.log").read_text()
    assert cfg != poll_cfg


def test_eval_prefers_finetune_checkpoint(trained, tmp_path):
    cfg, ckpt, _ = trained
    run = tmp_path / "scene"
    shutil.copytree(ckpt, run, ignore=shutil.ignore_patterns("test_preds"))
    assert checkpoints.pick_eval_checkpoint(str(run)) == (False, 4)
    state = torch.load(run / "checkpoint_4.pt", weights_only=True)
    # Zero colour head: every sample is sigmoid(0) = 0.5, as is the gray
    # test background, so only the finetune weights render flat gray.
    state["model"]["field.mlp_head.w_2"].zero_()
    (run / "finetune").mkdir()
    torch.save(state, run / "finetune" / "checkpoint_2.pt")
    assert checkpoints.pick_eval_checkpoint(str(run)) == (True, 2)
    eval_driver.main(["--config", cfg, "--data_dir", "unused", "--save_dir",
                      str(run), "--device", "cpu"])
    log = (run / "run_log.log").read_text()
    assert f"Evaluating checkpoint step 2 from {run / 'finetune'}" in log
    assert (run / "metrics_test_finetune_2.txt").exists()
    img = nh_io.load_img(str(run / "test_preds" / "001_color.png"))
    np.testing.assert_array_equal(img, np.full_like(img, 127))


def test_eval_without_checkpoint_raises(tmp_path):
    cfg = tu.write_tiny_yaml(str(tmp_path), model=FUSED_MODEL)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        eval_driver.main(["--config", cfg, "--data_dir", "unused",
                          "--save_dir", str(tmp_path / "empty"),
                          "--device", "cpu"])
