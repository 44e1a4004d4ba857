"""The port's drivers in the gin dialect: `python -m nerf_hugs_torch.train`
and `python -m nerf_hugs_torch.eval` with --gin_configs / --gin_bindings,
as scripts/{train,eval}_mipnerf360_*.sh call train.py and eval.py, on
scenes written in the kubric and phototourism layouts, with the shipped
gin files and tiny width bindings, on the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_torch.eval import main as eval_main
from nerf_hugs_torch.tools.hashgrid_inputs import (write_colmap_scene,
                                                   write_kubric_scene)
from nerf_hugs_torch.train import driver

REPO = pathlib.Path(__file__).resolve().parents[1]
GIN = REPO / "configs" / "mipnerf360"
# Toy widths; 512 rays a step (two 16x16 patches), 3 steps, an in-train
# render at steps 2 and 3.
TINY = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
        "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
        "NerfMLP.net_width_viewdirs = 16", "PropMLP.net_depth = 2",
        "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
        "Model.num_nerf_samples = 4", "Config.batch_size = 512",
        "Config.image_num_per_batch = 2", "Config.render_chunk_size = 512",
        "Config.max_steps = 3", "Config.print_every = 1",
        "Config.train_render_every = 2", "Config.checkpoint_every = 2"]


def gin_args(name: str, data_dir, ckpt, *extra) -> list:
    args = [f"--gin_configs={GIN / name}.gin",
            f"--gin_bindings=Config.data_dir = '{data_dir}'",
            f"--gin_bindings=Config.checkpoint_dir = '{ckpt}'"]
    return args + [f"--gin_bindings={b}" for b in TINY + list(extra)] + [
        "--logtostderr", "--device", "cpu"]


@pytest.fixture(scope="module")
def kubric(tmp_path_factory):
    """4 train and 2 test frames, 32x32 in rgb/2x/ (Config.factor = 2)."""
    return write_kubric_scene(str(tmp_path_factory.mktemp("kubric")), 4, 2,
                              32)


def run_module(module: str, args: list) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", module] + args, cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_python_m_train_and_eval_kubric_base(kubric, tmp_path):
    ckpt = tmp_path / "ckpt"
    out = run_module("nerf_hugs_torch.train",
                     gin_args("kubric_1024_base", kubric, ckpt))
    lines = out.splitlines()
    for step in (1, 2, 3):
        assert any(line.startswith(f"[train] {step}/3: loss=")
                   and "interlevel=" in line for line in lines), out
    assert sum(line.startswith("[train] ") and ": eval psnr=" in line
               for line in lines) == 2
    assert (ckpt / "checkpoint_2.pt").exists()
    assert (ckpt / "checkpoint_3.pt").exists()
    assert "training complete" in (ckpt / "run_log.log").read_text()
    # The run's config snapshot is JAX's for the same flags.
    from nerf_hugs_tpu.configs import gin_parser as jgin
    want = jgin.parse_gin_configs(
        [str(GIN / "kubric_1024_base.gin")],
        [f"Config.data_dir = '{kubric}'",
         f"Config.checkpoint_dir = '{ckpt}'"] + TINY)
    assert (ckpt / "config.gin").read_text() == jgin.config_str(want)

    out = run_module("nerf_hugs_torch.eval", gin_args(
        "kubric_1024_base", kubric, ckpt,
        "Config.eval_save_ray_data = True"))
    assert "Evaluating checkpoint step 3" in out and "mean: psnr=" in out
    preds = ckpt / "test_preds"
    for i in range(2):
        for suffix in ("color.png", "gt.png", "color_cc.png", "depth.tiff",
                       "metrics.txt"):
            assert (preds / f"{i:03d}_{suffix}").exists(), suffix
    bags = np.load(preds / "000_rays.npz")
    assert sorted(bags) == sorted(f"ray_{k}_{i}" for k in
                                  ("sdist", "weights", "rgbs")
                                  for i in range(3))
    assert bags["ray_sdist_2"].shape == (16, 5)     # vis_num_rays x 4 + 1
    mean = dict(line.split() for line in
                (ckpt / "metrics_test_3.txt").read_text().splitlines())
    assert np.isfinite(float(mean["psnr"])) and 0 < float(mean["ssim"]) <= 1


def test_withmask_trains_and_renders_one_test_image_an_event(
        kubric, tmp_path, monkeypatch, capsys):
    """kubric_1024_withmask.gin reads the scene's static masks; Mip-NeRF
    360's in-train render takes one rotating test image per event
    (train.py:306-307), where nerfacto evaluates a window."""
    rendered = []
    metrics = driver._eval_metrics

    def counted(model, batches, *args):
        batches = list(batches)
        rendered.append(len(batches))
        return metrics(model, batches, *args)

    monkeypatch.setattr(driver, "_eval_metrics", counted)
    driver.main(gin_args("kubric_1024_withmask", kubric, tmp_path / "ck"))
    out = capsys.readouterr().out
    assert rendered == [1, 1]
    terms = [line for line in out.splitlines()
             if line.startswith("[train] ") and "loss=" in line]
    assert len(terms) == 3
    assert all(np.isfinite(float(line.split("data=")[1].split()[0]))
               for line in terms)


def test_phototourism_finetune_moves_only_the_glo_table(tmp_path, capsys):
    """phototourism_1024_base.gin: the train stage, then the finetune
    stage on the test images' left halves, which trains GloEmbed_0 alone
    ('embedding' in path); eval restores the finetune checkpoint."""
    scene = write_colmap_scene(str(tmp_path / "photo"), "phototourism", 4, 2,
                               64)
    ckpt = tmp_path / "ck"
    extra = ("Config.finetune_max_steps = 2",
             "Config.finetune_batch_size = 512")
    driver.main(gin_args("phototourism_1024_base", scene, ckpt, *extra))
    out = capsys.readouterr().out
    assert "[finetune] 2/2: loss=" in out
    before = torch.load(ckpt / "checkpoint_3.pt", weights_only=True)["model"]
    after = torch.load(ckpt / "finetune" / "checkpoint_2.pt",
                       weights_only=True)["model"]
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    assert moved == ["GloEmbed_0.weight"]

    eval_main(gin_args("phototourism_1024_base", scene, ckpt, *extra))
    out = capsys.readouterr().out
    assert f"Evaluating checkpoint step 2 from {ckpt / 'finetune'}" in out
    assert (ckpt / "metrics_test_finetune_2.txt").exists()


def test_eval_writes_the_hugs_pairs(kubric, tmp_path):
    """--eval_data train --original_name --only_pred_gt: the
    {name}_color.png / _gt.png pairs that the HuGS stage reads."""
    ckpt = tmp_path / "ck"
    driver.main(gin_args("kubric_1024_base", kubric, ckpt,
                         "Config.train_render_every = 0"))
    eval_main(gin_args("kubric_1024_base", kubric, ckpt) + [
        "--eval_data", "train", "--original_name", "--only_pred_gt"])
    names = sorted(os.listdir(ckpt / "train_preds"))
    assert names == sorted(f"{i:05d}_{k}.png" for i in range(4)
                           for k in ("color", "gt"))


def test_gin_dialect_refusals(kubric, tmp_path):
    ckpt = tmp_path / "ck"
    # A loader neither package has is refused as JAX refuses it.
    with pytest.raises(ValueError, match="unknown dataset_loader"):
        driver.main(gin_args("kubric_1024_base", kubric, ckpt,
                             "Config.dataset_loader = 'robust'"))
    # Both directories must be set (train.py:45-60).
    with pytest.raises(ValueError, match="data_dir must be set"):
        driver.main([f"--gin_configs={GIN / 'kubric_1024_base.gin'}",
                     f"--gin_bindings=Config.checkpoint_dir = '{ckpt}'",
                     "--device", "cpu"])
    with pytest.raises(ValueError, match="checkpoint_dir"):
        driver.main([f"--gin_configs={GIN / 'kubric_1024_base.gin'}",
                     "--device", "cpu"])
    # A GLO table smaller than the split's embedding indices.
    with pytest.raises(ValueError, match="must cover"):
        driver.main(gin_args("kubric_1024_base", kubric, ckpt,
                             "Model.num_glo_features = 4",
                             "Model.num_embeddings = 2"))
    # A finetune stage needs an embedding to train ('embedding' in path).
    with pytest.raises(ValueError, match="has none"):
        driver.main(gin_args("kubric_1024_base", kubric, ckpt,
                             "Config.finetune_enable = True"))
    # The weight-decay term maps flax paths for Mip-NeRF 360 only.
    from nerf_hugs_torch.configs.gin_parser import parse_gin_configs
    config = parse_gin_configs([], ["Config.model_type = 'nerfacto'",
                                    "Config.dataset_loader = 'kubric'",
                                    "Config.weight_decay_mults = {'field': 1.}"])
    with pytest.raises(NotImplementedError, match="weight_decay_mults"):
        driver.preflight(config)
    # Scoped bindings are refused as in JAX.
    from nerf_hugs_torch.configs.gin_parser import GinParseError
    with pytest.raises(GinParseError, match="scopes"):
        driver.main(gin_args("kubric_1024_base", kubric, ckpt,
                             "train/Config.batch_size = 64"))
