"""Quality validation of the port on the procedural sphere world.

Twin of tools/validate_quality.py, in its two modes:

1. Exact-config mode: train one shipped config file end to end through
   the port's train driver, overriding only the dataset (the procedural
   `synthetic` scene, scaled by Config.synthetic_world_scale into the
   config's own near/far/bound; `synthetic_distractor` for a transient
   method or with --distractor) and the eval and checkpoint cadence. Every
   model shape, sample count, precision flag, optimizer and schedule field
   comes from the config file unchanged.

     python -m nerf_hugs_torch.tools.validate_quality \\
         --config configs/nerfacto/kubric_nerfacto_base.yml \\
         [--steps N] [--eval-every N] [--save-dir DIR] [--distractor] \\
         [--score-only] [--device cuda|cpu]
     python -m nerf_hugs_torch.tools.validate_quality \\
         --config configs/mipnerf360/kubric_1024_base.gin \\
         [--binding 'Model.remat_mlp = True'] ...

   Prints the driver's in-train eval lines ([train] N: eval psnr=...) as
   the PSNR-vs-steps table, then the held-out test split's RESULT line
   (per-image PSNR, mean PSNR and SSIM), then, on the card, a TIMING line
   (steps/s after the first step from the driver's print lines, the
   training wall and the peak device memory), and for NeRF-W and HA-NeRF
   a LOCALIZATION line: the mean inside/outside ratio of the uncertainty
   or the implicit mask over the distractor squares of the first 4 train
   views. Checkpoints are written at the --eval-every cadence, so a rerun
   with the same --save-dir resumes; --score-only scores the newest
   checkpoint without training.

2. Legacy reduced-config mode: three small configs of the first rounds,
   trained through the port's train step on the `synthetic` scene.

     python -m nerf_hugs_torch.tools.validate_quality nerfacto [steps] [--amp]
     python -m nerf_hugs_torch.tools.validate_quality nerf [steps] [--amp]
     python -m nerf_hugs_torch.tools.validate_quality mipnerf360 [steps]

The RESULT and LOCALIZATION lines have the format of the JAX tool's. Both
modes start from the JAX tool's initial weights, drawn without JAX
(models/jax_init.py: train.py's key in the first, PRNGKey(0) in the
second); the sample jitter and backgrounds come from torch generators
seeded from config.seed, so a trained PSNR matches the JAX tool's within
a margin, not bit for bit. A localization failure ends the run with an
error after the RESULT line (the JAX tool prints the traceback and exits
0). It runs on the card unless --device cpu is given; without a card that
is an error.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

from nerf_hugs_torch.configs import gin_parser
from nerf_hugs_torch.configs.config import Config, MLPConfig
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.models import construct_model, jax_init
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device

# Scene-only overrides for exact-config mode. World scale 0.35 puts the
# camera orbit at radius 0.875 and the sphere surface 0.7-1.05 from the
# cameras, inside kubric's near=0.1 / far=1.2 (gin) and far=2 (yaml) and
# bound=1, so the config's own geometry fields apply unchanged.
SCENE_OVERRIDES = {
    "num_images": 32,
    "height": 192,   # factor=2 in the kubric configs -> 96x128 effective
    "width": 256,
    "world_scale": 0.35,
}

# The render each transient method localizes its distractors with.
LOCALIZATION_SIGNAL = {"nerfw": "uncertainty", "hanerf": "implicit_mask"}
LOCALIZATION_VIEWS = 4

_TRAIN_LINE = re.compile(r"\[train\] (\d+)/\d+: .* (\S+) steps/s ")


def yaml_override_file(config_path: str, save_dir: str, args):
    """Copy the yaml config into save_dir, patching only the dataset and
    cadence keys; returns (train argv, steps)."""
    with open(config_path) as f:
        raw = yaml.safe_load(f)
    base = raw["base"]
    transient = raw.get("model", {}).get("transient_type")
    base["dataset_type"] = ("synthetic_distractor"
                            if (transient or args.distractor)
                            else "synthetic")
    base["synthetic_num_images"] = SCENE_OVERRIDES["num_images"]
    base["synthetic_height"] = SCENE_OVERRIDES["height"]
    base["synthetic_width"] = SCENE_OVERRIDES["width"]
    base["synthetic_world_scale"] = SCENE_OVERRIDES["world_scale"]
    if args.steps:
        base["num_steps"] = args.steps
    eval_every = args.eval_every or max(500,
                                        base.get("num_steps", 25000) // 10)
    base["eval_render_every"] = eval_every
    base["save_weight_every"] = eval_every
    base["save_eval_render"] = False
    base["save_test_render"] = False
    base["use_eval_lpips"] = False
    out = os.path.join(save_dir, "validate_config.yml")
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return ["--config", out], base.get("num_steps", 25000)


def gin_override_args(config_path: str, args):
    """The gin file untouched, the overrides as --gin_bindings (the
    --binding values last); returns (train argv, steps)."""
    probe = gin_parser.parse_gin_configs([config_path], [])
    loader = ("synthetic_distractor"
              if (probe.transient_type or args.distractor)
              else "synthetic")
    steps = args.steps or probe.max_steps
    eval_every = args.eval_every or max(500, steps // 10)
    bindings = [
        f"Config.dataset_loader = '{loader}'",
        f"Config.synthetic_num_images = {SCENE_OVERRIDES['num_images']}",
        f"Config.synthetic_height = {SCENE_OVERRIDES['height']}",
        f"Config.synthetic_width = {SCENE_OVERRIDES['width']}",
        f"Config.synthetic_world_scale = {SCENE_OVERRIDES['world_scale']}",
        f"Config.max_steps = {steps}",
        f"Config.train_render_every = {eval_every}",
        f"Config.checkpoint_every = {eval_every}",
        "Config.finetune_enable = False",
    ] + list(args.binding or [])
    argv = ["--gin_configs", config_path]
    for b in bindings:
        argv += ["--gin_bindings", b]
    return argv, steps


def score(model, config, device):
    """Per-image PSNR and SSIM of the held-out test split, rendered at
    train_frac 1.0, clipped and scored against the GT composited over the
    test background."""
    test_ds = load_dataset("test", "", config, is_training=False)
    harness = nh_image.MetricHarness(device=device)
    background = nh_image.BACKGROUND_VALUES[config.test_background_color]
    psnrs, ssims = [], []
    for idx in range(test_ds.size):
        batch = test_ds.generate_ray_batch(idx)
        rendering = render_image(model, batch.rays, 1.0, config, device)
        m = harness(np.clip(rendering["rgb"], 0, 1),
                    nh_image.composite_alpha(np.asarray(batch.rgb),
                                             background))
        psnrs.append(m["psnr"])
        ssims.append(m["ssim"])
    return psnrs, ssims


def localization(model, config, device, key: str):
    """The mean of `key` inside the distractor squares over its mean
    outside them, for each of the first LOCALIZATION_VIEWS train views
    that has both."""
    train_ds = load_dataset("train", "", config, is_training=True)
    ratios = []
    for idx in range(min(LOCALIZATION_VIEWS, train_ds.size)):
        batch = train_ds.generate_ray_batch(idx)
        rendering = render_image(model, batch.rays, 1.0, config, device)
        signal = np.asarray(rendering[key])[..., 0]
        inside = np.asarray(batch.rays.static_mask)[..., 0] < 0.5
        if inside.any() and (~inside).any():
            ratios.append(float(signal[inside].mean()
                                / max(signal[~inside].mean(), 1e-6)))
    return ratios


def result_line(tag: str, steps: int, psnrs, ssims) -> str:
    return (f"RESULT config={tag} steps={steps} "
            f"test_psnr={np.mean(psnrs):.2f} test_ssim={np.mean(ssims):.4f} "
            f"per_image_psnr={[round(p, 2) for p in psnrs]}")


def localization_line(tag: str, key: str, ratios) -> str:
    return (f"LOCALIZATION config={tag} signal={key} "
            f"inside_outside_ratio={np.mean(ratios):.2f} "
            f"per_image={[round(r, 2) for r in ratios]}")


def train_rate(log: str) -> float:
    """Steps/s after the first print line of a run's [train] lines: every
    later line's steps over the time they took (steps / their rate)."""
    lines = [(int(m.group(1)), float(m.group(2)))
             for m in _TRAIN_LINE.finditer(log)]
    spans = [(step - prev, rate) for (prev, _), (step, rate)
             in zip(lines, lines[1:])]
    if not spans:
        return float("nan")
    return sum(n for n, _ in spans) / sum(n / r for n, r in spans)


def restore_model(config, save_dir: str, device):
    """The config's model with the newest checkpoint under save_dir."""
    model = construct_model(config, device, torch.Generator().manual_seed(0))
    if checkpoints.restore_params(save_dir, model) is None:
        raise FileNotFoundError(f"no checkpoint under {save_dir} to score")
    return model


def exact_config_argv(args):
    """(tag, save_dir, train driver argv, steps) of an exact-config run;
    writes the patched yaml into save_dir."""
    tag = os.path.splitext(os.path.basename(args.config))[0]
    save_dir = args.save_dir or os.path.join(tempfile.gettempdir(),
                                             f"validate_{tag}")
    os.makedirs(save_dir, exist_ok=True)
    if args.config.endswith((".yml", ".yaml")):
        cfg_argv, steps = yaml_override_file(args.config, save_dir, args)
    else:
        cfg_argv, steps = gin_override_args(args.config, args)
    argv = cfg_argv + ["--data_dir", "synthetic", "--save_dir", save_dir,
                       "--device", args.device]
    return tag, save_dir, argv, steps


def run_exact_config(args) -> None:
    device = resolve_device(args.device)
    tag, save_dir, argv, steps = exact_config_argv(args)
    print(f"=== exact-config validation: {tag} ({steps} steps) ===",
          flush=True)
    print("train argv:", " ".join(argv), flush=True)
    timing = None
    if not args.score_only:
        log_path = os.path.join(save_dir, "run_log.log")
        offset = os.path.getsize(log_path) if os.path.exists(log_path) else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        driver.main(argv)
        wall = time.time() - t0
        print(f"training wall-clock: {wall:.0f}s", flush=True)
        if device.type == "cuda":
            with open(log_path) as f:
                f.seek(offset)
                rate = train_rate(f.read())
            timing = (f"TIMING config={tag} steps_per_sec={rate:.3f} "
                      f"train_wall_s={wall:.1f} peak_gib="
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")

    # The held-out test split at the exact config.
    pin_fp32_precision()
    config = driver.load_config_from_args(driver.parse_args(argv))
    model = restore_model(config, save_dir, device)
    psnrs, ssims = score(model, config, device)
    print(result_line(tag, steps, psnrs, ssims), flush=True)
    if timing:
        print(timing, flush=True)

    # NeRF-W's uncertainty and HA-NeRF's implicit mask should be higher
    # inside the distractor squares of the train views than outside.
    key = LOCALIZATION_SIGNAL.get(config.transient_type)
    if key:
        ratios = localization(model, config, device, key)
        print(localization_line(tag, key, ratios), flush=True)


# ---------------------------------------------------------------------------
# Legacy reduced-config mode.

def nerfacto_config(amp: bool) -> Config:
    config = Config(
        dataset_loader="synthetic", model_type="nerfacto", batch_size=4096,
        image_num_per_batch=8, near=0.5, far=6.0, max_steps=600,
        lr_init=1e-2, lr_final=1e-3, lr_delay_steps=50,
        grad_max_norm=0.0, grad_max_val=0.0, data_loss_type="mse",
        enable_amp=amp, bound=4.0, enable_scene_contraction=False,
        train_background_color="white", test_background_color="white",
        interlevel_loss_mult=1.0, distortion_loss_mult=0.0,
        render_chunk_size=4096)
    config.nerfacto.num_proposal_iterations = 1
    config.nerfacto.num_proposal_samples_per_ray = (96,)
    config.nerfacto.num_nerf_samples_per_ray = 48
    config.nerfacto.log2_hashmap_size = 19
    config.nerfacto.num_levels = 12
    config.nerfacto.base_res = 16
    config.nerfacto.max_res = 1024
    config.nerfacto.hidden_dim = 64
    config.nerfacto.hidden_dim_color = 64
    config.nerfacto.proposal_net_args_list = (
        {"base_res": 16, "hidden_dim": 16, "log2_hashmap_size": 17,
         "features_per_level": 2, "num_levels": 5, "max_res": 256},)
    return config


def nerf_config(amp: bool) -> Config:
    config = Config(
        dataset_loader="synthetic", model_type="nerf", batch_size=4096,
        image_num_per_batch=8, near=0.5, far=6.0, max_steps=600,
        lr_init=5e-4, lr_final=5e-5, lr_delay_steps=50,
        grad_max_norm=0.0, grad_max_val=0.0, data_loss_type="mse",
        enable_amp=amp, enable_scene_contraction=False,
        train_background_color="white", test_background_color="white",
        interlevel_loss_mult=0.0, distortion_loss_mult=0.0,
        data_coarse_loss_mult=0.1, render_chunk_size=4096)
    config.nerfacto.net_depth = 8
    config.nerfacto.net_width = 256
    config.nerfacto.num_coarse_nerf_samples_per_ray = 64
    config.nerfacto.num_fine_nerf_samples_per_ray = 128
    config.nerfacto.max_deg_point = 10
    config.nerfacto.proposal_initial_sampler = "uniform"
    return config


def mipnerf360_config(amp: bool) -> Config:
    config = Config(
        dataset_loader="synthetic", batch_size=4096,
        image_num_per_batch=8, near=0.5, far=6.0, max_steps=1500,
        lr_init=2e-3, lr_final=2e-4, lr_delay_steps=100,
        grad_max_norm=0.001, data_loss_type="mse",
        interlevel_loss_mult=1.0, distortion_loss_mult=0.01,
        render_chunk_size=4096)
    del amp  # the mipnerf360 stack trains fp32 like the reference
    config.model.num_prop_samples = 64
    config.model.num_nerf_samples = 32
    config.model.num_levels = 3
    config.nerf_mlp = MLPConfig(net_depth=4, net_width=256,
                                bottleneck_width=128, net_width_viewdirs=128)
    config.prop_mlp = MLPConfig(net_depth=4, net_width=128, disable_rgb=True)
    return config


LEGACY_CONFIGS = {"nerfacto": nerfacto_config, "nerf": nerf_config,
                  "mipnerf360": mipnerf360_config}


def legacy_model(config, device):
    """The legacy mode's model, from the initial weights that JAX's tool
    draws: setup_model(config, PRNGKey(0)) hands the key straight to
    flax's init (models/jax_init.py)."""
    model = construct_model(config, device,
                            torch.Generator().manual_seed(config.seed))
    jax_init.init_model_(model, config, root=(0, 0))
    return model


def run_legacy(model_type: str, steps: int, amp: bool, device_name: str):
    device = resolve_device(device_name)
    pin_fp32_precision()
    config = LEGACY_CONFIGS[model_type](amp)
    config.max_steps = steps
    dataset = load_dataset("train", "", config, is_training=True)
    model = legacy_model(config, device)
    optimizer, scheduler = step_lib.create_optimizer(config, model)
    rng = torch.Generator(device=device).manual_seed(config.seed + 1)
    thresholds = step_lib.initial_inlier_thresholds(config, device)

    t0 = time.time()
    for step, batch in zip(range(steps), dataset):
        frac = float(np.clip(step / steps, 0, 1))
        stats = step_lib.train_step(model, optimizer, scheduler,
                                    batch.to(device), frac, config, rng,
                                    thresholds)
        if step % 100 == 0 or step == steps - 1:
            print(f"step {step}: loss {float(stats['loss']):.5f} "
                  f"psnr {float(stats['psnr']):.2f} "
                  f"({time.time()-t0:.0f}s)", flush=True)

    test_ds = load_dataset("test", "", config, is_training=False)
    background = nh_image.BACKGROUND_VALUES[config.test_background_color]
    psnrs = []
    for idx in range(test_ds.size):
        batch = test_ds.generate_ray_batch(idx)
        rendering = render_image(model, batch.rays, 1.0, config, device)
        mse = float(np.mean((np.clip(rendering["rgb"], 0, 1)
                             - nh_image.composite_alpha(
                                 np.asarray(batch.rgb), background)) ** 2))
        psnrs.append(-10 * np.log10(mse))
    print(f"RESULT {model_type} amp={amp} steps={steps} "
          f"test_psnr={np.mean(psnrs):.2f} per_image="
          f"{[round(p, 2) for p in psnrs]}", flush=True)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.validate_quality",
        description="Train a config on the procedural sphere world and "
                    "score the held-out test split.")
    parser.add_argument("model_type", nargs="?", default=None,
                        choices=sorted(LEGACY_CONFIGS))
    parser.add_argument("steps_pos", nargs="?", type=int, default=600)
    parser.add_argument("--config", type=str, default=None,
                        help="shipped config file (.yml or .gin)")
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--eval-every", type=int, default=0)
    parser.add_argument("--save-dir", type=str, default=None)
    parser.add_argument("--distractor", action="store_true",
                        help="force the distractor scene (so a base config "
                             "can be compared against transient methods on "
                             "poisoned training data)")
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--score-only", action="store_true",
                        help="skip training; restore the newest checkpoint "
                             "in --save-dir and print the RESULT line")
    parser.add_argument("--binding", action="append", default=[],
                        help="extra gin binding for --config .gin runs "
                             "(e.g. 'Model.remat_mlp = True'); repeatable")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if not args.config and not args.model_type:
        parser.error("need a model_type or --config")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.config:
        run_exact_config(args)
    else:
        run_legacy(args.model_type, args.steps_pos, args.amp, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
