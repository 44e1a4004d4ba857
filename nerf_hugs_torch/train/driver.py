"""The yaml-dialect training driver of the port.

    python -m nerf_hugs_torch.train --config configs/nerfacto/X.yml \\
        --data_dir DATA --save_dir CKPT --device {cuda,cpu}

Keeps the loop of the repo's train.py (nerfacto yaml dialect, train stage):
early_exit_steps, print_every lines with steps/s and rays/s, step-numbered
checkpoints with the model-compat sidecar, resume from the newest
checkpoint, and the in-train eval window, which reports PSNR and SSIM
through the MetricHarness. The finetune stage and tensorboard summaries
wait (ROADMAP.md Queue 1).
Every printed line also lands in {save_dir}/run_log.log.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from nerf_hugs_tpu.configs import yaml_loader
from nerf_hugs_tpu.utils.record import Recorder
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.train",
        description="Train a nerfacto model from a yaml config.")
    parser.add_argument("--config", required=True, help="yaml config path")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--save_dir", required=True, help="checkpoint dir")
    parser.add_argument("--device", required=True, choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def eval_window_indices(event: int, dataset_size: int,
                        eval_images_num: int) -> list:
    """Event e (1-based) evaluates eval_images_num images starting at
    (e-1) * max(eval_images_num // 2, 1), wrapping mod dataset_size (the
    rotating window of nerfacto/train.py:241-296)."""
    n_eval = min(eval_images_num, dataset_size)
    stride = max(eval_images_num // 2, 1)
    base = ((event - 1) * stride) % dataset_size
    return [(base + i) % dataset_size for i in range(n_eval)]


def _eval_metrics(model, test_dataset, window, train_frac, config, device,
                  harness) -> dict:
    """Mean metrics (psnr, ssim) of the clipped renders over the window's
    test images, against the GT composited over the test background."""
    per_image = []
    for idx in window:
        batch = test_dataset.generate_ray_batch(idx)
        rgb = np.clip(render_image(model, batch.rays, train_frac, config,
                                   device)["rgb"], 0, 1)
        gt = nh_image.composite_alpha(
            np.asarray(batch.rgb, np.float32),
            nh_image.BACKGROUND_VALUES[config.test_background_color])
        per_image.append(harness(rgb, gt))
    return {k: float(np.mean([m[k] for m in per_image]))
            for k in per_image[0]}


def load_config(path: str, data_dir: str, save_dir: str):
    """The yaml config as the unified Config, with the CLI's directories."""
    config = yaml_loader.load_yaml_config(path)
    config.data_dir = data_dir
    config.checkpoint_dir = save_dir
    return config


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config, args.data_dir, args.save_dir)
    if config.model_type != "nerfacto":
        raise NotImplementedError(
            f"model_type {config.model_type!r} is not ported yet "
            "(ROADMAP.md Queue 1 items 13-14)")
    if config.finetune_enable:
        raise NotImplementedError("the finetune stage is not ported yet "
                                  "(ROADMAP.md Queue 1 item 8)")
    pin_fp32_precision()

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    checkpoints.check_model_compat(config.checkpoint_dir, config)
    checkpoints.record_model_compat(config.checkpoint_dir, config)
    with open(os.path.join(config.checkpoint_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=1, default=str)
    recorder = Recorder(config.checkpoint_dir)

    test_dataset = load_dataset("test", config.data_dir, config,
                                is_training=False)
    harness = nh_image.MetricHarness(device=device)
    model = NerfactoModel(config, device,
                          torch.Generator().manual_seed(config.seed))
    optimizer, scheduler = step_lib.create_optimizer(config, model)
    num_params = sum(p.numel() for p in model.parameters())
    recorder.print(f"Number of parameters being optimized: {num_params}")

    dataset = load_dataset("train", config.data_dir, config, is_training=True)
    init_step = checkpoints.restore_checkpoint(config.checkpoint_dir, model,
                                               optimizer, scheduler) + 1
    num_steps = config.max_steps
    if config.early_exit_steps is not None:
        num_steps = min(num_steps, config.early_exit_steps)
    rng = torch.Generator(device=device).manual_seed(config.seed + 1)

    stats_buffer = []
    start = time.time()
    for step in range(init_step, num_steps + 1):
        batch = next(dataset).to(device)
        # The fraction divides by the FULL max_steps even under
        # early_exit_steps, so early exits do not race the proposal anneal.
        train_frac = float(np.clip((step - 1) / max(config.max_steps - 1, 1),
                                   0, 1))
        stats_buffer.append(step_lib.train_step(
            model, optimizer, scheduler, batch, train_frac, config, rng))
        if step == init_step or step % config.print_every == 0:
            loss = float(torch.stack([s["loss"] for s in stats_buffer]).mean())
            psnr = float(torch.stack([s["psnr"] for s in stats_buffer]).mean())
            elapsed = time.time() - start
            steps_per_sec = len(stats_buffer) / max(elapsed, 1e-9)
            recorder.print(
                f"[train] {step}/{num_steps}: loss={loss:.5f} "
                f"psnr={psnr:.3f} lr={scheduler.get_last_lr()[0]:.2e} "
                f"{steps_per_sec:.2f} steps/s "
                f"{config.batch_size * steps_per_sec:.0f} rays/s")
            stats_buffer = []
            start = time.time()

        if step % config.checkpoint_every == 0 or step == num_steps:
            checkpoints.save_checkpoint(config.checkpoint_dir, model,
                                        optimizer, scheduler, step)

        if config.train_render_every > 0 and (
                step % config.train_render_every == 0 or step == num_steps):
            # Event number = triggers at or before `step`, counting the
            # extra final-step trigger when num_steps is off the cadence.
            event = step // config.train_render_every
            if step == num_steps and step % config.train_render_every:
                event += 1
            window = eval_window_indices(event, test_dataset.size,
                                         config.eval_images_num)
            metrics = _eval_metrics(model, test_dataset, window, train_frac,
                                    config, device, harness)
            recorder.print(f"[train] {step}: eval " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            start = time.time()
    recorder.print("training complete")
    recorder.close()
