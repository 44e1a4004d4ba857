"""The yaml-dialect training driver of the port.

    python -m nerf_hugs_torch.train --config configs/nerfacto/X.yml \\
        --data_dir DATA --save_dir CKPT [--device cuda|cpu]

Keeps the loop of the repo's train.py (nerfacto yaml dialect): the stages
["train"] and, with finetune_enable, ["finetune"] (the finetune_params
groups re-optimised on the left half of the test images, a data-only
loss, train_frac pinned to 1, checkpoints in {save_dir}/finetune/);
early_exit_steps (train stage only), print_every lines with steps/s and
rays/s, step-numbered checkpoints with the model-compat sidecar, resume
from the newest checkpoint of each stage, RobustNeRF's inlier thresholds
carried from step to step on the device, and the in-train eval window,
which reports PSNR and SSIM through the MetricHarness. Tensorboard
summaries wait (ROADMAP.md Queue 1 item 10b).
Every printed line also lands in {save_dir}/run_log.log. It runs on the
card unless --device cpu is given; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from nerf_hugs_torch.configs import gin_parser, yaml_loader
from nerf_hugs_torch.data import check_loader, load_dataset
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.models.nerfacto import (NerfactoModel,
                                             check_transient_config,
                                             module_names)
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device
from nerf_hugs_torch.utils.record import Recorder


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.train",
        description="Train a nerfacto model from a yaml config.")
    parser.add_argument("--config", required=True, help="yaml config path")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--save_dir", required=True, help="checkpoint dir")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
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


def check_num_embeddings(config, dataset, stage: str = "train") -> None:
    """With appearance or transient embeddings, the table must cover the
    split's largest embedding index (test splits, which the finetune stage
    trains on, come after the train images), as train.py:160-180 checks."""
    nc = config.nerfacto
    if not (nc.use_appearance_embedding or nc.use_transient_embedding):
        return
    needed = (int(np.max(dataset.embed_idxs)) + 1 if len(dataset.embed_idxs)
              else dataset.size)
    if needed > config.model.num_embeddings:
        raise ValueError(
            f"Number of embeddings {config.model.num_embeddings} must cover "
            f"the {stage} split's max embedding index (needs {needed})")


def load_config(path: str, data_dir: str, save_dir: str):
    """The yaml config as the unified Config, with the CLI's directories."""
    config = yaml_loader.load_yaml_config(path)
    config.data_dir = data_dir
    config.checkpoint_dir = save_dir
    return config


def preflight(config) -> None:
    """What a run checks before it builds anything: a nerfacto model, a
    known transient type with the embedding its head reads, a ported data
    loader, and, with finetune_enable, finetune_params groups that name
    modules of the model."""
    if config.model_type != "nerfacto":
        raise NotImplementedError(
            f"model_type {config.model_type!r} is not ported yet "
            "(ROADMAP.md Queue 1 items 13-14)")
    check_transient_config(config)
    check_loader(config)
    if config.finetune_enable:
        step_lib.finetune_partitions(config, module_names(config))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config, args.data_dir, args.save_dir)
    preflight(config)
    pin_fp32_precision()

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    checkpoints.check_model_compat(config.checkpoint_dir, config)
    checkpoints.record_model_compat(config.checkpoint_dir, config)
    with open(os.path.join(config.checkpoint_dir, "config.gin"), "w") as f:
        f.write(gin_parser.config_str(config))
    recorder = Recorder(config.checkpoint_dir)

    test_dataset = load_dataset("test", config.data_dir, config,
                                is_training=False)
    harness = nh_image.MetricHarness(device=device)
    model = NerfactoModel(config, device,
                          torch.Generator().manual_seed(config.seed))
    num_params = sum(p.numel() for p in model.parameters())
    recorder.print(f"Number of parameters being optimized: {num_params}")
    stages = ["train"] + (["finetune"] if config.finetune_enable else [])
    for stage in stages:
        run_stage(stage, model, config, device, test_dataset, harness,
                  recorder)
    recorder.print("training complete")
    recorder.close()


def stage_dataset(stage: str, config):
    """A stage's training batches: the train split, or for `finetune` the
    left halves of the test images with the finetune_* batch."""
    if stage == "finetune":
        return load_dataset(
            "test", config.data_dir, config, is_training=True,
            sample_from_half_image=True,
            batch_size=config.finetune_batch_size,
            patch_size=config.finetune_patch_size,
            patch_dilation=config.finetune_patch_dilation,
            image_num_per_batch=config.finetune_image_num_per_batch)
    return load_dataset("train", config.data_dir, config, is_training=True)


def run_stage(stage: str, model, config, device, test_dataset, harness,
              recorder) -> None:
    """One stage of train.py's loop. `finetune` starts from the model as
    the train stage left it, freezes all but the finetune_params groups,
    and trains on the left half of the test images with the finetune_*
    batch and schedule (train.py:133-175)."""
    is_finetune = stage == "finetune"
    if is_finetune:
        optimizer, scheduler = step_lib.create_finetune_optimizer(config,
                                                                  model)
        ckpt_dir = os.path.join(config.checkpoint_dir, "finetune")
        num_steps = config.finetune_max_steps
        batch_size = config.finetune_batch_size
    else:
        optimizer, scheduler = step_lib.create_optimizer(config, model)
        ckpt_dir = config.checkpoint_dir
        num_steps = config.max_steps
        batch_size = config.batch_size
        if config.early_exit_steps is not None:
            num_steps = min(num_steps, config.early_exit_steps)
    dataset = stage_dataset(stage, config)
    check_num_embeddings(config, dataset, stage)
    init_step = checkpoints.restore_checkpoint(ckpt_dir, model, optimizer,
                                               scheduler) + 1
    rng = torch.Generator(device=device).manual_seed(
        config.seed + (2 if is_finetune else 1))
    # RobustNeRF's thresholds stay on the device from step to step: reading
    # them on the host would wait for every step.
    robust = config.transient_type == "robustnerf" and not is_finetune
    thresholds = step_lib.initial_inlier_thresholds(config, device)

    stats_buffer = []
    start = time.time()
    for step in range(init_step, num_steps + 1):
        batch = next(dataset).to(device)
        # The finetune stage runs at the end of the schedule (train.py:
        # 232-236). The train fraction divides by the FULL max_steps even
        # under early_exit_steps, so early exits do not race the proposal
        # anneal.
        train_frac = 1.0 if is_finetune else float(np.clip(
            (step - 1) / max(config.max_steps - 1, 1), 0, 1))
        stats = step_lib.train_step(model, optimizer, scheduler, batch,
                                    train_frac, config, rng, thresholds,
                                    is_finetune)
        if robust:
            thresholds = stats["robust_inlier_threshold"]
        stats_buffer.append(stats)
        if step == init_step or step % config.print_every == 0:
            loss = float(torch.stack([s["loss"] for s in stats_buffer]).mean())
            psnr = float(torch.stack([s["psnr"] for s in stats_buffer]).mean())
            elapsed = time.time() - start
            steps_per_sec = len(stats_buffer) / max(elapsed, 1e-9)
            # The last step's loss terms (and the thresholds it hands the
            # next step): the run log's stand-in for the train_losses/*
            # summaries (ROADMAP.md Queue 1 item 10b).
            terms = " ".join(f"{k}={float(v):.5f}" for k, v in
                             stats_buffer[-1]["losses"].items())
            if robust:
                terms += " inlier_threshold=" + ",".join(
                    f"{float(t):.6g}" for t in thresholds)
            recorder.print(
                f"[{stage}] {step}/{num_steps}: loss={loss:.5f} "
                f"psnr={psnr:.3f} lr={scheduler.get_last_lr()[0]:.2e} "
                f"{steps_per_sec:.2f} steps/s "
                f"{batch_size * steps_per_sec:.0f} rays/s {terms}")
            stats_buffer = []
            start = time.time()

        if step % config.checkpoint_every == 0 or step == num_steps:
            checkpoints.save_checkpoint(ckpt_dir, model, optimizer, scheduler,
                                        step)

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
            recorder.print(f"[{stage}] {step}: eval " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
            start = time.time()
