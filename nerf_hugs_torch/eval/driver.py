"""The evaluation driver of the port, in both config dialects of eval.py.

    python -m nerf_hugs_torch.eval --config configs/nerfacto/X.yml \\
        --data_dir DATA --save_dir CKPT [--device cuda|cpu] \\
        [--eval_data train|test] [--original_name] [--only_pred_gt]
    python -m nerf_hugs_torch.eval --gin_configs=configs/mipnerf360/X.gin \\
        --gin_bindings="Config.data_dir = 'DATA'" \\
        --gin_bindings="Config.checkpoint_dir = 'CKPT'" [--logtostderr] \\
        [--device cuda|cpu] [--eval_data train|test] [--original_name] \\
        [--only_pred_gt]

Keeps the flow of the repo's eval.py for one process: restore the newest
checkpoint, preferring the finetune stage's, render every image of the
split through the chunked renderer at the train_frac the checkpoint was
trained at, colour-correct against GT in float64, quantize to the uint8
grid before the metrics (eval_quantize_metrics), crop eval_crop_borders, score psnr/ssim and their
colour-corrected *_cc twins, and save `{name}_color.png`, `_gt.png`,
`_color_cc.png`, `_depth.tiff` and `_metrics.txt` per image plus
`metrics_{split}_{stage}{step}.txt` beside the checkpoints.
`--original_name --only_pred_gt` writes only the `{name}_color/gt.png`
pairs into `{save_dir}/{split}_preds/`, the HuGS pipeline's input. With
eval_only_once false it polls for new checkpoints until the last one the
run will write. With eval_save_ray_data, `{name}_rays.npz` holds every
level's ray bags (`ray_sdist_0`, ...; Mip-NeRF 360 renders them, nerfacto
none), as eval.py:196-203 writes them. It runs on the card unless
--device cpu is given; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train.driver import (add_config_args,
                                          load_config_from_args, preflight)
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device
from nerf_hugs_torch.utils.record import Recorder


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.eval",
        description="Render a split of a run, score it and save the "
                    "images.")
    add_config_args(parser)
    parser.add_argument("--eval_data", default=None, choices=("train", "test"))
    parser.add_argument("--original_name", action="store_true")
    parser.add_argument("--only_pred_gt", action="store_true")
    return parser.parse_args(argv)


def polling_done(config, use_ft: bool, step: int) -> bool:
    """Whether polling has evaluated the last checkpoint the run writes:
    the LAST finetune checkpoint when finetune is on (the reference stops at
    the first), else step min(max_steps, early_exit_steps), the train
    driver's last step."""
    if config.finetune_enable:
        return use_ft and step >= config.finetune_max_steps
    return step >= min(config.max_steps,
                       config.early_exit_steps or config.max_steps)


def score_image(rgb: np.ndarray, gt: np.ndarray, config, harness):
    """The metric steps of eval: float64 colour correction, the uint8-grid
    quantization, the border crop, then psnr/ssim and psnr_cc/ssim_cc.
    Returns (metrics, the colour-corrected render)."""
    rgb_cc = nh_image.color_correct(rgb, gt)
    if config.eval_quantize_metrics:
        q = lambda z: np.round(z * 255) / 255
        rgb_m, rgb_cc_m, gt_m = q(rgb), q(rgb_cc), q(gt)
    else:
        rgb_m, rgb_cc_m, gt_m = rgb, rgb_cc, gt
    if config.eval_crop_borders > 0:
        c = config.eval_crop_borders
        crop = lambda z: z[c:-c, c:-c]
        rgb_m, rgb_cc_m, gt_m = map(crop, (rgb_m, rgb_cc_m, gt_m))
    metrics = harness(rgb_m, gt_m)
    metrics.update(harness(rgb_cc_m, gt_m, lambda s: f"{s}_cc"))
    return metrics, rgb_cc


def _save_outputs(out_dir, name, rgb, gt, rgb_cc, rendering, metrics,
                  only_pred_gt: bool) -> None:
    nh_io.save_img_u8(rgb, os.path.join(out_dir, f"{name}_color.png"))
    if gt is not None:
        nh_io.save_img_u8(gt, os.path.join(out_dir, f"{name}_gt.png"))
    if only_pred_gt:
        return
    if gt is not None:
        nh_io.save_img_u8(rgb_cc, os.path.join(out_dir,
                                               f"{name}_color_cc.png"))
    if "distance_mean" in rendering:
        nh_io.save_img_f32(rendering["distance_mean"],
                           os.path.join(out_dir, f"{name}_depth.tiff"))
    if gt is not None:
        with open(os.path.join(out_dir, f"{name}_metrics.txt"), "w") as f:
            for k, v in metrics.items():
                f.write(f"{k} {v}\n")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config_from_args(args)
    if args.eval_data:
        config.eval_data = args.eval_data
    preflight(config)
    pin_fp32_precision()

    model = construct_model(config, device,
                            torch.Generator().manual_seed(config.seed))
    dataset = load_dataset(config.eval_data, config.data_dir, config,
                           is_training=False)
    harness = nh_image.MetricHarness(device=device)
    recorder = Recorder(config.checkpoint_dir)
    out_dir = os.path.join(config.checkpoint_dir, f"{config.eval_data}_preds")
    if config.eval_save_output:
        os.makedirs(out_dir, exist_ok=True)

    last_step = None
    while True:
        use_ft, step = checkpoints.pick_eval_checkpoint(config.checkpoint_dir)
        ckpt_dir = (os.path.join(config.checkpoint_dir, "finetune") if use_ft
                    else config.checkpoint_dir)
        if step is None:
            # Polling mode starts beside the trainer: wait for the first
            # checkpoint. One-shot mode fails loudly.
            if config.eval_only_once:
                raise FileNotFoundError(
                    f"no checkpoint under {config.checkpoint_dir}")
            recorder.print(
                f"no checkpoint yet under {config.checkpoint_dir}, sleeping")
            time.sleep(10)
            continue
        # Dedupe on the effective step: finetune checkpoints count from 0
        # again, so they are offset by max_steps.
        effective_step = step + (config.max_steps if use_ft else 0)
        if last_step is not None and effective_step <= last_step:
            if config.eval_only_once:
                break
            time.sleep(10)
            continue
        last_step = effective_step
        checkpoints.check_model_compat(config.checkpoint_dir, config)
        checkpoints.restore_params(ckpt_dir, model, step)
        recorder.print(f"Evaluating checkpoint step {step} from {ckpt_dir}")
        # The train_frac the weights were trained at (sampling anneal);
        # finetune checkpoints sit past the whole schedule.
        train_frac = 1.0 if use_ft else float(
            np.clip(step / config.max_steps, 0.0, 1.0))

        all_metrics = []
        num_eval = min(dataset.size, config.eval_dataset_limit)
        for idx in range(num_eval):
            if idx % config.eval_render_interval != 0:
                continue
            batch = dataset.generate_ray_batch(idx)
            t0 = time.time()
            rendering = render_image(model, batch.rays, train_frac, config,
                                     device)
            recorder.print(f"image {idx}/{num_eval} rendered in "
                           f"{time.time() - t0:.2f}s")
            rgb = np.clip(np.nan_to_num(rendering["rgb"]), 0, 1)
            gt = None if batch.rgb is None else nh_image.composite_alpha(
                np.asarray(batch.rgb),
                nh_image.BACKGROUND_VALUES[config.test_background_color])
            name = (dataset.image_name(idx) if args.original_name
                    else f"{idx:03d}")
            metrics, rgb_cc = {}, None
            if gt is not None:
                metrics, rgb_cc = score_image(rgb, gt, config, harness)
                all_metrics.append(metrics)
                recorder.print("  " + " ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()))
            ray_bags = {k: v for k, v in rendering.items()
                        if k.startswith("ray_")}
            if config.eval_save_ray_data and ray_bags:
                np.savez(os.path.join(out_dir, f"{name}_rays.npz"),
                         **{f"{k}_{i}": arr for k, v in ray_bags.items()
                            for i, arr in enumerate(v)})
            if config.eval_save_output:
                _save_outputs(out_dir, name, rgb, gt, rgb_cc, rendering,
                              metrics, args.only_pred_gt)

        if all_metrics:
            mean = {k: float(np.mean([m[k] for m in all_metrics]))
                    for k in all_metrics[0]}
            recorder.print("mean: " + " ".join(
                f"{k}={v:.4f}" for k, v in mean.items()))
            # Finetune steps share numbers with train steps: the stage is
            # part of the name, so one summary cannot overwrite the other.
            stage = "finetune_" if use_ft else ""
            with open(os.path.join(
                    config.checkpoint_dir,
                    f"metrics_{config.eval_data}_{stage}{step}.txt"),
                    "w") as f:
                for k, v in mean.items():
                    f.write(f"{k} {v}\n")
        if config.eval_only_once or polling_done(config, use_ft, step):
            break

    recorder.print("evaluation complete")
    recorder.close()
