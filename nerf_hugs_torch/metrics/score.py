"""The final scoring CLI: PSNR/SSIM/LPIPS over rendered prediction/GT pairs.

    python -m nerf_hugs_torch.metrics --experiment_dir EXP --scene_names S... \\
        [--image_type whole|half_right|half_left] [--save] \\
        [--output_dir DIR] [--lpips_weights W] [--device cpu|cuda]

Twin of the repo's metrics.py: walks {experiment_dir}/{scene}/test_preds/
*_gt.png, scores each against its *_color.png, and reports per-image,
per-scene-mean and experiment-mean metrics as JSON
({output_dir}/metrics_results.json with --save). half_right is the
Phototourism protocol (the left half finetuned the embeddings). LPIPS needs
AlexNet-LPIPS weights on disk (--lpips_weights .npz or .pth); without them
lpips is left out.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
from pathlib import Path

import numpy as np

from nerf_hugs_tpu.utils import io as nh_io
from nerf_hugs_torch.metrics import image as nh_image
from nerf_hugs_torch.utils.device import resolve_device

IMAGE_TYPES = ["whole", "half_right", "half_left"]


def crop(img: np.ndarray, image_type: str) -> np.ndarray:
    if image_type == "half_left":
        return img[:, : img.shape[1] // 2]
    if image_type == "half_right":
        return img[:, img.shape[1] // 2:]
    return img


def main(experiment_dir, scene_names, image_type="whole", is_save=False,
         output_dir="output_metrics", lpips_weights=None, eval_data="test",
         device="cpu") -> dict:
    """Score every scene; returns {scene: {image: metrics, 'mean': ...},
    'mean': experiment mean}."""
    harness = nh_image.MetricHarness(lpips_weights_path=lpips_weights,
                                     device=device)
    results = collections.defaultdict(dict)
    experiment_mean = collections.defaultdict(list)
    for scene_name in scene_names:
        pred_dir = Path(experiment_dir) / scene_name / f"{eval_data}_preds"
        scene_mean = collections.defaultdict(list)
        gt_paths = sorted(pred_dir.glob("*_gt.png"))
        if not gt_paths:
            raise FileNotFoundError(f"no *_gt.png under {pred_dir}")
        for gt_path in gt_paths:
            image_name = gt_path.stem[:-3]
            pred_path = pred_dir / f"{image_name}_color.png"
            pred = np.clip(nh_io.load_img(str(pred_path))[..., :3] / 255.0,
                           0, 1)
            gt = np.clip(nh_io.load_img(str(gt_path))[..., :3] / 255.0, 0, 1)
            metrics = harness(crop(pred, image_type), crop(gt, image_type))
            results[scene_name][image_name] = metrics
            for key, val in metrics.items():
                scene_mean[key].append(val)
        results[scene_name]["mean"] = {
            key: float(np.mean(vals)) for key, vals in scene_mean.items()}
        for key, val in results[scene_name]["mean"].items():
            experiment_mean[key].append(val)
    results["mean"] = {key: float(np.mean(vals))
                       for key, vals in experiment_mean.items()}

    pad = max(len(s) for s in results)
    for scene_name in results:
        mean = (results["mean"] if scene_name == "mean"
                else results[scene_name]["mean"])
        parts = [f"psnr={mean['psnr']:.2f}", f"ssim={mean['ssim']:.3f}"]
        if "lpips" in mean:
            parts.append(f"lpips={mean['lpips']:.3f}")
        print(f"{scene_name}: {' ' * (pad - len(scene_name))}"
              + ", ".join(parts))

    if is_save:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "metrics_results.json"), "w") as f:
            json.dump(results, f, indent=4)
    return dict(results)


def cli(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.metrics",
        description="Score rendered prediction/GT pairs.")
    parser.add_argument("--experiment_dir", type=str, required=True)
    parser.add_argument("--scene_names", nargs="+", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="output_metrics")
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--image_type", type=str, choices=IMAGE_TYPES,
                        default="whole")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="path to AlexNet-LPIPS weights (.npz or torch)")
    parser.add_argument("--device", type=str, default="cpu",
                        choices=("cpu", "cuda"))
    args = parser.parse_args(argv)
    return main(args.experiment_dir, args.scene_names, args.image_type,
                args.save, args.output_dir, args.lpips_weights,
                device=resolve_device(args.device))
