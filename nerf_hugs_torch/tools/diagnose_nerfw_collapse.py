"""Diagnose a NeRF-W collapse from a checkpoint of the distractor run.

Twin of tools/diagnose_nerfw_collapse.py. At 1024-wide transient capacity
on the 32-image distractor scene, NeRF-W under the reference's
nerfw_density_loss_mult of 0.01 can end with a static-only eval render far
below its train PSNR. Two explanations: (a) the zero_glo / zero_tra static
render path is broken; (b) the transient branch absorbed the whole scene,
the degenerate NeRF-W optimum on small data.

The tool tells them apart from the saved checkpoint: it renders each of
the first --views TRAIN views of the same poisoned scene twice, once
through the training composite (embeddings live, `rgb_combined`: what the
train loss saw) and once through the eval path (the config's zero_glo /
zero_tra: what test scoring saw), and prints one line a view:

    view {idx}: combined_psnr=... static_only_psnr=... static_acc=...
    combined_static_part_mean=... transient_part_mean=... beta_mean=...
    (beta_min=...)

  - (a): the combined render reproduces the train PSNR while the static
    path scores low from the first checkpoints on.
  - (b): combined PSNR near the logged train PSNR, static accumulation
    near 0, the transient part carrying the colour, beta near beta_min.

    python -m nerf_hugs_torch.tools.diagnose_nerfw_collapse \\
        [--save-dir DIR] [--config GIN] [--views N] [--device cuda|cpu]

The config is bound as the JAX package's distractor runs bound it (the
validate_quality scene: 32 synthetic_distractor images of 192x256 at
factor 2; tools/tpu_queue_r4_long.sh), so --save-dir is the directory of
`python -m nerf_hugs_torch.tools.validate_quality --config GIN --steps
3000 --binding 'Config.factor = 2'`, whose default it shares. It restores
the newest checkpoint there through train/checkpoints (none is an error)
and renders through train/render_image. It runs on the card unless
--device cpu is given; without a card that is an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device

DEFAULT_CONFIG = "configs/mipnerf360/distractor_1024_glo4_nerfw.gin"
# The bindings of the JAX package's distractor runs
# (tools/diagnose_nerfw_collapse.py:62-72).
BINDINGS = (
    "Config.dataset_loader = 'synthetic_distractor'",
    "Config.synthetic_num_images = 32",
    "Config.synthetic_height = 192",
    "Config.synthetic_width = 256",
    "Config.synthetic_world_scale = 0.35",
    "Config.max_steps = 3000",
    "Config.finetune_enable = False",
    "Config.factor = 2",
    "Model.remat_mlp = True",
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.diagnose_nerfw_collapse",
        description="Render train views of a NeRF-W checkpoint through the "
                    "training composite and the static-only eval path.")
    parser.add_argument("--save-dir", default=None,
                        help="the run's checkpoint directory (default: "
                             "validate_quality's, validate_{config stem} "
                             "under the temporary directory)")
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--views", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.save_dir is None:
        stem = os.path.splitext(os.path.basename(args.config))[0]
        args.save_dir = os.path.join(tempfile.gettempdir(),
                                     f"validate_{stem}")
    return args


def load_config(args):
    """The config of the distractor run: the gin file under BINDINGS."""
    argv = ["--gin_configs", args.config]
    for binding in BINDINGS:
        argv += ["--gin_bindings", binding]
    argv += ["--data_dir", "synthetic", "--save_dir", args.save_dir]
    return driver.load_config_from_args(driver.parse_args(argv))


def restore(config, save_dir: str, device):
    """(the config's model with the newest checkpoint under save_dir, its
    step)."""
    model = construct_model(config, device, torch.Generator().manual_seed(0))
    step = checkpoints.restore_params(save_dir, model)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {save_dir}")
    return model, step


def psnr(x, y) -> float:
    """The JAX tool's PSNR: of x clipped to [0, 1] against y."""
    return float(-10.0 / np.log(10.0)
                 * np.log(np.mean((np.clip(x, 0, 1) - y) ** 2)))


def diagnose_view(model, config, batch, device) -> dict:
    """One train view through the training composite and the eval path."""
    gt = np.asarray(batch.rgb)[..., :3]
    live = dataclasses.replace(config, enable_render_zero_glo=False,
                               enable_render_zero_tra=False)
    full = render_image(model, batch.rays, 1.0, live, device)
    static = render_image(model, batch.rays, 1.0, config, device)
    mean = lambda v: float(np.mean(np.asarray(v)))
    return {
        "combined_psnr": psnr(full.get("rgb_combined", full["rgb"]), gt),
        "static_only_psnr": psnr(static["rgb"], gt),
        "static_acc": mean(static["acc"]),
        "combined_static_part_mean": mean(full["rgb_static"]),
        "transient_part_mean": mean(full["rgb_transient"]),
        "beta_mean": mean(full["uncertainty"]),
    }


def view_line(idx: int, d: dict, beta_min: float) -> str:
    return (f"view {idx}: combined_psnr={d['combined_psnr']:.2f} "
            f"static_only_psnr={d['static_only_psnr']:.2f} "
            f"static_acc={d['static_acc']:.4f} "
            f"combined_static_part_mean={d['combined_static_part_mean']:.4f} "
            f"transient_part_mean={d['transient_part_mean']:.4f} "
            f"beta_mean={d['beta_mean']:.4f} (beta_min={beta_min})")


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    pin_fp32_precision()
    config = load_config(args)
    model, step = restore(config, args.save_dir, device)
    print(f"restored step {step} from {args.save_dir}", flush=True)
    train_ds = load_dataset("train", "", config, is_training=True)
    for idx in range(min(args.views, train_ds.size)):
        batch = train_ds.generate_ray_batch(idx)
        print(view_line(idx, diagnose_view(model, config, batch, device),
                        config.model.beta_min), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
