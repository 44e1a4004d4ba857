"""The render driver of the port, in both config dialects of render.py.

    python -m nerf_hugs_torch.render --config configs/nerfacto/X.yml \\
        --data_dir DATA --save_dir CKPT [--device cuda|cpu]
    python -m nerf_hugs_torch.render \\
        --gin_configs=configs/mipnerf360/X.gin \\
        --gin_bindings="Config.data_dir = 'DATA'" \\
        --gin_bindings="Config.checkpoint_dir = 'CKPT'" [--logtostderr] \\
        [--device cuda|cpu]

Keeps the flow of the repo's render.py for one process: restore the newest
checkpoint, preferring the finetune stage's, and render every frame of the
test split, or of a camera path with render_path (a path file, spline
keyframes, llff's spiral or an ellipse: data/base.py::_apply_render_path),
through the chunked renderer into
{render_dir or save_dir/render}/{test_preds|path_renders}_step_N/:
color_*.png, acc_*.tiff and distance_{mean,median}_*.tiff. Frames are
sharded over independent jobs (frame i belongs to job
i % render_num_jobs), a frame whose file and whose job's next frame's file
exist is skipped, so a killed job resumes, and with render_save_async the
files are written by a pool of 4 threads. The job that finds every colour
frame claims the video encode (.videos_claimed) and encodes with the
ffmpeg binary when there is one; the frames are always written.

Frames render at train_frac 1.0, as render.py's do. One deliberate
divergence from render.py: the model-compat check reads the directory the
weights are restored from (render.py:128 reads checkpoint_dir even when it
restores finetune/). It runs on the card unless --device cpu is given;
without a card that is an error.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train.driver import (add_config_args,
                                          load_config_from_args, preflight)
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import io as nh_io
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device

_CLAIM = ".videos_claimed"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.render",
        description="Render the test split or a camera path of a run.")
    add_config_args(parser)
    return parser.parse_args(argv)


def create_videos(config, base_dir: str, out_dir: str, out_name: str,
                  num_frames: int) -> None:
    """Encode the saved frames with the ffmpeg binary, one video per kind
    (render.py:41-95): the colours, the accumulated opacity, and the
    distances under the turbo colour map between render_dist_percentile's
    percentiles of frame 0's mean distance, on a log curve."""
    if shutil.which("ffmpeg") is None:
        print("ffmpeg not found; skipping video encoding (frames saved)")
        return
    import matplotlib
    names = [n for n in config.checkpoint_dir.split("/") if n]
    exp_name, scene_name = (names[-2:] if len(names) >= 2
                            else ("exp", names[-1]))
    video_prefix = f"{scene_name}_{exp_name}_{out_name}"
    zpad = max(3, len(str(num_frames - 1)))
    curve = {"log": np.log}.get(config.render_dist_curve_fn, np.log)

    depth_file = os.path.join(out_dir, f"distance_mean_{0:0{zpad}d}.tiff")
    lo = hi = None
    if os.path.exists(depth_file):
        depth = nh_io.load_img(depth_file)
        p = config.render_dist_percentile
        lo, hi = [curve(x) for x in
                  np.percentile(depth.flatten(), [p, 100 - p])]

    for tag in ["color", "acc", "distance_mean", "distance_median"]:
        ext = "png" if tag == "color" else "tiff"
        if not os.path.exists(os.path.join(out_dir,
                                           f"{tag}_{0:0{zpad}d}.{ext}")):
            continue
        tmp_dir = os.path.join(base_dir, f"_frames_{tag}")
        os.makedirs(tmp_dir, exist_ok=True)
        for idx in range(num_frames):
            img = nh_io.load_img(os.path.join(out_dir,
                                              f"{tag}_{idx:0{zpad}d}.{ext}"))
            if tag == "color":
                img = img / 255.0
            elif tag == "acc":
                img = np.stack([img] * 3, -1)
            else:
                img = curve(np.maximum(img, 1e-9))
                img = np.clip((img - min(lo, hi)) / abs(hi - lo), 0, 1)
                img = matplotlib.colormaps["turbo"](img)[..., :3]
            nh_io.save_img_u8(np.clip(np.nan_to_num(img), 0, 1),
                              os.path.join(tmp_dir, f"{idx:0{zpad}d}.png"))
        video_file = os.path.join(base_dir, f"{video_prefix}_{tag}.mp4")
        print(f"Encoding {video_file}")
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(config.render_video_fps),
             "-i", os.path.join(tmp_dir, f"%0{zpad}d.png"),
             "-c:v", "libx264", "-crf", str(config.render_video_crf),
             "-pix_fmt", "yuv420p", video_file],
            check=True, capture_output=True)
        shutil.rmtree(tmp_dir, ignore_errors=True)


def claim_video_encode(out_dir: str) -> bool:
    """Claim the video encode atomically (O_CREAT | O_EXCL): two sharded
    jobs can both find the whole frame set, and concurrent ffmpeg runs on
    the same outputs corrupt the videos."""
    try:
        os.close(os.open(os.path.join(out_dir, _CLAIM),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False


def restore(config, model) -> tuple:
    """Load the newest checkpoint, the finetune stage's when finetune is on
    and it has one, after checking model compat on that directory. Returns
    the step as render.py numbers it: finetune steps count on from
    max_steps."""
    ft_dir = os.path.join(config.checkpoint_dir, "finetune")
    use_ft = (config.finetune_enable
              and checkpoints.latest_step(ft_dir) is not None)
    ckpt_dir = ft_dir if use_ft else config.checkpoint_dir
    checkpoints.check_model_compat(ckpt_dir, config)
    step = checkpoints.restore_params(ckpt_dir, model)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return step + int(config.max_steps) if use_ft else step


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = load_config_from_args(args)
    preflight(config)
    pin_fp32_precision()

    model = construct_model(config, device,
                            torch.Generator().manual_seed(config.seed))
    step = restore(config, model)
    print(f"Rendering checkpoint at step {step}.")
    dataset = load_dataset("test", config.data_dir, config,
                           is_training=False)

    out_name = ("path_renders" if config.render_path else "test_preds") \
        + f"_step_{step}"
    base_dir = config.render_dir or os.path.join(config.checkpoint_dir,
                                                 "render")
    out_dir = os.path.join(base_dir, out_name)
    os.makedirs(out_dir, exist_ok=True)
    path_fn = lambda x: os.path.join(out_dir, x)
    zpad = max(3, len(str(dataset.size - 1)))

    futures = []
    pool = (concurrent.futures.ThreadPoolExecutor(max_workers=4)
            if config.render_save_async else None)
    save_fn = ((lambda fn, *a: futures.append(pool.submit(fn, *a)))
               if pool else (lambda fn, *a: fn(*a)))
    jobs = config.render_num_jobs
    for idx in range(dataset.size):
        if idx % jobs != config.render_job_id:
            continue
        idx_str = f"{idx:0{zpad}d}"
        if (os.path.exists(path_fn(f"color_{idx_str}.png")) and
                os.path.exists(path_fn(f"color_{idx + jobs:0{zpad}d}.png"))):
            print(f"Image {idx}/{dataset.size} already exists, skipping")
            continue
        print(f"Evaluating image {idx + 1}/{dataset.size}")
        t0 = time.time()
        rays = dataset.generate_ray_batch(idx).rays
        rendering = render_image(model, rays, 1.0, config, device)
        print(f"Rendered in {time.time() - t0:0.3f}s")
        save_fn(nh_io.save_img_u8, rendering["rgb"],
                path_fn(f"color_{idx_str}.png"))
        for key in ["acc", "distance_mean", "distance_median"]:
            if key in rendering:
                save_fn(nh_io.save_img_f32, rendering[key],
                        path_fn(f"{key}_{idx_str}.tiff"))
    for f in futures:
        f.result()
    if pool:
        pool.shutdown()

    # Whichever job finishes last finds the full frame set and encodes the
    # videos (render.py:198-203).
    if jobs > 1:
        time.sleep(1)  # peer jobs' saves in flight
    num_files = len([n for n in os.listdir(out_dir)
                     if n.startswith("color_") and n.endswith(".png")])
    if num_files == dataset.size:
        if claim_video_encode(out_dir):
            print(f"All files found, creating videos "
                  f"(job {config.render_job_id}).")
            try:
                create_videos(config, base_dir, out_dir, out_name,
                              dataset.size)
            finally:
                # Only concurrent encodes are unsafe: a rerun may encode.
                os.unlink(os.path.join(out_dir, _CLAIM))
        else:
            print(f"video encode already claimed by another job "
                  f"({os.path.join(out_dir, _CLAIM)}); delete that file and "
                  f"rerun to force a re-encode")
    print("render complete")
