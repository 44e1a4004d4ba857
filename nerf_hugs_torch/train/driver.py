"""The training driver of the port, in both config dialects of train.py.

    python -m nerf_hugs_torch.train --config configs/nerfacto/X.yml \\
        --data_dir DATA --save_dir CKPT [--device cuda|cpu]
    python -m nerf_hugs_torch.train \\
        --gin_configs=configs/mipnerf360/X.gin \\
        --gin_bindings="Config.data_dir = 'DATA'" \\
        --gin_bindings="Config.checkpoint_dir = 'CKPT'" [--logtostderr] \\
        [--device cuda|cpu]

The yaml dialect builds nerfacto, the gin dialect Mip-NeRF 360 (or
whatever Config.model_type names); --data_dir / --save_dir override either
dialect's directories, and both must end up set (train.py:45-60).
Keeps the loop of the repo's train.py: the stages
["train"] and, with finetune_enable, ["finetune"] (the finetune_params
groups re-optimised on the left half of the test images, a data-only
loss, train_frac pinned to 1, checkpoints in {save_dir}/finetune/);
early_exit_steps (train stage only), print_every lines with steps/s and
rays/s, step-numbered checkpoints with the model-compat sidecar, resume
from the newest checkpoint of each stage, RobustNeRF's inlier thresholds
carried from step to step on the device, and the in-train eval, which
reports PSNR and SSIM through the MetricHarness: a rotating window of
eval_images_num test images for nerfacto, one rotating test image
(`next(test_dataset)`, train.py:306-307) for Mip-NeRF 360. Tensorboard
summaries go to {checkpoint_dir}/tb_{stage} (train.py:192-196, 267-288,
346-363; utils/summary.py writes what flax's writer writes): each print
event the train scalars, the loss terms and histograms of the buffer,
each in-train eval its metrics and the images of utils/vis.py's suite.
Every printed line also lands in {save_dir}/run_log.log. It runs on the
card unless --device cpu is given; without a card that is an error. With
--trace each print line ends in the host ms a step of the spans of
TraceLine.SPANS since the last print (utils/trace.py) and the loader's
starved gets.

Run as N processes (`torchrun --nproc_per_node N -m
nerf_hugs_torch.train ...`), it trains one model on N times the per-rank
batch, as train.py does over a global mesh of N hosts: the ranks join the
launcher's process group (--dist_backend, nccl on the card and gloo on the
CPU by default) before any device call, start from rank 0's parameters,
draw their own shares of each global batch and average their gradients
(parallel/mesh.py). Rank 0 alone writes config.gin, run_log.log, tb_*,
the checkpoints and the print and eval lines.
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
from nerf_hugs_torch.models import backbone as model_backbone, construct_model
from nerf_hugs_torch.models import jax_init
from nerf_hugs_torch.parallel import mesh
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import trace, vis
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device
from nerf_hugs_torch.utils.record import Recorder
from nerf_hugs_torch.utils.summary import SummaryWriter


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """The config flags of train.py and eval.py: the gin dialect
    (--gin_configs, --gin_bindings; --logtostderr is accepted and does
    nothing) and the yaml dialect (--config, --data_dir, --save_dir)."""
    parser.add_argument("--gin_configs", action="append", default=[],
                        help="gin config file(s), Mip-NeRF 360 style")
    parser.add_argument("--gin_bindings", action="append", default=[],
                        help="gin binding overrides")
    parser.add_argument("--config", default=None,
                        help="yaml config path, nerfacto style")
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--save_dir", default=None,
                        help="checkpoint dir (nerfacto name)")
    parser.add_argument("--logtostderr", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--dist_backend", default=None, choices=mesh.BACKENDS,
                        help="process-group backend when a launcher such as "
                             "torchrun starts N ranks (default: nccl on "
                             "cuda, gloo on cpu)")


def init_device(args):
    """Join the launcher's process group, if any, before any CUDA call;
    returns (device, whether this call joined it)."""
    joined = mesh.maybe_initialize_distributed(args.device, args.dist_backend)
    return resolve_device(args.device), joined


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.train",
        description="Train a model from a yaml or gin config.")
    add_config_args(parser)
    parser.add_argument("--trace", action="store_true",
                        help="record the program's spans and add their host "
                             "ms a step to each print line")
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


def _eval_metrics(model, batches, train_frac, config, device, harness):
    """Mean metrics (psnr, ssim) of the clipped renders over the test
    images of `batches` (fetched one at a time), against the GT composited
    over the test background; returns them with the last image's
    rendering and batch."""
    per_image = []
    for batch in batches:
        rendering = render_image(model, batch.rays, train_frac, config,
                                 device)
        gt = nh_image.composite_alpha(
            np.asarray(batch.rgb, np.float32),
            nh_image.BACKGROUND_VALUES[config.test_background_color])
        per_image.append(harness(np.clip(rendering["rgb"], 0, 1), gt))
    metrics = {k: float(np.mean([m[k] for m in per_image]))
               for k in per_image[0]}
    return metrics, rendering, batch


class TraceLine:
    """The --trace part of a print line: the host ms a step of SPANS and
    the loader's starved gets (`data.starved`) since the last reading,
    from the records it drains from utils/trace.py's ring."""

    SPANS = ("data.wait", "data.copy", "step.forward", "step.backward",
             "step.update")

    def __init__(self):
        self.restart()

    def restart(self) -> None:
        """Start the next reading from now."""
        trace.drain()
        self.starved = trace.counters().get("data.starved", 0)

    def read(self, steps: int) -> str:
        ms = dict.fromkeys(self.SPANS, 0.0)
        for r in trace.drain():
            if r.name in ms:
                ms[r.name] += (r.end - r.start) * 1e3
        starved = trace.counters().get("data.starved", 0)
        line = " ".join(f"{k}={v / max(steps, 1):.2f}ms"
                        for k, v in ms.items())
        line += f" data.starved={starved - self.starved}"
        self.starved = starved
        return line


def read_stats(stats_buffer, thresholds=None) -> dict:
    """The buffer's losses and PSNRs, the last step's loss terms and, for
    RobustNeRF, the thresholds it hands on, in one copy to the host."""
    terms = stats_buffer[-1]["losses"]
    parts = {"loss": torch.stack([s["loss"] for s in stats_buffer]),
             "psnr": torch.stack([s["psnr"] for s in stats_buffer]),
             "terms": torch.stack([v.float() for v in terms.values()])}
    if thresholds is not None:
        parts["thresholds"] = thresholds.float().reshape(-1)
    flat = torch.cat([v.float() for v in parts.values()]).cpu().numpy()
    bounds = np.cumsum([0] + [len(v) for v in parts.values()])
    host = {k: flat[a:b] for k, a, b in zip(parts, bounds, bounds[1:])}
    host["terms"] = dict(zip(terms, host["terms"].tolist()))
    return host


def train_summaries(writer, step: int, host: dict, steps_per_sec: float,
                    rays_per_sec: float, lr: float,
                    total_time: float) -> None:
    """A print event's summaries (train.py:267-288)."""
    loss, psnr = float(np.mean(host["loss"])), float(np.mean(host["psnr"]))
    writer.scalar("train_loss", loss, step)
    writer.scalar("train_psnr", psnr, step)
    writer.scalar("train_steps_per_sec", steps_per_sec, step)
    writer.scalar("train_rays_per_sec", rays_per_sec, step)
    writer.scalar("learning_rate", lr, step)
    writer.histogram("train_loss_hist", host["loss"], step)
    writer.histogram("train_psnr_hist", host["psnr"], step)
    for name, value in host["terms"].items():
        writer.scalar(f"train_losses/{name}", value, step)
    # PSNR against wall time (train.py:210-213).
    writer.scalar("train_avg_psnr_timed", psnr, int(total_time))


def render_summaries(writer, step: int, metrics: dict, rendering: dict,
                     rays, device) -> None:
    """An in-train eval's summaries (train.py:346-363): its metrics, and
    the visualization suite of the last window image's rendering, computed
    on the device and copied to the host once, clipped to [0, 1]."""
    for k, v in metrics.items():
        writer.scalar(f"eval_{k}", v, step)
    on_device = lambda a: torch.tensor(np.asarray(a), device=device)
    suite = vis.visualize_suite(
        {k: ([on_device(x) for x in v] if k.startswith("ray_")
             else on_device(v)) for k, v in rendering.items()},
        rays.map(on_device))
    images = [torch.clamp(v, 0, 1) for v in suite.values()]
    flat = torch.cat([v.reshape(-1) for v in images]).cpu().numpy()
    bounds = np.cumsum([0] + [v.numel() for v in images])
    for name, image, a, b in zip(suite, images, bounds, bounds[1:]):
        arr = flat[a:b].reshape(image.shape)
        writer.image(f"render_{name}", arr[..., None] if arr.ndim == 2
                     else arr, step)


def check_num_embeddings(config, dataset, stage: str = "train") -> None:
    """With GLO, appearance or transient embeddings, the table must cover
    the split's largest embedding index (test splits, which the finetune
    stage trains on, come after the train images), as train.py:163-181
    checks."""
    mc, nc = config.model, config.nerfacto
    uses_embeds = (mc.num_glo_features > 0 or mc.num_transient_features > 0
                   or (config.model_type in ("nerfacto", "nerf")
                       and (nc.use_appearance_embedding
                            or nc.use_transient_embedding)))
    if not uses_embeds:
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


def load_config_from_args(args):
    """The config of either dialect (train.py:45-60): the yaml of --config,
    else the gin files and bindings; --data_dir / --save_dir override the
    directories, and both must be set."""
    if args.config:
        config = yaml_loader.load_yaml_config(args.config)
    else:
        config = gin_parser.parse_gin_configs(args.gin_configs,
                                              args.gin_bindings)
    if args.data_dir:
        config.data_dir = args.data_dir
    if args.save_dir:
        config.checkpoint_dir = args.save_dir
    if config.checkpoint_dir is None:
        raise ValueError("checkpoint_dir/--save_dir must be set")
    if config.data_dir is None:
        raise ValueError("data_dir must be set")
    return config


def preflight(config) -> None:
    """What a run checks before it builds anything: a ported model type, a
    known transient type with the embeddings its heads read, a ported data
    loader, weight_decay_mults only where the model maps the flax paths
    (Mip-NeRF 360), and, with finetune_enable, finetune_params groups that
    name modules of the model (Mip-NeRF 360: an embedding to train)."""
    backbone = model_backbone(config)
    backbone.check_transient_config(config)
    check_loader(config)
    if config.weight_decay_mults and config.model_type != "mipnerf360":
        raise NotImplementedError(
            "weight_decay_mults is ported for model_type 'mipnerf360' only")
    if config.finetune_enable:
        labels = step_lib.finetune_partitions(config,
                                              backbone.module_names(config))
        if "trainable" not in labels.values():
            raise ValueError(
                "finetune_enable trains Mip-NeRF 360's embeddings ('embedding'"
                " in path), and this model has none: set num_glo_features or"
                " num_transient_features")


def main(argv=None):
    args = parse_args(argv)
    device, joined = init_device(args)
    try:
        train(args, device)
    finally:
        mesh.shutdown(joined)


def train(args, device) -> None:
    config = load_config_from_args(args)
    if args.trace:
        trace.enable()
    preflight(config)
    pin_fp32_precision()
    world = mesh.process_count()
    if config.batch_size % world:
        raise ValueError(f"batch_size {config.batch_size} must divide "
                         f"evenly by {world} processes")

    if mesh.process_index() == 0:
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        with open(os.path.join(config.checkpoint_dir, "config.gin"),
                  "w") as f:
            f.write(gin_parser.config_str(config))
    recorder = Recorder(config.checkpoint_dir,
                        enable_file=mesh.process_index() == 0)

    test_dataset = load_dataset("test", config.data_dir, config,
                                is_training=False)
    harness = nh_image.MetricHarness(device=device)
    model = construct_model(config, device,
                            torch.Generator().manual_seed(config.seed))
    # train.py's own initial weights, drawn as JAX draws them, for every
    # backbone: a nerfacto run's quality hangs on its initial draw by more
    # than the 1 dB the quality gate allows (models/jax_init.py).
    jax_init.init_model_(model, config)
    # Every rank starts from rank 0's parameters (train.py's ranks would
    # each draw their own: ROADMAP, known faults in the reference).
    mesh.replicate(model)
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
    # Each stage's directory carries its own compat sidecar: the render
    # driver checks the directory it restores.
    checkpoints.check_model_compat(ckpt_dir, config)
    checkpoints.record_model_compat(ckpt_dir, config)
    dataset = stage_dataset(stage, config)
    check_num_embeddings(config, dataset, stage)
    init_step = checkpoints.restore_checkpoint(ckpt_dir, model, optimizer,
                                               scheduler) + 1
    rng = torch.Generator(device=device).manual_seed(
        mesh.fold_in(config.seed + (2 if is_finetune else 1)))
    # RobustNeRF's thresholds stay on the device from step to step: reading
    # them on the host would wait for every step.
    robust = config.transient_type == "robustnerf" and not is_finetune
    thresholds = step_lib.initial_inlier_thresholds(config, device)
    # The run's root even in the finetune stage, as train.py:192-196.
    lead = mesh.process_index() == 0
    writer = (SummaryWriter(os.path.join(config.checkpoint_dir,
                                         f"tb_{stage}")) if lead else None)

    # One process keeps the plain copy: against it the pinned prefetch held
    # steps/s from step 9 on but lost 1-3 ms a warm-up step (PERF.md §6).
    batches = (mesh.prefetch_to_device(dataset, device)
               if mesh.process_count() > 1
               else (batch.to(device) for batch in dataset))
    stats_buffer = []
    total_time = 0.0
    traced = TraceLine() if trace.enabled() else None
    start = time.time()
    for step in range(init_step, num_steps + 1):
        batch = next(batches)
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
            spans = "" if traced is None else " " + traced.read(
                len(stats_buffer))
            if lead:
                host = read_stats(stats_buffer, thresholds if robust else None)
                elapsed = time.time() - start
                total_time += elapsed
                steps_per_sec = len(stats_buffer) / max(elapsed, 1e-9)
                lr = scheduler.get_last_lr()[0]
                # The last step's loss terms (and the thresholds it hands the
                # next step).
                terms = " ".join(f"{k}={v:.5f}" for k, v in
                                 host["terms"].items())
                if robust:
                    terms += " inlier_threshold=" + ",".join(
                        f"{t:.6g}" for t in host["thresholds"].tolist())
                recorder.print(
                    f"[{stage}] {step}/{num_steps}: "
                    f"loss={float(np.mean(host['loss'])):.5f} "
                    f"psnr={float(np.mean(host['psnr'])):.3f} lr={lr:.2e} "
                    f"{steps_per_sec:.2f} steps/s "
                    f"{batch_size * steps_per_sec:.0f} rays/s {terms}{spans}")
                train_summaries(writer, step, host, steps_per_sec,
                                batch_size * steps_per_sec, lr, total_time)
            stats_buffer = []
            start = time.time()

        if step % config.checkpoint_every == 0 or step == num_steps:
            checkpoints.save_checkpoint(ckpt_dir, model, optimizer, scheduler,
                                        step)

        if config.train_render_every > 0 and (
                step % config.train_render_every == 0 or step == num_steps):
            if config.model_type == "mipnerf360":
                test_batches = [next(test_dataset)]
            else:
                # Event number = triggers at or before `step`, counting the
                # extra final-step trigger when num_steps is off the
                # cadence.
                event = step // config.train_render_every
                if step == num_steps and step % config.train_render_every:
                    event += 1
                test_batches = (test_dataset.generate_ray_batch(i)
                                for i in eval_window_indices(
                                    event, test_dataset.size,
                                    config.eval_images_num))
            metrics, rendering, test_batch = _eval_metrics(
                model, test_batches, train_frac, config, device, harness)
            if lead:
                recorder.print(f"[{stage}] {step}: eval " + " ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()))
                render_summaries(writer, step, metrics, rendering,
                                 test_batch.rays, device)
            if traced is not None:
                traced.restart()
            start = time.time()
    if lead:
        writer.close()

