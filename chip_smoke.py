#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nerf_hugs_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device: require CUDA, print the card's name and power limit, pin fp32;
  2. build every kernel of nerf_hugs_torch/csrc/ with nvcc, one process per
     source, all started together;
  3. the hash-grid kernels against their plain PyTorch versions on the
     card, at the field's and the proposal's grid specs of
     kubric_nerfacto_base, for both hash_impls, on 2^20 random positions
     plus exact-1.0 edges and on the main path's [16384, samples per ray, 3]
     sample tensors (forward within 1e-6 absolute, table gradient within
     1e-5 of its largest entry; the atomics sum in a varying order), then
     the median of 10 timed runs of each at the main path's shapes;
  4. the fused-MLP kernel against its plain version at the three shapes of
     kubric_nerfacto_base with enable_tcnn_mlp (proposal mlp_base
     [4194304, 14] -> 64 -> 1, field mlp_base [2097152, 32] -> 256 -> 65,
     field mlp_head [2097152, 80] -> 256 -> 256 -> 3), in bf16 within 2 bf16
     ulps (2^-7) of the output's largest entry and in fp32 within 1e-5 of
     it, also on a ragged, unaligned span of 4097 rows, then the median of
     10 timed runs of each;
  5. a small model on the card (kernels) against the same weights on the
     CPU (plain versions), loss and every parameter gradient, with the
     Dense MLPs and with enable_tcnn_mlp on for the field and the proposal;
  6. 8 train steps of configs/nerfacto/kubric_nerfacto_base.yml at full
     model width on a procedural scene through `nerf_hugs_torch.train.main`,
     with the hash-grid kernels' launch counters read around the run;
  7. the same 8 steps with enable_tcnn_mlp on for the field and the
     proposal, then `nerf_hugs_torch.eval.main` on its checkpoint (2 test
     images of 256x256, 4 render chunks each) with the fused-MLP and
     hash-grid launch counters read around the eval, then the scoring CLI
     over the test_preds/ PNGs the eval wrote.
The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384              # rays per step of kubric_nerfacto_base
FIELD_N = BATCH * 128      # batch x field samples per ray
PROPOSAL_N = BATCH * 256   # batch x proposal samples per ray
# The fused-MLP shapes of kubric_nerfacto_base with enable_tcnn_mlp.
FUSED_SHAPES = (("proposal mlp_base", PROPOSAL_N, (14, 64, 1)),
                ("field mlp_base", FIELD_N, (32, 256, 65)),
                ("field mlp_head", FIELD_N, (80, 256, 256, 3)))
# Relative to the output's largest entry (see phase 4 above).
FUSED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def median_ms(fn, runs: int = 10) -> float:
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, hashgrid, hashgrid_bwd, spec, table, pos, g, label):
    """Both kernels against their plain versions on the same inputs;
    returns (forward max abs error, table-gradient max abs error)."""
    out_k = hashgrid.hashgrid_fwd(table, pos, spec)
    out_p = hashgrid.hashgrid_encode_plain(table, pos, spec)
    gt_k = hashgrid_bwd.hashgrid_table_grad(pos, g, spec)
    gt_p = hashgrid_bwd.hashgrid_table_grad_plain(pos, g, spec)
    torch.cuda.synchronize()
    check(out_k.shape == out_p.shape == g.shape,
          f"hashgrid_fwd gave {tuple(out_k.shape)} ({label})")
    fwd_abs = float((out_k - out_p).abs().max())
    fwd_rel = fwd_abs / float(out_p.abs().max())
    bwd_abs = float((gt_k - gt_p).abs().max())
    bwd_rel = bwd_abs / float(gt_p.abs().max())
    print(f"check {label}: fwd max_abs={fwd_abs:.3e} max_rel={fwd_rel:.3e}  "
          f"table-grad max_abs={bwd_abs:.3e} max_rel={bwd_rel:.3e}",
          flush=True)
    check(math.isfinite(fwd_abs) and fwd_abs <= 1e-6,
          f"hashgrid_fwd disagrees with its plain version ({label}): "
          f"{fwd_abs}")
    check(math.isfinite(bwd_rel) and bwd_rel <= 1e-5,
          f"hashgrid_bwd disagrees with its plain version ({label}): "
          f"{bwd_rel}")
    return fwd_abs, bwd_abs


def kernel_phase(torch, hashgrid, hashgrid_bwd, dev):
    """Kernel vs plain version at the main path's specs and sample shapes;
    returns the worst errors and the timings per spec."""
    field = hashgrid.HashGridSpec(num_levels=16, features_per_level=2,
                                  log2_hashmap_size=21, base_res=16,
                                  max_res=8192)
    proposal = hashgrid.HashGridSpec(num_levels=7, features_per_level=2,
                                     log2_hashmap_size=17, base_res=16,
                                     max_res=2048)
    gen = torch.Generator(device=dev).manual_seed(0)
    edges = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.3, 0.7], [0.3, 1.0, 0.7],
                          [0.3, 0.7, 1.0], [0.0, 0.0, 0.0]], device=dev)
    pos = torch.cat([torch.rand((1 << 20, 3), generator=gen, device=dev),
                     edges])
    worst = {"fwd": 0.0, "bwd": 0.0}
    timings = {}
    for name, base_spec, n_main in (("field", field, FIELD_N),
                                    ("proposal", proposal, PROPOSAL_N)):
        # [rays, samples per ray, 3], as the model hands the encoder.
        main_shape = (BATCH, n_main // BATCH)
        for impl in ("xor", "add"):
            spec = dataclasses.replace(base_spec, hash_impl=impl)
            table = torch.rand(spec.num_rows * 2, generator=gen,
                               device=dev) * 2 - 1
            g = torch.randn((pos.shape[0], spec.output_dim), generator=gen,
                            device=dev)
            errs = [compare(torch, hashgrid, hashgrid_bwd, spec, table, pos,
                            g, f"{name:8s} {impl}, {pos.shape[0]} positions "
                            "with exact-1.0 edges")]
            p = torch.rand(main_shape + (3,), generator=gen, device=dev)
            g = torch.randn(main_shape + (spec.output_dim,), generator=gen,
                            device=dev)
            errs.append(compare(torch, hashgrid, hashgrid_bwd, spec, table, p,
                                g, f"{name:8s} {impl}, [{BATCH}, "
                                f"{main_shape[1]}, 3] main-path samples"))
            for fwd_abs, bwd_abs in errs:
                worst["fwd"] = max(worst["fwd"], fwd_abs)
                worst["bwd"] = max(worst["bwd"], bwd_abs)
            if impl != "xor":
                continue
            t = {
                "fwd": median_ms(
                    lambda: hashgrid.hashgrid_fwd(table, p, spec)),
                "fwd_plain": median_ms(
                    lambda: hashgrid.hashgrid_encode_plain(table, p, spec)),
                "bwd": median_ms(
                    lambda: hashgrid_bwd.hashgrid_table_grad(p, g, spec)),
                "bwd_plain": median_ms(
                    lambda: hashgrid_bwd.hashgrid_table_grad_plain(
                        p, g, spec)),
            }
            timings[name] = t
            print(f"time  {name:8s} xor, {n_main} samples x "
                  f"{spec.num_levels} levels: fwd {t['fwd']:.3f} ms (plain "
                  f"{t['fwd_plain']:.3f})  table-grad {t['bwd']:.3f} ms "
                  f"(plain {t['bwd_plain']:.3f})", flush=True)
    return worst, timings


def fused_mlp_phase(torch, fused_mlp, dev):
    """The fused-MLP kernel vs its plain version at the main path's shapes,
    bf16 and fp32; returns the worst abs error and the timings."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst, timings = 0.0, {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, n, dims in FUSED_SHAPES:
            x = torch.randn((n, dims[0]), generator=gen, device=dev).to(dtype)
            ws = [((torch.rand((a, b), generator=gen, device=dev) * 2 - 1)
                   * math.sqrt(6.0 / a)).to(dtype)
                  for a, b in zip(dims[:-1], dims[1:])]
            out_k = fused_mlp.fused_mlp_fwd(x, ws)
            out_p = fused_mlp.fused_mlp_plain(x, ws)
            torch.cuda.synchronize()
            label = f"{name} {dtype_name} [{n}, {dims[0]}] -> " + " -> ".join(
                str(d) for d in dims[1:])
            check(out_k.shape == out_p.shape == (n, dims[-1])
                  and out_k.dtype == dtype, f"fused_mlp_fwd gave "
                  f"{tuple(out_k.shape)} {out_k.dtype} ({label})")
            err = float((out_k.float() - out_p.float()).abs().max())
            rel = err / float(out_p.float().abs().max())
            # A ragged row count (64 * 64 + 1) starting one row in, so the
            # last tile is partial and, for d_in 14, x is not 16-byte
            # aligned: the masked edges and the input's plain-load path.
            sub = x[1:1 + 64 * 64 + 1]
            sub_err = float((fused_mlp.fused_mlp_fwd(sub, ws).float()
                             - out_p[1:1 + sub.shape[0]].float()).abs().max())
            rel = max(rel, sub_err / float(out_p.float().abs().max()))
            worst = max(worst, err, sub_err)
            t = {"ms": median_ms(lambda: fused_mlp.fused_mlp_fwd(x, ws)),
                 "plain_ms": median_ms(
                     lambda: fused_mlp.fused_mlp_plain(x, ws))}
            timings[(name, dtype_name)] = t
            print(f"check {label}: max_abs={err:.3e} (ragged span "
                  f"{sub_err:.3e}) max_rel={rel:.3e} "
                  f"(tol {FUSED_TOL[dtype_name]:.3e}); kernel "
                  f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms",
                  flush=True)
            check(math.isfinite(rel) and rel <= FUSED_TOL[dtype_name],
                  f"fused_mlp_fwd disagrees with its plain version "
                  f"({label}): {rel}")
            del x, ws, out_k, out_p, sub
    return worst, timings


SMALL_YAML = """\
base:
  dataset_type: synthetic
  downsample_factor: 1
  model_type: nerfacto
  batch_size: 256
  patch_size: 4
  num_img_per_batch: 4
  num_steps: 100
  warmup_steps: 10
  near: 0.5
  far: 4.0
  bound: 1.5
  enable_amp: false
  synthetic_num_images: 4
  synthetic_height: 32
  synthetic_width: 32
  test_background_color: gray
model:
  num_proposal_iterations: 1
  num_proposal_samples_per_ray: [32]
  num_nerf_samples_per_ray: 16
  log2_hashmap_size: 12
  num_levels: 6
  base_res: 4
  max_res: 128
  hidden_dim: 32
  hidden_dim_color: 32
  geo_feat_dim: 15
  proposal_net_args_list:
  - {base_res: 4, hidden_dim: 16, log2_hashmap_size: 10, num_levels: 4,
     max_res: 32}
  distortion_loss_mult: 0.002
"""


def fused_overlay(model: dict) -> dict:
    """The model section with enable_tcnn_mlp on for the field and for
    every proposal_net_args_list entry."""
    return {**model, "enable_tcnn_mlp": True, "proposal_net_args_list": [
        {**a, "enable_tcnn_mlp": True}
        for a in model["proposal_net_args_list"]]}


def small_model_phase(torch, tmp, dev, fused: bool):
    """A small model through the kernels on the card vs the same weights
    through the plain versions on the CPU."""
    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss
    raw = yaml.safe_load(SMALL_YAML)
    if fused:
        raw["model"] = fused_overlay(raw["model"])
    path = os.path.join(tmp, "small.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    config = driver.load_config(path, tmp, os.path.join(tmp, "small_ckpt"))
    batch = next(load_dataset("train", tmp, config, is_training=True))
    results = {}
    for device in ("cpu", dev):
        model = NerfactoModel(config, device,
                              torch.Generator().manual_seed(0))
        check(model.field.mlp_head.fused == fused
              and model.proposal_0.mlp_base.fused == fused,
              "the small model's MLPs do not follow enable_tcnn_mlp")
        loss, _ = compute_loss(model, batch.to(device), 0.3, config, None)
        loss.backward()
        results[device] = (loss.item(), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = results["cpu"], results[dev]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_rel = max(float((grads_g[k] - grads_c[k]).abs().max())
                   / max(float(grads_c[k].abs().max()), 1e-30)
                   for k in grads_c)
    mlp = "fused MLPs" if fused else "Dense MLPs"
    print(f"check small model ({mlp}) cuda vs cpu: loss {loss_g:.6f} vs "
          f"{loss_c:.6f} (rel {loss_rel:.2e}); worst gradient error "
          f"{grad_rel:.2e} of the leaf's max", flush=True)
    check(math.isfinite(loss_g) and loss_rel <= 1e-5,
          f"small-model loss differs between cuda and cpu ({mlp})")
    check(grad_rel <= 1e-4, f"small-model gradients differ between cuda "
                            f"and cpu ({mlp})")


def launch_counters():
    from nerf_hugs_torch.ops import fused_mlp, hashgrid, hashgrid_bwd
    return {"hashgrid_fwd": hashgrid.hashgrid_fwd,
            "hashgrid_bwd": hashgrid_bwd.hashgrid_table_grad,
            "fused_mlp_fwd": fused_mlp.fused_mlp_fwd}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in launch_counters().items()}


def train_phase(torch, tmp, fused: bool):
    """8 full-width kubric_nerfacto_base steps through the driver; returns
    (config path, checkpoint dir, kernel launches)."""
    import yaml
    from nerf_hugs_torch.train import main as train_main
    with open(os.path.join(HERE, "configs", "nerfacto",
                           "kubric_nerfacto_base.yml")) as f:
        raw = yaml.safe_load(f)
    raw["base"].update({
        "dataset_type": "synthetic", "early_exit_steps": 8, "print_every": 1,
        "synthetic_num_images": 32, "synthetic_height": 512,
        "synthetic_width": 512,
        # Shrinks the procedural world so the sphere lies inside the
        # config's near/far (0.1/2) and bound (1).
        "synthetic_world_scale": 0.5,
        # Read by the eval phase only: 2 test images.
        "eval_dataset_limit": 2})
    tag = "fused" if fused else "dense"
    if fused:
        raw["model"] = fused_overlay(raw["model"])
    cfg_path = os.path.join(tmp, f"kubric_nerfacto_base_synthetic_{tag}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    save_dir = os.path.join(tmp, "exp", tag)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    train_main(["--config", cfg_path, "--data_dir", tmp, "--save_dir",
                save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(save_dir, "run_log.log")) as f:
        log = f.read()
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
             for m in re.finditer(r"\[train\] (\d+)/\d+: loss=(\S+) "
                                  r"psnr=\S+ lr=\S+ (\S+) steps/s", log)]
    evals = re.findall(r"\[train\] \d+: eval psnr=(\S+)", log)
    check([s for s, _, _ in steps] == list(range(1, 9)),
          f"expected print lines for steps 1..8, got {steps}")
    check(all(math.isfinite(loss) for _, loss, _ in steps),
          "non-finite training loss")
    expected = ["hashgrid_fwd", "hashgrid_bwd"] + (
        ["fused_mlp_fwd"] if fused else [])
    check(all(launches[k] > 0 for k in expected),
          f"a kernel was not launched during training: {launches}")
    check(fused or launches["fused_mlp_fwd"] == 0,
          f"the Dense run launched the fused MLP: {launches}")
    check(os.path.exists(os.path.join(save_dir, "checkpoint_8.pt")),
          "no step-8 checkpoint")
    check(len(evals) == 1 and math.isfinite(float(evals[0])),
          "the final eval printed no PSNR")
    # Steps 2..8, each timed from the previous print to its own (the
    # driver synchronises on the stats it prints).
    rate = 7 / sum(1 / r for _, _, r in steps[1:])
    print(f"train ({tag} MLPs): 8 steps in {wall:.1f} s; steps/s after the "
          f"first step {rate:.3f} ({rate * 16384:.0f} rays/s); losses "
          f"{[round(loss, 5) for _, loss, _ in steps]}; eval psnr "
          f"{evals[0]}; peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}", flush=True)
    return cfg_path, save_dir, launches


def png_psnr(pred_path: str, gt_path: str) -> float:
    """PSNR of one PNG pair in float64 numpy, independent of the port."""
    import numpy as np
    from PIL import Image
    pred, gt = (np.asarray(Image.open(p), np.float64)[..., :3] / 255.0
                for p in (pred_path, gt_path))
    return float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))


def eval_phase(torch, cfg_path: str, save_dir: str):
    """nerf_hugs_torch.eval on the fused run's checkpoint, then the scoring
    CLI over the PNGs it wrote; returns the eval's kernel launches."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.metrics import main as score_main
    reset_launches()
    t0 = time.time()
    eval_main(["--config", cfg_path, "--data_dir", os.path.dirname(cfg_path),
               "--save_dir", save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    check(launches["fused_mlp_fwd"] > 0 and launches["hashgrid_fwd"] > 0,
          f"eval did not run through the kernels: {launches}")

    preds = os.path.join(save_dir, "test_preds")
    colors = sorted(f for f in os.listdir(preds) if f.endswith("_color.png"))
    check(colors == ["000_color.png", "001_color.png"],
          f"eval wrote {colors}")
    summary_path = os.path.join(save_dir, "metrics_test_8.txt")
    check(os.path.exists(summary_path), "eval wrote no metrics_test_8.txt")
    with open(summary_path) as f:
        mean = {k: float(v) for k, v in (line.split() for line in f)}
    check(math.isfinite(mean["psnr"]) and math.isfinite(mean["psnr_cc"])
          and 0 < mean["ssim"] <= 1,
          f"eval metrics out of range: {mean}")
    with open(os.path.join(save_dir, "run_log.log")) as f:
        renders = re.findall(r"image \d+/\d+ rendered in (\S+)s", f.read())
    print(f"eval (fused MLPs): 2 images of 256x256 in {wall:.1f} s "
          f"(render {', '.join(renders)} s); mean {mean}; launches "
          f"{launches}", flush=True)

    out_dir = os.path.join(os.path.dirname(save_dir), "scores")
    score_main(["--experiment_dir", os.path.dirname(save_dir),
                "--scene_names", os.path.basename(save_dir), "--save",
                "--output_dir", out_dir, "--device", "cuda"])
    with open(os.path.join(out_dir, "metrics_results.json")) as f:
        scores = json.load(f)
    scene = scores[os.path.basename(save_dir)]
    # The CLI against a float64 PSNR of the same PNG pairs.
    worst = max(abs(scene[name]["psnr"] - png_psnr(
        os.path.join(preds, f"{name}_color.png"),
        os.path.join(preds, f"{name}_gt.png"))) for name in ("000", "001"))
    # The PNGs truncate to uint8 where the eval's metrics round to the
    # uint8 grid: each pixel moves by less than 1/255 in the prediction and
    # in the GT, so the two RMS errors differ by at most 2/255.
    rmse = lambda psnr: 10.0 ** (-psnr / 20.0)
    gap = abs(rmse(scores["mean"]["psnr"]) - rmse(mean["psnr"]))
    print(f"score: CLI psnr {scores['mean']['psnr']:.6f} ssim "
          f"{scores['mean']['ssim']:.6f} over the PNGs; worst per-image "
          f"difference to a float64 PSNR of the same PNGs {worst:.2e}; "
          f"eval psnr {mean['psnr']:.6f} (rmse gap {gap:.2e}, bound "
          f"{2 / 255:.2e})", flush=True)
    check(worst <= 1e-4, f"the scoring CLI's psnr is off by {worst}")
    check(gap <= 2 / 255, "the scoring CLI's psnr does not fit the eval's")
    return launches


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "nerf_hugs_torch")):
        fail("nerf_hugs_torch/ is not beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_hugs_torch.ops import fused_mlp, hashgrid, hashgrid_bwd, kernels
    from nerf_hugs_torch.utils.device import pin_fp32_precision
    pin_fp32_precision()
    kernels.load()
    built = ", ".join(os.path.relpath(p, HERE) for p in kernels.sources())
    print(f"build: {built} -> {kernels.build_seconds:.1f} s", flush=True)
    for src, log in kernels.build_log.items():
        for line in log.splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                print(f"ptxas {src}: {line.strip()}", flush=True)

    worst, timings = kernel_phase(torch, hashgrid, hashgrid_bwd, dev)
    fused_worst, fused_timings = fused_mlp_phase(torch, fused_mlp, dev)
    with tempfile.TemporaryDirectory() as tmp:
        small_model_phase(torch, tmp, dev, fused=False)
        small_model_phase(torch, tmp, dev, fused=True)
        _, _, launches = train_phase(torch, tmp, fused=False)
        cfg_path, save_dir, _ = train_phase(torch, tmp, fused=True)
        eval_launches = eval_phase(torch, cfg_path, save_dir)
    check("jax" not in sys.modules, "jax was imported")

    field = timings["field"]
    head = fused_timings[("field mlp_head", "bfloat16")]
    print(json.dumps({"kernels": [
        {"name": "hashgrid_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid.py:448",
         "launches": launches["hashgrid_fwd"], "max_abs_err": worst["fwd"],
         "ms": field["fwd"], "plain_ms": field["fwd_plain"]},
        {"name": "hashgrid_bwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid_bwd.py:48",
         "launches": launches["hashgrid_bwd"], "max_abs_err": worst["bwd"],
         "ms": field["bwd"], "plain_ms": field["bwd_plain"]},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_hugs_tpu/ops/fused_mlp.py:39",
         "launches": eval_launches["fused_mlp_fwd"],
         "max_abs_err": fused_worst, "ms": head["ms"],
         "plain_ms": head["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
