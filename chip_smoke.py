#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nerf_hugs_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device: require CUDA, print the card's name and power limit, pin fp32;
  2. build the hash-grid kernels from nerf_hugs_torch/csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     field's and the proposal's grid specs of kubric_nerfacto_base, for both
     hash_impls, on 2^20 random positions plus exact-1.0 edges and on the
     main path's [16384, samples per ray, 3] sample tensors (forward within
     1e-6 absolute, table gradient within 1e-5 of its largest entry; the
     atomics sum in a varying order), then the median of 10 timed runs of
     each at the main path's shapes;
  4. a small model on the card (kernels) against the same weights on the
     CPU (plain versions): loss and every parameter gradient;
  5. 8 train steps of configs/nerfacto/kubric_nerfacto_base.yml at full
     model width on a procedural scene through `nerf_hugs_torch.train.main`,
     with both kernels' launch counters read around the run.
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


def small_model_phase(torch, tmp, dev):
    """A small model through the kernels on the card vs the same weights
    through the plain versions on the CPU."""
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss
    path = os.path.join(tmp, "small.yml")
    with open(path, "w") as f:
        f.write(SMALL_YAML)
    config = driver.load_config(path, tmp, os.path.join(tmp, "small_ckpt"))
    batch = next(load_dataset("train", tmp, config, is_training=True))
    results = {}
    for device in ("cpu", dev):
        model = NerfactoModel(config, device,
                              torch.Generator().manual_seed(0))
        loss, _ = compute_loss(model, batch.to(device), 0.3, config, None)
        loss.backward()
        results[device] = (loss.item(), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = results["cpu"], results[dev]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_rel = max(float((grads_g[k] - grads_c[k]).abs().max())
                   / max(float(grads_c[k].abs().max()), 1e-30)
                   for k in grads_c)
    print(f"check small model cuda vs cpu: loss {loss_g:.6f} vs "
          f"{loss_c:.6f} (rel {loss_rel:.2e}); worst gradient error "
          f"{grad_rel:.2e} of the leaf's max")
    check(math.isfinite(loss_g) and loss_rel <= 1e-5,
          "small-model loss differs between cuda and cpu")
    check(grad_rel <= 1e-4, "small-model gradients differ between cuda "
                            "and cpu")


def train_phase(torch, tmp, hashgrid, hashgrid_bwd):
    """8 full-width kubric_nerfacto_base steps through the driver."""
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
        "synthetic_world_scale": 0.5})
    cfg_path = os.path.join(tmp, "kubric_nerfacto_base_synthetic.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    save_dir = os.path.join(tmp, "ckpt")

    hashgrid.hashgrid_fwd.launches = 0
    hashgrid_bwd.hashgrid_table_grad.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    train_main(["--config", cfg_path, "--data_dir", tmp, "--save_dir",
                save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"hashgrid_fwd": hashgrid.hashgrid_fwd.launches,
                "hashgrid_bwd": hashgrid_bwd.hashgrid_table_grad.launches}
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
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched during training: {launches}")
    check(os.path.exists(os.path.join(save_dir, "checkpoint_8.pt")),
          "no step-8 checkpoint")
    check(len(evals) == 1 and math.isfinite(float(evals[0])),
          "the final eval printed no PSNR")
    # Steps 2..8, each timed from the previous print to its own (the
    # driver synchronises on the stats it prints).
    rate = 7 / sum(1 / r for _, _, r in steps[1:])
    print(f"train: 8 steps in {wall:.1f} s; steps/s after the first step "
          f"{rate:.3f} ({rate * 16384:.0f} rays/s); losses "
          f"{[round(loss, 5) for _, loss, _ in steps]}; eval psnr "
          f"{evals[0]}; peak device memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
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

    from nerf_hugs_torch.ops import hashgrid, hashgrid_bwd, kernels
    from nerf_hugs_torch.utils.device import pin_fp32_precision
    pin_fp32_precision()
    kernels.load()
    print(f"build: csrc/hashgrid.cu -> {kernels.build_seconds:.1f} s",
          flush=True)

    worst, timings = kernel_phase(torch, hashgrid, hashgrid_bwd, dev)
    with tempfile.TemporaryDirectory() as tmp:
        small_model_phase(torch, tmp, dev)
        launches = train_phase(torch, tmp, hashgrid, hashgrid_bwd)
    check("jax" not in sys.modules, "jax was imported")

    field = timings["field"]
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
