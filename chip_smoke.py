#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nerf_hugs_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. device: require CUDA, print the card's name and power limit, pin fp32;
  2. build every kernel of nerf_hugs_torch/csrc/ with nvcc, one process per
     source, all started together;
  3. the hash-grid kernels against their plain PyTorch versions on the
     card, at the field's and the proposal's grid specs of
     kubric_nerfacto_base and of kubric_nerfacto_tpu, for both hash_impls,
     on 2^20 random positions plus exact-1.0 edges, on adversarial sets of
     a ragged 2^13 + 37 samples (all in one cell; all at the origin with
     zero gradient; half of them there, in random lanes; warps split
     between two cells by halves and by alternating lanes; ray-ordered
     samples whose out-of-box tails collapse to the origin with zero
     gradient) and, at kubric_nerfacto_base, on the main path's
     [16384, samples per ray, 3] sample tensors (forward within 1e-6
     absolute, table gradient within 1e-5 of its largest entry; the atomics
     sum in a varying order), then the median of 10 timed runs of each at
     the main path's shapes;
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
  6. the hash-grid kernels on the main path's own inputs: one batch of
     compute_loss + backward through the full-width kubric_nerfacto_base
     model of phase 7 on the card, with hooks on the field's and the
     proposal's HashGridEncoding capturing the grid positions and output
     gradients they receive; both kernels checked against their plain
     versions on them and timed, with the share of out-of-box samples and
     of zero-gradient (sample, level) pairs;
  7. 8 train steps of configs/nerfacto/kubric_nerfacto_base.yml at full
     model width on a procedural scene through `nerf_hugs_torch.train.main`,
     with the hash-grid kernels' launch counters read around the run;
  8. the same 8 steps with enable_tcnn_mlp on for the field and the
     proposal, then `nerf_hugs_torch.eval.main` on its checkpoint (2 test
     images of 256x256, 4 render chunks each) with the fused-MLP and
     hash-grid launch counters read around the eval, then the scoring CLI
     over the test_preds/ PNGs the eval wrote;
  9. the planar-accumulate kernel against its plain version on the gathers
     of n = 2^21 samples from dense levels of 81^3 and 127^3 rows, and on a
     ragged span of them (within 1e-5 absolute), with timings, then the
     microbenchmark `nerf_hugs_torch.tools.bench_fwd_copies` through its
     entry point at n = 2^21, with the kernel's launch counter read around
     it.
Beside each timed kernel it prints its bound: the least time the card could
take, the larger of the bytes it must move (each input read once, each
output written once) over the memory rate and its operations over the peak
rate for their type (H100 SXM data sheet), and, where one PyTorch call
computes the same function, that call's time. The last two lines are the
kernels' JSON record and the result line.
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
# The fused-MLP shapes of kubric_nerfacto_base with enable_tcnn_mlp: (name,
# samples per ray, layer widths); the rows are the batch's rays times the
# samples per ray.
FUSED_SHAPES = (("proposal mlp_base", 256, (14, 64, 1)),
                ("field mlp_base", 128, (32, 256, 65)),
                ("field mlp_head", 128, (80, 256, 256, 3)))
# Relative to the output's largest entry (see phase 4 above).
FUSED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# Ragged: no multiple of a warp or a block. Each adversarial row gradient
# sums up to n payloads, and the plain version's sequential atomics round
# about sqrt(n) times; at 2^13 that stays a few 1e-6 of the largest entry.
ADVERSARIAL_N = (1 << 13) + 37
ACCUM_N = 1 << 21          # samples of the planar-accumulate microbenchmark
ACCUM_SIZES = (81, 127)    # its dense levels of N^3 rows checked in phase 9
# NVIDIA H100 SXM data sheet: memory rate, dense peaks by operand type
# (bf16 on the tensor cores, fp32 on the FMA units).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(least ms, what sets it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    bwd_abs = float((gt_k - gt_p).abs().max())
    # An all-zero plain gradient (every dL/dfeature zero) must come out
    # exactly zero.
    bwd_max = float(gt_p.abs().max())
    bwd_rel = bwd_abs / bwd_max if bwd_max else bwd_abs
    print(f"check {label}: fwd max_abs={fwd_abs:.3e}  table-grad "
          f"max_abs={bwd_abs:.3e} max_rel={bwd_rel:.3e}", flush=True)
    check(math.isfinite(fwd_abs) and fwd_abs <= 1e-6,
          f"hashgrid_fwd disagrees with its plain version ({label}): "
          f"{fwd_abs}")
    check(math.isfinite(bwd_abs) and bwd_abs <= 1e-5 * bwd_max,
          f"hashgrid_bwd disagrees with its plain version ({label}): "
          f"{bwd_rel}")
    return fwd_abs, bwd_abs


def library_hashgrid(torch, hashgrid, hashgrid_bwd, spec, table, p, g):
    """The yardsticks of the hash-grid kernels: one PyTorch call for each
    kernel's function, fed the corner rows and weights computed beforehand
    (outside the timing): `embedding_bag` with per-sample weights for the
    forward's weighted gather, `index_add_` for the table gradient's
    scatter. Each is checked against its kernel; returns their times."""
    pos = p.reshape(-1, spec.num_dims)
    rows, weights = [], []
    for lvl in range(spec.num_levels):
        r, w = hashgrid.corner_rows_level(spec, pos, lvl)
        rows.append(r.t() + int(spec.level_offsets[lvl]))
        weights.append(w.t())
    corners = 2 ** spec.num_dims
    rows = torch.stack(rows, 1).reshape(-1, corners)        # [n * L, 8]
    weights = torch.stack(weights, 1).reshape(-1, corners)
    tab = table.view(-1, spec.features_per_level)
    keys = rows.reshape(-1)
    vals = (weights[..., None] * g.reshape(-1, 1, spec.features_per_level)
            ).reshape(-1, spec.features_per_level)
    fwd = lambda: torch.nn.functional.embedding_bag(
        rows, tab, per_sample_weights=weights, mode="sum")
    bwd = lambda: torch.zeros_like(tab).index_add_(0, keys, vals)
    out_k = hashgrid.hashgrid_fwd(table, p, spec)
    gt_k = hashgrid_bwd.hashgrid_table_grad(p, g, spec)
    fwd_rel = float((fwd().view(out_k.shape) - out_k).abs().max()
                    / out_k.abs().max())
    bwd_rel = float((bwd().view(-1) - gt_k).abs().max() / gt_k.abs().max())
    check(fwd_rel <= 1e-5 and bwd_rel <= 1e-5,
          f"the library yardsticks disagree with the kernels: {fwd_rel}, "
          f"{bwd_rel}")
    return {"fwd_library": median_ms(fwd), "bwd_library": median_ms(bwd)}


def time_hashgrid(torch, hashgrid, hashgrid_bwd, spec, table, p, g, label):
    """Median times of both kernels, their plain versions and their
    yardsticks on one input set, with the bound; prints one line."""
    t = {
        "fwd": median_ms(lambda: hashgrid.hashgrid_fwd(table, p, spec)),
        "fwd_plain": median_ms(
            lambda: hashgrid.hashgrid_encode_plain(table, p, spec)),
        "bwd": median_ms(
            lambda: hashgrid_bwd.hashgrid_table_grad(p, g, spec)),
        "bwd_plain": median_ms(
            lambda: hashgrid_bwd.hashgrid_table_grad_plain(p, g, spec)),
    }
    t.update(library_hashgrid(torch, hashgrid, hashgrid_bwd, spec, table, p,
                              g))
    # Both kernels move the positions, the whole table (these samples touch
    # most of its rows) and a [n, L*F] array once; per sample and level the
    # fp32 work is 16 products of corner weights and 32 operations of the
    # weighted sums.
    n = p.numel() // spec.num_dims
    t["bound_ms"], t["bound_by"] = bound(nbytes(table, p, g),
                                         48 * n * spec.num_levels)
    print(f"time  {label}, {n} samples x {spec.num_levels} levels: fwd "
          f"{t['fwd']:.3f} ms (plain {t['fwd_plain']:.3f}, embedding_bag "
          f"{t['fwd_library']:.3f})  table-grad {t['bwd']:.3f} ms (plain "
          f"{t['bwd_plain']:.3f}, index_add_ {t['bwd_library']:.3f}); bound "
          f"of each {t['bound_ms']:.3f} ms ({t['bound_by']}, "
          f"{nbytes(table, p, g) / 1e6:.1f} MB)", flush=True)
    return t


def adversarial_sets(torch, dev, gen):
    """[(label, positions [ADVERSARIAL_N, 3], zero-gradient mask [n])]:
    the cases that stress the kernels' row combining and zero skipping."""
    n = ADVERSARIAL_N
    lane = torch.arange(n, device=dev) % 32
    a = torch.tensor([0.3, 0.6, 0.2], device=dev).expand(n, 3)
    b = torch.tensor([0.7, 0.1, 0.9], device=dev).expand(n, 3)
    origin = torch.zeros((n, 3), device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    uniform = torch.rand((n, 3), generator=gen, device=dev)
    # Rays of 128 ordered samples from a point in the box; the samples that
    # leave the box collapse to the origin with a zero gradient, as the
    # model's out-of-box samples do.
    rays = -(-n // 128)
    start = torch.rand((rays, 1, 3), generator=gen, device=dev)
    direction = torch.nn.functional.normalize(
        torch.randn((rays, 1, 3), generator=gen, device=dev), dim=-1)
    t = torch.linspace(0.0, 1.5, 128, device=dev)[None, :, None]
    ray_pos = (start + direction * t).reshape(-1, 3)[:n]
    inside = ((ray_pos >= 0) & (ray_pos <= 1)).all(-1)
    return [
        ("every sample in one cell", a.contiguous(), none),
        ("every sample at the origin, zero gradient", origin, ~none),
        ("half at the origin with zero gradient, random lanes",
         torch.where(half[:, None], origin, uniform), half),
        ("warps split between two cells by halves",
         torch.where((lane < 16)[:, None], a, b), none),
        ("warps split between two cells, alternating lanes",
         torch.where((lane % 2 == 0)[:, None], a, b), none),
        ("ray-ordered, out-of-box tails at the origin with zero gradient",
         (ray_pos * inside[:, None]).contiguous(), ~inside),
    ]


def kernel_phase(torch, hashgrid, hashgrid_bwd, dev):
    """Kernel vs plain version at the kubric_nerfacto_base and
    kubric_nerfacto_tpu specs on uniform, edge and adversarial sets, and at
    the main path's sample shapes; returns the worst errors and the
    timings per kubric_nerfacto_base spec."""
    from nerf_hugs_torch.tools.hashgrid_inputs import BATCH, GRIDS
    gen = torch.Generator(device=dev).manual_seed(0)
    edges = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.3, 0.7], [0.3, 1.0, 0.7],
                          [0.3, 0.7, 1.0], [0.0, 0.0, 0.0]], device=dev)
    pos = torch.cat([torch.rand((1 << 20, 3), generator=gen, device=dev),
                     edges])
    adversarial = adversarial_sets(torch, dev, gen)
    worst = {"fwd": 0.0, "bwd": 0.0}
    timings = {}
    for name, kw, n_main in GRIDS:
        base_spec = hashgrid.HashGridSpec(**kw)
        for impl in ("xor", "add"):
            spec = dataclasses.replace(base_spec, hash_impl=impl)
            table = torch.rand(spec.num_rows * 2, generator=gen,
                               device=dev) * 2 - 1
            g = torch.randn((pos.shape[0], spec.output_dim), generator=gen,
                            device=dev)
            errs = [compare(torch, hashgrid, hashgrid_bwd, spec, table, pos,
                            g, f"{name:12s} {impl}, {pos.shape[0]} positions "
                            "with exact-1.0 edges")]
            for label, p, zero in adversarial:
                g = torch.randn((p.shape[0], spec.output_dim), generator=gen,
                                device=dev).masked_fill(zero[:, None], 0.0)
                errs.append(compare(torch, hashgrid, hashgrid_bwd, spec,
                                    table, p, g, f"{name:12s} {impl}, "
                                    f"{p.shape[0]} samples, {label}"))
            if n_main is not None:
                # [rays, samples per ray, 3], as the model hands the encoder.
                main_shape = (BATCH, n_main // BATCH)
                p = torch.rand(main_shape + (3,), generator=gen, device=dev)
                g = torch.randn(main_shape + (spec.output_dim,),
                                generator=gen, device=dev)
                errs.append(compare(
                    torch, hashgrid, hashgrid_bwd, spec, table, p, g,
                    f"{name:12s} {impl}, [{BATCH}, {main_shape[1]}, 3] "
                    "main-path samples"))
                if impl == "xor":
                    timings[name] = time_hashgrid(
                        torch, hashgrid, hashgrid_bwd, spec, table, p, g,
                        f"{name:8s} xor, uniform")
            for fwd_abs, bwd_abs in errs:
                worst["fwd"] = max(worst["fwd"], fwd_abs)
                worst["bwd"] = max(worst["bwd"], bwd_abs)
    return worst, timings


def fused_mlp_phase(torch, fused_mlp, dev):
    """The fused-MLP kernel vs its plain version at the main path's shapes,
    bf16 and fp32; returns the worst abs error and the timings."""
    from nerf_hugs_torch.tools.hashgrid_inputs import BATCH
    gen = torch.Generator(device=dev).manual_seed(1)
    worst, timings = 0.0, {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, per_ray, dims in FUSED_SHAPES:
            n = BATCH * per_ray
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
            t["bound_ms"], t["bound_by"] = bound(
                nbytes(x, out_p, *ws),
                2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:])),
                dtype_name)
            timings[(name, dtype_name)] = t
            print(f"check {label}: max_abs={err:.3e} (ragged span "
                  f"{sub_err:.3e}) max_rel={rel:.3e} "
                  f"(tol {FUSED_TOL[dtype_name]:.3e}); kernel "
                  f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.3f} ms ({t['bound_by']})", flush=True)
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


def small_model_phase(torch, tmp, dev, fused: bool):
    """A small model through the kernels on the card vs the same weights
    through the plain versions on the CPU."""
    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.tools.hashgrid_inputs import fused_overlay
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
    from nerf_hugs_torch.ops import accum, fused_mlp, hashgrid, hashgrid_bwd
    return {"hashgrid_fwd": hashgrid.hashgrid_fwd,
            "hashgrid_bwd": hashgrid_bwd.hashgrid_table_grad,
            "fused_mlp_fwd": fused_mlp.fused_mlp_fwd,
            "planar_accum": accum.planar_accum}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in launch_counters().items()}


def captured_phase(torch, hashgrid, hashgrid_bwd, cfg_path, tmp, dev):
    """Phase 6: both kernels on the inputs the main path hands them,
    checked and timed; returns the worst errors."""
    from nerf_hugs_torch.tools.hashgrid_inputs import (
        capture_hashgrid_inputs, capture_shares)
    captured = capture_hashgrid_inputs(cfg_path, tmp, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, (spec, p, g) in captured.items():
        print(f"capture {name:8s} {tuple(p.shape)}: "
              + capture_shares(spec, p, g), flush=True)
        table = torch.rand(spec.num_rows * 2, generator=gen,
                           device=dev) * 2 - 1
        fwd_abs, bwd_abs = compare(torch, hashgrid, hashgrid_bwd, spec, table,
                                   p, g, f"{name:8s} captured")
        worst = {"fwd": max(worst["fwd"], fwd_abs),
                 "bwd": max(worst["bwd"], bwd_abs)}
        time_hashgrid(torch, hashgrid, hashgrid_bwd, spec, table, p, g,
                      f"{name:8s} captured")
    return worst


def train_phase(torch, tmp, fused: bool):
    """8 full-width kubric_nerfacto_base steps through the driver; returns
    (config path, checkpoint dir, kernel launches)."""
    from nerf_hugs_torch.tools.hashgrid_inputs import base_yaml
    from nerf_hugs_torch.train import main as train_main
    tag = "fused" if fused else "dense"
    cfg_path = base_yaml(tmp, fused)
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


def accum_phase(torch, dev):
    """Phase 9: the planar-accumulate kernel against its plain version,
    then the microbenchmark through its entry point; returns the worst abs
    error, the timings per dense level and the benchmark's launches."""
    from nerf_hugs_torch.ops import accum
    from nerf_hugs_torch.tools import bench_fwd_copies
    worst, timings = 0.0, {}
    for N in ACCUM_SIZES:
        tab2, idx, w = bench_fwd_copies.make_inputs(N, ACCUM_N, dev)
        vals = [tab2.index_select(0, idx[c]) for c in range(4)]
        out_k = accum.planar_accum(*vals, w)
        out_p = accum.planar_accum_plain(*vals, w)
        # A ragged span, rows 1 .. n-3 of each input with w's columns as a
        # view: a partial last block and a strided w.
        m = ACCUM_N - 3
        sub = [v[1:m] for v in vals]
        sub_k = accum.planar_accum(*sub, w[:, 1:m])
        sub_p = accum.planar_accum_plain(*sub, w[:, 1:m])
        torch.cuda.synchronize()
        check(out_k.shape == out_p.shape == (ACCUM_N, accum.F)
              and sub_k.shape == (m - 1, accum.F),
              f"planar_accum gave {tuple(out_k.shape)}, "
              f"{tuple(sub_k.shape)}")
        err = float((out_k - out_p).abs().max())
        sub_err = float((sub_k - sub_p).abs().max())
        t = {"ms": median_ms(lambda: accum.planar_accum(*vals, w)),
             "plain_ms": median_ms(
                 lambda: accum.planar_accum_plain(*vals, w))}
        # 16 products and 16 sums per sample.
        t["bound_ms"], t["bound_by"] = bound(nbytes(*vals, w, out_k),
                                             32 * ACCUM_N)
        timings[N] = t
        print(f"check planar_accum, gathers of {ACCUM_N} samples from "
              f"{N}^3 rows: max_abs={err:.3e} (ragged span {sub_err:.3e}, "
              f"tol 1e-5); kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {nbytes(*vals, w, out_k) / 1e6:.1f} MB)",
              flush=True)
        check(math.isfinite(err) and max(err, sub_err) <= 1e-5,
              f"planar_accum disagrees with its plain version ({N}^3 "
              f"rows): {err}, ragged span {sub_err}")
        worst = max(worst, err, sub_err)
        del tab2, idx, w, vals, out_k, out_p, sub, sub_k, sub_p

    reset_launches()
    t0 = time.time()
    report = bench_fwd_copies.main([str(ACCUM_N.bit_length() - 1)])
    torch.cuda.synchronize()
    launches = read_launches()
    check(sorted(report) == list(bench_fwd_copies.SIZES)
          and all(math.isfinite(v) and v > 0 for r in report.values()
                  for v in r.values()),
          f"bench_fwd_copies reported {report}")
    check(launches["planar_accum"] > 0,
          f"bench_fwd_copies did not launch planar_accum: {launches}")
    print(f"bench_fwd_copies {ACCUM_N.bit_length() - 1}: "
          f"{len(report)} sizes in {time.time() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return worst, timings, launches["planar_accum"]


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
    from nerf_hugs_torch.tools.hashgrid_inputs import base_yaml
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
        captured_worst = captured_phase(torch, hashgrid, hashgrid_bwd,
                                        base_yaml(tmp, fused=False), tmp, dev)
        worst = {k: max(v, captured_worst[k]) for k, v in worst.items()}
        _, _, launches = train_phase(torch, tmp, fused=False)
        cfg_path, save_dir, _ = train_phase(torch, tmp, fused=True)
        eval_launches = eval_phase(torch, cfg_path, save_dir)
    accum_worst, accum_timings, accum_launches = accum_phase(torch, dev)
    check("jax" not in sys.modules, "jax was imported")
    check("nerf_hugs_tpu" not in sys.modules, "nerf_hugs_tpu was imported")

    field = timings["field"]
    head = fused_timings[("field mlp_head", "bfloat16")]
    acc = accum_timings[81]
    print(json.dumps({"kernels": [
        {"name": "hashgrid_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid.py:448",
         "launches": launches["hashgrid_fwd"], "max_abs_err": worst["fwd"],
         "ms": field["fwd"], "plain_ms": field["fwd_plain"],
         "bound_ms": field["bound_ms"], "bound_by": field["bound_by"],
         "library_ms": field["fwd_library"]},
        {"name": "hashgrid_bwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid_bwd.py:48",
         "launches": launches["hashgrid_bwd"], "max_abs_err": worst["bwd"],
         "ms": field["bwd"], "plain_ms": field["bwd_plain"],
         "bound_ms": field["bound_ms"], "bound_by": field["bound_by"],
         "library_ms": field["bwd_library"]},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_hugs_tpu/ops/fused_mlp.py:39",
         "launches": eval_launches["fused_mlp_fwd"],
         "max_abs_err": fused_worst, "ms": head["ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": None},
        {"name": "planar_accum", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/accum.cu",
         "replaces": "tools/bench_fwd_copies.py:94",
         "launches": accum_launches, "max_abs_err": accum_worst,
         "ms": acc["ms"], "plain_ms": acc["plain_ms"],
         "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
