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
  4. the fused-MLP kernels against their plain version at the three shapes
     of kubric_nerfacto_base with enable_tcnn_mlp (proposal mlp_base
     [4194304, 14] -> 64 -> 1, field mlp_base [2097152, 32] -> 256 -> 65,
     field mlp_head [2097152, 80] -> 256 -> 256 -> 3), in bf16 within 2 bf16
     ulps (2^-7) of the output's largest entry and in fp32 within 1e-5 of
     it, also on a ragged, unaligned span of 4097 rows, then the median of
     10 timed runs of each beside the kernel alone from a profiler trace
     and the cuBLAS chain in the same dtype (torch.matmul + relu per layer;
     fp32 with TF32 off);
     then bf16 at every width of configs/nerfacto/*nerfacto*.yml and at
     edge widths (1, 256, odd, 8 layers) at small n, below one tile and
     ragged from row 1, each call checked to take the kernel its widths
     route to (8 layers of 256: the streamed kernel, the rest resident),
     and fp32 at its edges (the same, NeRF-W's transient head and the
     widest head; every fp32 call takes the fp32 kernel);
  5. a small model on the card (kernels) against the same weights on the
     CPU (plain versions), loss and every parameter gradient, with the
     Dense MLPs, with enable_tcnn_mlp on for the field and the proposal,
     as NeRF-W (transient head, uncertainty) and as RobustNeRF (patch
     mask under a carried threshold of 0.2);
  3b. the d = 2 hash-grid kernels (HA-NeRF's implicit mask: 16 levels of
     2^19 rows, resolution 16 to 2048) against their plain versions at the
     mask's spec, for both hash_impls, on [16384, 2] pixel-centre positions
     of 64 patches of 16x16 pixels, on 2^20 uniform positions plus exact-1.0
     edges, on the 2-D adversarial sets, on one position and on a ragged
     n (16421): the forward bit for bit (max abs error 0.0), then timed at
     n = 16384 (the main path's: one position per ray) and 2^20;
  6. the hash-grid kernels on the main path's own inputs: one batch of
     compute_loss + backward through the full-width kubric_nerfacto_base
     model of phase 7, and through the full-width HA-NeRF model of phase
     10 on its distractor scene, on the card, with hooks on the field's and the proposal's
     HashGridEncoding (and on the HA-NeRF model's implicit_mask.hashgrid)
     capturing the grid positions and output gradients they receive; the
     kernels checked against their plain versions on them (the mask's
     forward bit for bit) and timed, with
     the share of out-of-box samples and of zero-gradient (sample, level)
     pairs;
  7. 8 train steps of configs/nerfacto/kubric_nerfacto_base.yml at full
     model width through `nerf_hugs_torch.train.main` on a scene written in
     the kubric layout (32 train and 4 test frames of the procedural sphere
     world at 256x256 in rgb/2x/, one lens with small radial and tangential
     distortion, an opaque random square in each train frame) and read by
     the kubric loader, with the hash-grid kernels' launch counters read
     around the run;
  8. the same 8 steps with enable_tcnn_mlp on for the field and the
     proposal on the procedural `synthetic` scene, then
     `nerf_hugs_torch.eval.main` on its checkpoint (2 test images of
     256x256, 4 render chunks each) with the fused-MLP and hash-grid launch
     counters read around the eval (the resident bf16 kernel must launch,
     the streamed one never), then the scoring CLI over the test_preds/
     PNGs the eval wrote; then (8b) the same config with enable_amp off,
     so the fused MLPs run in fp32: 4 train steps and an eval of 1 image,
     the fp32 kernel launched in both and neither bf16 kernel;
  9. the planar-accumulate kernel against its plain version on the gathers
     of n = 2^21 samples from dense levels of 81^3 and 127^3 rows, and on a
     ragged span of them (within 1e-5 absolute), with timings beside one
     torch.einsum over the same rows laid out beforehand, then the
     microbenchmark `nerf_hugs_torch.tools.bench_fwd_copies` through its
     entry point at n = 2^21, with the kernel's launch counter read around
     it;
  10. HA-NeRF: 8 train steps of configs/nerfacto/distractor_nerfacto_hanerf
     .yml, its model section unchanged (appearance and transient
     embeddings, two proposal nets, the 2-D implicit mask, 512 + 256 + 128
     samples per ray), on a capture written in the distractor layout
     (`hashgrid_inputs.write_colmap_scene`: 32 train and 4 test frames of
     the procedural sphere world at 256x256 in 0/images_8/, one OPENCV
     camera with small distortion at 8x, 4096 SfM points on the sphere,
     data_split.json, a random opaque square and its static mask per
     train frame) read by the config's own distractor loader (only the
     base section's cadence keys change), then `nerf_hugs_torch.eval.main`
     on 2 test images, with every launch counter read around each; the
     d = 2 kernels must launch in both;
  11. RobustNeRF: 8 train steps of configs/nerfacto/distractor_nerfacto_
     robustnerf0.8.yml, model section unchanged, on the distractor capture
     of phase 10; the inlier threshold each step hands the next is printed
     and must be finite and move after step 1; then an eval of 2 test
     images;
  12. NeRF-W: configs/nerfacto/phototourism_nerfacto_nerfw.yml, model
     section unchanged, on a capture in the phototourism layout (the same
     world on a 120-degree arc, one PINHOLE camera per frame at 512x512,
     halved by the loader, a .tsv split), 8 train steps and then 4 steps of
     its finetune stage (finetune_num_steps overridden) with the launch
     counters read around each stage: hashgrid_bwd must launch in the
     train stage and never in the finetune stage (only
     appearance_embedding trains); the beta and density terms must be
     finite; then an eval of 2 test images from the finetune checkpoint;
  13. HuGS: (a) SAM at vit_t (its published 1024 input) on the card against
     the same weights on the CPU, the image embedding, the decoder's
     full-resolution logits and IoU, and predict_count's maps (relative
     error at most 1e-4 of the largest entry; a count may differ only
     where a logit lies that close to the threshold); (b)
     scripts/hugs_kubric.sh's three stages on a kubric capture written
     with a COLMAP model in sparse/0 (2 train frames at 256x256 in rgb/1x/
     and 128x128 in rgb/2x/, 2 test frames): 8 steps of
     configs/nerfacto/kubric_nerfacto_gen_mask.yml, `nerf_hugs_torch.eval`
     of the train split with --original_name --only_pred_gt, `python -m
     nerf_hugs_torch.hugs` at vit_h (random weights from a seeded
     generator on the card) with configs/hugs/kubric.yml into the scene,
     then 4 steps of kubric_nerfacto_withmask.yml reading the masks just
     written (the scene's own masks are deleted first): the hash-grid
     kernels launch in stages 1, 2 and 4 and no NeRF kernel in stage 3,
     one mask per train frame at its size with values in {0, 1}; (c) at
     vit_h, the encoder's ms per set_image, the decoder's per batch of 64
     and of 256 prompts (filters and packing included), s/image with its
     stage split at configs/hugs/kubric.yml and kubric_tpu.yml, and at
     kubric.yml on one 768x1024 frame, with peak device memory.
Each train run prints its steps/s over steps 2-8 and its peak device
memory. The planar accumulate's timing line gives its profiler time too. Each hash-grid timing line also gives the kernels' own device time from a
torch.profiler trace: at the mask's 16384 positions the CUDA events around
one wrapper call mostly see the host's launch path. Beside each timed
kernel it prints its bound: the least time the card could
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
# Relative to the output's largest entry (see phase 4 above).
FUSED_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# Phase 4's small bf16 cases beyond the shipped widths: (widths, rows, rows
# skipped at the start of x). Widths 1 and 256, odd widths, 8 layers, and
# 8 layers of 256, whose weights no block can hold (the streamed kernel).
FUSED_EDGES = (((1, 256), 129, 0), ((256, 1), 65, 1),
               ((17, 48, 24, 5), 1000, 1), ((32,) * 9, 513, 0),
               ((256,) * 9, 4097, 1))
# The fp32 kernel's edges beyond the main shapes (the same triples): n
# below one tile, ragged from row 1, widths 1 and 256, odd widths, 8
# layers, 8 layers of 256 (every layer streamed), NeRF-W's transient head
# (two blocks an SM) and the widest head (two layers streamed).
FUSED_EDGES_F32 = (((14, 64, 1), 37, 0), ((80, 256, 256, 3), 4097, 1),
                   ((32, 256, 65), 100, 1)) + FUSED_EDGES + (
    ((80, 64, 64, 5), 3000, 1), ((128, 256, 256, 3), 300, 1))
# Ragged: no multiple of a warp or a block. Each adversarial row gradient
# sums up to n payloads, and the plain version's sequential atomics round
# about sqrt(n) times; at 2^13 that stays a few 1e-6 of the largest entry.
ADVERSARIAL_N = (1 << 13) + 37
# Train steps of the fp32 fused path (phase 8b); its eval renders 1 image.
F32_STEPS = 4
ACCUM_N = 1 << 21          # samples of the planar-accumulate microbenchmark
ACCUM_SIZES = (81, 127)    # its dense levels of N^3 rows checked in phase 9
# HuGS (phase 13): a kubric capture of two train and two test frames,
# 256x256 in rgb/1x/ (the gen_mask config's downsample_factor 1) and
# 128x128 in rgb/2x/ (withmask's 2); train steps of the gen_mask stage and
# of the withmask retrain; the vit_t card-against-CPU check's prompts and
# its relative tolerance (TF32 off).
HUGS_TRAIN, HUGS_TEST, HUGS_SIZE = 2, 2, 256
HUGS_STEPS, WITHMASK_STEPS = 8, 4
SAM_PROMPTS, SAM_TOL = 16, 1e-4
# The frame of the extra s/image reading: the reference captures' size.
HUGS_BIG = (768, 1024)
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


def device_ms(torch, fn, kernel: str, runs: int = 20):
    """Mean device time per launch of the CUDA kernel whose name holds
    `kernel` (each call of `fn` launches it once), over the launches
    torch.profiler's trace recorded (None where it recorded none): the
    kernel alone, without the host's launch path that CUDA events around a
    short kernel also see. The trace may drop a few records of a short
    session, so the mean is taken over those it kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if kernel in e.key and e.device_time_total > 0]
    count = sum(e.count for e in events)
    total = sum(e.device_time_total for e in events)
    return total / count / 1e3 if count else None


def bound(nbytes: float, flops: float, dtype: str = "float32"):
    """(least ms, what sets it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(torch, hashgrid, hashgrid_bwd, spec, table, pos, g, label):
    """Both kernels against their plain versions on the same inputs (the
    d = 2 forward bit for bit); returns (forward max abs error,
    table-gradient max abs error)."""
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
    fwd_tol = 0.0 if spec.num_dims == 2 else 1e-6
    print(f"check {label}: fwd max_abs={fwd_abs:.3e} (tol {fwd_tol:.0e})  "
          f"table-grad "
          f"max_abs={bwd_abs:.3e} max_rel={bwd_rel:.3e}", flush=True)
    check(math.isfinite(fwd_abs) and fwd_abs <= fwd_tol,
          f"hashgrid_fwd disagrees with its plain version ({label}): "
          f"{fwd_abs}")
    check(math.isfinite(bwd_abs) and bwd_abs <= 1e-5 * bwd_max,
          f"hashgrid_bwd disagrees with its plain version ({label}): "
          f"{bwd_rel}")
    return fwd_abs, bwd_abs


def library_hashgrid(torch, hashgrid, hashgrid_bwd, spec, table, p, g):
    """The yardsticks of the hash-grid kernels
    (tools/bench_hashgrid.py::yardsticks: `embedding_bag` for the
    forward's weighted gather, `index_add_` for the table gradient's
    scatter, fed the corner rows and weights computed beforehand), each
    checked against its kernel; returns their times and the number of
    distinct table rows the samples touch."""
    from nerf_hugs_torch.tools.bench_hashgrid import yardsticks
    fwd, bwd, rows_touched = yardsticks(spec, table, p, g)
    out_k = hashgrid.hashgrid_fwd(table, p, spec)
    gt_k = hashgrid_bwd.hashgrid_table_grad(p, g, spec)
    fwd_rel = float((fwd().view(out_k.shape) - out_k).abs().max()
                    / out_k.abs().max())
    bwd_rel = float((bwd().view(-1) - gt_k).abs().max() / gt_k.abs().max())
    check(fwd_rel <= 1e-5 and bwd_rel <= 1e-5,
          f"the library yardsticks disagree with the kernels: {fwd_rel}, "
          f"{bwd_rel}")
    return {"fwd_library": median_ms(fwd), "bwd_library": median_ms(bwd),
            "rows_touched": rows_touched}


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
    t["fwd_device"] = device_ms(
        torch, lambda: hashgrid.hashgrid_fwd(table, p, spec),
        "hashgrid_fwd_kernel")
    t["bwd_device"] = device_ms(
        torch, lambda: hashgrid_bwd.hashgrid_table_grad(p, g, spec),
        "hashgrid_bwd")
    shown = lambda ms: "not measured" if ms is None else f"{ms:.4f} ms"
    from nerf_hugs_torch.tools.bench_hashgrid import bounds
    n = p.numel() // spec.num_dims
    (t["fwd_bound_ms"], t["fwd_bound_by"], fwd_bytes), (
        t["bwd_bound_ms"], t["bwd_bound_by"], bwd_bytes) = bounds(
            spec, table, p, g, t["rows_touched"])
    print(f"time  {label}, {n} samples x {spec.num_levels} levels: fwd "
          f"{t['fwd']:.3f} ms (plain {t['fwd_plain']:.3f}, embedding_bag "
          f"{t['fwd_library']:.3f}; bound {t['fwd_bound_ms']:.4f} ms, "
          f"{t['fwd_bound_by']}, {fwd_bytes / 1e6:.1f} MB with "
          f"{t['rows_touched']} of {spec.num_rows} rows)  table-grad "
          f"{t['bwd']:.3f} ms (plain {t['bwd_plain']:.3f}, index_add_ "
          f"{t['bwd_library']:.3f}; bound {t['bwd_bound_ms']:.4f} ms, "
          f"{t['bwd_bound_by']}, {bwd_bytes / 1e6:.1f} MB); kernels alone "
          f"on the device (profiler): fwd {shown(t['fwd_device'])}, "
          f"table-grad {shown(t['bwd_device'])}", flush=True)
    return t


def adversarial_sets(torch, dev, gen, d: int = 3):
    """[(label, positions [ADVERSARIAL_N, d], zero-gradient mask [n])]:
    the cases that stress the kernels' row combining and zero skipping."""
    n = ADVERSARIAL_N
    lane = torch.arange(n, device=dev) % 32
    a = torch.tensor([0.3, 0.6, 0.2][:d], device=dev).expand(n, d)
    b = torch.tensor([0.7, 0.1, 0.9][:d], device=dev).expand(n, d)
    origin = torch.zeros((n, d), device=dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    half = torch.rand(n, generator=gen, device=dev) < 0.5
    uniform = torch.rand((n, d), generator=gen, device=dev)
    # Lines of 128 ordered samples from a point in the box (rays, at d =
    # 3); the samples that leave the box collapse to the origin with a zero
    # gradient, as the model's out-of-box samples do.
    lines = -(-n // 128)
    start = torch.rand((lines, 1, d), generator=gen, device=dev)
    direction = torch.nn.functional.normalize(
        torch.randn((lines, 1, d), generator=gen, device=dev), dim=-1)
    t = torch.linspace(0.0, 1.5, 128, device=dev)[None, :, None]
    line_pos = (start + direction * t).reshape(-1, d)[:n]
    inside = ((line_pos >= 0) & (line_pos <= 1)).all(-1)
    return [
        ("every sample in one cell", a.contiguous(), none),
        ("every sample at the origin, zero gradient", origin, ~none),
        ("half at the origin with zero gradient, random lanes",
         torch.where(half[:, None], origin, uniform), half),
        ("warps split between two cells by halves",
         torch.where((lane < 16)[:, None], a, b), none),
        ("warps split between two cells, alternating lanes",
         torch.where((lane % 2 == 0)[:, None], a, b), none),
        ("ordered along lines, out-of-box tails at the origin with zero "
         "gradient", (line_pos * inside[:, None]).contiguous(), ~inside),
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


def mask_kernel_phase(torch, hashgrid, hashgrid_bwd, dev):
    """Phase 3b: the d = 2 kernels against their plain versions at the
    implicit mask's spec on pixel-centre, uniform, edge and adversarial
    sets, on one position and on a ragged n, the forward bit for bit;
    returns the worst errors and the timings at n = 16384 (pixel centres,
    the main path's shape) and 2^20 (uniform)."""
    from nerf_hugs_torch.models.nerfacto import MASK_GRID
    from nerf_hugs_torch.tools.hashgrid_inputs import MASK_N, pixel_centres
    gen = torch.Generator(device=dev).manual_seed(3)
    edges = torch.tensor([[1.0, 1.0], [1.0, 0.3], [0.3, 1.0], [0.0, 0.0],
                          [1.0, 0.0]], device=dev)
    uniform = lambda n: torch.rand((n, 2), generator=gen, device=dev)
    # (label, positions, zero-gradient mask, timed)
    sets = [(f"[{MASK_N}, 2] pixel centres of 16x16 patches",
             pixel_centres(gen, MASK_N), None, True),
            (f"{(1 << 20) + 5} positions with exact-1.0 edges",
             torch.cat([uniform(1 << 20), edges]), None, True)]
    sets += [(label, p, zero, False)
             for label, p, zero in adversarial_sets(torch, dev, gen, d=2)]
    # One sample, and a count that fills no whole block.
    sets += [(f"{n} uniform positions", uniform(n), None, False)
             for n in (1, MASK_N + 37)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    timings = {}
    for impl in ("xor", "add"):
        spec = dataclasses.replace(MASK_GRID, hash_impl=impl)
        table = torch.rand(spec.num_rows * 2, generator=gen,
                           device=dev) * 2 - 1
        for label, p, zero, timed in sets:
            g = torch.randn((p.shape[0], spec.output_dim), generator=gen,
                            device=dev)
            if zero is not None:
                g = g.masked_fill(zero[:, None], 0.0)
            fwd_abs, bwd_abs = compare(torch, hashgrid, hashgrid_bwd, spec,
                                       table, p, g, f"mask 2-D {impl}, "
                                       f"{label}")
            worst = {"fwd": max(worst["fwd"], fwd_abs),
                     "bwd": max(worst["bwd"], bwd_abs)}
            if impl == "xor" and timed:
                n = p.shape[0]
                timings[n] = time_hashgrid(torch, hashgrid, hashgrid_bwd,
                                           spec, table, p, g,
                                           f"mask 2-D xor, {label}")
    return worst, timings


def shipped_fused_widths() -> list:
    """The bf16 fused-MLP widths of configs/nerfacto/*nerfacto*.yml with
    enable_tcnn_mlp on, as the model builds them."""
    import glob
    from nerf_hugs_torch.configs import yaml_loader
    from nerf_hugs_torch.models.nerfacto import fused_mlp_widths
    widths = set()
    for path in glob.glob(os.path.join(HERE, "configs", "nerfacto",
                                       "*nerfacto*.yml")):
        widths.update(fused_mlp_widths(
            yaml_loader.load_yaml_config(path)).values())
    return sorted(widths)


def fused_inputs(torch, dims, n, dtype, gen, dev):
    x = torch.randn((n, dims[0]), generator=gen, device=dev).to(dtype)
    ws = [((torch.rand((a, b), generator=gen, device=dev) * 2 - 1)
           * math.sqrt(6.0 / a)).to(dtype)
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


def fused_route_check(torch, fused_mlp, x, ws, label):
    """One kernel call against the plain version; checks that the bf16
    launch went to the kernel its widths route to; returns the relative
    error (of the output's largest entry)."""
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    fwd = fused_mlp.fused_mlp_fwd
    before = (fwd.launches_resident, fwd.launches_streamed, fwd.launches_f32)
    out_k = fwd(x, ws)
    out_p = fused_mlp.fused_mlp_plain(x, ws)
    torch.cuda.synchronize()
    check(out_k.shape == out_p.shape == (x.shape[0], dims[-1])
          and out_k.dtype == x.dtype,
          f"fused_mlp_fwd gave {tuple(out_k.shape)} {out_k.dtype} ({label})")
    got = (fwd.launches_resident - before[0],
           fwd.launches_streamed - before[1], fwd.launches_f32 - before[2])
    if x.dtype == torch.bfloat16:
        resident = fused_mlp.is_resident(x.dtype, dims)
        check(got == ((1, 0, 0) if resident else (0, 1, 0)),
              f"the bf16 launch took the wrong kernel ({label}): {got}")
    else:
        check(got == (0, 0, 1),
              f"the fp32 launch took the wrong kernel ({label}): {got}")
    return float((out_k.float() - out_p.float()).abs().max()
                 / out_p.float().abs().max())


def fused_mlp_phase(torch, fused_mlp, dev):
    """The fused-MLP kernels vs their plain version at the main path's
    shapes, bf16 and fp32, on the ragged unaligned span, and at the
    shipped widths (bf16) and each dtype's edges at small n; returns the
    worst abs error per dtype at the main shapes and the timings."""
    from nerf_hugs_torch.tools.bench_fused_mlp import cublas_chain
    from nerf_hugs_torch.tools.hashgrid_inputs import BATCH, FUSED_SHAPES
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    timings = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        tol = FUSED_TOL[dtype_name]
        kernel = ("fused_mlp_resident_kernel" if dtype_name == "bfloat16"
                  else "fused_mlp_f32_kernel")
        for name, per_ray, dims in FUSED_SHAPES:
            n = BATCH * per_ray
            x, ws = fused_inputs(torch, dims, n, dtype, gen, dev)
            label = f"{name} {dtype_name} [{n}, {dims[0]}] -> " + " -> ".join(
                str(d) for d in dims[1:])
            rel = fused_route_check(torch, fused_mlp, x, ws, label)
            out_p = fused_mlp.fused_mlp_plain(x, ws)
            scale = float(out_p.float().abs().max())
            # A ragged row count (64 * 64 + 1) starting one row in, so the
            # last tile is partial and, for d_in 14, x is not 16-byte
            # aligned: the masked edges and the input's unaligned span.
            sub = x[1:1 + 64 * 64 + 1]
            sub_err = float((fused_mlp.fused_mlp_fwd(sub, ws).float()
                             - out_p[1:1 + sub.shape[0]].float()).abs().max())
            rel = max(rel, sub_err / scale)
            worst[dtype_name] = max(worst[dtype_name], rel * scale)
            call = lambda: fused_mlp.fused_mlp_fwd(x, ws)
            t = {"ms": median_ms(call),
                 "alone": device_ms(torch, call, kernel),
                 "plain_ms": median_ms(
                     lambda: fused_mlp.fused_mlp_plain(x, ws)),
                 "library_ms": None}
            t["bound_ms"], t["bound_by"] = bound(
                nbytes(x, out_p, *ws),
                2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:])),
                dtype_name)
            # The cuBLAS chain in the same dtype (fp32 with TF32 off): one
            # torch.matmul (+ relu) per layer, a yardstick the port never
            # calls.
            chain_rel = float((cublas_chain(x, ws).float()
                               - out_p.float()).abs().max()) / scale
            t["library_ms"] = median_ms(lambda: cublas_chain(x, ws))
            library = (f", cuBLAS {dtype_name} chain "
                       f"{t['library_ms']:.3f} ms (max_rel {chain_rel:.3e})")
            timings[(name, dtype_name)] = t
            alone = ("not measured" if t["alone"] is None
                     else f"{t['alone']:.3f} ms")
            print(f"check {label}: max_abs={rel * scale:.3e} max_rel="
                  f"{rel:.3e} (ragged span {sub_err / scale:.3e}; tol "
                  f"{tol:.3e}); kernel "
                  f"{t['ms']:.3f} ms (alone on the device {alone}), plain "
                  f"{t['plain_ms']:.3f} ms{library}, bound "
                  f"{t['bound_ms']:.3f} ms ({t['bound_by']})", flush=True)
            check(math.isfinite(rel) and rel <= tol,
                  f"fused_mlp_fwd disagrees with its plain version "
                  f"({label}): {rel}")
            del x, ws, out_p, sub
    # bf16 at every shipped width and at the edges, small n: below one
    # tile, and not a multiple of 64 with x starting one row in; then fp32
    # at its own edges.
    cases = [(dims, n, skip, torch.bfloat16)
             for dims in shipped_fused_widths()
             for n, skip in ((37, 0), (4097, 1))] + [
        (dims, n, skip, torch.bfloat16) for dims, n, skip in FUSED_EDGES] + [
        (dims, n, skip, torch.float32)
        for dims, n, skip in FUSED_EDGES_F32]
    for dims, n, skip, dtype in cases:
        x, ws = fused_inputs(torch, dims, n + skip, dtype, gen, dev)
        if dtype == torch.float32:
            plan = fused_mlp.f32_plan(dims)
            how = (f"fp32, {plan['rows']}-row tiles, resident "
                   f"{plan['resident']}")
        else:
            how = "bf16 " + ("resident" if fused_mlp.is_resident(
                torch.bfloat16, dims) else "streamed")
        label = f"{how} {dims} n={n}{' from row 1' if skip else ''}"
        rel = fused_route_check(torch, fused_mlp, x[skip:], ws, label)
        print(f"check {label}: max_rel={rel:.3e}", flush=True)
        tol = FUSED_TOL[str(dtype).split(".")[-1]]
        check(math.isfinite(rel) and rel <= tol,
              f"fused_mlp_fwd disagrees with its plain version ({label}): "
              f"{rel}")
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


# The small model's variants beyond the Dense base: (base keys, model
# keys). RobustNeRF's inner patch of 2 fits the 4x4 patches.
SMALL_VARIANTS = {
    "Dense MLPs": ({}, {}),
    "fused MLPs": ({}, None),
    "NeRF-W": ({}, {"use_appearance_embedding": True,
                    "appearance_embedding_dim": 8,
                    "use_transient_embedding": True,
                    "transient_embedding_dim": 8, "hidden_dim_transient": 16,
                    "transient_type": "nerfw"}),
    "RobustNeRF": ({"robustnerf_inner_patch_size": 2},
                   {"transient_type": "robustnerf",
                    "robustnerf_inlier_quantile": 0.8}),
}


def small_model_phase(torch, tmp, dev, variant: str):
    """A small model through the kernels on the card vs the same weights
    through the plain versions on the CPU."""
    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.tools.hashgrid_inputs import fused_overlay
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss
    raw = yaml.safe_load(SMALL_YAML)
    base, model_keys = SMALL_VARIANTS[variant]
    fused = model_keys is None
    raw["base"].update(base)
    raw["model"] = (fused_overlay(raw["model"]) if fused
                    else {**raw["model"], **model_keys})
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
        thresholds = torch.full((config.num_ray_levels,), 0.2,
                                device=device)
        loss, stats = compute_loss(model, batch.to(device), 0.3, config,
                                   None, thresholds)
        check(set(stats["losses"]) >= {
            "NeRF-W": {"beta", "density"}}.get(variant, {"data"}),
            f"the small {variant} model's loss has terms "
            f"{sorted(stats['losses'])}")
        if variant == "RobustNeRF":
            mask = float(stats["robust_mask"][0])
            check(0 < mask < 1, f"the robust mask keeps {mask} of the "
                                "pixels: it does not bite")
        loss.backward()
        results[device] = (loss.item(), {
            k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (loss_c, grads_c), (loss_g, grads_g) = results["cpu"], results[dev]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_rel = max(float((grads_g[k] - grads_c[k]).abs().max())
                   / max(float(grads_c[k].abs().max()), 1e-30)
                   for k in grads_c)
    print(f"check small model ({variant}) cuda vs cpu: loss {loss_g:.6f} "
          f"vs {loss_c:.6f} (rel {loss_rel:.2e}); worst gradient error "
          f"{grad_rel:.2e} of the leaf's max", flush=True)
    check(math.isfinite(loss_g) and loss_rel <= 1e-5,
          f"small-model loss differs between cuda and cpu ({variant})")
    check(grad_rel <= 1e-4, f"small-model gradients differ between cuda "
                            f"and cpu ({variant})")


def launch_counters():
    """{kernel: (wrapper, counter attribute)}: the hash-grid wrappers count
    their d = 3 and d = 2 kernels apart."""
    from nerf_hugs_torch.ops import accum, fused_mlp, hashgrid, hashgrid_bwd
    return {"hashgrid_fwd": (hashgrid.hashgrid_fwd, "launches"),
            "hashgrid_bwd": (hashgrid_bwd.hashgrid_table_grad, "launches"),
            "fused_mlp_fwd": (fused_mlp.fused_mlp_fwd, "launches"),
            "fused_mlp_fwd_resident": (fused_mlp.fused_mlp_fwd,
                                       "launches_resident"),
            "fused_mlp_fwd_streamed": (fused_mlp.fused_mlp_fwd,
                                       "launches_streamed"),
            "fused_mlp_fwd_f32": (fused_mlp.fused_mlp_fwd, "launches_f32"),
            "planar_accum": (accum.planar_accum, "launches"),
            "hashgrid_fwd_2d": (hashgrid.hashgrid_fwd, "launches_2d"),
            "hashgrid_bwd_2d": (hashgrid_bwd.hashgrid_table_grad,
                                "launches_2d")}


def reset_launches() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {k: getattr(fn, attr)
            for k, (fn, attr) in launch_counters().items()}


def captured_phase(torch, hashgrid, hashgrid_bwd, cfg_path, data_dir, dev,
                   names=("field", "proposal")):
    """Phase 6: the kernels on the inputs the main path hands the encoders
    of `names`, checked and timed; returns the worst errors and the
    timings per encoder."""
    from nerf_hugs_torch.tools.hashgrid_inputs import (
        capture_hashgrid_inputs, capture_shares)
    captured = capture_hashgrid_inputs(cfg_path, data_dir, dev, names)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {"fwd": 0.0, "bwd": 0.0}
    timings = {}
    for name, (spec, p, g) in captured.items():
        print(f"capture {name:8s} {tuple(p.shape)}: "
              + capture_shares(spec, p, g), flush=True)
        table = torch.rand(spec.num_rows * 2, generator=gen,
                           device=dev) * 2 - 1
        fwd_abs, bwd_abs = compare(torch, hashgrid, hashgrid_bwd, spec, table,
                                   p, g, f"{name:8s} captured")
        worst = {"fwd": max(worst["fwd"], fwd_abs),
                 "bwd": max(worst["bwd"], bwd_abs)}
        timings[name] = time_hashgrid(torch, hashgrid, hashgrid_bwd, spec,
                                      table, p, g, f"{name:8s} captured")
    return worst, timings


# The kernels each run must launch, and those it must not.
DENSE = ("hashgrid_fwd", "hashgrid_bwd")
FUSED = DENSE + ("fused_mlp_fwd", "fused_mlp_fwd_resident")
# enable_amp off: the fused MLPs run in fp32.
FUSED_F32 = DENSE + ("fused_mlp_fwd", "fused_mlp_fwd_f32")
# No main path's MLP routes to the streamed bf16 kernel.
NEVER = ("fused_mlp_fwd_streamed",)
HANERF = DENSE + ("hashgrid_fwd_2d", "hashgrid_bwd_2d")


def stage_lines(log: str, stage: str):
    """[(step, loss, steps/s, {term: value})] of a stage's print lines."""
    lines = re.finditer(rf"\[{stage}\] (\d+)/\d+: loss=(\S+) psnr=\S+ "
                        r"lr=\S+ (\S+) steps/s \S+ rays/s(.*)", log)
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)),
             dict(t.split("=") for t in m.group(4).split())) for m in lines]


def train_phase(torch, cfg_path: str, data_dir: str, save_dir: str,
                tag: str, expected, finetune_steps: int = 0,
                num_steps: int = 8):
    """`num_steps` full-width steps of `cfg_path` through the trainer, and its
    finetune stage of `finetune_steps` when it has one; the launch
    counters are set to 0 before each stage and read after it. Checks that
    every kernel of `expected` launched in the train stage and no other
    hash-grid or MLP kernel did; returns ({stage: kernel launches},
    {stage: the print lines' loss terms})."""
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train import main as train_main
    launches = {}
    run_stage = driver.run_stage

    def counted_stage(stage, *args):
        reset_launches()
        run_stage(stage, *args)
        torch.cuda.synchronize()
        launches[stage] = read_launches()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    driver.run_stage = counted_stage
    try:
        train_main(["--config", cfg_path, "--data_dir", data_dir,
                    "--save_dir", save_dir, "--device", "cuda"])
    finally:
        driver.run_stage = run_stage
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()

    with open(os.path.join(save_dir, "run_log.log")) as f:
        log = f.read()
    stages = {"train": num_steps, "finetune": finetune_steps}
    check(sorted(launches) == sorted(k for k, v in stages.items() if v),
          f"stages run: {sorted(launches)}")
    lines = {stage: stage_lines(log, stage) for stage in stages}
    for stage, n in stages.items():
        check([s[0] for s in lines[stage]] == list(range(1, n + 1)),
              f"expected {stage} print lines for steps 1..{n}, got "
              f"{lines[stage]}")
        check(all(math.isfinite(s[1]) for s in lines[stage]),
              f"non-finite {stage} loss")
    steps = lines["train"]
    terms = {stage: [s[3] for s in lines[stage]] for stage in stages}
    check(all(math.isfinite(float(v)) for t in terms["train"]
              for k, v in t.items() if k != "inlier_threshold"),
          f"non-finite loss terms: {terms['train']}")
    train = launches["train"]
    check(all(train[k] > 0 for k in expected),
          f"a kernel was not launched during training: {train}")
    check(all(train[k] == 0 for k in FUSED + FUSED_F32 + HANERF + NEVER
              if k not in expected),
          f"the {tag} run launched a kernel off its path: {train}")
    check(os.path.exists(os.path.join(save_dir,
                                      f"checkpoint_{num_steps}.pt")),
          f"no step-{num_steps} checkpoint")
    evals = re.findall(r"\[train\] \d+: eval psnr=(\S+)", log)
    check(len(evals) == 1 and math.isfinite(float(evals[0])),
          "the final eval printed no PSNR")
    # Steps 2.., each timed from the previous print to its own (the
    # driver synchronises on the stats it prints).
    rate = (len(steps) - 1) / sum(1 / s[2] for s in steps[1:])
    print(f"train ({tag}): {len(steps)} steps in {wall:.1f} s; steps/s "
          f"after the "
          f"first step {rate:.3f} ({rate * 16384:.0f} rays/s); losses "
          f"{[round(s[1], 5) for s in steps]}; step-{len(steps)} terms "
          f"{terms['train'][-1]}; eval psnr {evals[0]}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {train}", flush=True)
    return launches, terms


def png_psnr(pred_path: str, gt_path: str) -> float:
    """PSNR of one PNG pair in float64 numpy, independent of the port."""
    import numpy as np
    from PIL import Image
    pred, gt = (np.asarray(Image.open(p), np.float64)[..., :3] / 255.0
                for p in (pred_path, gt_path))
    return float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))


def eval_phase(torch, cfg_path: str, data_dir: str, save_dir: str,
               tag: str, expected, score: bool,
               summary: str = "metrics_test_8.txt", images: int = 2):
    """nerf_hugs_torch.eval of `images` test images on a run's newest
    checkpoint (checks that the forward kernels of `expected` launched, no
    other hash-grid or MLP kernel did, and that it wrote `summary`), then,
    with `score`, the scoring CLI over the PNGs it wrote; returns the
    eval's kernel launches."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.metrics import main as score_main
    reset_launches()
    t0 = time.time()
    eval_main(["--config", cfg_path, "--data_dir", data_dir,
               "--save_dir", save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    check(all(launches[k] > 0 for k in expected if "bwd" not in k),
          f"eval did not run through the kernels: {launches}")
    check(all(launches[k] == 0 for k in FUSED + FUSED_F32 + HANERF + NEVER
              if k not in expected),
          f"eval launched a kernel off its path: {launches}")

    preds = os.path.join(save_dir, "test_preds")
    colors = sorted(f for f in os.listdir(preds) if f.endswith("_color.png"))
    check(colors == [f"{i:03d}_color.png" for i in range(images)],
          f"eval wrote {colors}")
    summary_path = os.path.join(save_dir, summary)
    check(os.path.exists(summary_path), f"eval wrote no {summary}")
    with open(summary_path) as f:
        mean = {k: float(v) for k, v in (line.split() for line in f)}
    check(math.isfinite(mean["psnr"]) and math.isfinite(mean["psnr_cc"])
          and 0 < mean["ssim"] <= 1,
          f"eval metrics out of range: {mean}")
    with open(os.path.join(save_dir, "run_log.log")) as f:
        renders = re.findall(r"image \d+/\d+ rendered in (\S+)s", f.read())
    print(f"eval ({tag}): {images} images of 256x256 in {wall:.1f} s (render "
          f"{', '.join(renders)} s per image); mean {mean}; launches "
          f"{launches}", flush=True)
    if not score:
        return launches

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


def robust_phase(torch, cfg_path: str, data_dir: str, save_dir: str):
    """Phase 11: RobustNeRF's 8 steps and an eval; the threshold each step
    hands the next must be finite and move after step 1."""
    _, terms = train_phase(torch, cfg_path, data_dir, save_dir,
                           "RobustNeRF, distractor scene", DENSE)
    thresholds = [[float(v) for v in t["inlier_threshold"].split(",")]
                  for t in terms["train"]]
    print(f"robust thresholds handed on by steps 1..8: {thresholds}",
          flush=True)
    check(all(math.isfinite(v) and v > 0 for t in thresholds for v in t),
          f"non-finite RobustNeRF thresholds: {thresholds}")
    check(thresholds[0] != [1.0] and any(t != thresholds[0]
                                         for t in thresholds[1:]),
          f"the RobustNeRF threshold does not move: {thresholds}")
    eval_phase(torch, cfg_path, data_dir, save_dir, "RobustNeRF", DENSE,
               score=False)


def nerfw_phase(torch, cfg_path: str, data_dir: str, save_dir: str):
    """Phase 12: NeRF-W's 8 train and 4 finetune steps and an eval of the
    finetune checkpoint; the finetune stage trains appearance_embedding
    alone, so the table-gradient kernel must not launch there."""
    launches, terms = train_phase(torch, cfg_path, data_dir, save_dir,
                                  "NeRF-W, phototourism scene", DENSE,
                                  finetune_steps=4)
    check(all(math.isfinite(float(t[k])) for t in terms["train"]
              for k in ("beta", "density")),
          f"the NeRF-W steps lack finite beta/density terms: {terms}")
    check(all(set(t) == {"data"} for t in terms["finetune"]),
          f"the finetune stage's loss is not the data term alone: {terms}")
    ft = launches["finetune"]
    check(ft["hashgrid_fwd"] > 0 and ft["hashgrid_bwd"] == 0,
          f"the finetune stage ran the table gradient: {ft}")
    print(f"finetune (NeRF-W): 4 steps, losses "
          f"{[t['data'] for t in terms['finetune']]}; launches {ft}",
          flush=True)
    eval_phase(torch, cfg_path, data_dir, save_dir, "NeRF-W finetuned",
               DENSE, score=False, summary="metrics_test_finetune_4.txt")


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
             "alone_ms": device_ms(torch,
                                   lambda: accum.planar_accum(*vals, w),
                                   "planar_accum"),
             "plain_ms": median_ms(
                 lambda: accum.planar_accum_plain(*vals, w))}
        # The yardstick: one einsum over the same gathered rows and weights,
        # laid out beforehand as [4 corners, n, 2 halves, F] and [4, n, 2]
        # (outside the timing).
        rows = torch.stack(vals).view(4, ACCUM_N, 2, accum.F)
        halves = w.view(2, 4, ACCUM_N).permute(1, 2, 0).contiguous()
        library = lambda: torch.einsum("cnh,cnhf->nf", halves, rows)
        lib_err = float((library() - out_k).abs().max())
        check(lib_err <= 1e-5, f"the einsum yardstick disagrees with "
                               f"planar_accum: {lib_err}")
        t["library_ms"] = median_ms(library)
        # 16 products and 16 sums per sample.
        t["bound_ms"], t["bound_by"] = bound(nbytes(*vals, w, out_k),
                                             32 * ACCUM_N)
        timings[N] = t
        print(f"check planar_accum, gathers of {ACCUM_N} samples from "
              f"{N}^3 rows: max_abs={err:.3e} (ragged span {sub_err:.3e}, "
              f"tol 1e-5); kernel {t['ms']:.4f} ms (alone "
              f"{_ms(t['alone_ms'])}), plain "
              f"{t['plain_ms']:.4f} ms, einsum {t['library_ms']:.4f} ms "
              f"(max_abs {lib_err:.3e}), bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}, {nbytes(*vals, w, out_k) / 1e6:.1f} MB)",
              flush=True)
        check(math.isfinite(err) and max(err, sub_err) <= 1e-5,
              f"planar_accum disagrees with its plain version ({N}^3 "
              f"rows): {err}, ragged span {sub_err}")
        worst = max(worst, err, sub_err)
        del tab2, idx, w, vals, out_k, out_p, sub, sub_k, sub_p, rows, \
            halves

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


def _ms(v) -> str:
    return "not recorded" if v is None else f"{v:.4f} ms"


def _rel_err(got, want) -> float:
    """Largest absolute difference over the reference's largest entry."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def sam_card_phase(torch, dev):
    """Phase 13a: SAM (vit_t at its published 1024 input and window 14) on
    the card against the same weights on the CPU: the image embedding, the
    decoder's full-resolution logits and IoU for SAM_PROMPTS prompts, and
    predict_count's maps. A count may differ only at a pixel where one of
    the CPU's logits lies within SAM_TOL of the largest of the threshold;
    returns the worst relative errors."""
    import numpy as np
    from nerf_hugs_torch.hugs.sam import weights
    from nerf_hugs_torch.hugs.sam.predictor import SamPredictor, build_sam
    cpu_sam = build_sam("vit_t", device="cpu", rng_seed=0)
    cpu = SamPredictor(cpu_sam)
    card = SamPredictor(weights.load_state_dict(
        build_sam("vit_t", device=dev), cpu_sam.state_dict()))
    rs = np.random.RandomState(0)
    hw = (200, 300)
    image = (rs.rand(*hw, 3) * 255).astype(np.uint8)
    for p in (cpu, card):
        p.set_image(image)
    errs = {"encoder": _rel_err(card._embedding.cpu(), cpu._embedding)}
    pts = cpu.apply_coords(rs.rand(SAM_PROMPTS, 1, 2) * [hw[1], hw[0]], hw)
    labels = np.ones((SAM_PROMPTS, 1))
    logits, iou = cpu.predict_batched(pts, labels)
    card_logits, card_iou = card.predict_batched(pts, labels)
    errs["logits"] = _rel_err(card_logits, logits)
    errs["iou"] = _rel_err(card_iou, iou)
    near = (np.abs(logits) <= SAM_TOL * np.abs(logits).max()).any((0, 1))
    flips = 0
    for best in (True, False):
        args = (pts, labels, 0.0, 0.0, 1.0, SAM_PROMPTS, best)
        diff = card.predict_count(*args) != cpu.predict_count(*args)
        check(bool(near[diff].all()),
              f"SAM counts differ away from the threshold (select_best "
              f"{best}): {int(diff.sum())} pixels")
        flips += int(diff.sum())
    print(f"check SAM vit_t card vs cpu, {hw[0]}x{hw[1]} image, "
          f"{SAM_PROMPTS} prompts: relative errors encoder "
          f"{errs['encoder']:.3e}, logits {errs['logits']:.3e}, iou "
          f"{errs['iou']:.3e} (tol {SAM_TOL}); count maps differ at "
          f"{flips} pixels, each within {SAM_TOL} of the threshold",
          flush=True)
    check(max(errs.values()) <= SAM_TOL,
          f"SAM on the card disagrees with the CPU: {errs}")
    return errs


def _hugs_line(tag: str, records) -> str:
    """`tag`: s/image and the stage split, mean over the records."""
    from nerf_hugs_torch.hugs.segment import STAGES
    n = len(records)
    stages = " ".join(
        f"{k}={sum(r[2].get(k, 0.0) for r in records) / n:.3f}"
        for k in STAGES)
    return (f"hugs {tag}: {sum(r[1] for r in records) / n:.3f} s/image "
            f"over {n} ({', '.join(f'{r[1]:.3f}' for r in records)}); "
            f"stages s/image {stages}")


def hugs_phase(torch, tmp: str, dev):
    """Phase 13b: scripts/hugs_kubric.sh by its three stages on a written
    kubric capture, and a withmask retrain on the masks they wrote; phase
    13c: SAM's timings at vit_h. Returns the HuGS stage's records."""
    import shutil

    import numpy as np
    import yaml
    from PIL import Image

    from nerf_hugs_torch.data import base as data_base
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.hugs import main as hugs_main
    from nerf_hugs_torch.hugs import segment
    from nerf_hugs_torch.hugs.sam.amg import build_point_grid
    from nerf_hugs_torch.hugs.sam.predictor import SamPredictor, build_sam
    from nerf_hugs_torch.tools.hashgrid_inputs import (shipped_yaml,
                                                       write_kubric_scene)
    from nerf_hugs_torch.train.driver import load_config
    t0 = time.time()
    scene = write_kubric_scene(os.path.join(tmp, "hugs_kubric"), HUGS_TRAIN,
                               HUGS_TEST, HUGS_SIZE, factors=(1, 2))
    print(f"hugs scene: {HUGS_TRAIN} train + {HUGS_TEST} test frames at "
          f"{HUGS_SIZE}x{HUGS_SIZE} (1x) and {HUGS_SIZE // 2} (2x), a "
          f"COLMAP model in sparse/0, written in {time.time() - t0:.1f} s",
          flush=True)
    names = [f"{i:05d}" for i in range(HUGS_TRAIN)]
    save_dir = os.path.join(tmp, "exp", "hugs_gen")
    gen_cfg = shipped_yaml(tmp, "kubric_nerfacto_gen_mask", HUGS_STEPS)
    # 1. Partial nerfacto training.
    train_phase(torch, gen_cfg, scene, save_dir, "HuGS stage 1, gen_mask",
                DENSE, num_steps=HUGS_STEPS)
    # 2. The train split's pred/gt pairs.
    reset_launches()
    t0 = time.time()
    eval_main(["--config", gen_cfg, "--data_dir", scene, "--save_dir",
               save_dir, "--eval_data", "train", "--original_name",
               "--only_pred_gt", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = read_launches()
    preds = os.path.join(save_dir, "train_preds")
    check(sorted(os.listdir(preds)) == sorted(
        f"{n}_{k}.png" for n in names for k in ("color", "gt")),
        f"stage 2 wrote {sorted(os.listdir(preds))}")
    check(launches["hashgrid_fwd"] > 0 and all(
        v == 0 for k, v in launches.items() if k != "hashgrid_fwd"),
        f"stage 2 launches {launches}")
    print(f"hugs stage 2 (eval of the train split, --original_name "
          f"--only_pred_gt): {HUGS_TRAIN} pairs in {time.time() - t0:.1f} "
          f"s; launches {launches}", flush=True)
    # 3. The static masks, into the scene as the script writes them; the
    # scene's own masks go first, so the retrain can read only these.
    mask_dir = os.path.join(scene, "static_masks")
    shutil.rmtree(mask_dir)
    config_path = os.path.join(HERE, "configs", "hugs", "kubric.yml")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    os.environ["NERF_HUGS_HUGS_TIMING"] = "1"
    t0 = time.time()
    records = hugs_main([
        "--images", preds, "--colmap", os.path.join(scene, "sparse", "0"),
        "--sam_model", "vit_h", "--output", scene, "--config", config_path,
        "--device", "cuda"])
    torch.cuda.synchronize()
    wall, peak = time.time() - t0, torch.cuda.max_memory_allocated()
    check(all(v == 0 for v in read_launches().values()),
          f"the HuGS stage launched a NeRF kernel: {read_launches()}")
    check([r[0] for r in records] == names, f"HuGS records {records}")
    for name in names:
        mask = np.asarray(Image.open(os.path.join(mask_dir, f"{name}.png")))
        check(mask.shape[:2] == (HUGS_SIZE, HUGS_SIZE)
              and set(np.unique(mask / 255.0)) <= {0.0, 1.0},
              f"mask {name}: shape {mask.shape}, values "
              f"{np.unique(mask)[:8]}")
        check(os.path.exists(os.path.join(scene, "visualizations",
                                          f"{name}.png")),
              f"no visualization of {name}")
    print(f"hugs stage 3 (python -m nerf_hugs_torch.hugs, vit_h, random "
          f"weights, configs/hugs/kubric.yml): {HUGS_TRAIN} masks of "
          f"{HUGS_SIZE}x{HUGS_SIZE} in {wall:.1f} s with the model's build; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print(_hugs_line(f"kubric.yml, {HUGS_SIZE}x{HUGS_SIZE}", records),
          flush=True)
    # 4. The withmask retrain on the masks just written.
    wm_cfg = shipped_yaml(tmp, "kubric_nerfacto_withmask", WITHMASK_STEPS)
    train = load_dataset("train", scene, load_config(wm_cfg, scene, ""),
                         is_training=False)
    for name, m in zip(names, train.static_masks):
        want = data_base.load_static_mask(
            os.path.join(mask_dir, f"{name}.png"), *m.shape[:2])
        check(np.array_equal(m, want), f"the retrain did not read {name}")
    train_phase(torch, wm_cfg, scene, os.path.join(tmp, "exp",
                                                    "hugs_withmask"),
                "HuGS stage 4, withmask retrain", DENSE,
                num_steps=WITHMASK_STEPS)

    # 13c. Timings at vit_h on the stage's own frames.
    predictor = SamPredictor(build_sam("vit_h", device=dev))
    gt = (segment.load_image_rgb(os.path.join(preds, f"{names[0]}_gt.png"))
          [..., :3] * 255).astype(np.uint8)
    enc = median_ms(lambda: predictor.set_image(gt), runs=5)
    grid = predictor.apply_coords(build_point_grid(64) * HUGS_SIZE,
                                  gt.shape[:2])
    dec = {}
    for n, budget in ((64, 192), (256, 64)):
        pts, labels = grid[:n, None, :], np.ones((n, 1))
        dec[n] = median_ms(lambda: predictor.predict_compact(
            pts, labels, 0.8, 0.9, 1.0, n, budget), runs=5)
    print(f"hugs SAM vit_h: encoder {enc:.3f} ms per set_image "
          f"({HUGS_SIZE}x{HUGS_SIZE} frame); decoder + filters + packing "
          f"{dec[64]:.3f} ms per batch of 64 prompts (budget 192), "
          f"{dec[256]:.3f} ms per batch of 256 (budget 64)", flush=True)
    with open(os.path.join(HERE, "configs", "hugs", "kubric_tpu.yml")) as f:
        tpu_config = segment.SegmentConfig(**yaml.safe_load(f))
    torch.cuda.reset_peak_memory_stats()
    tpu_records = segment.main(preds, os.path.join(scene, "sparse", "0"),
                               "vit_h", None, os.path.join(tmp, "hugs_tpu"),
                               tpu_config, predictor=predictor)
    print(_hugs_line(f"kubric_tpu.yml, {HUGS_SIZE}x{HUGS_SIZE}",
                     tpu_records)
          + f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    # One frame at the reference captures' 768x1024: the written frame and
    # its render resized (the SfM points stretch with them).
    import cv2
    big = os.path.join(tmp, "hugs_big")
    os.makedirs(big)
    for kind in ("gt", "color"):
        img = cv2.imread(os.path.join(preds, f"{names[0]}_{kind}.png"))
        cv2.imwrite(os.path.join(big, f"{names[0]}_{kind}.png"),
                    cv2.resize(img, HUGS_BIG[::-1],
                               interpolation=cv2.INTER_LINEAR))
    with open(config_path) as f:
        config = segment.SegmentConfig(**yaml.safe_load(f))
    torch.cuda.reset_peak_memory_stats()
    big_records = segment.main(big, os.path.join(scene, "sparse", "0"),
                               "vit_h", None, os.path.join(tmp, "hugs_out"),
                               config, predictor=predictor)
    print(_hugs_line(f"kubric.yml, {HUGS_BIG[0]}x{HUGS_BIG[1]}",
                     big_records)
          + f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del predictor
    torch.cuda.empty_cache()
    return records


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
    from nerf_hugs_torch.tools.hashgrid_inputs import (
        MASK_N, base_yaml, shipped_yaml, write_colmap_scene,
        write_kubric_scene)
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
    worst_2d, timings_2d = mask_kernel_phase(torch, hashgrid, hashgrid_bwd,
                                             dev)
    fused_worst, fused_timings = fused_mlp_phase(torch, fused_mlp, dev)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        scene = write_kubric_scene(os.path.join(tmp, "kubric"))
        distractor = write_colmap_scene(os.path.join(tmp, "distractor"),
                                        "distractor")
        phototourism = write_colmap_scene(os.path.join(tmp, "photo"),
                                          "phototourism")
        print(f"scenes: 32 train + 4 test frames each, kubric and "
              f"distractor at 256x256, phototourism at 512x512, written in "
              f"{time.time() - t0:.1f} s", flush=True)
        for variant in SMALL_VARIANTS:
            small_model_phase(torch, tmp, dev, variant)
        dense_cfg = base_yaml(tmp, fused=False, scene="kubric")
        hanerf_cfg = shipped_yaml(tmp, "distractor_nerfacto_hanerf")
        captured_worst, _ = captured_phase(torch, hashgrid, hashgrid_bwd,
                                           dense_cfg, scene, dev)
        worst = {k: max(v, captured_worst[k]) for k, v in worst.items()}
        captured_worst, captured_2d = captured_phase(
            torch, hashgrid, hashgrid_bwd, hanerf_cfg, distractor, dev,
            ("mask",))
        worst_2d = {k: max(v, captured_worst[k]) for k, v in worst_2d.items()}
        launches, _ = train_phase(torch, dense_cfg, scene,
                                  os.path.join(tmp, "exp", "dense"),
                                  "Dense MLPs, kubric scene", DENSE)
        launches = launches["train"]
        fused_cfg = base_yaml(tmp, fused=True)
        fused_dir = os.path.join(tmp, "exp", "fused")
        train_phase(torch, fused_cfg, tmp, fused_dir,
                    "fused MLPs, synthetic scene", FUSED)
        eval_launches = eval_phase(torch, fused_cfg, tmp, fused_dir,
                                   "fused MLPs", FUSED, score=True)
        f32_cfg = base_yaml(tmp, fused=True, steps=F32_STEPS,
                            enable_amp=False, eval_dataset_limit=1)
        f32_dir = os.path.join(tmp, "exp", "fused_fp32")
        train_phase(torch, f32_cfg, tmp, f32_dir,
                    "fused MLPs in fp32, synthetic scene", FUSED_F32,
                    num_steps=F32_STEPS)
        f32_eval = eval_phase(torch, f32_cfg, tmp, f32_dir,
                              "fused MLPs in fp32", FUSED_F32, score=False,
                              summary=f"metrics_test_{F32_STEPS}.txt",
                              images=1)
        hanerf_dir = os.path.join(tmp, "exp", "hanerf")
        hanerf_launches, terms = train_phase(
            torch, hanerf_cfg, distractor, hanerf_dir,
            "HA-NeRF, distractor scene", HANERF)
        hanerf_launches = hanerf_launches["train"]
        check(all(float(t["mask_size"]) > 0 for t in terms["train"]),
              f"the HA-NeRF steps have no mask_size term: {terms}")
        eval_phase(torch, hanerf_cfg, distractor, hanerf_dir, "HA-NeRF",
                   HANERF, score=False)
        robust_phase(torch, shipped_yaml(
            tmp, "distractor_nerfacto_robustnerf0.8"), distractor,
            os.path.join(tmp, "exp", "robustnerf"))
        nerfw_phase(torch, shipped_yaml(
            tmp, "phototourism_nerfacto_nerfw", finetune_num_steps=4),
            phototourism, os.path.join(tmp, "exp", "nerfw"))
        sam_card_phase(torch, dev)
        hugs_phase(torch, tmp, dev)
    accum_worst, accum_timings, accum_launches = accum_phase(torch, dev)
    check("jax" not in sys.modules, "jax was imported")
    check("nerf_hugs_tpu" not in sys.modules, "nerf_hugs_tpu was imported")

    field = timings["field"]
    mask = timings_2d[MASK_N]
    head = fused_timings[("field mlp_head", "bfloat16")]
    head_f32 = fused_timings[("field mlp_head", "float32")]
    acc = accum_timings[81]
    print(json.dumps({"kernels": [
        {"name": "hashgrid_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid.py:448",
         "launches": launches["hashgrid_fwd"], "max_abs_err": worst["fwd"],
         "ms": field["fwd"], "plain_ms": field["fwd_plain"],
         "bound_ms": field["fwd_bound_ms"],
         "bound_by": field["fwd_bound_by"],
         "library_ms": field["fwd_library"]},
        {"name": "hashgrid_bwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid_bwd.py:48",
         "launches": launches["hashgrid_bwd"], "max_abs_err": worst["bwd"],
         "ms": field["bwd"], "plain_ms": field["bwd_plain"],
         "bound_ms": field["bwd_bound_ms"],
         "bound_by": field["bwd_bound_by"],
         "library_ms": field["bwd_library"]},
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_hugs_tpu/ops/fused_mlp.py:39",
         "launches": eval_launches["fused_mlp_fwd_resident"],
         "max_abs_err": fused_worst["bfloat16"], "ms": head["ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": head["library_ms"]},
        {"name": "fused_mlp_fwd_fp32", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/fused_mlp.cu",
         "replaces": "nerf_hugs_tpu/ops/fused_mlp.py:39",
         "launches": f32_eval["fused_mlp_fwd_f32"],
         "max_abs_err": fused_worst["float32"], "ms": head_f32["ms"],
         "plain_ms": head_f32["plain_ms"],
         "bound_ms": head_f32["bound_ms"],
         "bound_by": head_f32["bound_by"],
         "library_ms": head_f32["library_ms"]},
        {"name": "planar_accum", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/accum.cu",
         "replaces": "tools/bench_fwd_copies.py:94",
         "launches": accum_launches, "max_abs_err": accum_worst,
         "ms": acc["ms"], "plain_ms": acc["plain_ms"],
         "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
         "library_ms": acc["library_ms"]},
        {"name": "hashgrid_fwd_2d", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid.py:448",
         "launches": hanerf_launches["hashgrid_fwd_2d"],
         "max_abs_err": worst_2d["fwd"], "ms": mask["fwd"],
         "plain_ms": mask["fwd_plain"],
         "bound_ms": mask["fwd_bound_ms"],
         "bound_by": mask["fwd_bound_by"],
         "library_ms": mask["fwd_library"]},
        {"name": "hashgrid_bwd_2d", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/hashgrid.cu",
         "replaces": "nerf_hugs_tpu/ops/hashgrid_bwd.py:48",
         "launches": hanerf_launches["hashgrid_bwd_2d"],
         "max_abs_err": worst_2d["bwd"], "ms": mask["bwd"],
         "plain_ms": mask["bwd_plain"],
         "bound_ms": mask["bwd_bound_ms"],
         "bound_by": mask["bwd_bound_by"],
         "library_ms": mask["bwd_library"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
