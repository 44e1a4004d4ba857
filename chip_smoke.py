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
     kubric.yml on one 768x1024 frame, with peak device memory;
  14. Mip-NeRF 360 (no ported kernel runs on its path: each run must
     launch none): (a) the toy model of tests/test_torch_port_mipnerf360.py
     (NerfMLP 2 x 32, PropMLP 2 x 16, 8 / 4 samples) on the card against
     the same weights on the CPU, loss and every gradient, in fp32 (phase
     5's tolerances) and in bf16 with remat (2e-2), as base, GLO with the
     contraction and the reciprocal raydist, NeRF-W and HA-NeRF; (b) 8
     steps of configs/mipnerf360/kubric_1024_base.gin, model sections
     unchanged (NerfMLP 8 x 1024, PropMLP 4 x 256, 64 / 64 / 32 samples,
     batch 16384), through `nerf_hugs_torch.train.main` with gin flags on
     phase 7's kubric scene, bound only to its directories and cadence
     (early_exit_steps, print_every, eval_dataset_limit), with a
     torch.profiler window over steps 5-7 (device ms per step split into
     GEMM, Adam, sort / searchsorted, reductions and elementwise, the wall
     ms and the busy share), then an eval of 2 test images and the scoring
     CLI, then max_dilate_weights and the lift + IPE alone at its shapes;
     (c) the same for kubric_1024_base_tpu_bf16.gin (bf16 + remat); (d) 4
     steps of kubric_1024_withmask.gin and of kubric_1024_robustnerf0.8.gin
     with the Config.patch_size = 16 binding its loss needs (the carried
     thresholds finite and moving); (e) 8 steps of
     distractor_1024_glo4_base.gin on phase 10's capture and an eval of 2
     images with its zero GLO, then 4 steps each of the nerfw and hanerf
     gins; (f) phototourism_1024_base.gin on phase 12's capture, 4 train
     and 4 finetune steps (every tensor but GloEmbed_0.weight bit-equal
     across the finetune stage), then an eval from the finetune
     checkpoint;
  15. vanilla NeRF (no ported kernel runs on its path: each run must
     launch none): (a) the toy model of tests/test_torch_port_vanilla.py
     (a 5-layer trunk of 32, 16 + 16 samples) on the card against the
     same weights on the CPU, as base, NeRF-W and HA-NeRF, without the
     interlevel term (the module docstring of that test says why): the
     loss and every gradient in fp32 and fp64 at phase 5's tolerances,
     but NeRF-W's fp32 gradients, which are held to 3 times the CPU's own
     error under a 1e-7 move of the ray origins (vanilla_small_phase says
     why); (b)
     8 steps of configs/nerfacto/kubric_nerf_base.yml, model section
     unchanged (64 + 64 samples, the fine pass over their 128-sample
     union, batch 4096, fp32), on phase 7's kubric scene with a profiler
     window over steps 5-7, then an eval of 2 images; (c) 4 steps of kubric_nerf_hanerf.yml
     on the same scene, and phototourism_nerf_nerfw.yml (128 + 128
     samples) on phase 12's capture, 4 train and 2 finetune steps, in
     which only appearance_embedding moves;
  16. the render driver, `nerf_hugs_torch.render.main`, which renders at
     train_frac 1.0 as render.py does: (a) over phase 7's
     kubric_nerfacto_base checkpoint, the 4 test frames, each colour PNG
     equal bit for bit to the eval driver's image of the same frame
     (phase 16 runs that eval of 2 images first, with max_steps set to
     the checkpoint's 8 steps so that it too is at 1.0), the hash-grid forward
     launched and nothing else; (b) job 1 of render_num_jobs 2 writes only
     the odd frames, and its rerun skips frame 1; (c) render_path with
     render_path_frames 3 writes 3 frames of the ellipse path; (d) over
     phase 8's fused checkpoint, frames 0 and 16 (job 0 of 16), frame 0
     equal to the eval image of that checkpoint at max_steps 8, the
     hash-grid and resident fused bf16
     forwards launched; seconds per frame for each;
  17. llff and blender (no ported kernel: each run must launch none): a
     forward-facing llff capture and a 360 one (20 frames of 1008x756 in
     images_4/ each, LLFF's own size at factor 4,
     hashgrid_inputs.write_llff_scene) and a blender scene
     (8 train and 2 test frames of 800x800, write_blender_scene) written,
     then 4 steps and an eval of 1 image each of llff_256.gin (NDC,
     cylinders), 360.gin (contraction, NerfMLP 8 x 1024) and
     blender_256.gin at their model sections, and the render driver over
     the llff_256 run with render_config.gin (the spiral path,
     render_path_frames 3).
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


def config_args(cfg, data_dir: str, save_dir: str) -> list:
    """The drivers' flags on the card: `cfg` is a yaml path (--config
    --data_dir --save_dir) or a list of gin flags (--gin_configs and
    --gin_bindings), to which the directories are bound."""
    if isinstance(cfg, str):
        return ["--config", cfg, "--data_dir", data_dir, "--save_dir",
                save_dir, "--device", "cuda"]
    return cfg + [f"--gin_bindings=Config.data_dir = '{data_dir}'",
                  f"--gin_bindings=Config.checkpoint_dir = '{save_dir}'",
                  "--device", "cuda"]


def train_phase(torch, cfg_path, data_dir: str, save_dir: str,
                tag: str, expected, finetune_steps: int = 0,
                num_steps: int = 8):
    """`num_steps` full-width steps of `cfg_path` (a yaml path or gin
    flags, config_args) through the trainer, and its
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
        train_main(config_args(cfg_path, data_dir, save_dir))
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
    with open(os.path.join(save_dir, "config.gin")) as f:
        batch = int(re.search(r"Config\.batch_size = (\d+)",
                              f.read()).group(1))
    print(f"train ({tag}): {len(steps)} steps in {wall:.1f} s; steps/s "
          f"after the "
          f"first step {rate:.3f} ({rate * batch:.0f} rays/s); losses "
          f"{[round(s[1], 5) for s in steps]}; step-{len(steps)} terms "
          f"{terms['train'][-1]}; eval psnr {evals[0]}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {train}", flush=True)
    return launches, terms


def png_shape(path: str) -> tuple:
    """(height, width) of a PNG."""
    from PIL import Image
    with Image.open(path) as img:
        return img.height, img.width


def png_pixels(path: str):
    import numpy as np
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img)


def png_psnr(pred_path: str, gt_path: str) -> float:
    """PSNR of one PNG pair in float64 numpy, independent of the port."""
    import numpy as np
    from PIL import Image
    pred, gt = (np.asarray(Image.open(p), np.float64)[..., :3] / 255.0
                for p in (pred_path, gt_path))
    return float(-10.0 * np.log10(np.mean((pred - gt) ** 2)))


def eval_phase(torch, cfg_path, data_dir: str, save_dir: str,
               tag: str, expected, score: bool,
               summary: str = "metrics_test_8.txt", images: int = 2,
               ssim_min: float = 0.0):
    """nerf_hugs_torch.eval of `images` test images on a run's newest
    checkpoint (checks that the forward kernels of `expected` launched, no
    other hash-grid or MLP kernel did, that it wrote `summary`, and that
    the mean SSIM lies in (ssim_min, 1]), then, with `score`, the scoring
    CLI over the PNGs it wrote; returns the eval's kernel launches."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.metrics import main as score_main
    reset_launches()
    t0 = time.time()
    eval_main(config_args(cfg_path, data_dir, save_dir))
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
          and ssim_min < mean["ssim"] <= 1,
          f"eval metrics out of range: {mean}")
    with open(os.path.join(save_dir, "run_log.log")) as f:
        renders = re.findall(r"image \d+/\d+ rendered in (\S+)s", f.read())
    height, width = png_shape(os.path.join(preds, colors[0]))
    print(f"eval ({tag}): {images} images of {width}x{height} in {wall:.1f} "
          f"s (render "
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


# Phase 14: Mip-NeRF 360. The toy model of 14a (the widths of
# tests/test_torch_port_mipnerf360.py) and its variants; the gin files'
# directories and cadence are the only bindings of 14b-14f, beside the
# patch size that kubric_1024_robustnerf0.8.gin needs
# (tests/test_configs.py).
MIP_TOY = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
           "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
           "NerfMLP.net_width_viewdirs = 16",
           "NerfMLP.net_depth_transient = 2",
           "NerfMLP.net_width_transient = 16", "PropMLP.net_depth = 2",
           "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
           "Model.num_nerf_samples = 4", "Config.randomized = False"]
MIP_VARIANTS = {
    "base": [],
    "GLO, contract": ["Model.num_glo_features = 4",
                      "NerfMLP.warp_fn = @coord.contract",
                      "PropMLP.warp_fn = @coord.contract",
                      "Model.raydist_fn = @jnp.reciprocal",
                      "Config.distortion_loss_mult = 0.01"],
    "NeRF-W": ["Config.transient_type = 'nerfw'",
               "Model.num_transient_features = 8",
               "Model.num_glo_features = 4"],
    "HA-NeRF": ["Config.transient_type = 'hanerf'",
                "Model.num_transient_features = 8"],
}
MIP_BF16 = ["Model.compute_dtype = 'bfloat16'", "Model.remat_mlp = True"]
# Card against CPU: phase 5's tolerances in fp32 (loss relative, each
# gradient relative to its leaf's largest entry); in bf16 the bound of the
# port's bf16 forward test, 2e-2, as bf16 rounds after other sums on the
# card.
MIP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# The profiler window of a train run: the train stage's steps 5-7.
MIP_WINDOW = (5, 3)
MIP_RAYS = 16384           # the gin files' batch_size
# cuBLAS's Hopper GEMMs are named nvjet_*.
MIP_CATEGORIES = (("gemm", r"nvjet|gemm|xmma|cutlass|cublas"),
                  ("adam", r"adam"),
                  ("sort/searchsorted", r"sort|radix|searchsorted"),
                  ("reduce", r"reduce"),
                  ("IPE and elementwise", r"."))


def gin_flags(name: str, steps: int, *extra) -> list:
    """configs/mipnerf360/{name}.gin, exiting after `steps` train steps,
    printing every step and evaluating 2 test images (the yaml phases'
    cadence keys), with the bindings `extra`."""
    path = os.path.join(HERE, "configs", "mipnerf360", f"{name}.gin")
    bindings = [f"Config.early_exit_steps = {steps}",
                "Config.print_every = 1", "Config.eval_dataset_limit = 2"]
    return [f"--gin_configs={path}"] + [
        f"--gin_bindings={b}" for b in bindings + list(extra)]


def mip_small_phase(torch, dev):
    """Phase 14a: the toy Mip-NeRF 360 model on the card against the same
    weights on the CPU, loss and every gradient, in fp32 and in bf16 with
    remat, for each of MIP_VARIANTS; then one step of the port's Adam
    (the fused OptaxAdam) on each device from the CPU's gradients, every
    new parameter within 1e-6 relative of the CPU's (relative to the
    larger of the parameter and the rate)."""
    import numpy as np

    from nerf_hugs_torch.configs import gin_parser
    from nerf_hugs_torch.models import construct_model
    from nerf_hugs_torch.train.step import (apply_gradients, compute_loss,
                                            create_optimizer)
    from nerf_hugs_torch.utils import structs
    rs = np.random.RandomState(0)
    n = 256
    d = rs.randn(n, 3).astype(np.float32)
    column = lambda v: np.full((n, 1), v, np.float32)
    rays = structs.Rays(
        pix_coords=rs.rand(n, 2).astype(np.float32),
        origins=rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        directions=d,
        viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
        radii=column(0.01), lossmult=column(1.0), static_mask=column(1.0),
        near=column(0.05), far=column(1.2),
        embed_idx=(np.arange(n) % 3).astype(np.int32)[:, None],
        cam_idx=np.zeros((n, 1), np.int32))
    batch = structs.Batch(rays=rays, rgb=rs.rand(n, 3).astype(np.float32))
    for variant, extra in MIP_VARIANTS.items():
        for dtype, dtype_bindings in (("float32", []),
                                      ("bfloat16", MIP_BF16)):
            config = gin_parser.parse_gin_configs(
                [], MIP_TOY + extra + dtype_bindings)
            results = {}
            for device in ("cpu", dev):
                model = construct_model(config, device,
                                        torch.Generator().manual_seed(0))
                check(model.NerfMLP_0.remat == (dtype == "bfloat16"),
                      "the toy model does not follow remat_mlp")
                loss, _ = compute_loss(model, batch.to(device), 0.4, config,
                                       None)
                loss.backward()
                results[device] = (loss.item(), {
                    k: p.grad.detach().cpu()
                    for k, p in model.named_parameters()}, model)
            (loss_c, grads_c, model_c), (loss_g, grads_g, model_g) = (
                results["cpu"], results[dev])
            loss_rel = abs(loss_g - loss_c) / abs(loss_c)
            grad_rel = max(float((grads_g[k] - grads_c[k]).abs().max())
                           / max(float(grads_c[k].abs().max()), 1e-30)
                           for k in grads_c)
            loss_tol, grad_tol = MIP_TOL[dtype]
            print(f"check mipnerf360 toy ({variant}, {dtype}"
                  f"{' + remat' if dtype_bindings else ''}) cuda vs cpu: "
                  f"loss {loss_g:.6f} vs {loss_c:.6f} (rel {loss_rel:.2e}, "
                  f"bound {loss_tol:.0e}); worst gradient error "
                  f"{grad_rel:.2e} of the leaf's max (bound {grad_tol:.0e}) "
                  f"over {len(grads_c)} leaves", flush=True)
            check(math.isfinite(loss_g) and loss_rel <= loss_tol,
                  f"toy mipnerf360 loss differs ({variant}, {dtype})")
            check(grad_rel <= grad_tol,
                  f"toy mipnerf360 gradients differ ({variant}, {dtype})")
            for model in (model_c, model_g):
                opt, sched = create_optimizer(config, model)
                lr = opt.param_groups[0]["lr"]
                params = dict(model.named_parameters())
                with torch.no_grad():
                    apply_gradients(opt, sched, params, {
                        k: g.to(params[k].device) for k, g in grads_c.items()})
            params_c = dict(model_c.named_parameters())
            adam_rel = max(float(((p.detach().cpu() - params_c[k]).abs()
                                  / params_c[k].abs().clamp(min=lr)).max())
                           for k, p in model_g.named_parameters())
            print(f"check mipnerf360 toy ({variant}, {dtype}) Adam step from "
                  f"the CPU's gradients, cuda vs cpu: worst {adam_rel:.2e} "
                  f"of max(|param|, lr {lr:g}) (bound 1e-6)", flush=True)
            check(adam_rel <= 1e-6,
                  f"toy mipnerf360 Adam steps differ ({variant}, {dtype})")


def mip_categorize(prof, steps: int) -> dict:
    """{category: device ms per step}, the total and the five longest
    kernels (ms per step) of a profiler window over `steps` steps."""
    totals = {name: 0.0 for name, _ in MIP_CATEGORIES}
    kernels = []
    for e in prof.key_averages():
        t = e.device_time_total / 1e3 / steps
        if t <= 0 or e.device_type.name != "CUDA":
            continue
        kernels.append((t, e.key))
        for name, pattern in MIP_CATEGORIES:
            if re.search(pattern, e.key, re.IGNORECASE):
                totals[name] += t
                break
    kernels.sort(reverse=True)
    return {"split": {k: round(v, 3) for k, v in totals.items()},
            "device_ms": round(sum(totals.values()), 3),
            "longest": [(k[:70], round(t, 3)) for t, k in kernels[:5]]}


def mip_train(torch, flags: list, data_dir: str, save_dir: str, tag: str,
              steps: int, finetune_steps: int = 0, profile: bool = False):
    """train_phase on gin flags (no ported kernel may launch); with
    `profile`, a torch.profiler window over MIP_WINDOW's train steps,
    whose device ms per step, wall ms per step (host clock, synchronised
    at both ends) and busy share (device over wall) are printed and
    returned with the peak device memory and steps/s (outside the
    window)."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from nerf_hugs_torch.train import step as step_lib
    first, count = MIP_WINDOW
    window = {}
    train_step = step_lib.train_step
    calls = [0]

    def windowed(*args, **kwargs):
        calls[0] += 1
        if calls[0] == first:
            torch.cuda.synchronize()
            window["prof"] = profiler(activities=[ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.time()
        out = train_step(*args, **kwargs)
        if calls[0] == first + count - 1:
            torch.cuda.synchronize()
            window["wall"] = time.time() - window["t0"]
            window["prof"].__exit__(None, None, None)
        return out

    if profile:
        step_lib.train_step = windowed
    try:
        launches, terms = train_phase(torch, flags, data_dir, save_dir, tag,
                                      (), finetune_steps=finetune_steps,
                                      num_steps=steps)
    finally:
        step_lib.train_step = train_step
    # Steps/s over the train steps after the first, those of the profiler
    # window left out.
    with open(os.path.join(save_dir, "run_log.log")) as f:
        rates = [s[2] for s in stage_lines(f.read(), "train")[1:]
                 if not (profile and first <= s[0] < first + count)]
    reading = {"steps_per_s": (len(rates) / sum(1 / r for r in rates)),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        check("wall" in window, f"the profiler window did not close: "
                                f"{calls[0]} steps")
        split = mip_categorize(window["prof"], count)
        reading.update(split)
        reading["wall_ms"] = window["wall"] * 1e3 / count
        reading["busy"] = split["device_ms"] / reading["wall_ms"]
        check(split["device_ms"] > 0, f"the {tag} trace has no device time")
        print(f"profile ({tag}), train steps {first}-{first + count - 1}: "
              f"device {split['device_ms']:.3f} ms per step, wall "
              f"{reading['wall_ms']:.3f} ms per step, busy share "
              f"{reading['busy']:.3f}; split {split['split']}; longest "
              f"{split['longest']}", flush=True)
    return launches, terms, reading


def mip_step_flops(name: str, remat: bool) -> float:
    """The GEMM operations of one train step of a batch of
    configs/mipnerf360/{name}.gin, counting the products autograd runs:
    each MLP's multiply-adds a sample (a skip concatenation widens the
    layer after it) x 2 x its samples for the forward, once more for the
    weight gradients, and once more for the input gradients but those of
    each trunk's first layer (its IPE features carry no gradient: the
    rays carry none and each level's samples are stop-gradient); under
    remat the forward runs twice."""
    from nerf_hugs_torch.configs import gin_parser
    from nerf_hugs_torch.core import geopoly
    config = gin_parser.parse_gin_configs([os.path.join(
        HERE, "configs", "mipnerf360", f"{name}.gin")])
    mc = config.model
    check(mc.stop_level_grad,
          f"{name}: the IPE features carry a gradient; count its products")

    def stack(d_in, width, depth, skip):
        macs, d = 0, d_in
        for i in range(depth):
            macs += d * width
            d = width + (d_in if i % skip == 0 and i > 0 else 0)
        return macs, d

    def mlp_macs(c, glo):
        """(multiply-adds a sample, those of the trunk's first layer)."""
        feat = 2 * len(geopoly.generate_basis(
            c.basis_shape, c.basis_subdivisions)) * (c.max_deg_point
                                                     - c.min_deg_point)
        macs, d = stack(feat, c.net_width, c.net_depth, c.skip_layer)
        macs += d
        if not c.disable_rgb:
            macs += d * c.bottleneck_width
            view, d = stack(c.bottleneck_width + 3 + 6 * c.deg_view + glo,
                            c.net_width_viewdirs, c.net_depth_viewdirs,
                            c.skip_layer_dir)
            macs += view + d * c.num_rgb_channels
        return macs, feat * c.net_width

    samples = ((config.nerf_mlp, mc.num_glo_features, mc.num_nerf_samples),
               (config.prop_mlp, 0, mc.num_prop_samples * (mc.num_levels - 1)))
    total = 0
    for c, glo, n in samples:
        macs, first = mlp_macs(c, glo)
        total += n * ((3 + remat) * macs - first)
    return 2 * config.batch_size * total


def mip_micro_phase(torch, dev):
    """Phase 14b's passes outside the GEMMs at kubric_1024_base's shapes,
    each timed alone (median of 10, CUDA events): max_dilate_weights at
    the second proposal level ([16384, 65] endpoints, its [16384, 193, 64]
    mask), and the lift + integrated positional encoding of the NerfMLP
    ([16384, 32] samples) and of the PropMLP ([16384, 64])."""
    from nerf_hugs_torch.core import coord, geopoly, stepfun
    gen = torch.Generator(device=dev).manual_seed(3)
    rays = MIP_RAYS
    t = torch.sort(torch.rand(rays, 65, generator=gen, device=dev),
                   dim=-1).values
    t[:, 0], t[:, -1] = 0.0, 1.0
    w = torch.rand(rays, 64, generator=gen, device=dev)
    w = w / w.sum(-1, keepdim=True)
    dilate = median_ms(lambda: stepfun.max_dilate_weights(
        t, w, 0.0025 + 0.5 / 64, domain=(0.0, 1.0)))
    basis = torch.tensor(geopoly.generate_basis("icosahedron", 2).T.copy(),
                         dtype=torch.float32, device=dev)
    ipe = {}
    for name, samples in (("NerfMLP", 32), ("PropMLP", 64)):
        mean = torch.randn(rays, samples, 3, generator=gen, device=dev)
        a = 0.01 * torch.randn(rays, samples, 3, 3, generator=gen,
                               device=dev)
        cov = a @ a.transpose(-1, -2)
        ipe[name] = median_ms(lambda: coord.integrated_pos_enc(
            *coord.lift_and_diagonalize(mean, cov, basis), 0, 12))
    print(f"mipnerf360 passes at kubric_1024_base's shapes: "
          f"max_dilate_weights {dilate:.3f} ms ([16384, 65] -> [16384, 193] "
          f"endpoints); lift + IPE {ipe['NerfMLP']:.3f} ms (NerfMLP, "
          f"[16384, 32] samples -> 504 features), {ipe['PropMLP']:.3f} ms "
          f"(PropMLP, [16384, 64])", flush=True)


def mip_phase(torch, tmp: str, scene: str, distractor: str,
              phototourism: str, dev):
    """Phase 14: Mip-NeRF 360 (14a the toy model card vs CPU; 14b-14f the
    shipped gin files at full width through the drivers)."""
    mip_small_phase(torch, dev)
    exp = lambda name: os.path.join(tmp, "exp", f"mip_{name}")
    # 14b: kubric_1024_base, fp32.
    base = gin_flags("kubric_1024_base", 8)
    _, _, fp32 = mip_train(torch, base, scene, exp("base"),
                           "Mip-NeRF 360 kubric_1024_base, fp32", 8,
                           profile=True)
    eval_phase(torch, base, scene, exp("base"), "Mip-NeRF 360 base", (),
               score=True)
    mip_micro_phase(torch, dev)
    # 14c: the bf16 + remat overlay.
    _, _, bf16 = mip_train(torch, gin_flags("kubric_1024_base_tpu_bf16", 8),
                           scene, exp("bf16"),
                           "Mip-NeRF 360 kubric_1024_base_tpu_bf16", 8,
                           profile=True)
    flops = {remat: mip_step_flops("kubric_1024_base", remat)
             for remat in (False, True)}
    print("mipnerf360 kubric_1024_base: " + "; ".join(
        f"{tag} {r['steps_per_s']:.3f} steps/s, device {r['device_ms']:.3f}"
        f" ms per step, busy {r['busy']:.3f}, peak {r['peak_gib']:.2f} GiB, "
        f"GEMMs {flops[remat] / 1e12:.2f} TFLOP in "
        f"{r['split']['gemm']:.3f} ms "
        f"({flops[remat] / r['split']['gemm'] / 1e9:.1f} TFLOP/s)"
        for tag, r, remat in (("fp32", fp32, False),
                              ("bf16 + remat", bf16, True)))
        + f"; bf16 / fp32 device time "
        f"{bf16['device_ms'] / fp32['device_ms']:.3f}", flush=True)
    # 14d: withmask, and RobustNeRF with the patch its loss needs.
    mip_train(torch, gin_flags("kubric_1024_withmask", 4), scene,
              exp("withmask"), "Mip-NeRF 360 kubric_1024_withmask", 4)
    _, terms, _ = mip_train(
        torch, gin_flags("kubric_1024_robustnerf0.8", 4,
                         "Config.patch_size = 16"),
        scene, exp("robustnerf"), "Mip-NeRF 360 kubric_1024_robustnerf0.8",
        4)
    thresholds = [[float(v) for v in t["inlier_threshold"].split(",")]
                  for t in terms["train"]]
    print(f"mipnerf360 robust thresholds handed on by steps 1..4 (one per "
          f"level): {thresholds}", flush=True)
    check(all(math.isfinite(v) and v > 0 for t in thresholds for v in t),
          f"non-finite RobustNeRF thresholds: {thresholds}")
    check(thresholds[0] != [1.0] * 3 and any(t != thresholds[0]
                                             for t in thresholds[1:]),
          f"the RobustNeRF threshold does not move: {thresholds}")
    # 14e: the distractor trio on phase 10's capture.
    glo = gin_flags("distractor_1024_glo4_base", 8)
    _, terms, _ = mip_train(torch, glo, distractor, exp("distractor"),
                            "Mip-NeRF 360 distractor_1024_glo4_base", 8)
    check(all(float(t["distortion"]) > 0 for t in terms["train"]),
          f"no distortion term: {terms['train']}")
    eval_phase(torch, glo, distractor, exp("distractor"),
               "Mip-NeRF 360 distractor glo4, zero GLO", (), score=False)
    _, terms, _ = mip_train(torch, gin_flags("distractor_1024_glo4_nerfw", 4),
                            distractor, exp("nerfw"),
                            "Mip-NeRF 360 distractor_1024_glo4_nerfw", 4)
    check(all(math.isfinite(float(t[k])) for t in terms["train"]
              for k in ("beta", "density")),
          f"the NeRF-W steps lack finite beta/density terms: {terms}")
    _, terms, _ = mip_train(torch, gin_flags("distractor_1024_glo4_hanerf",
                                             4),
                            distractor, exp("hanerf"),
                            "Mip-NeRF 360 distractor_1024_glo4_hanerf", 4)
    check(all(float(t["mask_size"]) > 0 for t in terms["train"]),
          f"the HA-NeRF steps have no mask_size term: {terms}")
    # 14f: phototourism_1024_base, its train and finetune stages.
    photo = gin_flags("phototourism_1024_base", 4,
                      "Config.finetune_max_steps = 4")
    _, terms, _ = mip_train(torch, photo, phototourism, exp("photo"),
                            "Mip-NeRF 360 phototourism_1024_base", 4,
                            finetune_steps=4)
    check(all(set(t) == {"data"} for t in terms["finetune"]),
          f"the finetune stage's loss is not the data term alone: {terms}")
    before = torch.load(os.path.join(exp("photo"), "checkpoint_4.pt"),
                        weights_only=True)["model"]
    after = torch.load(os.path.join(exp("photo"), "finetune",
                                    "checkpoint_4.pt"),
                       weights_only=True)["model"]
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    with open(os.path.join(exp("photo"), "run_log.log")) as f:
        rates = [s[2] for s in stage_lines(f.read(), "finetune")[1:]]
    print(f"finetune (Mip-NeRF 360 phototourism): 4 steps, steps/s after "
          f"the first {len(rates) / sum(1 / r for r in rates):.3f}; losses "
          f"{[t['data'] for t in terms['finetune']]}; moved {moved} of "
          f"{len(before)} tensors", flush=True)
    check(moved == ["GloEmbed_0.weight"],
          f"the finetune stage moved {moved}, not GloEmbed_0 alone")
    eval_phase(torch, photo, phototourism, exp("photo"),
               "Mip-NeRF 360 phototourism finetuned", (), score=False,
               summary="metrics_test_finetune_4.txt")


# Phase 15: vanilla NeRF. The toy model of tests/test_torch_port_vanilla.py
# (SMALL_YAML's base, 256 rays) and its variants; its loss leaves out the
# interlevel term, whose coarse and fine fences tie in exact arithmetic and
# which jumps where one ulp of rounding splits a tie.
VANILLA_TOY = {
    "net_depth": 5, "net_width": 32, "max_deg_point": 4, "deg_view": 2,
    "num_coarse_nerf_samples_per_ray": 16,
    "num_fine_nerf_samples_per_ray": 16, "proposal_initial_sampler": "uniform",
    "opaque_background": True, "coarse_rgb_loss_mult": 0.5,
    "interlevel_loss_mult": 0.0}
VANILLA_VARIANTS = {
    "base": {},
    "NeRF-W": {"transient_type": "nerfw", "use_appearance_embedding": True,
               "appearance_embedding_dim": 8,
               "use_transient_embedding": True,
               "transient_embedding_dim": 8},
    "HA-NeRF": {"transient_type": "hanerf", "use_transient_embedding": True,
                "transient_embedding_dim": 8},
}
NOT_ANY = ()               # a run that must launch no ported kernel


def vanilla_small_phase(torch, tmp, dev):
    """Phase 15a: the toy vanilla model on the card against the same
    weights on the CPU. Its gradients are not continuous in fp32: a ReLU
    whose pre-activation lies within rounding of zero on one device and
    not the other moves its weights' gradients by one sample's share,
    which reaches 1e-3 of a leaf's max in NeRF-W's uncertainty-weighted
    loss (the CPU alone moves as much when the ray origins move by 1e-7).
    So the fp32 run holds the loss to phase 5's 1e-5 and the gradients to
    its 1e-4, but NeRF-W's, which are held to 3 times the CPU's own error
    under that 1e-7 move (and at least 1e-4); the same weights in fp64
    hold the loss and every gradient to 1e-5 and 1e-4, where rounding
    cannot flip a ReLU."""
    import copy

    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.vanilla import VanillaNerfModel
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss

    def loss_and_grads(model, batch, device, dtype):
        model = copy.deepcopy(model).to(device=device, dtype=dtype)
        model.coarse.compute_dtype = model.fine.compute_dtype = dtype
        batch = batch.to(device)
        batch.rays = batch.rays.map(
            lambda x: x.to(dtype) if x.is_floating_point() else x)
        batch.rgb = batch.rgb.to(dtype)
        loss, _ = compute_loss(model, batch, 0.3, config, None)
        loss.backward()
        return loss.item(), {k: p.grad.detach().cpu().double()
                             for k, p in model.named_parameters()}

    def worst(grads, want):
        return max(float((grads[k] - want[k]).abs().max())
                   / max(float(want[k].abs().max()), 1e-30) for k in want)

    for variant, keys in VANILLA_VARIANTS.items():
        raw = yaml.safe_load(SMALL_YAML)
        raw["base"]["model_type"] = "nerf"
        raw["model"] = {**VANILLA_TOY, **keys}
        path = os.path.join(tmp, "vanilla_small.yml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        config = driver.load_config(path, tmp, os.path.join(tmp, "v_ckpt"))
        batch = next(load_dataset("train", tmp, config, is_training=True))
        model = VanillaNerfModel(config, "cpu",
                                 torch.Generator().manual_seed(0))
        moved = copy.deepcopy(batch)
        noise = torch.randn(moved.rays.origins.shape,
                            generator=torch.Generator().manual_seed(5))
        moved.rays.origins = moved.rays.origins * (1 + 1e-7 * noise.numpy())
        readings = {}
        for dtype in (torch.float32, torch.float64):
            loss_c, grads_c = loss_and_grads(model, batch, "cpu", dtype)
            loss_g, grads_g = loss_and_grads(model, batch, dev, dtype)
            readings[dtype] = (abs(loss_g - loss_c) / abs(loss_c),
                               worst(grads_g, grads_c), len(grads_c))
        _, grads_m = loss_and_grads(model, moved, "cpu", torch.float32)
        self32 = worst(grads_m, loss_and_grads(model, batch, "cpu",
                                               torch.float32)[1])
        (l32, g32, n), (l64, g64, _) = (readings[torch.float32],
                                        readings[torch.float64])
        bound32 = 3 * max(self32, 1e-4) if variant == "NeRF-W" else 1e-4
        print(f"check vanilla toy ({variant}) cuda vs cpu over {n} leaves: "
              f"fp32 loss rel {l32:.2e} (bound 1e-05), gradients "
              f"{g32:.2e} of the leaf's max (bound {bound32:.2e}; the CPU "
              f"against itself with the origins moved by 1e-7: "
              f"{self32:.2e}); fp64 loss rel {l64:.2e} (bound 1e-05), "
              f"gradients {g64:.2e} (bound 1e-04)", flush=True)
        check(l32 <= 1e-5 and l64 <= 1e-5,
              f"toy vanilla loss differs ({variant})")
        check(g32 <= bound32 and g64 <= 1e-4,
              f"toy vanilla gradients differ ({variant})")


def vanilla_step_flops(cfg_path: str) -> float:
    """The GEMM operations of one train step of the vanilla yaml at
    `cfg_path`, counting the products autograd runs: PointMLP's
    multiply-adds a sample (the trunk's skip widens the layer after it)
    x 2 x the coarse and the fine pass's samples for the forward, once
    more for the weight gradients and once more for the input gradients
    but those of each trunk's first layer (its encoding carries none)."""
    from nerf_hugs_torch.configs import config as cfg
    from nerf_hugs_torch.train import driver
    config = driver.load_config(cfg_path, "", "")
    nc = config.nerfacto
    c = cfg.MLPConfig(net_depth=nc.net_depth, net_width=nc.net_width,
                      min_deg_point=nc.min_deg_point,
                      max_deg_point=nc.max_deg_point, deg_view=nc.deg_view)
    first = 3 + 6 * (c.max_deg_point - c.min_deg_point)
    macs, d = 0, first
    for i in range(c.net_depth):
        macs += d * c.net_width
        d = c.net_width + (first if i % c.skip_layer == 0 and i > 0 else 0)
    macs += d * (1 + c.bottleneck_width)
    view = c.bottleneck_width + 3 + 6 * c.deg_view
    for i in range(c.net_depth_viewdirs):
        macs += view * c.net_width_viewdirs
        view = c.net_width_viewdirs
    macs += view * c.num_rgb_channels
    coarse = nc.num_coarse_nerf_samples_per_ray
    samples = config.batch_size * (coarse + coarse
                                   + nc.num_fine_nerf_samples_per_ray)
    return 2 * samples * (3 * macs - first * c.net_width)


def vanilla_phase(torch, tmp: str, scene: str, phototourism: str, dev):
    """Phase 15: vanilla NeRF (15a the toy model card vs CPU; 15b-c the
    shipped yamls at full width through the drivers)."""
    from nerf_hugs_torch.tools.hashgrid_inputs import shipped_yaml
    vanilla_small_phase(torch, tmp, dev)
    exp = lambda name: os.path.join(tmp, "exp", f"nerf_{name}")
    base = shipped_yaml(tmp, "kubric_nerf_base")
    _, _, reading = mip_train(torch, base, scene, exp("base"),
                              "vanilla kubric_nerf_base", 8, profile=True)
    eval_phase(torch, base, scene, exp("base"), "vanilla kubric_nerf_base",
               NOT_ANY, score=False)
    flops = vanilla_step_flops(base)
    print(f"vanilla kubric_nerf_base: {reading['steps_per_s']:.3f} steps/s, "
          f"device {reading['device_ms']:.3f} ms per step, busy "
          f"{reading['busy']:.3f}, peak {reading['peak_gib']:.2f} GiB, "
          f"GEMMs {flops / 1e12:.3f} TFLOP in "
          f"{reading['split']['gemm']:.3f} ms "
          f"({flops / reading['split']['gemm'] / 1e9:.1f} TFLOP/s)",
          flush=True)
    _, terms, _ = mip_train(torch, shipped_yaml(tmp, "kubric_nerf_hanerf",
                                                steps=4),
                            scene, exp("hanerf"), "vanilla kubric_nerf_hanerf",
                            4)
    check(all(float(t["mask_size"]) > 0 for t in terms["train"]),
          f"the HA-NeRF steps have no mask_size term: {terms}")
    nerfw = shipped_yaml(tmp, "phototourism_nerf_nerfw", steps=4,
                         finetune_num_steps=2)
    _, terms, _ = mip_train(torch, nerfw, phototourism, exp("nerfw"),
                            "vanilla phototourism_nerf_nerfw", 4,
                            finetune_steps=2)
    check(all(math.isfinite(float(t[k])) for t in terms["train"]
              for k in ("beta", "density")),
          f"the NeRF-W steps lack finite beta/density terms: {terms}")
    before = torch.load(os.path.join(exp("nerfw"), "checkpoint_4.pt"),
                        weights_only=True)["model"]
    after = torch.load(os.path.join(exp("nerfw"), "finetune",
                                    "checkpoint_2.pt"),
                       weights_only=True)["model"]
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    print(f"finetune (vanilla NeRF-W): 2 steps, losses "
          f"{[t['data'] for t in terms['finetune']]}; moved {moved} of "
          f"{len(before)} tensors", flush=True)
    check(moved == ["appearance_embedding.weight"],
          f"the finetune stage moved {moved}, not appearance_embedding")


def render_phase(torch, cfg, data_dir: str, save_dir: str, tag: str,
                 expected, out_name: str, frames, base: dict = None):
    """The render driver over a run's newest checkpoint, with the
    base-section keys `base` (a yaml) or gin bindings (a list) on top of
    `cfg`; checks that it wrote the colour, acc and distance files of
    `frames` into render/`out_name` (or render_dir), that the forward
    kernels of `expected` launched and no other ported kernel did.
    Returns (the output directory, the seconds each frame took, its
    stdout)."""
    import contextlib
    import io

    import yaml
    from nerf_hugs_torch.render import main as render_main
    if isinstance(cfg, str):
        with open(cfg) as f:
            raw = yaml.safe_load(f)
        raw["base"].update(base or {})
        cfg = os.path.join(os.path.dirname(cfg), f"render_{tag}.yml".replace(
            " ", "_").replace(",", ""))
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
        out_dir = (base or {}).get("render_dir") or os.path.join(save_dir,
                                                                 "render")
    else:
        cfg = cfg + [f"--gin_bindings={b}" for b in base or []]
        out_dir = os.path.join(save_dir, "render")
    out_dir = os.path.join(out_dir, out_name)
    reset_launches()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        render_main(config_args(cfg, data_dir, save_dir))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    log = buf.getvalue()
    check(all(launches[k] > 0 for k in expected),
          f"render ({tag}) did not run through the kernels: {launches}")
    check(all(launches[k] == 0 for k in read_launches()
              if k not in expected),
          f"render ({tag}) launched a kernel off its path: {launches}")
    seconds = [float(t) for t in re.findall(r"Rendered in (\S+)s", log)]
    for i in frames:
        for kind in ("color", "acc", "distance_mean", "distance_median"):
            ext = "png" if kind == "color" else "tiff"
            check(os.path.exists(os.path.join(out_dir, f"{kind}_{i:03d}."
                                                       f"{ext}")),
                  f"render ({tag}) wrote no {kind} of frame {i}")
    colours = sorted(f for f in os.listdir(out_dir) if f.startswith("color_"))
    height, width = png_shape(os.path.join(out_dir, colours[0]))
    print(f"render ({tag}): {len(seconds)} frames of {width}x{height} in "
          f"{wall:.1f} s, {colours}; seconds per frame {seconds}; launches "
          f"{launches}", flush=True)
    return out_dir, seconds, log


def at_max_steps(cfg_path: str, steps: int) -> str:
    """A copy of the yaml at `cfg_path` with num_steps (max_steps) set to
    `steps`, beside it: the eval driver then evaluates a checkpoint of that
    step at train_frac 1.0, where the render driver renders every frame."""
    import yaml
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["base"]["num_steps"] = steps
    path = cfg_path.replace(".yml", f"_max{steps}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def render_phases(torch, dense_cfg, scene: str, dense_dir: str,
                  fused_cfg, fused_tmp: str, fused_dir: str) -> None:
    """Phase 16: the render driver over phase 7's and phase 8's
    checkpoints. Their frames are held against the eval driver's images
    with max_steps set to the checkpoints' 8 steps, so that both render at
    train_frac 1.0."""
    dense_end = at_max_steps(dense_cfg, 8)
    eval_phase(torch, dense_end, scene, dense_dir, "Dense MLPs, kubric",
               DENSE, score=False)
    out, _, _ = render_phase(torch, dense_end, scene, dense_dir,
                             "Dense kubric test split", ("hashgrid_fwd",),
                             "test_preds_step_8", range(4))
    for i in range(2):
        same = (png_pixels(os.path.join(out, f"color_{i:03d}.png")) ==
                png_pixels(os.path.join(dense_dir, "test_preds",
                                        f"{i:03d}_color.png"))).all()
        check(bool(same), f"render frame {i} differs from the eval's image")
    print("render (Dense kubric): frames 0 and 1 equal the eval driver's "
          "colour PNGs bit for bit", flush=True)
    sharded = os.path.join(dense_dir, "sharded")
    keys = {"render_num_jobs": 2, "render_job_id": 1,
            "render_dir": sharded}
    render_phase(torch, dense_cfg, scene, dense_dir, "job 1 of 2",
                 ("hashgrid_fwd",), "test_preds_step_8", (1, 3), keys)
    _, seconds, log = render_phase(torch, dense_cfg, scene, dense_dir,
                                   "job 1 of 2 rerun", ("hashgrid_fwd",),
                                   "test_preds_step_8", (1, 3), keys)
    written = sorted(os.listdir(os.path.join(sharded, "test_preds_step_8")))
    check([f for f in written if f.startswith("color_")]
          == ["color_001.png", "color_003.png"],
          f"job 1 of 2 wrote {written}")
    check("Image 1/4 already exists, skipping" in log and len(seconds) == 1,
          "the rerun of job 1 did not skip frame 1")
    render_phase(torch, dense_cfg, scene, dense_dir, "ellipse path",
                 ("hashgrid_fwd",), "path_renders_step_8", range(3),
                 {"render_path": True, "render_path_frames": 3})
    fused_end = at_max_steps(fused_cfg, 8)
    eval_phase(torch, fused_end, fused_tmp, fused_dir, "fused MLPs", FUSED,
               score=False)
    out, _, _ = render_phase(torch, fused_end, fused_tmp, fused_dir,
                             "fused bf16, job 0 of 16",
                             ("hashgrid_fwd", "fused_mlp_fwd",
                              "fused_mlp_fwd_resident"),
                             "test_preds_step_8", (0, 16),
                             {"render_num_jobs": 16, "render_job_id": 0})
    check(bool((png_pixels(os.path.join(out, "color_000.png")) ==
                png_pixels(os.path.join(fused_dir, "test_preds",
                                        "000_color.png"))).all()),
          "the fused render of frame 0 differs from the eval's image")
    print("render (fused bf16): frame 0 equals the eval driver's colour PNG "
          "bit for bit", flush=True)


def llff_blender_phase(torch, tmp: str):
    """Phase 17: llff (forward-facing through NDC, and 360) and blender
    scenes, 4 steps and an eval of 1 image of each shipped gin, and the
    render driver's spiral over the llff_256 run."""
    from nerf_hugs_torch.tools.hashgrid_inputs import (write_blender_scene,
                                                       write_llff_scene)
    t0 = time.time()
    scenes = {"llff_256": write_llff_scene(os.path.join(tmp, "llff"), True),
              "360": write_llff_scene(os.path.join(tmp, "llff_360"), False),
              "blender_256": write_blender_scene(os.path.join(tmp,
                                                              "blender"))}
    print(f"scenes: llff forward-facing and 360 (20 frames of 1008x756 in "
          f"images_4/ each) and blender (8 + 2 frames of 800x800) written "
          f"in {time.time() - t0:.1f} s", flush=True)
    readings = {}
    for name, data_dir in scenes.items():
        flags = gin_flags(name, 4, "Config.eval_dataset_limit = 1")
        save_dir = os.path.join(tmp, "exp", f"mip_{name}")
        _, _, readings[name] = mip_train(torch, flags, data_dir, save_dir,
                                         f"Mip-NeRF 360 {name}", 4)
        # 4 steps from random weights: a mean SSIM below 0, within its
        # range [-1, 1], is a possible reading.
        eval_phase(torch, flags, data_dir, save_dir, name, NOT_ANY,
                   score=False, summary="metrics_test_4.txt", images=1,
                   ssim_min=-1.0)
    spiral = gin_flags("llff_256", 4) + [
        "--gin_configs=" + os.path.join(HERE, "configs", "mipnerf360",
                                        "render_config.gin")]
    render_phase(torch, spiral, scenes["llff_256"],
                 os.path.join(tmp, "exp", "mip_llff_256"), "llff spiral",
                 NOT_ANY, "path_renders_step_4", range(3),
                 ["Config.render_path_frames = 3"])
    print("llff / blender: " + "; ".join(
        f"{name} {r['steps_per_s']:.3f} steps/s, peak {r['peak_gib']:.2f} "
        f"GiB" for name, r in readings.items()), flush=True)


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
        mip_phase(torch, tmp, scene, distractor, phototourism, dev)
        vanilla_phase(torch, tmp, scene, phototourism, dev)
        render_phases(torch, dense_cfg, scene,
                      os.path.join(tmp, "exp", "dense"), fused_cfg, tmp,
                      fused_dir)
        llff_blender_phase(torch, tmp)
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
