#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (nerf_hugs_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --transient NAME [--log PATH]
    python3 chip_smoke.py --vanilla NAME [--log PATH]

The second form trains one of the JAX package's distractor runs
(TRANSIENT_RUNS, NAME one of hanerf, nerfw_strongreg, base, nerfw: 3000
fp32 steps of a distractor_1024_glo4 gin on the quality tool's
distractor scene, about 40 minutes on an H100), writes the tool's whole
output to PATH and gates its held-out quality against JAX's; the third
trains one of VANILLA_RUNS (base, hanerf, base_distractor: 3000 fp32
steps of kubric_nerf_base.yml or kubric_nerf_hanerf.yml on the tool's
scene, the distractor scene for the last two) and records its held-out
quality, which JAX has no target for. The first form never runs them.

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
  4b. the integrated-positional-encoding kernels (ops/ipe.py) against
     their plain versions: the forward bit for bit, the gradient within
     1e-5 of its largest entry (against the closed form and autograd),
     at every (basis, degrees) of configs/mipnerf360/*.gin on a ragged
     4099 rows with arguments around the 100 pi cap, inf and NaN, and at
     mip360_bf16.train's shapes ([1048576, 21] and [524288, 21], 12
     degrees) in bf16 and fp32, then the median of 10 timed runs of each;
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
     around the run; then its tensorboard file tb_train (a print event
     every step, the in-train eval at step 8) read back by this script's
     own decoder (the record framing and both CRC-32Cs, then the Event
     protobufs): every tag of train.py's summaries at its steps, the loss
     terms those of the run log, finite values, with the host ms the
     summaries add to a print event and to the render event;
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
  14. Mip-NeRF 360 (no ported kernel runs on its path, each run must
     launch none, but the encoding's of phase 4b: the phase's runs must
     launch its forward, and its gradient never, since every shipped gin
     stops the levels' gradient): (a) the toy model of tests/test_torch_port_mipnerf360.py
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
     ms and the busy share), its tb_train read back as in phase 7, the ray
     strips of its render event among the images (2048 x 1983: 16 rays of
     3 levels), then an eval of 2 test images and the scoring CLI, then
     max_dilate_weights and the lift + IPE alone at its shapes;
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
     window over steps 5-7, the model the train driver built on the card
     holding init_vanilla_'s CPU draw of JAX's initial weights (bit for
     bit, embeddings within 1e-6), then an eval of 2 images; (c) 4 steps of kubric_nerf_hanerf.yml
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
     render_path_frames 3);
  18. the import of released checkpoints: for kubric_nerfacto_base.yml and
     kubric_nerf_base.yml at full width, a torch snapshot in the released
     layout (tcnn flat grids in fp16, torch Linears, state.global_step at
     the config's last step) made from a seeded numpy generator
     (tools/released_snapshots.py), converted by `python -m
     nerf_hugs_torch.tools.convert_reference_checkpoint` on the card
     (seconds and peak device memory printed), then the eval (1 image:
     the hash-grid forward must launch for nerfacto, no kernel for
     vanilla) and render (1 frame) drivers on the output directory with
     the config.yml it emitted (legacy_cumulative_deltas); test image 0 of
     the converted checkpoint equals, bit for bit, the rendering of the
     model loaded straight from the same flax tree through from_jax, and
     so do the eval's and the render's colour PNGs.
  19. multi-process data parallelism (nerf_hugs_torch/parallel/mesh.py),
     each rank a process of this script (`--rank ...`) started with
     torchrun's environment and a timeout: (a) phase 5's small Dense model
     as 2 gloo ranks on the one card (CUDA_VISIBLE_DEVICES=0, LOCAL_RANK 0
     each), 3 steps on the two halves of 3 seeded global batches: both
     ranks' parameters bit-equal, and the losses within phase 5's 1e-5
     (relative) and the first step's averaged gradients within its 1e-4
     of each leaf's largest entry of one process stepping the whole batches
     on the card; (b) `python -m nerf_hugs_torch.train` as 2 gloo ranks
     on kubric_nerfacto_base.yml at full width on phase 7's scene, 4 steps
     (a correctness run: the 256 MiB field-table gradient crosses the host
     every step), each rank's hash-grid forward and backward launched, one
     checkpoint directory with one config.gin, one run_log.log and one
     events file, the gradient all-reduce's synchronised host ms a step
     and, on rank 0, the profiler's device ms under it; then the eval of 2
     images as 2 ranks, its PSNR within 1e-3 dB of a one-process eval of
     the same checkpoint; (c) the same 4 steps as a world of one over nccl
     against two runs without a group (those two at once on the card):
     the first step's averaged
     gradients (after the flat all-reduce's cat and split) within phase
     5's 1e-4 of each leaf's largest entry of the first run's, leaf for
     leaf, and 2 nccl ranks on one card refused with the port's message; (d) with two or
     more cards, (a) over nccl on cards 0 and 1, else a line saying it was
     not run.
  20. the quality gate: `python -m nerf_hugs_torch.tools.validate_quality
     --config ... --device cuda` trains (a) kubric_nerfacto_base.yml for
     1000 steps and (b) kubric_nerfacto_tpu.yml for 3000 steps on the
     procedural sphere world (the tool's scene: 32 images of 192x256,
     96x128 at the configs' factor 2, world scale 0.35) and scores the
     held-out test split (nerfacto starts from the JAX package's initial
     weights, models/jax_init.py), each in a process of this script
     (`--quality`) that runs the tool's module as `python -m` does, with
     the launch counters read around every train step and around the
     whole run: the
     held-out PSNR at least JAX's (PARITY.md:278, :284-285) less 1.0 dB
     and the SSIM at least JAX's less 0.01, hashgrid_fwd and hashgrid_bwd
     launched in every train step, no fused-MLP kernel launched; printed:
     the in-train eval curve, steps/s, the training wall and peak memory
     (the tool's TIMING line), the launches per step and, for (b), the
     device ms per step and the busy share of 5 profiled steps.
  21. the sweep of every shipped config that no earlier phase runs: the
     phase of each file under configs/{nerfacto,mipnerf360,hugs}/ is in
     SHIPPED_RUNS (phase 21's own entries are SWEEP's and REFUSED's), and
     a file it lacks fails the script. Each config of
     SWEEP trains 3 steps through `nerf_hugs_torch.train.main` at its
     published widths on the capture its own loader reads (phase 7's
     kubric scene, phase 10's distractor and phase 12's phototourism
     captures, phase 17's llff, 360 and blender scenes), only the cadence
     and directory keys changed, with 2 finetune steps where the config
     has the stage, then `nerf_hugs_torch.eval.main` of 1 test image (of
     the finetune checkpoint where there is one) with the in-train eval
     off, or, for the runs of SWEEP_COVERED (whose eval path another run
     covers; a cut for the script's time limit), the train driver's
     in-train eval of the last step alone, and is deleted; the launch counters are
     read around every train step and the eval: a
     nerfacto train step launches hashgrid_fwd and hashgrid_bwd (HA-NeRF
     the d = 2 kernels too), a finetune step no hashgrid_bwd, a Mip-NeRF
     360 run none but the encoding's, a vanilla run no kernel, no run a
     fused-MLP kernel; every loss
     and loss term finite, the eval's PNG and finite PSNR (in-train: its
     finite PSNR); a withmask run's
     train split has a mean static mask below 1, a RobustNeRF run's carried
     thresholds are finite and move after step 1, a finetune stage moves
     the appearance or GLO embedding alone (every other tensor bit-equal);
     printed per run: steps/s over steps 2-3, peak device memory (reset
     before the run, the cache emptied after it), eval seconds an image
     and the launches of each step. The configs of REFUSED raise the
     port's error through the train driver with nothing launched or
     written; phase 15c's kubric_nerf_hanerf and phototourism_nerf_nerfw
     runs get an eval of 1 image each;
  22. a released-asset drop at full width, written from seeded
     generators into the temporary directory: a torch snapshot of
     kubric_nerfacto_base in the released layout (ckpt_8.pth), a flax
     msgpack TrainState of kubric_1024_withmask (NerfMLP 8 x 1024,
     utils/flax_msgpack.py::msgpack_serialize), "released" renders of
     both from the same weights loaded straight through models/from_jax.py
     and rendered by the port, an AlexNet-LPIPS and a SAM vit_b .pth in
     the official key schemas and phase 7's capture as data/scene0; then
     `python -m nerf_hugs_torch.tools.validate_released_assets` in-process
     on the card with a --config_map (2 test images a pair): 2 rows
     without an error, LPIPS in the released scores, finite scores of
     ours, ours against the released renders above 45 dB in both, the
     nerfacto eval through hashgrid_fwd and the Mip-NeRF 360 eval through
     no kernel, both pairs in PAPER_COMPARISON.{md,json}; printed: each
     pair's conversion and eval seconds and peak device memory.
  23. the NeRF-W collapse diagnosis on phase 14e's checkpoint of
     distractor_1024_glo4_nerfw: `python -m
     nerf_hugs_torch.tools.diagnose_nerfw_collapse --views 1` under the
     tool's bindings (the quality tool's distractor scene at factor 2), in
     a process of this script (`--diagnose`) that keeps the view's numbers
     at full precision: one view line that parses, every number finite,
     static_acc in [0, 1], beta_mean at least beta_min, the printed line
     the record's, and its static-only PSNR within 1e-4 dB of the PSNR
     (float64) of the same train view rendered here through the eval
     path; printed: the line, both PSNRs and the phase's seconds.
The captures of phases 5-23 are written by processes of this script
(`--captures ROOT GROUP`) started after phases 1-4, whose timings make
the kernels line, one a capture group: the kubric scene, the distractor
and the phototourism captures beside phase 5, the llff and blender
captures beside phases 5-16. Before the kernels line, every config that
SHIPPED_RUNS names must have been handed to a driver (the train, eval,
render or HuGS driver, or the quality tool) in the phase it names.
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

import concurrent.futures
import contextlib
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
    from nerf_hugs_torch.utils import trace
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    fwd = fused_mlp.fused_mlp_fwd
    before = trace.counters()
    out_k = fwd(x, ws)
    out_p = fused_mlp.fused_mlp_plain(x, ws)
    torch.cuda.synchronize()
    check(out_k.shape == out_p.shape == (x.shape[0], dims[-1])
          and out_k.dtype == x.dtype,
          f"fused_mlp_fwd gave {tuple(out_k.shape)} {out_k.dtype} ({label})")
    n = launches_between(before, trace.counters())
    got = (n["fused_mlp_fwd_resident"], n["fused_mlp_fwd_streamed"],
           n["fused_mlp_fwd_f32"])
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


# Phase 4b: the encoding kernels of ops/ipe.py. The mip360_bf16.train cell
# encodes 16384 rays a step: 64 samples a ray at each proposal level, 32 at
# the NeRF level, lifted onto icosahedron/2 (d = 21) at 12 degrees; every
# (basis, degrees) of the Mip-NeRF 360 gins is checked besides on a ragged
# n, with arguments around the range-reduction cap and not finite.
IPE_ROWS = (16384 * 64, 16384 * 32)
IPE_BASIS, IPE_DEGREES = ("icosahedron", 2), (0, 12)
IPE_EDGES = ((("icosahedron", 2), 0, 12), (("icosahedron", 2), 0, 16),
             (("octahedron", 1), 0, 16))
IPE_EDGE_N = 4099
# The gradient against the plain closed form and against autograd through
# the eager composition, relative to its largest entry (fp32 sums in
# another order).
IPE_GRAD_RTOL = 1e-5


def ipe_inputs(torch, n, basis_key, gen, dev, lo=0, hi=12, specials=False):
    """Lifted means and variances [n, d] on the card: points uniform in
    [-4, 4]^3 with covariances A A^T (A ~ 0.05 N(0, 1)) through the basis;
    with `specials`, the first means set to +-100 pi / 2^l, l in [lo, hi),
    and their neighbours, large, zero, infinite and NaN, and three
    variances to inf, NaN and 0."""
    import numpy as np
    from nerf_hugs_torch.core import coord, geopoly
    basis = torch.tensor(np.ascontiguousarray(
        geopoly.generate_basis(*basis_key).T), dtype=torch.float32,
        device=dev)
    pts = torch.rand(n, 3, generator=gen, device=dev) * 8 - 4
    a = torch.randn(n, 3, 3, generator=gen, device=dev) * 0.05
    mean, var = coord.lift_and_diagonalize(pts, a @ a.transpose(-1, -2),
                                           basis)
    mean, var = mean.contiguous(), var.contiguous()
    if specials:
        cap = np.float32(100 * math.pi)
        vals = []
        for deg in range(lo, hi):
            at = np.float32(cap / np.float32(2.0 ** deg))
            for x in (at, np.nextafter(at, np.float32(0)),
                      np.nextafter(at, np.float32(np.inf))):
                vals += [x, -x]
        vals += [1e6, -7.7e3, 3e30, 0.0, -0.0, np.inf, -np.inf, np.nan]
        mean.view(-1)[:len(vals)] = torch.tensor(
            np.array(vals, np.float32), device=dev)
        var.view(-1)[-3:] = torch.tensor([np.inf, np.nan, 0.0], device=dev)
    return mean, var


def ipe_fwd_error(torch, got, want):
    """(equal bit for bit, NaN matching NaN; largest |got - want| where
    both are finite)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    same = bool(torch.equal(nan_g, nan_w) and torch.equal(
        got.masked_fill(nan_g, 0).view(ints),
        want.masked_fill(nan_w, 0).view(ints)))
    both = torch.isfinite(got) & torch.isfinite(want)
    diff = (got.float() - want.float()).abs()[both]
    return same, float(diff.max()) if diff.numel() else 0.0


def ipe_grad_error(pairs) -> float:
    """The largest |got - want| over the largest |want|, over (got, want)
    pairs."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in pairs)


def ipe_phase(torch, dev):
    """Phase 4b: the encoding's forward kernel against its plain version
    (the eager composition and cast) bit for bit, and its gradient kernel
    within IPE_GRAD_RTOL of the plain closed form and of autograd, on
    IPE_EDGES and at the cell's shapes; then, at the cell's shapes, the
    median of 10 timed runs of each beside its plain version, the kernel
    alone from a profiler trace and its bound (bytes over the memory
    rate). Returns the worst errors and the timings by (rows, dtype)."""
    from nerf_hugs_torch.core import coord
    from nerf_hugs_torch.ops import ipe
    gen = torch.Generator(device=dev)
    gen.manual_seed(2300)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for basis_key, lo, hi in IPE_EDGES:
        mean, var = ipe_inputs(torch, IPE_EDGE_N, basis_key, gen, dev, lo,
                               hi, specials=True)
        for dtype in (torch.float32, torch.bfloat16):
            same, err = ipe_fwd_error(
                torch, ipe.ipe_fwd(mean, var, lo, hi, dtype),
                ipe.integrated_pos_enc_plain(mean, var, lo, hi, dtype))
            check(same, f"ipe_fwd differs from its plain version at "
                        f"{basis_key}, degrees [{lo}, {hi}), {dtype}, "
                        f"ragged n with the cap's edges: max_abs {err}")
            worst["fwd"] = max(worst["fwd"], err)
        print(f"check ipe_fwd, {IPE_EDGE_N} rows of {basis_key} at degrees "
              f"[{lo}, {hi}) with the cap's edges, inf and NaN: bit for bit "
              f"in float32 and bfloat16", flush=True)
    lo, hi = IPE_DEGREES
    timings = {}
    for n in IPE_ROWS:
        mean, var = ipe_inputs(torch, n, IPE_BASIS, gen, dev)
        for dtype in (torch.bfloat16, torch.float32):
            fwd = lambda: ipe.ipe_fwd(mean, var, lo, hi, dtype)
            plain = lambda: ipe.integrated_pos_enc_plain(mean, var, lo, hi,
                                                         dtype)
            out = fwd()
            same, err = ipe_fwd_error(torch, out, plain())
            check(same, f"ipe_fwd differs from its plain version at {n} "
                        f"rows, {dtype}: max_abs {err}")
            g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            bwd = lambda: ipe.ipe_bwd(mean, var, g, lo, hi)
            got = bwd()
            m = mean.clone().requires_grad_(True)
            v = var.clone().requires_grad_(True)
            coord.integrated_pos_enc(m, v, lo, hi).to(dtype).backward(g)
            closed = ipe.integrated_pos_enc_grad_plain(mean, var, g, lo, hi)
            rel = ipe_grad_error(zip(got, closed))
            rel_auto = ipe_grad_error(zip(got, (m.grad, v.grad)))
            del m, v
            check(max(rel, rel_auto) <= IPE_GRAD_RTOL,
                  f"ipe_bwd at {n} rows, {dtype}: {rel} against the closed "
                  f"form, {rel_auto} against autograd")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], rel, rel_auto)
            name = str(dtype).split(".")[-1]
            t = {"fwd": median_ms(fwd), "fwd_plain": median_ms(plain),
                 "fwd_alone": device_ms(torch, fwd, "ipe_fwd_kernel"),
                 "bwd": median_ms(bwd),
                 "bwd_plain": median_ms(
                     lambda: ipe.integrated_pos_enc_grad_plain(
                         mean, var, g, lo, hi)),
                 "bwd_alone": device_ms(torch, bwd, "ipe_bwd_kernel")}
            fwd_bytes = nbytes(mean, var, out)
            bwd_bytes = nbytes(mean, var, g, *got)
            t["fwd_bound_ms"], t["fwd_bound_by"] = bound(fwd_bytes, 0)
            t["bwd_bound_ms"], t["bwd_bound_by"] = bound(bwd_bytes, 0)
            timings[(n, name)] = t
            print(f"check ipe, {n} rows x {mean.shape[1]}, degrees [{lo}, "
                  f"{hi}), {name}: forward bit for bit (max_abs {err:.3e}); "
                  f"kernel {t['fwd']:.4f} ms (alone {_ms(t['fwd_alone'])}), "
                  f"plain {t['fwd_plain']:.4f} ms, bound "
                  f"{t['fwd_bound_ms']:.4f} ms ({fwd_bytes / 1e6:.1f} MB); "
                  f"gradient rel {rel:.3e} (closed form), {rel_auto:.3e} "
                  f"(autograd), kernel {t['bwd']:.4f} ms (alone "
                  f"{_ms(t['bwd_alone'])}), plain {t['bwd_plain']:.4f} ms, "
                  f"bound {t['bwd_bound_ms']:.4f} ms "
                  f"({bwd_bytes / 1e6:.1f} MB)", flush=True)
            del out, g, got, closed
        del mean, var
        torch.cuda.empty_cache()
    return worst, timings


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


# {kernel: its launch counter in nerf_hugs_torch.utils.trace}: the hash-grid
# wrappers count their d = 3 and d = 2 kernels apart. The encoding kernels of
# ops/ipe.py, which every Mip-NeRF 360 run launches, are read apart (phases
# 4b and 14).
LAUNCH_COUNTERS = {
    "hashgrid_fwd": "hashgrid_fwd.launches",
    "hashgrid_bwd": "hashgrid_bwd.launches",
    "fused_mlp_fwd": "fused_mlp_fwd.launches",
    "fused_mlp_fwd_resident": "fused_mlp_fwd.launches_resident",
    "fused_mlp_fwd_streamed": "fused_mlp_fwd.launches_streamed",
    "fused_mlp_fwd_f32": "fused_mlp_fwd.launches_f32",
    "planar_accum": "planar_accum.launches",
    "hashgrid_fwd_2d": "hashgrid_fwd.launches_2d",
    "hashgrid_bwd_2d": "hashgrid_bwd.launches_2d"}
# The counters at the last reset_launches.
_launches_at_reset = {}


def reset_launches() -> None:
    from nerf_hugs_torch.utils import trace
    _launches_at_reset.clear()
    _launches_at_reset.update(trace.counters())


def launches_between(before: dict, after: dict) -> dict:
    """{kernel: its launches} between two snapshots of the counters."""
    return {k: after.get(c, 0) - before.get(c, 0)
            for k, c in LAUNCH_COUNTERS.items()}


def read_launches() -> dict:
    """{kernel: its launches since the last reset_launches}."""
    from nerf_hugs_torch.utils import trace
    return launches_between(_launches_at_reset, trace.counters())


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


# The shipped configs handed to a driver, as [configs/ path, the phases
# of main's done() that ran it]: check_driven holds SHIPPED_RUNS to it.
DRIVEN = []
# A yaml copy written for a run -> the shipped file it copies.
COPIES = {}


def shipped_yaml(tmp: str, name: str, *args, **kwargs) -> str:
    """hashgrid_inputs.shipped_yaml, remembering the copy's shipped file."""
    from nerf_hugs_torch.tools import hashgrid_inputs
    path = hashgrid_inputs.shipped_yaml(tmp, name, *args, **kwargs)
    COPIES[path] = f"configs/nerfacto/{name}.yml"
    return path


def driven(argv: list) -> list:
    """Records in DRIVEN each config of the driver flags `argv` (--config
    and --gin_configs, or their copies); returns `argv`."""
    for flag, value in zip(argv, argv[1:] + [None]):
        path = (value if flag == "--config" else flag.split("=", 1)[1]
                if flag.startswith("--gin_configs=") else None)
        if path is not None:
            path = COPIES.get(path, path)
            DRIVEN.append([os.path.relpath(os.path.join(HERE, path), HERE),
                           None])
    return argv


def config_args(cfg, data_dir: str, save_dir: str) -> list:
    """The drivers' flags on the card: `cfg` is a yaml path (--config
    --data_dir --save_dir) or a list of gin flags (--gin_configs and
    --gin_bindings), to which the directories are bound."""
    if isinstance(cfg, str):
        return driven(["--config", cfg, "--data_dir", data_dir,
                       "--save_dir", save_dir, "--device", "cuda"])
    return driven(cfg + [f"--gin_bindings=Config.data_dir = '{data_dir}'",
                         f"--gin_bindings=Config.checkpoint_dir = "
                         f"'{save_dir}'", "--device", "cuda"])


def train_phase(torch, cfg_path, data_dir: str, save_dir: str,
                tag: str, expected, finetune_steps: int = 0,
                num_steps: int = 8, in_train_eval: bool = True):
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
    patched = {name: getattr(driver, name) for name in
               ("run_stage", "train_summaries", "render_summaries")}
    summary_ms = SUMMARY_MS[save_dir] = {"train": [], "render": []}

    def counted_stage(stage, *args):
        reset_launches()
        patched["run_stage"](stage, *args)
        torch.cuda.synchronize()
        launches[stage] = read_launches()

    def timed(kind):
        # The host time a print or render event spends on its summaries
        # (render: the vis suite on the card, its one copy to the host and
        # the PNG writes).
        def call(*args):
            t = time.perf_counter()
            patched[f"{kind}_summaries"](*args)
            summary_ms[kind].append((time.perf_counter() - t) * 1e3)
        return call

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    driver.run_stage = counted_stage
    driver.train_summaries = timed("train")
    driver.render_summaries = timed("render")
    try:
        train_main(config_args(cfg_path, data_dir, save_dir))
    finally:
        for name, fn in patched.items():
            setattr(driver, name, fn)
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
    check(len(evals) == in_train_eval and all(
        math.isfinite(float(v)) for v in evals),
          f"in-train eval PSNRs {evals}, expected {int(in_train_eval)}")
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
          f"{terms['train'][-1]}; eval psnr "
          f"{evals[0] if evals else 'not run'}; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {train}", flush=True)
    return launches, terms


# Tensorboard summaries (phases 7 and 14): what the train driver writes to
# {save_dir}/tb_train, read back by this script's own decoder.
SUMMARY_MS = {}            # {save_dir: {"train"|"render": [host ms]}}
TRAIN_SCALARS = ("train_loss", "train_psnr", "train_steps_per_sec",
                 "train_rays_per_sec", "learning_rate")
TRAIN_HISTOGRAMS = ("train_loss_hist", "train_psnr_hist")
RENDER_IMAGES = ("color", "acc", "color_matte", "depth_mean", "depth_median",
                 "depth_triplet", "coords_mod")


def _crc32c_table() -> list:
    table = []
    for n in range(256):
        for _ in range(8):
            n = (n >> 1) ^ 0x82F63B78 if n & 1 else n >> 1
        table.append(n)
    return table


CRC32C_TABLE = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


def proto_fields(buf: bytes) -> dict:
    """{field number: [values]} of one protobuf message: ints for varints,
    bytes for 64-bit and length-delimited fields."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            fail(f"protobuf wire type {wire} in a summary")
        out.setdefault(field, []).append(value)
    return out


def _varint(buf: bytes, i: int):
    value, shift = 0, 0
    while True:
        b = buf[i]
        value |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if not b & 0x80:
            return value, i


def read_summaries(log_dir: str) -> dict:
    """{tag: [(step, plugin, value)]} of the one event file in `log_dir`,
    each TFRecord's length and payload CRCs checked: scalars as floats,
    histograms as [k, 3] float64 arrays, images as (width, height, PNGs)."""
    import numpy as np
    files = [f for f in os.listdir(log_dir)
             if f.startswith("events.out.tfevents.")]
    check(len(files) == 1, f"{log_dir} holds {files}")
    with open(os.path.join(log_dir, files[0]), "rb") as f:
        data = f.read()
    out, i, events = {}, 0, 0
    while i < len(data):
        length = data[i:i + 8]
        n = int.from_bytes(length, "little")
        payload = data[i + 12:i + 12 + n]
        check(int.from_bytes(data[i + 8:i + 12], "little")
              == masked_crc32c(length)
              and int.from_bytes(data[i + 12 + n:i + 16 + n], "little")
              == masked_crc32c(payload), f"a bad record CRC in {files[0]}")
        i += 16 + n
        event = proto_fields(payload)
        events += 1
        if events == 1:
            check(event.get(3) == [b"brain.Event:2"],
                  "the first record is not the file_version event")
            continue
        step = event.get(2, [0])[0]
        for value in proto_fields(event[5][0])[1]:
            value = proto_fields(value)
            tag = value[1][0].decode()
            plugin = proto_fields(proto_fields(value[9][0])[1][0])[1][0]
            tensor = proto_fields(value[8][0])
            dims = [proto_fields(d).get(1, [0])[0]
                    for d in proto_fields(tensor.get(2, [b""])[0]).get(2, [])]
            if plugin == b"images":
                strings = tensor[8]
                value = (int(strings[0]), int(strings[1]), strings[2:])
            else:
                dtype = {1: np.float32, 2: np.float64}[tensor[1][0]]
                value = np.frombuffer(tensor[4][0], dtype).reshape(dims)
            out.setdefault(tag, []).append((step, plugin.decode(), value))
    return out


def check_summaries(save_dir: str, tag: str, steps: int, terms: dict,
                    ray_strips: bool = False) -> None:
    """The tb_train file of a run of `steps` train steps printing every
    step with one in-train eval at the last: every tag of train.py's print
    events (the loss terms of the run log) at every step, the eval's
    metrics and the visualization suite's images at the last, Mip-NeRF
    360's ray strips (`ray_strips`) among them; finite values, one count a
    histogram (a buffer of one step), one PNG an image."""
    summaries = read_summaries(os.path.join(save_dir, "tb_train"))
    images = RENDER_IMAGES + (("ray_colors", "ray_weights") if ray_strips
                              else ())
    train = (TRAIN_SCALARS + TRAIN_HISTOGRAMS
             + tuple(f"train_losses/{k}" for k in terms
                     if k != "inlier_threshold"))
    want = set(train) | {"train_avg_psnr_timed", "eval_psnr", "eval_ssim"} \
        | {f"render_{k}" for k in images}
    check(set(summaries) == want, f"{tag} summaries: tags "
          f"{sorted(set(summaries) ^ want)} differ from train.py's")
    for name in train:
        check([s for s, _, _ in summaries[name]] == list(range(1, steps + 1)),
              f"{tag} summaries: {name} at steps "
              f"{[s for s, _, _ in summaries[name]]}")
    for name in want - set(train) - {"train_avg_psnr_timed"}:
        check([s for s, _, _ in summaries[name]] == [steps],
              f"{tag} summaries: {name} not at step {steps} alone")
    check(len(summaries["train_avg_psnr_timed"]) == steps,
          f"{tag} summaries: train_avg_psnr_timed written "
          f"{len(summaries['train_avg_psnr_timed'])} times")
    import numpy as np
    sizes = {}
    for name, events in summaries.items():
        for _, plugin, value in events:
            if name.startswith("render_"):
                width, height, pngs = value
                check(plugin == "images" and len(pngs) == 1
                      and pngs[0].startswith(b"\x89PNG\r\n\x1a\n"),
                      f"{tag} summaries: {name} is no PNG image")
                sizes[name[len("render_"):]] = (width, height)
            elif name.endswith("_hist"):
                check(plugin == "histograms" and value.shape == (30, 3)
                      and np.isfinite(value).all() and value[:, 2].sum() == 1,
                      f"{tag} summaries: {name} is no histogram of one step")
            else:
                check(plugin == "scalars" and value.shape == ()
                      and math.isfinite(float(value)),
                      f"{tag} summaries: {name} = {value}")
    ms = SUMMARY_MS[save_dir]
    print(f"summaries ({tag}): {len(summaries)} tags in tb_train, every "
          f"value finite, record CRCs good; images {sizes}; host ms a print "
          f"event {statistics.median(ms['train']):.3f} (median of "
          f"{len(ms['train'])}), a render event (vis suite on the card, one "
          f"copy, PNG writes) {', '.join(f'{t:.1f}' for t in ms['render'])}",
          flush=True)
    if ray_strips:
        # vis_num_rays 16 rays of 3 levels, each level's strip repeated
        # 2048 // 49 = 41 times, a blank row between rays, the last cut.
        check(sizes["ray_colors"] == sizes["ray_weights"] == (2048, 1983),
              f"{tag}: ray strips of {sizes['ray_colors']}")


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
    from nerf_hugs_torch.tools.hashgrid_inputs import write_kubric_scene
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
    eval_main(driven(["--config", gen_cfg, "--data_dir", scene,
                      "--save_dir", save_dir, "--eval_data", "train",
                      "--original_name", "--only_pred_gt", "--device",
                      "cuda"]))
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
    records = hugs_main(driven([
        "--images", preds, "--colmap", os.path.join(scene, "sparse", "0"),
        "--sam_model", "vit_h", "--output", scene, "--config", config_path,
        "--device", "cuda"]))
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
    tpu_path = os.path.join(HERE, "configs", "hugs", "kubric_tpu.yml")
    driven(["--config", tpu_path])
    with open(tpu_path) as f:
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
    """train_phase on gin flags (no ported kernel of LAUNCH_COUNTERS may
    launch); with
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
    mask), and the lift + integrated positional encoding (the kernel of
    ops/ipe.py, in fp32 as this gin computes) of the NerfMLP ([16384, 32]
    samples) and of the PropMLP ([16384, 64])."""
    from nerf_hugs_torch.core import coord, geopoly, stepfun
    from nerf_hugs_torch.ops import ipe as ipe_ops
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
        ipe[name] = median_ms(lambda: ipe_ops.integrated_pos_enc(
            *coord.lift_and_diagonalize(mean, cov, basis), 0, 12,
            torch.float32))
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
    _, terms, fp32 = mip_train(torch, base, scene, exp("base"),
                               "Mip-NeRF 360 kubric_1024_base, fp32", 8,
                               profile=True)
    check_summaries(exp("base"), "Mip-NeRF 360 kubric_1024_base", 8,
                    terms["train"][-1], ray_strips=True)
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


def initial_draw_check(torch, cfg_path: str, state: dict) -> None:
    """Phase 15b: `state`, the parameters of the model the train driver
    built on the card before its first step, equal init_vanilla_'s draw
    on the CPU: bit for bit, the embeddings (erfinv) within 1e-6."""
    from nerf_hugs_torch.models import construct_model, jax_init
    from nerf_hugs_torch.train import driver
    t0 = time.time()
    model = construct_model(driver.load_config(cfg_path, "", ""), "cpu",
                            torch.Generator().manual_seed(0))
    # Two threads: the capture writers may hold the other cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jax_init.init_vanilla_(model)
    finally:
        torch.set_num_threads(threads)
    want = model.state_dict()
    check(set(state) == set(want), f"the driver's vanilla model has "
                                   f"{sorted(state)}, not {sorted(want)}")
    got = {k: v.cpu() for k, v in state.items()}
    embeds = [k for k in want if k.endswith("_embedding.weight")]
    unequal = [k for k in want
               if k not in embeds and not torch.equal(got[k], want[k])]
    err = max((float((got[k] - want[k]).abs().max()) for k in embeds),
              default=0.0)
    print(f"vanilla kubric_nerf_base: the train driver's initial "
          f"parameters on the card ({len(want)} tensors, "
          f"{sum(v.numel() for v in want.values())} values) against "
          f"init_vanilla_ on the CPU: {len(unequal)} tensors differ, "
          f"{len(embeds)} embeddings within {err:.1e} (bound 1e-06); the "
          f"CPU draw and the comparison in {time.time() - t0:.1f} s",
          flush=True)
    check(not unequal, f"the card's vanilla draw differs from the CPU's "
                       f"in {unequal}")
    check(err <= 1e-6, f"the card's vanilla embeddings differ by {err}")


def vanilla_phase(torch, tmp: str, scene: str, phototourism: str, dev):
    """Phase 15: vanilla NeRF (15a the toy model card vs CPU; 15b-c the
    shipped yamls at full width through the drivers)."""
    from nerf_hugs_torch.train import driver
    vanilla_small_phase(torch, tmp, dev)
    exp = lambda name: os.path.join(tmp, "exp", f"nerf_{name}")
    base = shipped_yaml(tmp, "kubric_nerf_base")
    run_stage, drawn = driver.run_stage, {}

    def first_state(stage, model, *args):
        if not drawn:
            drawn.update({k: v.detach().clone()
                          for k, v in model.state_dict().items()})
        return run_stage(stage, model, *args)

    driver.run_stage = first_state
    try:
        _, _, reading = mip_train(torch, base, scene, exp("base"),
                                  "vanilla kubric_nerf_base", 8,
                                  profile=True)
    finally:
        driver.run_stage = run_stage
    initial_draw_check(torch, base, drawn)
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


def llff_blender_phase(torch, tmp: str, scenes: dict) -> None:
    """Phase 17: on the llff (forward-facing through NDC, and 360) and
    blender captures of `scenes` (by the gin that reads them), 4 steps and
    an eval of 1 image of each shipped gin, and the render driver's spiral
    over the llff_256 run."""
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


# Phase 18: released-format snapshots of these shipped yamls at full width,
# each at its config's last step (so eval and render both run at
# train_frac 1.0), with the forward kernels its eval must launch.
IMPORTS = (("kubric_nerfacto_base", ("hashgrid_fwd",)),
           ("kubric_nerf_base", ()))


def import_phase(torch, tmp: str, scene: str, dev) -> None:
    """Phase 18: each of IMPORTS as a released torch snapshot from a seeded
    generator (tools/released_snapshots.py), converted by
    `nerf_hugs_torch.tools.convert_reference_checkpoint` on the card, then
    the eval (1 image) and render (1 frame) drivers on its directory with
    the config.yml it emitted; the converted checkpoint's rendering of
    test image 0 equals, bit for bit, that of the model loaded straight
    from the same flax tree through from_jax, and so do the eval's and
    the render's PNGs."""
    import numpy as np
    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models import (construct_model, from_jax,
                                        nerfacto_import, torch_compat)
    from nerf_hugs_torch.tools import released_snapshots
    from nerf_hugs_torch.tools.convert_reference_checkpoint import (
        main as convert_main)
    from nerf_hugs_torch.train import checkpoints, driver
    from nerf_hugs_torch.train.render_image import render_image
    root = os.path.join(tmp, "import")
    os.makedirs(root)
    for seed, (name, expected) in enumerate(IMPORTS):
        cfg = shipped_yaml(root, name, eval_dataset_limit=1)
        config = driver.load_config(cfg, scene, root)
        nerfacto = config.model_type == "nerfacto"
        step = config.max_steps
        t0 = time.time()
        snapshot = (released_snapshots.nerfacto_snapshot if nerfacto else
                    released_snapshots.vanilla_snapshot)(
            construct_model(config, "cpu", torch.Generator().manual_seed(0)),
            config, seed, step)
        pth = os.path.join(root, f"{name}_{step}.pth")
        torch.save(snapshot, pth)
        made = time.time() - t0
        out = os.path.join(root, name)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        convert_main(["--reference_checkpoint", pth, "--config", cfg,
                      "--output_dir", out, "--device", dev])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - before
        emitted = os.path.join(out, "config.yml")
        with open(emitted) as f:
            check(yaml.safe_load(f)["model"]["legacy_cumulative_deltas"]
                  is True, f"{name}: config.yml lacks legacy_cumulative_"
                           f"deltas")
        print(f"import ({name}): a released-format snapshot of "
              f"{os.path.getsize(pth) / 2 ** 20:.1f} MiB written in "
              f"{made:.1f} s; converted on the card in {seconds:.2f} s, peak "
              f"device memory {peak / 2 ** 30:.3f} GiB above what was "
              f"allocated before", flush=True)
        eval_phase(torch, emitted, scene, out, f"imported {name}", expected,
                   score=False, summary=f"metrics_test_{step}.txt", images=1,
                   ssim_min=-1.0)
        render_dir, _, _ = render_phase(
            torch, emitted, scene, out, f"imported {name}", expected,
            f"test_preds_step_{step}", (0,),
            {"render_num_jobs": 4, "render_job_id": 0})

        config = driver.load_config(emitted, scene, out)
        converted = construct_model(config, dev,
                                    torch.Generator().manual_seed(1))
        check(checkpoints.restore_params(out, converted) == step,
              f"{name}: the converted checkpoint is not at step {step}")
        sd = {k: v.numpy() for k, v in snapshot["model"].items()}
        if nerfacto:
            sd = {k: v for k, v in sd.items()
                  if not k.endswith(nerfacto_import._IGNORED_SUFFIXES)}
            state = from_jax.convert_nerfacto_params(
                nerfacto_import.convert_nerfacto_state_dict(sd, config))
        else:
            state = from_jax.convert_vanilla_params(
                torch_compat.convert_nerf_model_state_dict(sd, config))
        direct = construct_model(config, dev,
                                 torch.Generator().manual_seed(2))
        direct.load_state_dict(state)
        rays = load_dataset("test", scene, config,
                            is_training=False).generate_ray_batch(0).rays
        want, got = (render_image(m, rays, 1.0, config, dev)
                     for m in (direct, converted))
        check(sorted(want) == sorted(got) and all(
            np.array_equal(want[k], got[k]) for k in want),
              f"{name}: the converted model renders other values than the "
              f"tree loaded straight")
        pixels = (np.clip(np.nan_to_num(want["rgb"]), 0, 1) * 255).astype(
            np.uint8)
        for path in (os.path.join(out, "test_preds", "000_color.png"),
                     os.path.join(render_dir, "color_000.png")):
            check(np.array_equal(png_pixels(path), pixels),
                  f"{name}: {path} is not the direct model's image")
        print(f"import ({name}): test image 0 of the converted checkpoint "
              f"equals the model loaded straight from the flax tree bit for "
              f"bit ({sorted(want)}), and so do the eval's and the render's "
              f"PNGs", flush=True)
        del converted, direct


# Phase 19: ranks of this script (`python3 chip_smoke.py --rank ...`).
MP_TIMEOUT_S = 420        # a rank that outlives it is killed
MP_TOY_STEPS = 3
MP_STEPS = 4              # 19b / 19c full-width train steps
MP_PSNR_TOL = 1e-3        # dB, 19b's 2-rank eval against one process
MP_GRAD_TOL = 1e-4        # 19c, of each leaf's max (phase 5's)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_ranks(argv: list, world, local_ranks=None, visible=None,
                 timeout: float = MP_TIMEOUT_S) -> list:
    """`python3 argv...` as `world` ranks with torchrun's environment
    (world None: one process without it), each rank on LOCAL_RANK
    local_ranks[r] (default 0) and, with `visible`, CUDA_VISIBLE_DEVICES
    `visible`; returns [(returncode, output)] in rank order. Every rank
    still running at `timeout` is killed."""
    port = free_port()
    procs = []
    for rank in range(world or 1):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        if world:
            env.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": str((local_ranks or [0] * world)[rank]),
                        "LOCAL_WORLD_SIZE": str(world),
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible
        procs.append(subprocess.Popen(
            [sys.executable] + argv, cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        deadline = time.time() + timeout
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.time(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(killed at timeout)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def check_ranks(results, tag: str) -> None:
    for rank, (rc, out) in enumerate(results):
        check(rc == 0, f"{tag}: rank {rank} exited with {rc}:\n{out[-4000:]}")


def toy_steps(torch, config, state, batches, dev):
    """MP_TOY_STEPS deterministic train steps from `state` on `batches`
    (host Batches); returns (losses, the first step's gradients, the final
    state) on the host."""
    from nerf_hugs_torch.models import construct_model
    from nerf_hugs_torch.parallel import mesh
    from nerf_hugs_torch.train import step as step_lib
    model = construct_model(config, dev, torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    mesh.replicate(model)
    opt, sched = step_lib.create_optimizer(config, model)
    thresholds = step_lib.initial_inlier_thresholds(config, dev)
    losses, grads = [], None
    for batch in batches:
        stats = step_lib.train_step(model, opt, sched, batch.to(dev), 0.3,
                                    config, None, thresholds)
        losses.append(float(stats["loss"]))
        if grads is None:
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}
    return losses, grads, {k: v.detach().cpu() for k, v in
                           model.state_dict().items()}


def rank_toy(torch, work: str, backend: str) -> None:
    """A rank of 19a / 19d: its half of each global batch of toy.pt."""
    import dataclasses
    from nerf_hugs_torch.parallel import mesh
    from nerf_hugs_torch.utils.device import resolve_device
    joined = mesh.maybe_initialize_distributed("cuda", backend)
    dev = resolve_device("cuda")
    saved = torch.load(os.path.join(work, "toy.pt"), weights_only=False)
    rank, world = mesh.process_index(), mesh.process_count()

    def half(batch):
        per = len(batch.rgb) // world
        take = lambda x: x[rank * per:(rank + 1) * per]
        return dataclasses.replace(batch, rays=batch.rays.map(take),
                                   rgb=take(batch.rgb))

    reset_launches()
    losses, grads, state = toy_steps(torch, saved["config"], saved["state"],
                                     [half(b) for b in saved["batches"]],
                                     dev)
    torch.cuda.synchronize()
    torch.save({"losses": losses, "grads": grads, "state": state,
                "launches": read_launches(), "device": str(dev)},
               os.path.join(work, f"toy_{backend}_rank{rank}.pt"))
    mesh.shutdown(joined)


def rank_driver(torch, kind: str, stem: str, options: set,
                args: list) -> None:
    """A rank of 19b / 19c: the train or eval driver with the launch
    counters and, in train, the gradient all-reduce timed (synchronised
    host ms a step) and, with "profile" in `options`, rank 0's profiler
    device ms under it a step, and the run's device ms in copies and in
    NCCL kernels; writes them to {stem}_{RANK}.json. With "grads", the
    first step's averaged gradients go to {stem}_{RANK}_grads.pt."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.train import main as train_main
    from nerf_hugs_torch.train import step as step_lib
    reduce_ms = []
    mean_gradients = step_lib.mean_gradients

    def timed(params):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.record_function("mean_gradients"):
            grads = mean_gradients(params)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)
        if "grads" in options and len(reduce_ms) == 1:
            torch.save({k: g.cpu() for k, g in grads.items()
                        if g is not None},
                       f"{stem}_{os.environ.get('RANK', '0')}_grads.pt")
        return grads

    step_lib.mean_gradients = timed
    reset_launches()
    readings = {}
    t0 = time.time()
    if (kind == "train" and "profile" in options
            and os.environ.get("RANK") == "0"):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            train_main(args)
            torch.cuda.synchronize()
        rows = {e.key: e for e in prof.key_averages()}
        dev_us = lambda e: getattr(e, "device_time_total",
                                   getattr(e, "cuda_time_total", 0.0))
        reduce_row = rows.get("mean_gradients")
        readings = {
            "reduce_device_ms": (dev_us(reduce_row) / 1e3 / max(
                reduce_row.count, 1)) if reduce_row else None,
            "memcpy_device_ms_run": sum(dev_us(e) for k, e in rows.items()
                                        if k.startswith("Memcpy")) / 1e3,
            "nccl_device_ms_run": sum(dev_us(e) for k, e in rows.items()
                                      if "nccl" in k.lower()) / 1e3}
    else:
        (train_main if kind == "train" else eval_main)(args)
    torch.cuda.synchronize()
    with open(f"{stem}_{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump({"launches": read_launches(), "reduce_ms": reduce_ms,
                   "wall_s": time.time() - t0, "profile": readings}, f)


def rank_nccl_shared() -> None:
    """A rank of 19c's refusal: nccl with every rank on one card."""
    from nerf_hugs_torch.parallel import mesh
    try:
        mesh.maybe_initialize_distributed("cuda", "nccl", timeout_s=60)
    except RuntimeError as e:
        print(f"REFUSED: {e}", flush=True)
        sys.exit(5)
    print("NOT REFUSED", flush=True)


def rank_main(argv: list) -> None:
    """`chip_smoke.py --rank toy DIR BACKEND | driver train|eval STEM
    OPTIONS ARGS... | nccl_shared`: one rank of phase 19 (OPTIONS: a
    comma-separated subset of profile and grads, or -)."""
    sys.path.insert(0, HERE)
    import torch
    from nerf_hugs_torch.utils.device import pin_fp32_precision
    pin_fp32_precision()
    if argv[0] == "toy":
        rank_toy(torch, argv[1], argv[2])
    elif argv[0] == "driver":
        rank_driver(torch, argv[1], argv[2], set(argv[3].split(",")),
                    argv[4:])
    elif argv[0] == "nccl_shared":
        rank_nccl_shared()
    else:
        fail(f"unknown rank mode {argv}")


def leaf_rel(a: dict, b: dict) -> float:
    """The largest |a - b| of a leaf over that leaf's largest |b|."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               / max(float(b[k].float().abs().max()), 1e-30) for k in b)


def mp_toy_phase(torch, tmp: str, dev, backend: str, local_ranks,
                 visible) -> None:
    """19a (gloo, both ranks on card 0) and 19d (nccl, cards 0 and 1)."""
    import yaml
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models import construct_model
    from nerf_hugs_torch.train import driver
    work = os.path.join(tmp, "mp_toy")
    if not os.path.exists(os.path.join(work, "toy.pt")):
        os.makedirs(work, exist_ok=True)
        path = os.path.join(work, "small.yml")
        with open(path, "w") as f:
            f.write(SMALL_YAML)
        config = driver.load_config(path, work, os.path.join(work, "ck"))
        dataset = load_dataset("train", work, config, is_training=True)
        batches = [next(dataset) for _ in range(MP_TOY_STEPS)]
        state = construct_model(config, "cpu",
                                torch.Generator().manual_seed(0)).state_dict()
        torch.save({"config": config, "state": state, "batches": batches},
                   os.path.join(work, "toy.pt"))
    saved = torch.load(os.path.join(work, "toy.pt"), weights_only=False)
    t0 = time.time()
    results = launch_ranks([__file__, "--rank", "toy", work, backend], 2,
                           local_ranks, visible)
    wall = time.time() - t0
    check_ranks(results, f"toy ranks over {backend}")
    ranks = [torch.load(os.path.join(work, f"toy_{backend}_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    one = toy_steps(torch, saved["config"], saved["state"],
                    saved["batches"], dev)
    equal = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
                for k in ranks[0]["state"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["losses"], one[0]))
    grad_rel = leaf_rel(ranks[0]["grads"], one[1])
    param_rel = leaf_rel(ranks[0]["state"], one[2])
    print(f"multi-process toy ({backend}, 2 ranks on "
          f"{[r['device'] for r in ranks]}, CUDA_VISIBLE_DEVICES={visible}): "
          f"{MP_TOY_STEPS} steps in {wall:.1f} s with start-up; ranks' "
          f"parameters bit-equal {equal}; losses {ranks[0]['losses']} vs one "
          f"process {one[0]} (worst rel {loss_rel:.2e}); first-step "
          f"gradient worst {grad_rel:.2e} of the leaf's max; parameters "
          f"after {MP_TOY_STEPS} steps worst {param_rel:.2e} of the leaf's "
          f"max; launches per rank {[r['launches'] for r in ranks]}",
          flush=True)
    check(equal, f"the {backend} ranks' parameters differ")
    check(ranks[0]["losses"] == ranks[1]["losses"],
          f"the {backend} ranks' losses differ")
    check(loss_rel <= 1e-5, f"2-rank losses differ from one process "
                            f"({backend})")
    check(grad_rel <= 1e-4, f"2-rank gradients differ from one process "
                            f"({backend})")
    check(all(r["launches"][k] > 0 for r in ranks for k in DENSE),
          f"a toy rank did not launch the hash-grid kernels: "
          f"{[r['launches'] for r in ranks]}")


def mp_driver(kind: str, cfg: str, data_dir: str, save_dir: str, tag: str,
              world, backend=None, local_ranks=None, visible=None,
              options: str = "-") -> list:
    """The train or eval driver as `world` ranks (None: one process
    without a group) through rank_driver with `options`; returns each
    rank's (output, record)."""
    stem = os.path.join(os.path.dirname(save_dir), f"{tag}_{kind}")
    extra = ["--dist_backend", backend] if backend else []
    outs = launch_ranks([__file__, "--rank", "driver", kind, stem, options]
                        + config_args(cfg, data_dir, save_dir) + extra,
                        world, local_ranks, visible)
    check_ranks(outs, f"{tag} {kind}")
    records = []
    for rank, (_, out) in enumerate(outs):
        with open(f"{stem}_{rank}.json") as f:
            records.append((out, json.load(f)))
    return records


def metrics_psnr(save_dir: str) -> float:
    with open(os.path.join(save_dir, f"metrics_test_{MP_STEPS}.txt")) as f:
        return float(dict(line.split() for line in f)["psnr"])


def mp_phase(torch, tmp: str, scene: str, dev) -> None:
    """Phase 19 (see the module's docstring)."""
    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.tools.hashgrid_inputs import base_yaml
    mp_toy_phase(torch, tmp, dev, "gloo", None, "0")

    # 19b: the drivers at full width as 2 gloo ranks on the one card.
    work = os.path.join(tmp, "mp")
    os.makedirs(work, exist_ok=True)
    cfg = base_yaml(work, fused=False, steps=MP_STEPS, scene="kubric")
    save2 = os.path.join(work, "two")
    t0 = time.time()
    train = mp_driver("train", cfg, scene, save2, "two", 2, "gloo",
                      visible="0", options="profile")
    wall = time.time() - t0
    (out0, rec0), (out1, rec1) = train
    steps = stage_lines(out0, "train")
    check([s[0] for s in steps] == list(range(1, MP_STEPS + 1))
          and not stage_lines(out1, "train"),
          f"2-rank train print lines: rank 0 {steps}, rank 1 "
          f"{stage_lines(out1, 'train')}")
    check(all(r["launches"][k] > 0 for _, r in train for k in DENSE),
          f"a train rank did not launch the hash-grid kernels: "
          f"{[r['launches'] for _, r in train]}")
    listing = sorted(os.listdir(save2))
    events = os.listdir(os.path.join(save2, "tb_train"))
    with open(os.path.join(save2, "run_log.log")) as f:
        log = f.read()
    check(listing == sorted([f"checkpoint_{MP_STEPS}.pt", "config.gin",
                             "model_compat.json", "run_log.log",
                             "tb_train"])
          and len(events) == 1 and log.count("Number of parameters") == 1,
          f"2-rank train wrote {listing}, events {events}")
    rate = (len(steps) - 1) / sum(1 / s[2] for s in steps[1:])
    reduce_ms = [statistics.median(r["reduce_ms"][1:]) for _, r in train]
    print(f"multi-process train (kubric_nerfacto_base, 2 gloo ranks on one "
          f"card, a correctness run): {MP_STEPS} steps in {wall:.1f} s with "
          f"start-up; steps/s after the first {rate:.3f}; losses "
          f"{[round(s[1], 5) for s in steps]}; gradient all-reduce "
          f"(synchronised host ms a step, median of steps 2-{MP_STEPS}) "
          f"{reduce_ms}; rank 0 profile {rec0['profile']}; launches per rank "
          f"{[r['launches'] for _, r in train]}", flush=True)

    evals = mp_driver("eval", cfg, scene, save2, "two", 2, "gloo",
                      visible="0")
    check(all(r["launches"]["hashgrid_fwd"] > 0 for _, r in evals),
          f"an eval rank did not launch the hash-grid forward: "
          f"{[r['launches'] for _, r in evals]}")
    check("mean: psnr=" in evals[0][0] and "mean: psnr=" not in evals[1][0],
          "the 2-rank eval's scores are not rank 0's alone")
    psnr_two = metrics_psnr(save2)
    eval_main(config_args(cfg, scene, save2))
    psnr_one = metrics_psnr(save2)
    print(f"multi-process eval (2 gloo ranks, 2 images): psnr {psnr_two!r} "
          f"vs one process {psnr_one!r}; launches per rank "
          f"{[r['launches'] for _, r in evals]}", flush=True)
    check(abs(psnr_two - psnr_one) <= MP_PSNR_TOL,
          "the 2-rank eval's PSNR differs from one process's")

    # 19c: a world of one over nccl against two runs without a group, held
    # by the first step's averaged gradients (the parameters after Adam's
    # steps cannot tell a misplaced gradient from noise: every entry moves
    # by about the learning rate whatever its gradient).
    # The two runs without a group share the card at once; the nccl run,
    # whose all-reduce is timed and profiled, runs alone.
    run = lambda name, world=None, backend=None, options="grads": mp_driver(
        "train", cfg, scene, os.path.join(work, name), name, world, backend,
        options=options)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        outs = dict(zip(("alone_a", "alone_b"),
                        pool.map(run, ("alone_a", "alone_b"))))
    outs["nccl1"] = run("nccl1", 1, "nccl", "profile,grads")
    runs = {}
    for name, out in outs.items():
        grads = torch.load(os.path.join(work, f"{name}_train_0_grads.pt"),
                           weights_only=True)
        runs[name] = (out[0], grads, stage_lines(out[0][0], "train"))
    nccl = runs["nccl1"][0]
    spread = leaf_rel(runs["alone_b"][1], runs["alone_a"][1])
    diff = leaf_rel(runs["nccl1"][1], runs["alone_a"][1])
    same_leaves = sorted(runs["nccl1"][1]) == sorted(runs["alone_a"][1])
    losses = {name: [s[1] for s in r[2]] for name, r in runs.items()}
    print(f"multi-process world of one over nccl: first-step averaged "
          f"gradients worst {diff:.3e} of the leaf's max against a run "
          f"without a group, two runs without a group {spread:.3e}; losses "
          f"{losses}; gradient all-reduce "
          f"{statistics.median(nccl[1]['reduce_ms'][1:]):.3f} ms a step "
          f"(synchronised host clock); profile {nccl[1]['profile']}; "
          f"launches {nccl[1]['launches']}", flush=True)
    check(same_leaves and diff <= MP_GRAD_TOL,
          "the nccl world of one's averaged gradients differ from a run "
          "without a group")
    shared = launch_ranks([__file__, "--rank", "nccl_shared"], 2,
                          visible="0", timeout=120)
    check(all(rc == 5 and "takes one rank per card" in out
              for rc, out in shared),
          f"2 nccl ranks on one card were not refused: {shared}")
    print("multi-process: 2 nccl ranks on one card refused: " + re.search(
        r"REFUSED: .*", shared[0][1]).group(0), flush=True)

    # 19d: nccl over two cards.
    if torch.cuda.device_count() >= 2:
        mp_toy_phase(torch, tmp, dev, "nccl", [0, 1], None)
    else:
        print(f"multi-process 19d (2 nccl ranks on 2 cards): not run, "
              f"{torch.cuda.device_count()} card", flush=True)


# Phase 20: the quality gate. Each run: (config, steps, JAX's held-out
# PSNR and SSIM on the same scene at the same steps, whether its train
# steps are profiled).
QUALITY_RUNS = (("kubric_nerfacto_base", 1000, 27.42, 0.9294, False),
                ("kubric_nerfacto_tpu", 3000, 34.73, 0.9888, True))
# The margins below JAX's targets: the port starts from JAX's initial
# weights and batches but draws its sample jitter and backgrounds from
# other random streams (JAX's paired runs moved by +-0.3 dB an image,
# PARITY.md:341).
QUALITY_PSNR_MARGIN, QUALITY_SSIM_MARGIN = 1.0, 0.01
QUALITY_WINDOW = (101, 5)     # the profiled train steps: first, count
QUALITY_TIMEOUT_S = 420
QUALITY_RESULT = re.compile(
    r"^RESULT config=(\S+) steps=(\d+) test_psnr=(\S+) test_ssim=(\S+) "
    r"per_image_psnr=\[(.*)\]$", re.M)
QUALITY_TIMING = re.compile(
    r"^TIMING config=\S+ steps_per_sec=(\S+) train_wall_s=(\S+) "
    r"peak_gib=(\S+)$", re.M)


def quality_main(argv: list) -> None:
    """`chip_smoke.py --quality profile|- ARGS...`: one run of phase 20,
    `python -m nerf_hugs_torch.tools.validate_quality ARGS` in this process
    (runpy, as __main__), with the hash-grid launches counted around each
    train step and every counter read around the run; with `profile`, a
    torch.profiler window over QUALITY_WINDOW's train steps. Prints one
    `QUALITY_CHILD {json}` line last."""
    import runpy

    sys.path.insert(0, HERE)
    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from nerf_hugs_torch.train import step as step_lib
    profiled, argv = argv[0] == "profile", argv[1:]
    first, count = QUALITY_WINDOW
    per_step, window = [], {}
    train_step = step_lib.train_step

    def counted(*args, **kwargs):
        n = len(per_step) + 1
        if profiled and n == first:
            torch.cuda.synchronize()
            window["prof"] = profiler(activities=[ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.time()
        before = read_launches()
        out = train_step(*args, **kwargs)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        if profiled and n == first + count - 1:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.time() - window["t0"]) * 1e3 / count
            window["prof"].__exit__(None, None, None)
        return out

    step_lib.train_step = counted
    reset_launches()
    sys.argv = ["validate_quality"] + argv
    runpy.run_module("nerf_hugs_torch.tools.validate_quality",
                     run_name="__main__", alter_sys=True)
    torch.cuda.synchronize()
    summary = {"steps": len(per_step), "totals": read_launches(),
               "per_step_min": {k: min((s[k] for s in per_step), default=0)
                                for k in DENSE},
               "per_step_max": {k: max((s[k] for s in per_step), default=0)
                                for k in DENSE}}
    if profiled:
        check("wall_ms" in window, f"the profiler window did not close: "
                                   f"{len(per_step)} steps")
        summary.update(mip_categorize(window["prof"], count))
        summary["wall_ms"] = window["wall_ms"]
        summary["busy"] = summary["device_ms"] / window["wall_ms"]
    print("QUALITY_CHILD " + json.dumps(summary), flush=True)


def quality_phase(tmp: str) -> list:
    """Phase 20 (see the module's docstring); returns one reading a run."""
    readings = []
    for name, steps, psnr_want, ssim_want, profiled in QUALITY_RUNS:
        argv = driven([
            __file__, "--quality", "profile" if profiled else "-",
            "--config", f"configs/nerfacto/{name}.yml", "--steps",
            str(steps), "--save-dir", os.path.join(tmp, "quality", name),
            "--device", "cuda"])
        t0 = time.time()
        ((rc, out),) = launch_ranks(argv, None, timeout=QUALITY_TIMEOUT_S)
        wall = time.time() - t0
        check(rc == 0, f"quality {name}: exited with {rc}:\n{out[-4000:]}")
        result = QUALITY_RESULT.search(out)
        timing = QUALITY_TIMING.search(out)
        child = re.search(r"^QUALITY_CHILD (.*)$", out, re.M)
        check(result is not None and timing is not None and child is not None,
              f"quality {name}: no RESULT, TIMING or QUALITY_CHILD line:\n"
              f"{out[-4000:]}")
        child = json.loads(child.group(1))
        curve = [(int(s), float(p), float(q)) for s, p, q in re.findall(
            r"\[train\] (\d+): eval psnr=(\S+) ssim=(\S+)", out)]
        psnr, ssim = float(result.group(3)), float(result.group(4))
        per_image = [float(x) for x in result.group(5).split(",")]
        rate, train_wall, peak = (float(x) for x in timing.groups())
        print(f"quality ({name}, {steps} steps): in-train eval (step, psnr, "
              f"ssim) {curve}", flush=True)
        print(f"quality ({name}): {result.group(0)}", flush=True)
        print(f"quality ({name}): held-out PSNR {psnr} (JAX {psnr_want}, "
              f"gate {psnr_want - QUALITY_PSNR_MARGIN:.2f}), SSIM {ssim} (JAX "
              f"{ssim_want}, gate {ssim_want - QUALITY_SSIM_MARGIN:.4f}); "
              f"{rate} steps/s after the first step, train wall {train_wall} "
              f"s, peak device memory {peak} GiB, {wall:.1f} s with start-up "
              f"and scoring; launches per step (min, max) "
              f"{child['per_step_min']}, {child['per_step_max']} over "
              f"{child['steps']} steps, whole run {child['totals']}",
              flush=True)
        if profiled:
            print(f"profile (quality {name}), train steps "
                  f"{QUALITY_WINDOW[0]}-{sum(QUALITY_WINDOW) - 1}: device "
                  f"{child['device_ms']:.3f} ms per step, wall "
                  f"{child['wall_ms']:.3f} ms per step, busy share "
                  f"{child['busy']:.3f}; split {child['split']}; longest "
                  f"{child['longest']}", flush=True)
        check(all(math.isfinite(v) for v in [psnr, ssim] + per_image),
              f"quality {name}: a non-finite score")
        check(child["steps"] == steps
              and all(child["per_step_min"][k] >= 1 for k in DENSE),
              f"quality {name}: a train step launched no hash-grid kernel")
        check(all(child["totals"][k] == 0 for k in
                  FUSED + FUSED_F32 + NEVER if k not in DENSE),
              f"quality {name}: a fused-MLP kernel launched: "
              f"{child['totals']}")
        check(psnr >= psnr_want - QUALITY_PSNR_MARGIN,
              f"quality {name}: held-out PSNR {psnr} below JAX's "
              f"{psnr_want} less {QUALITY_PSNR_MARGIN} dB")
        check(ssim >= ssim_want - QUALITY_SSIM_MARGIN,
              f"quality {name}: held-out SSIM {ssim} below JAX's "
              f"{ssim_want} less {QUALITY_SSIM_MARGIN}")
        readings.append({"name": name, "psnr": psnr, "ssim": ssim,
                         "steps_per_s": rate, **child})
    return readings


# The transient methods' held-out quality (`python3 chip_smoke.py
# --transient NAME`, one run a call; the default run trains none of them:
# each takes about 40 minutes). Each run is a command of the JAX package's
# distractor queue (its script and run name), the tool's arguments as that
# command gives them, JAX's held-out PSNR and SSIM and localization ratio
# on the same scene at the same steps (PARITY.md:346-395; targets taken on
# a TPU), the floor of the port's localization ratio, whether the run is
# gated (the shipped NeRF-W run is recorded beside JAX's collapse) and
# whether the tool prints a LOCALIZATION line for it.
@dataclasses.dataclass(frozen=True)
class TransientRun:
    script: str
    run: str
    args: tuple
    psnr: float
    ssim: float
    ratio: float = None
    floor: float = None
    gated: bool = True
    localizes: bool = False


_DISTRACTOR = "configs/mipnerf360/distractor_1024_glo4_{}.gin"
_STEPS = ("--steps", "3000")
_BINDINGS = ("--binding", "Config.factor = 2", "--binding",
             "Model.remat_mlp = True")
TRANSIENT_RUNS = {
    "hanerf": TransientRun(
        "tools/tpu_queue_r4_long.sh", "hanerf_flagship_L",
        ("--config", _DISTRACTOR.format("hanerf")) + _STEPS + _BINDINGS,
        32.95, 0.9920, 4157.0, 10.0, localizes=True),
    "nerfw_strongreg": TransientRun(
        "tools/tpu_queue_r5i.sh", "nerfw_strongreg",
        ("--config", _DISTRACTOR.format("nerfw")) + _STEPS + _BINDINGS
        + ("--binding", "Config.nerfw_density_loss_mult = 0.3"),
        34.05, 0.9874, 13.45, 3.0, localizes=True),
    "base": TransientRun(
        "tools/tpu_queue_r4_long.sh", "base_flagship_L",
        ("--config", _DISTRACTOR.format("base")) + _STEPS
        + ("--distractor",) + _BINDINGS, 23.25, 0.8870),
    "nerfw": TransientRun(
        "tools/tpu_queue_r4_long.sh", "nerfw_flagship_L",
        ("--config", _DISTRACTOR.format("nerfw")) + _STEPS + _BINDINGS,
        0.47, 0.0178, 1.67, gated=False, localizes=True),
}
# Remat only trades memory (recompute the MLPs' activations in the
# backward pass): a train step with and without it leaves bit-equal
# parameters (tests/test_torch_port_transient_quality.py), and the fp32
# runs fit the card without it, about 30% faster.
TRANSIENT_DROPPED = ("--binding", "Model.remat_mlp = True")
TRANSIENT_TIMEOUT_S = 3300
QUALITY_LOCALIZATION = re.compile(
    r"^LOCALIZATION config=\S+ signal=(\S+) inside_outside_ratio=(\S+) "
    r"per_image=\[(.*)\]$", re.M)


# Vanilla NeRF's held-out quality (`python3 chip_smoke.py --vanilla NAME`,
# never in the default run): 3000 fp32 steps of a shipped vanilla yaml on
# the quality tool's scene, from JAX's initial weights
# (models/jax_init.py::init_vanilla_). JAX has no held-out vanilla target,
# so each run is recorded, not gated. The run names no JAX queue command.
_VANILLA = "configs/nerfacto/kubric_nerf_{}.yml"
VANILLA_RUNS = {
    "base": TransientRun(
        None, None, ("--config", _VANILLA.format("base")) + _STEPS, None,
        None, gated=False),
    "hanerf": TransientRun(
        None, None, ("--config", _VANILLA.format("hanerf")) + _STEPS, None,
        None, gated=False, localizes=True),
    "base_distractor": TransientRun(
        None, None, ("--config", _VANILLA.format("base")) + _STEPS
        + ("--distractor",), None, None, gated=False),
}
VANILLA_TIMEOUT_S = 1500


def transient_args(run: TransientRun) -> list:
    """The run's tool arguments on the card: JAX's without remat."""
    args = list(run.args)
    for i in range(len(args) - 1):
        if tuple(args[i:i + 2]) == TRANSIENT_DROPPED:
            return args[:i] + args[i + 2:]
    return args


def held_out_main(kind: str, argv: list) -> None:
    """`chip_smoke.py --transient|--vanilla NAME [--log PATH]`: one run of
    TRANSIENT_RUNS or VANILLA_RUNS (`kind`) through phase 20's `--quality`
    child on the card (the tool's whole output written to PATH), then, for
    a NeRF-W gin, the collapse diagnosis of its checkpoint on 2 train
    views; prints the in-train eval curve, RESULT, LOCALIZATION, steps/s,
    peak memory and wall, and fails on a failed run, a missing line, a
    non-finite score or any kernel launched; a gated run also fails with
    held-out PSNR or SSIM below JAX's less phase 20's margins or its
    localization ratio at or below its floor. Prints one `TRANSIENT {json}`
    or `VANILLA {json}` line last."""
    runs, timeout_s = {"transient": (TRANSIENT_RUNS, TRANSIENT_TIMEOUT_S),
                       "vanilla": (VANILLA_RUNS, VANILLA_TIMEOUT_S)}[kind]
    if (len(argv) not in (1, 3) or argv[0] not in runs
            or argv[1:2] not in ([], ["--log"])):
        fail(f"usage: chip_smoke.py --{kind} {{{','.join(runs)}}} "
             f"[--log PATH]")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name, run = argv[0], runs[argv[0]]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    config = run.args[run.args.index("--config") + 1]
    with tempfile.TemporaryDirectory() as tmp:
        save_dir = os.path.join(tmp, name)
        log_path = (os.path.abspath(argv[2]) if len(argv) == 3
                    else os.path.join(tmp, f"{kind}.log"))
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        t0 = time.time()
        with open(log_path, "w") as log:
            try:
                rc = subprocess.run(
                    [sys.executable, __file__, "--quality", "-"]
                    + transient_args(run)
                    + ["--save-dir", save_dir, "--device", "cuda"],
                    cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                    timeout=timeout_s).returncode
            except subprocess.TimeoutExpired:
                rc = "killed at timeout"
        wall = time.time() - t0
        with open(log_path) as f:
            out = f.read()
        check(rc == 0, f"{kind} {name}: exited with {rc}:\n"
                       f"{out[-4000:]}")
        diagnosis = []
        if config.endswith(".gin") and "nerfw" in config:
            t1 = time.time()
            ((rc, diag),) = launch_ranks(
                [__file__, "--diagnose", "--save-dir", save_dir, "--config",
                 config, "--views", "2", "--device", "cuda"], None,
                timeout=DIAGNOSE_TIMEOUT_S)
            check(rc == 0, f"{kind} {name}: the diagnosis exited with "
                           f"{rc}:\n{diag[-4000:]}")
            diagnosis = DIAGNOSE_LINE.findall(diag)
            for line in re.findall(r"^view \d+: .*$", diag, re.M):
                print(f"{kind} ({name}) diagnosis: {line}", flush=True)
            print(f"{kind} ({name}): diagnosis in "
                  f"{time.time() - t1:.1f} s", flush=True)
    result = QUALITY_RESULT.search(out)
    timing = QUALITY_TIMING.search(out)
    loc = QUALITY_LOCALIZATION.search(out)
    child = re.search(r"^QUALITY_CHILD (.*)$", out, re.M)
    check(result is not None and timing is not None and child is not None
          and (loc is not None) == run.localizes,
          f"{kind} {name}: a RESULT, TIMING, LOCALIZATION or "
          f"QUALITY_CHILD line is missing:\n{out[-4000:]}")
    child = json.loads(child.group(1))
    curve = [(int(s), float(p), float(q)) for s, p, q in re.findall(
        r"\[train\] (\d+): eval psnr=(\S+) ssim=(\S+)", out)]
    psnr, ssim = float(result.group(3)), float(result.group(4))
    per_image = [float(x) for x in result.group(5).split(",")]
    rate, train_wall, peak = (float(x) for x in timing.groups())
    ratio = float(loc.group(2)) if loc else None
    steps = int(result.group(2))
    print(f"{kind} ({name}): {' '.join(transient_args(run))}"
          + (f"; JAX's command {run.script} {run.run}" if run.script
             else ""), flush=True)
    print(f"{kind} ({name}, {steps} steps): in-train eval (step, psnr, "
          f"ssim) {curve}", flush=True)
    print(f"{kind} ({name}): {result.group(0)}", flush=True)
    if loc:
        print(f"{kind} ({name}): {loc.group(0)}", flush=True)
    gate = (f"gate {run.psnr - QUALITY_PSNR_MARGIN:.2f} / "
            f"{run.ssim - QUALITY_SSIM_MARGIN:.4f}"
            + (f", localization above {run.floor}" if run.floor else "")
            if run.gated else "recorded, not gated")
    target = (f"JAX {run.psnr} / {run.ssim}" if run.psnr is not None
              else "no JAX target")
    print(f"{kind} ({name}): held-out PSNR {psnr}, SSIM {ssim} ({target}, "
          f"{gate}); localization {ratio} (JAX {run.ratio}); {rate} "
          f"steps/s after the first step, train wall "
          f"{train_wall} s, peak device memory {peak} GiB, {wall:.1f} s "
          f"with start-up and scoring; launches over the run "
          f"{child['totals']}", flush=True)
    check(child["steps"] == steps, f"{kind} {name}: {child['steps']} "
                                   f"train steps counted, not {steps}")
    check(all(v == 0 for v in child["totals"].values()),
          f"{kind} {name}: a hash-grid or fused-MLP kernel launched: "
          f"{child['totals']}")
    check(all(math.isfinite(v) for v in [psnr, ssim] + per_image
              + ([ratio] if loc else [])),
          f"{kind} {name}: a non-finite score")
    if run.gated:
        check(psnr >= run.psnr - QUALITY_PSNR_MARGIN,
              f"{kind} {name}: held-out PSNR {psnr} below JAX's "
              f"{run.psnr} less {QUALITY_PSNR_MARGIN} dB")
        check(ssim >= run.ssim - QUALITY_SSIM_MARGIN,
              f"{kind} {name}: held-out SSIM {ssim} below JAX's "
              f"{run.ssim} less {QUALITY_SSIM_MARGIN}")
        check(run.floor is None or ratio > run.floor,
              f"{kind} {name}: localization {ratio} not above "
              f"{run.floor}")
    print(f"{kind.upper()} " + json.dumps({
        "name": name, "steps": steps, "psnr": psnr, "ssim": ssim,
        "per_image_psnr": per_image, "localization": ratio,
        "steps_per_s": rate, "train_wall_s": train_wall, "peak_gib": peak,
        "wall_s": wall, "curve": curve, "diagnosis": diagnosis,
        "gated": run.gated}), flush=True)


# Phase 23: the NeRF-W collapse diagnosis of phase 14e's checkpoint.
DIAGNOSE_CONFIG = "configs/mipnerf360/distractor_1024_glo4_nerfw.gin"
DIAGNOSE_LINE = re.compile(
    r"^view (\d+): combined_psnr=(\S+) static_only_psnr=(\S+) "
    r"static_acc=(\S+) combined_static_part_mean=(\S+) "
    r"transient_part_mean=(\S+) beta_mean=(\S+) \(beta_min=(\S+)\)$", re.M)
DIAGNOSE_PSNR_TOL = 1e-4      # dB, the tool's static-only PSNR against ours
DIAGNOSE_TIMEOUT_S = 300


def diagnose_main(argv: list) -> None:
    """`chip_smoke.py --diagnose ARGS...`: the main of
    `python -m nerf_hugs_torch.tools.diagnose_nerfw_collapse ARGS` in this
    process, every view's numbers kept at full precision; prints one
    `DIAGNOSE_CHILD {json}` line last."""
    sys.path.insert(0, HERE)
    from nerf_hugs_torch.tools import diagnose_nerfw_collapse as tool
    views, diagnose_view = [], tool.diagnose_view

    def kept(*args, **kwargs):
        views.append(diagnose_view(*args, **kwargs))
        return views[-1]

    tool.diagnose_view = kept
    tool.main(argv)
    print("DIAGNOSE_CHILD " + json.dumps(views), flush=True)


def diagnose_phase(torch, save_dir: str, dev) -> None:
    """Phase 23 (see the module's docstring)."""
    import numpy as np

    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models import construct_model
    from nerf_hugs_torch.tools import diagnose_nerfw_collapse as tool
    from nerf_hugs_torch.train import checkpoints
    from nerf_hugs_torch.train.render_image import render_image
    t0 = time.time()
    ((rc, out),) = launch_ranks(
        [__file__, "--diagnose", "--save-dir", save_dir, "--config",
         DIAGNOSE_CONFIG, "--views", "1", "--device", "cuda"], None,
        timeout=DIAGNOSE_TIMEOUT_S)
    tool_s = time.time() - t0
    check(rc == 0, f"diagnose: exited with {rc}:\n{out[-4000:]}")
    lines = DIAGNOSE_LINE.findall(out)
    child = re.search(r"^DIAGNOSE_CHILD (.*)$", out, re.M)
    check(len(lines) == 1 and child is not None,
          f"diagnose: not one view line and the child's record:\n"
          f"{out[-4000:]}")
    printed = [float(x) for x in lines[0][1:]]
    (view,) = json.loads(child.group(1))
    beta_min = printed[-1]
    check(all(math.isfinite(v) for v in printed + list(view.values())),
          f"diagnose: a non-finite number: {lines[0]}")
    check(re.search(r"^" + re.escape(tool.view_line(0, view, beta_min))
                    + "$", out, re.M) is not None,
          f"diagnose: the printed line is not the record's: {lines[0]}")
    check(0.0 <= view["static_acc"] <= 1.0,
          f"diagnose: static_acc {view['static_acc']} outside [0, 1]")
    check(view["beta_mean"] >= beta_min,
          f"diagnose: beta_mean {view['beta_mean']} below beta_min "
          f"{beta_min}")
    # The same train view through the eval path, rendered here.
    config = tool.load_config(tool.parse_args(
        ["--save-dir", save_dir, "--config", DIAGNOSE_CONFIG]))
    model = construct_model(config, dev, torch.Generator().manual_seed(0))
    step = checkpoints.restore_params(save_dir, model)
    batch = load_dataset("train", "", config,
                         is_training=True).generate_ray_batch(0)
    rgb = render_image(model, batch.rays, 1.0, config, dev)["rgb"]
    err = (np.clip(rgb.astype(np.float64), 0, 1)
           - np.asarray(batch.rgb, np.float64)[..., :3]) ** 2
    own = float(-10 * np.log10(err.mean()))
    text = re.search(r"^view 0: .*$", out, re.M).group(0)
    print(f"diagnose (distractor_1024_glo4_nerfw, phase 14e's step-{step} "
          f"checkpoint): {text}; "
          f"the eval path's PSNR of view 0 here {own:.6f} dB against the "
          f"tool's {view['static_only_psnr']:.6f}; tool {tool_s:.1f} s, "
          f"phase {time.time() - t0:.1f} s", flush=True)
    check(abs(own - view["static_only_psnr"]) <= DIAGNOSE_PSNR_TOL,
          f"diagnose: static-only PSNR {view['static_only_psnr']} against "
          f"the eval path's {own} dB")


SHIPPED_DIRS = ("nerfacto", "mipnerf360", "hugs")
# The configs phase 21 shows refused, with the exception the port raises
# and a part of its message: NeRF-W without the transient embedding (the
# port refuses it before building the model, where JAX's loss fails with a
# KeyError: ROADMAP Queue 3) and the vanilla yamls of a loader no registry
# has (JAX's `unknown dataset_loader`, nerf_hugs_tpu/data/__init__.py:35).
REFUSED = {
    "configs/nerfacto/distractor_nerfacto_nerfw.yml":
        (ValueError, "needs use_transient_embedding"),
    **{f"configs/nerfacto/{stem}.yml":
       (ValueError, "unknown dataset_loader 'robust'")
       for stem in ("distractor_nerf", "distractor_nerf_hanerf",
                    "distractor_nerf_nerfw")},
}
# Phase 21's trained runs: (config, the capture its loader reads). Each
# trains SWEEP_STEPS steps (and SWEEP_FINETUNE finetune steps where the
# config has the stage), evaluates 1 test image, and is deleted after its
# checks.
SWEEP = (
    ("nerfacto/kubric_nerfacto_robustnerf0.8.yml", "kubric"),
    ("nerfacto/kubric_nerfacto_base_addhash.yml", "kubric"),
    ("nerfacto/kubric_nerfacto_tpu_addhash.yml", "kubric"),
    ("nerfacto/kubric_nerf_nerfw.yml", "kubric"),
    ("mipnerf360/kubric_1024_withmask_tpu_bf16.gin", "kubric"),
    ("nerfacto/distractor_nerfacto_base.yml", "distractor"),
    ("nerfacto/distractor_nerfacto_base_addhash.yml", "distractor"),
    ("nerfacto/distractor_nerfacto_tpu.yml", "distractor"),
    ("nerfacto/distractor_nerfacto_withmask.yml", "distractor"),
    ("mipnerf360/distractor_1024_glo4_robustnerf0.8.gin", "distractor"),
    ("mipnerf360/distractor_1024_glo4_withmask.gin", "distractor"),
    ("mipnerf360/distractor_1024_glo4_withmask_tpu_bf16.gin", "distractor"),
    ("mipnerf360/distractor_1024_glo4_nerfw_strongreg.gin", "distractor"),
    ("nerfacto/phototourism_nerfacto_base.yml", "photo"),
    ("nerfacto/phototourism_nerfacto_base_addhash.yml", "photo"),
    ("nerfacto/phototourism_nerfacto_hanerf.yml", "photo"),
    ("nerfacto/phototourism_nerfacto_robustnerf0.8.yml", "photo"),
    ("nerfacto/phototourism_nerfacto_tpu.yml", "photo"),
    ("nerfacto/phototourism_nerfacto_withmask.yml", "photo"),
    ("nerfacto/phototourism_nerf_base.yml", "photo"),
    ("nerfacto/phototourism_nerf_hanerf.yml", "photo"),
    ("mipnerf360/phototourism_1024_robustnerf0.8.gin", "photo"),
    ("mipnerf360/phototourism_1024_withmask.gin", "photo"),
    ("mipnerf360/phototourism_1024_withmask_tpu_bf16.gin", "photo"),
    ("mipnerf360/360_glo4.gin", "llff_360"),
    ("mipnerf360/llff_512.gin", "llff"),
    ("mipnerf360/debug.gin", "llff"),
    ("mipnerf360/blender_512.gin", "blender"),
)
# A cut for the script's time limit: runs whose eval path another run
# covers (the same backbone and loader, or the same hash_impl, widths or
# transient head on another capture) keep the train driver's in-train
# eval of their last step and skip the eval driver; every other run turns
# the in-train eval off (train_render_every, a cadence key) and evaluates
# 1 image through the eval driver. Each run renders and scores one test
# image.
SWEEP_COVERED = {f"configs/{c}" for c in (
    "nerfacto/kubric_nerfacto_robustnerf0.8.yml",
    "nerfacto/kubric_nerfacto_base_addhash.yml",
    "nerfacto/kubric_nerfacto_tpu_addhash.yml",
    "nerfacto/kubric_nerf_nerfw.yml",
    "nerfacto/distractor_nerfacto_base.yml",
    "nerfacto/distractor_nerfacto_base_addhash.yml",
    "nerfacto/distractor_nerfacto_tpu.yml",
    "mipnerf360/distractor_1024_glo4_robustnerf0.8.gin",
    "mipnerf360/distractor_1024_glo4_nerfw_strongreg.gin")}
# The file of every shipped config -> the phase that trains or refuses it
# on the card (13 runs the HuGS yamls' segmentation stage, 17 renders with
# render_config.gin); phase 21's are SWEEP and REFUSED. A config added
# later that no phase names fails phase 21 and
# tests/test_torch_port_sweep.py, and check_driven fails the script where
# a named phase did not hand its config to a driver.
SHIPPED_RUNS = {
    **{f"configs/nerfacto/{stem}.yml": phase for stem, phase in (
        ("distractor_nerfacto_hanerf", "10"),
        ("distractor_nerfacto_robustnerf0.8", "11"),
        ("kubric_nerf_base", "15"), ("kubric_nerf_hanerf", "15"),
        ("kubric_nerfacto_base", "7"), ("kubric_nerfacto_gen_mask", "13"),
        ("kubric_nerfacto_tpu", "20"), ("kubric_nerfacto_withmask", "13"),
        ("phototourism_nerf_nerfw", "15"),
        ("phototourism_nerfacto_nerfw", "12"))},
    **{f"configs/mipnerf360/{stem}.gin": phase for stem, phase in (
        ("360", "17"), ("blender_256", "17"),
        ("distractor_1024_glo4_base", "14"),
        ("distractor_1024_glo4_hanerf", "14"),
        ("distractor_1024_glo4_nerfw", "14"), ("kubric_1024_base", "14"),
        ("kubric_1024_base_tpu_bf16", "14"),
        ("kubric_1024_robustnerf0.8", "14"), ("kubric_1024_withmask", "14"),
        ("llff_256", "17"), ("phototourism_1024_base", "14"),
        ("render_config", "17"))},
    "configs/hugs/kubric.yml": "13", "configs/hugs/kubric_tpu.yml": "13",
    **{f"configs/{config}": "21" for config, _ in SWEEP},
    **{config: "21" for config in REFUSED},
}
SWEEP_STEPS, SWEEP_FINETUNE = 3, 2
# The finetune stage may move these tensors alone (the appearance or GLO
# embedding); every other one stays bit-equal.
FINETUNED = ("appearance_embedding.weight", "GloEmbed_0.weight")


def check_coverage() -> None:
    """Every file under configs/{SHIPPED_DIRS} is in SHIPPED_RUNS and
    nothing else is."""
    shipped = sorted(
        os.path.relpath(os.path.join(root, f), HERE)
        for d in SHIPPED_DIRS
        for root, _, files in os.walk(os.path.join(HERE, "configs", d))
        for f in files)
    check(shipped == sorted(SHIPPED_RUNS),
          f"configs without a phase: "
          f"{sorted(set(shipped) - set(SHIPPED_RUNS))}; named but absent: "
          f"{sorted(set(SHIPPED_RUNS) - set(shipped))}")


def check_driven() -> None:
    """Each SHIPPED_RUNS config was handed to a driver (DRIVEN) in the
    phases that name it."""
    def within(phase: str, phases) -> bool:
        first, _, last = (phases or "0").partition("-")
        return int(first) <= int(phase) <= int(last or first)
    missed = sorted(f"{config} (phase {phase})"
                    for config, phase in SHIPPED_RUNS.items()
                    if not any(path == config and within(phase, phases)
                               for path, phases in DRIVEN))
    check(not missed, f"no driver of the named phase was given: {missed}")
    print(f"coverage: all {len(SHIPPED_RUNS)} shipped configs were handed "
          f"to a driver in the phase that SHIPPED_RUNS names", flush=True)


def sweep_flags(tmp: str, config: str, in_train_eval: bool = True):
    """The drivers' config of `config` (configs/ relative) as shipped, with
    the cadence keys alone changed: exit after SWEEP_STEPS, print every
    step, 1 eval image, SWEEP_FINETUNE finetune steps (read only where the
    config has the stage), and without `in_train_eval` no in-train eval."""
    stem = os.path.splitext(os.path.basename(config))[0]
    if config.endswith(".yml"):
        off = {} if in_train_eval else {"eval_render_every": 0}
        return shipped_yaml(tmp, stem, steps=SWEEP_STEPS,
                            eval_dataset_limit=1,
                            finetune_num_steps=SWEEP_FINETUNE, **off)
    off = [] if in_train_eval else ["Config.train_render_every = 0"]
    return gin_flags(stem, SWEEP_STEPS, "Config.eval_dataset_limit = 1",
                     f"Config.finetune_max_steps = {SWEEP_FINETUNE}", *off)


def sweep_run(torch, tmp: str, config: str, data_dir: str) -> dict:
    """One trained run of phase 21 through the train and eval drivers with
    the checks of the module docstring; returns its readings."""
    import shutil

    import numpy as np
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train import step as step_lib
    stem = os.path.splitext(os.path.basename(config))[0]
    save_dir = os.path.join(tmp, "exp", f"sweep_{stem}")
    covered = f"configs/{config}" in SWEEP_COVERED
    flags = sweep_flags(os.path.join(tmp, "sweep"), config, covered)
    cfg = driver.load_config_from_args(driver.parse_args(
        config_args(flags, data_dir, save_dir)))
    finetune = SWEEP_FINETUNE if cfg.finetune_enable else 0
    nerfacto = cfg.model_type == "nerfacto"
    expected = (HANERF if cfg.transient_type == "hanerf" else DENSE) \
        if nerfacto else NOT_ANY

    # The launches of each step and the train split the run read.
    per_step = []
    datasets = {}
    train_step, stage_dataset = step_lib.train_step, driver.stage_dataset

    def counted_step(*args):
        before = read_launches()
        out = train_step(*args)
        after = read_launches()
        per_step.append(("finetune" if args[8] else "train",
                         {k: after[k] - before[k] for k in after}))
        return out

    def recorded_dataset(stage, config):
        datasets[stage] = stage_dataset(stage, config)
        return datasets[stage]

    step_lib.train_step = counted_step
    driver.stage_dataset = recorded_dataset
    try:
        launches, terms = train_phase(torch, flags, data_dir, save_dir,
                                      f"sweep {stem}", expected,
                                      finetune_steps=finetune,
                                      num_steps=SWEEP_STEPS,
                                      in_train_eval=covered)
    finally:
        step_lib.train_step, driver.stage_dataset = train_step, stage_dataset
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(save_dir, "run_log.log")) as f:
        rates = [s[2] for s in stage_lines(f.read(), "train")[1:]]
    reading = {"steps_per_s": len(rates) / sum(1 / r for r in rates),
               "peak_gib": peak}

    stages = [s for s, _ in per_step]
    check(stages == ["train"] * SWEEP_STEPS + ["finetune"] * finetune,
          f"{stem}: steps by stage {stages}")
    for stage, counts in per_step:
        if stage == "train":
            check(all(counts[k] > 0 for k in expected),
                  f"{stem}: a train step launched {counts}")
        else:
            check(counts["hashgrid_bwd"] == 0 and (
                not nerfacto or counts["hashgrid_fwd"] > 0),
                  f"{stem}: a finetune step launched {counts}")
        check(all(counts[k] == 0 for k in counts if k not in expected),
              f"{stem}: a step launched a kernel off its path: {counts}")
    check(all(math.isfinite(float(v)) for t in terms["finetune"]
              for v in t.values()), f"{stem}: non-finite finetune terms")
    reading["launches_per_step"] = {
        stage: {k: v for k, v in per_step[i][1].items() if v}
        for i, (stage, _) in enumerate(per_step)}

    notes = []
    if cfg.transient_type == "withmask":
        mean = float(np.mean([m.mean() for m in
                              datasets["train"].static_masks]))
        notes.append(f"train split's mean static mask {mean:.4f}")
        check(mean < 1.0, f"{stem}: the withmask run read masks of ones")
    if cfg.transient_type == "robustnerf":
        thresholds = [[float(v) for v in t["inlier_threshold"].split(",")]
                      for t in terms["train"]]
        notes.append(f"thresholds handed on {thresholds}")
        check(all(math.isfinite(v) for t in thresholds for v in t),
              f"{stem}: non-finite RobustNeRF thresholds {thresholds}")
        check(thresholds[0] != [1.0] * len(thresholds[0]) and any(
            t != thresholds[0] for t in thresholds[1:]),
              f"{stem}: the RobustNeRF threshold does not move: "
              f"{thresholds}")
    if finetune:
        before, after = (torch.load(os.path.join(*d), weights_only=True)[
            "model"] for d in ((save_dir, f"checkpoint_{SWEEP_STEPS}.pt"),
                               (save_dir, "finetune",
                                f"checkpoint_{finetune}.pt")))
        moved = sorted(k for k in before if not torch.equal(before[k],
                                                            after[k]))
        notes.append(f"finetune moved {moved} of {len(before)} tensors")
        check(moved and all(k in FINETUNED for k in moved),
              f"{stem}: the finetune stage moved {moved}")
    if covered:
        notes.append("the in-train eval's image (eval driver not run)")
    else:
        summary = (f"metrics_test_finetune_{finetune}.txt" if finetune
                   else f"metrics_test_{SWEEP_STEPS}.txt")
        t0 = time.time()
        eval_phase(torch, flags, data_dir, save_dir, f"sweep {stem}",
                   expected, score=False, summary=summary, images=1,
                   ssim_min=-1.0)
        reading["eval_s"] = time.time() - t0
        notes.append(f"eval {reading['eval_s']:.2f} s an image")
    print(f"sweep ({stem}): {reading['steps_per_s']:.3f} steps/s over "
          f"steps 2-{SWEEP_STEPS}, peak {peak:.2f} GiB; launches per step "
          f"{reading['launches_per_step']}; " + "; ".join(notes), flush=True)
    shutil.rmtree(save_dir)
    torch.cuda.empty_cache()
    return reading


def refused_run(torch, tmp: str, config: str, data_dir: str) -> str:
    """A REFUSED config through the train driver: its error and message,
    and nothing launched or written."""
    from nerf_hugs_torch.train import main as train_main
    error, message = REFUSED[config]
    stem = os.path.splitext(os.path.basename(config))[0]
    save_dir = os.path.join(tmp, "exp", f"sweep_{stem}")
    flags = sweep_flags(os.path.join(tmp, "sweep"), config)
    reset_launches()
    try:
        train_main(config_args(flags, data_dir, save_dir))
        raised = None
    except error as e:
        raised = str(e)
    check(raised is not None and message in raised,
          f"{stem}: trained, or raised another error than {message!r}: "
          f"{raised!r}")
    check(not any(read_launches().values()) and not os.path.exists(
        save_dir), f"{stem}: the refused run launched or wrote something")
    print(f"sweep ({stem}): refused with {error.__name__}: {raised}",
          flush=True)
    return raised


def sweep_phase(torch, tmp: str, captures: dict) -> dict:
    """Phase 21 (see the module's docstring); returns the readings a run."""
    check_coverage()
    os.makedirs(os.path.join(tmp, "sweep"))
    t0 = time.time()
    readings = {}
    for config, capture in SWEEP:
        readings[config] = sweep_run(torch, tmp, config, captures[capture])
    for config in sorted(REFUSED):
        refused_run(torch, tmp, config, captures["distractor"])
    # The evals phase 15c's vanilla runs had not had.
    for stem, capture, summary in (
            ("kubric_nerf_hanerf", "kubric", "metrics_test_4.txt"),
            ("phototourism_nerf_nerfw", "photo",
             "metrics_test_finetune_2.txt")):
        cfg = shipped_yaml(os.path.join(tmp, "sweep"), stem, steps=4,
                           eval_dataset_limit=1, finetune_num_steps=2)
        t1 = time.time()
        eval_phase(torch, cfg, captures[capture],
                   os.path.join(tmp, "exp", f"nerf_{stem.split('_')[-1]}"),
                   f"sweep {stem}, phase 15c's run", NOT_ANY, score=False,
                   summary=summary, images=1, ssim_min=-1.0)
        readings[f"nerfacto/{stem}.yml"] = {"eval_s": time.time() - t1}
    print(f"sweep: {len(SWEEP)} configs trained and evaluated "
          f"({len(SWEEP) - len(SWEEP_COVERED)} through the eval driver), "
          f"{len(REFUSED)} refused, 2 evals of phase 15c's runs in "
          f"{time.time() - t0:.1f} s", flush=True)
    return readings


# Phase 22: a synthetic drop of released assets at full width, validated
# by `python -m nerf_hugs_torch.tools.validate_released_assets`.
RELEASED_PAIRS = (
    ("kubric_nerfacto_base", "nerfacto/kubric_nerfacto_base.yml",
     ("hashgrid_fwd",)),
    ("kubric_1024_withmask", "mipnerf360/kubric_1024_withmask.gin",
     NOT_ANY))
RELEASED_STEP = 8
RELEASED_IMAGES = 2         # eval_dataset_limit of the mapped configs
RELEASED_PSNR = 45.0        # dB, tests/test_released_assets_dryrun.py:127


def lpips_official(path: str, seed: int) -> None:
    """AlexNet-LPIPS weights in the official key schema (net.slice{k}.{i}
    convolutions of torchvision's AlexNet, lin{i}.model.1 heads) from a
    seeded generator."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    sd, in_ch = {}, 3
    for i, (out_ch, k, idx) in enumerate(((64, 11, 0), (192, 5, 3),
                                          (384, 3, 6), (256, 3, 8),
                                          (256, 3, 10))):
        fan_in = in_ch * k * k
        sd[f"net.slice{i + 1}.{idx}.weight"] = torch.from_numpy(rng.normal(
            0, (2 / fan_in) ** 0.5, (out_ch, in_ch, k, k)).astype(np.float32))
        sd[f"net.slice{i + 1}.{idx}.bias"] = torch.zeros(out_ch)
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(np.abs(rng.normal(
            0, 0.1, (1, out_ch, 1, 1))).astype(np.float32))
        in_ch = out_ch
    torch.save(sd, path)


def sam_official(path: str, dev) -> int:
    """SAM vit_b in the official key schema, the mask-prompt downscaling
    layers of every official file included, from a seeded generator on the
    card; returns its parameter count without those layers."""
    import torch
    from nerf_hugs_torch.hugs.sam.predictor import build_sam
    sd = {k: v.cpu() for k, v in build_sam("vit_b", device=dev,
                                           rng_seed=3).state_dict().items()}
    count = sum(v.numel() for v in sd.values())
    gen = torch.Generator().manual_seed(4)
    for name, shape in (("0.weight", (4, 1, 2, 2)), ("0.bias", (4,)),
                        ("1.weight", (4,)), ("1.bias", (4,)),
                        ("3.weight", (16, 4, 2, 2)), ("3.bias", (16,)),
                        ("4.weight", (16,)), ("4.bias", (16,)),
                        ("6.weight", (256, 16, 1, 1)), ("6.bias", (256,))):
        sd[f"prompt_encoder.mask_downscaling.{name}"] = torch.randn(
            shape, generator=gen)
    torch.save(sd, path)
    return count


def mapped_config(root: str, config: str) -> str:
    """A copy of configs/{config} in `root` evaluating RELEASED_IMAGES test
    images (the --config_map target)."""
    import yaml
    src = os.path.join(HERE, "configs", config)
    dst = os.path.join(root, os.path.basename(config))
    if config.endswith(".yml"):
        with open(src) as f:
            raw = yaml.safe_load(f)
        raw["base"]["eval_dataset_limit"] = RELEASED_IMAGES
        with open(dst, "w") as f:
            yaml.safe_dump(raw, f)
    else:
        with open(src) as f, open(dst, "w") as out:
            out.write(f.read() + f"\nConfig.eval_dataset_limit = "
                                 f"{RELEASED_IMAGES}\n")
    return dst


def released_renders(torch, config, state: dict, data_dir: str,
                     out_dir: str, dev) -> None:
    """rendering_results' test_preds of a model loaded straight from
    `state` (a port state dict): {i}_color.png rendered by the port at the
    eval's train_frac, {i}_gt.png the test image as eval composites it."""
    import numpy as np
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.metrics import image as nh_image
    from nerf_hugs_torch.models import construct_model
    from nerf_hugs_torch.train.render_image import render_image
    from nerf_hugs_torch.utils import io as nh_io
    model = construct_model(config, dev, torch.Generator().manual_seed(5))
    model.load_state_dict(state)
    dataset = load_dataset("test", data_dir, config, is_training=False)
    train_frac = float(np.clip(RELEASED_STEP / config.max_steps, 0, 1))
    os.makedirs(out_dir)
    for i in range(RELEASED_IMAGES):
        batch = dataset.generate_ray_batch(i)
        rgb = render_image(model, batch.rays, train_frac, config, dev)["rgb"]
        nh_io.save_img_u8(np.clip(np.nan_to_num(rgb), 0, 1),
                          os.path.join(out_dir, f"{i:03d}_color.png"))
        nh_io.save_img_u8(nh_image.composite_alpha(
            np.asarray(batch.rgb),
            nh_image.BACKGROUND_VALUES[config.test_background_color]),
            os.path.join(out_dir, f"{i:03d}_gt.png"))
    del model


def released_phase(torch, tmp: str, scene: str, dev) -> list:
    """Phase 22 (see the module's docstring); returns the report's rows."""
    import yaml
    from nerf_hugs_torch.configs import gin_parser
    from nerf_hugs_torch.models import construct_model, from_jax
    from nerf_hugs_torch.models import nerfacto_import
    from nerf_hugs_torch.tools import convert_reference_checkpoint as conv
    from nerf_hugs_torch.tools import released_snapshots
    from nerf_hugs_torch.tools import validate_released_assets as vra
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.utils import flax_msgpack
    import nerf_hugs_torch.eval as eval_pkg
    root = os.path.join(tmp, "released")
    drop = os.path.join(root, "drop")
    os.makedirs(os.path.join(drop, "data"))
    os.symlink(scene, os.path.join(drop, "data", "scene0"))
    t0 = time.time()
    config_map = {}
    for experiment, config, _ in RELEASED_PAIRS:
        mapped = config_map[experiment] = mapped_config(root, config)
        ckpt_dir = os.path.join(drop, "checkpoints", experiment, "scene0")
        os.makedirs(ckpt_dir)
        renders = os.path.join(drop, "rendering_results", experiment,
                               "scene0", "test_preds")
        if config.endswith(".yml"):
            cfg = driver.load_config(mapped, scene, root)
            model = construct_model(cfg, "cpu",
                                    torch.Generator().manual_seed(0))
            snapshot = released_snapshots.nerfacto_snapshot(
                model, cfg, 0, RELEASED_STEP)
            torch.save(snapshot, os.path.join(ckpt_dir,
                                              f"ckpt_{RELEASED_STEP}.pth"))
            # Rendered as the converter's emitted config.yml composites.
            with open(mapped) as f:
                raw = yaml.safe_load(f)
            raw["model"]["legacy_cumulative_deltas"] = True
            legacy = os.path.join(root, f"{experiment}_legacy.yml")
            with open(legacy, "w") as f:
                yaml.safe_dump(raw, f)
            cfg = driver.load_config(legacy, scene, root)
            sd = {k: v.numpy() for k, v in snapshot["model"].items()
                  if not k.endswith(nerfacto_import._IGNORED_SUFFIXES)}
            state = from_jax.convert_nerfacto_params(
                nerfacto_import.convert_nerfacto_state_dict(sd, cfg))
        else:
            cfg = gin_parser.parse_gin_configs([mapped], [])
            model = construct_model(cfg, "cpu",
                                    torch.Generator().manual_seed(0))
            train_state = released_snapshots.mipnerf360_train_state(
                model, 1, RELEASED_STEP)
            with open(os.path.join(ckpt_dir, f"checkpoint_{RELEASED_STEP}"),
                      "wb") as f:
                f.write(flax_msgpack.msgpack_serialize(train_state))
            state = from_jax.convert_mipnerf360_params(
                train_state["params"])
        del model
        released_renders(torch, cfg, state, scene, renders, dev)
    lpips_official(os.path.join(drop, "lpips_alex.pth"), 6)
    sam_count = sam_official(os.path.join(drop, "sam_vit_b.pth"), dev)
    map_path = os.path.join(root, "config_map.json")
    with open(map_path, "w") as f:
        json.dump(config_map, f)
    sizes = {name: sum(os.path.getsize(os.path.join(d, n))
                       for d, _, files in os.walk(os.path.join(drop, name))
                       for n in files) / 2 ** 20
             for name in ("checkpoints", "rendering_results")}
    print(f"released drop: written in {time.time() - t0:.1f} s (checkpoints "
          f"{sizes['checkpoints']:.1f} MiB, renders "
          f"{sizes['rendering_results']:.2f} MiB, LPIPS and SAM vit_b "
          f".pth)", flush=True)

    # Each pair's conversion and eval timed, with the eval's launches and
    # the pair's peak device memory.
    timings = {}
    current = [None]          # the pair being validated
    patched = (vra.validate_pair, conv.main, eval_pkg.main)

    def timed(key, fn):
        def call(*args, **kwargs):
            if key == "eval":
                reset_launches()
            t = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timings.setdefault(current[0], {})[key] = time.time() - t
            if key == "eval":
                timings[current[0]]["launches"] = read_launches()
            return out
        return call

    def pair(experiment, *args, **kwargs):
        current[0] = experiment
        torch.cuda.reset_peak_memory_stats()
        row = patched[0](experiment, *args, **kwargs)
        timings[experiment]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                           / 2 ** 30)
        torch.cuda.empty_cache()
        return row

    work = os.path.join(root, "work")
    vra.validate_pair, conv.main = pair, timed("convert", conv.main)
    eval_pkg.main = timed("eval", eval_pkg.main)
    try:
        t0 = time.time()
        rows, extras = vra.main(["--assets_dir", drop, "--work_dir", work,
                                 "--config_map", map_path, "--device", dev])
        wall = time.time() - t0
    finally:
        vra.validate_pair, conv.main, eval_pkg.main = patched
    rows = {r["experiment"]: r for r in rows}
    check(sorted(rows) == sorted(e for e, _, _ in RELEASED_PAIRS)
          and not any("error" in r for r in rows.values()),
          f"released: rows {json.dumps(list(rows.values()), default=str)}")
    check(extras["lpips"]["ok"] and extras["sam"]["converted_param_count"]
          == sam_count, f"released: extras {extras}")
    for experiment, _, expected in RELEASED_PAIRS:
        row, t = rows[experiment], timings[experiment]
        check("lpips" in row["released_scores"] and all(
            math.isfinite(v) for v in row["our_scores"].values()),
              f"released {experiment}: scores {row}")
        check(row["ours_vs_released_psnr"] > RELEASED_PSNR,
              f"released {experiment}: ours against the released renders "
              f"{row['ours_vs_released_psnr']} dB")
        launched = t["launches"]
        check(all(launched[k] > 0 for k in expected) and all(
            launched[k] == 0 for k in launched if k not in expected),
              f"released {experiment}: the eval launched {launched}")
        print(f"released ({experiment}): converted in {t['convert']:.2f} s, "
              f"eval of {RELEASED_IMAGES} images in {t['eval']:.2f} s, peak "
              f"{t['peak_gib']:.2f} GiB; released "
              f"{row['released_scores']}; ours {row['our_scores']}; ours "
              f"against released {row['ours_vs_released_psnr']} dB (bar "
              f"{RELEASED_PSNR}); eval launches "
              f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    for name in ("PAPER_COMPARISON.md", "PAPER_COMPARISON.json"):
        with open(os.path.join(work, name)) as f:
            text = f.read()
        check(all(e in text for e, _, _ in RELEASED_PAIRS),
              f"released: {name} does not name both pairs")
    print(f"released: the twin validated the drop in {wall:.1f} s; LPIPS "
          f"{extras['lpips']}; SAM vit_b "
          f"{extras['sam']['converted_param_count']} parameters", flush=True)
    return list(rows.values())


# The captures of phases 5-22, written by processes of this script
# (`--captures ROOT GROUP`) while the main process checks the kernels:
# the kubric scene and the distractor and phototourism captures (read from
# phase 5 on), and the llff and blender ones (from phase 17 on).
CAPTURE_GROUPS = ("kubric", "distractor", "photo", "llff")
CAPTURES_TIMEOUT_S = 600


def write_captures(root: str, group: str) -> None:
    """Write `group` of CAPTURE_GROUPS under `root` and print the seconds
    it took: the kubric scene, the distractor or the phototourism capture
    (32 + 4 frames each), or the forward-facing and 360 llff captures and
    the blender scene."""
    sys.path.insert(0, HERE)
    from nerf_hugs_torch.tools import hashgrid_inputs
    t0 = time.time()
    if group == "kubric":
        hashgrid_inputs.write_kubric_scene(os.path.join(root, "kubric"))
    elif group in ("distractor", "photo"):
        hashgrid_inputs.write_colmap_scene(
            os.path.join(root, group),
            "phototourism" if group == "photo" else group)
    elif group == "llff":
        hashgrid_inputs.write_llff_scene(os.path.join(root, "llff"), True)
        hashgrid_inputs.write_llff_scene(os.path.join(root, "llff_360"),
                                         False)
        hashgrid_inputs.write_blender_scene(os.path.join(root, "blender"))
    else:
        fail(f"unknown capture group {group!r}")
    print(f"{time.time() - t0:.3f}", flush=True)


@contextlib.contextmanager
def capture_writers(root: str):
    """Starts a writer for each of CAPTURE_GROUPS; yields wait(group),
    which returns the writer's seconds and fails the script if it did not
    exit 0 within CAPTURES_TIMEOUT_S. A writer still running on exit is
    killed."""
    procs = {group: subprocess.Popen(
        [sys.executable, __file__, "--captures", root, group], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for group in CAPTURE_GROUPS}

    def wait(group: str) -> float:
        try:
            out = procs[group].communicate(timeout=CAPTURES_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            fail(f"captures ({group}): still writing after "
                 f"{CAPTURES_TIMEOUT_S} s")
        check(procs[group].returncode == 0,
              f"captures ({group}): exited with {procs[group].returncode}:"
              f"\n{out[-4000:]}")
        return float(out.split()[-1])

    try:
        yield wait
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "nerf_hugs_torch")):
        fail("nerf_hugs_torch/ is not beside this script: run it from a "
             "checkout of the repository")
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--quality"]:
        quality_main(sys.argv[2:])
        return
    if sys.argv[1:2] in (["--transient"], ["--vanilla"]):
        held_out_main(sys.argv[1][2:], sys.argv[2:])
        return
    if sys.argv[1:2] == ["--diagnose"]:
        diagnose_main(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--captures"]:
        write_captures(*sys.argv[2:4])
        return
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = "cuda"
    start = time.time()

    def done(phases: str) -> None:
        for entry in DRIVEN:
            entry[1] = entry[1] or phases
        print(f"time: phases {phases} done at {time.time() - start:.1f} s",
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_hugs_torch.ops import fused_mlp, hashgrid, hashgrid_bwd, kernels
    from nerf_hugs_torch.tools.hashgrid_inputs import (
        MASK_N, PHOTOTOURISM_SCENE, base_yaml)
    from nerf_hugs_torch.utils.device import pin_fp32_precision
    from nerf_hugs_torch.utils import trace
    pin_fp32_precision()
    kernels.load()
    built = ", ".join(os.path.relpath(p, HERE) for p in kernels.sources())
    counts = trace.counters()
    print(f"build: {built} -> {counts['kernels.load_s']:.1f} s, "
          f"{counts.get('kernels.builds', 0)} nvcc runs", flush=True)
    for src, log in kernels.build_log.items():
        for line in log.splitlines():
            if re.search(r"Used \d+ registers|spill", line):
                print(f"ptxas {src}: {line.strip()}", flush=True)

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        worst, timings = kernel_phase(torch, hashgrid, hashgrid_bwd, dev)
        worst_2d, timings_2d = mask_kernel_phase(torch, hashgrid,
                                                 hashgrid_bwd, dev)
        fused_worst, fused_timings = fused_mlp_phase(torch, fused_mlp, dev)
        ipe_worst, ipe_timings = ipe_phase(torch, dev)
        done("1-4")
        # The writers start after the kernels line's timings, which their
        # CPU load would disturb.
        wait_captures = stack.enter_context(capture_writers(tmp))
        for variant in SMALL_VARIANTS:
            small_model_phase(torch, tmp, dev, variant)
        done("5")
        t0 = time.time()
        seconds = max(wait_captures(g) for g in ("kubric", "distractor",
                                                  "photo"))
        scene = os.path.join(tmp, "kubric")
        distractor = os.path.join(tmp, "distractor")
        phototourism = os.path.join(tmp, "photo", PHOTOTOURISM_SCENE)
        print(f"scenes: 32 train + 4 test frames each, kubric and "
              f"distractor at 256x256, phototourism at 512x512, written in "
              f"{seconds:.1f} s (the slowest writer) beside phase 5 "
              f"(waited {time.time() - t0:.1f} s)", flush=True)
        dense_cfg = base_yaml(tmp, fused=False, scene="kubric")
        COPIES[dense_cfg] = "configs/nerfacto/kubric_nerfacto_base.yml"
        hanerf_cfg = shipped_yaml(tmp, "distractor_nerfacto_hanerf")
        captured_worst, _ = captured_phase(torch, hashgrid, hashgrid_bwd,
                                           dense_cfg, scene, dev)
        worst = {k: max(v, captured_worst[k]) for k, v in worst.items()}
        captured_worst, captured_2d = captured_phase(
            torch, hashgrid, hashgrid_bwd, hanerf_cfg, distractor, dev,
            ("mask",))
        worst_2d = {k: max(v, captured_worst[k]) for k, v in worst_2d.items()}
        done("6")
        launches, terms = train_phase(torch, dense_cfg, scene,
                                      os.path.join(tmp, "exp", "dense"),
                                      "Dense MLPs, kubric scene", DENSE)
        launches = launches["train"]
        check_summaries(os.path.join(tmp, "exp", "dense"),
                        "Dense MLPs, kubric", 8, terms["train"][-1])
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
        done("7-12")
        sam_card_phase(torch, dev)
        hugs_phase(torch, tmp, dev)
        done("13")
        ipe_names = {"fwd": "ipe.launches", "bwd": "ipe_bwd.launches"}
        ipe_before = {k: trace.counters().get(c, 0)
                      for k, c in ipe_names.items()}
        mip_phase(torch, tmp, scene, distractor, phototourism, dev)
        ipe_launches = {k: trace.counters().get(c, 0) - ipe_before[k]
                        for k, c in ipe_names.items()}
        # Every shipped gin stops the levels' gradient (stop_level_grad), so
        # the encoding's inputs never require one.
        check(ipe_launches["fwd"] > 0 and ipe_launches["bwd"] == 0,
              f"the Mip-NeRF 360 runs launched ipe_fwd "
              f"{ipe_launches['fwd']} times (some expected) and ipe_bwd "
              f"{ipe_launches['bwd']} (none expected)")
        print(f"check Mip-NeRF 360 runs: ipe_fwd launched "
              f"{ipe_launches['fwd']} times, ipe_bwd "
              f"{ipe_launches['bwd']}", flush=True)
        done("14")
        vanilla_phase(torch, tmp, scene, phototourism, dev)
        done("15")
        render_phases(torch, dense_cfg, scene,
                      os.path.join(tmp, "exp", "dense"), fused_cfg, tmp,
                      fused_dir)
        done("16")
        t0 = time.time()
        seconds = wait_captures("llff")
        print(f"scenes: llff forward-facing and 360 (20 frames of 1008x756 "
              f"in images_4/ each) and blender (8 + 2 frames of 800x800) "
              f"written in {seconds:.1f} s beside phases 5-16 (waited "
              f"{time.time() - t0:.1f} s)", flush=True)
        llff = {"llff_256": os.path.join(tmp, "llff"),
                "360": os.path.join(tmp, "llff_360"),
                "blender_256": os.path.join(tmp, "blender")}
        llff_blender_phase(torch, tmp, llff)
        done("17")
        import_phase(torch, tmp, scene, dev)
        done("18")
        mp_phase(torch, tmp, scene, dev)
        done("19")
        quality_phase(tmp)
        done("20")
        sweep_phase(torch, tmp, {
            "kubric": scene, "distractor": distractor, "photo": phototourism,
            "llff": llff["llff_256"], "llff_360": llff["360"],
            "blender": llff["blender_256"]})
        done("21")
        released_phase(torch, tmp, scene, dev)
        done("22")
        diagnose_phase(torch, os.path.join(tmp, "exp", "mip_nerfw"), dev)
        done("23")
    check_driven()
    accum_worst, accum_timings, accum_launches = accum_phase(torch, dev)
    check("jax" not in sys.modules, "jax was imported")
    check("nerf_hugs_tpu" not in sys.modules, "nerf_hugs_tpu was imported")

    field = timings["field"]
    mask = timings_2d[MASK_N]
    head = fused_timings[("field mlp_head", "bfloat16")]
    head_f32 = fused_timings[("field mlp_head", "float32")]
    acc = accum_timings[81]
    ipe_row = ipe_timings[(IPE_ROWS[0], "bfloat16")]
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
    ] + [
        {"name": f"ipe_{k}", "route": "cuda",
         "source": "nerf_hugs_torch/csrc/ipe.cu",
         "replaces": "none (XLA fuses nerf_hugs_tpu/core/coord.py:81)",
         "launches": ipe_launches[k],
         "max_abs_err": ipe_worst[k] if k == "fwd" else None,
         "max_rel_err": ipe_worst[k] if k == "bwd" else None,
         "ms": ipe_row[k],
         "plain_ms": ipe_row[f"{k}_plain"],
         "bound_ms": ipe_row[f"{k}_bound_ms"],
         "bound_by": ipe_row[f"{k}_bound_by"], "library_ms": None,
         "shapes": {f"{n}x{dt}": {"ms": t[k], "alone_ms": t[f"{k}_alone"],
                                  "plain_ms": t[f"{k}_plain"],
                                  "bound_ms": t[f"{k}_bound_ms"]}
                    for (n, dt), t in ipe_timings.items()}}
        for k in ("fwd", "bwd")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
