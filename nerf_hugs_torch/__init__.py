"""nerf_hugs_torch: the PyTorch + CUDA port of nerf_hugs_tpu for NVIDIA Hopper.

The JAX package (`nerf_hugs_tpu`) stays the numerical reference; this package
mirrors its layout module by module and imports nothing of jax or of the JAX
package (it keeps its own copies of the jax-free modules it needs). Ported so
far, in the yaml dialect on the `kubric`, `distractor` and `phototourism`
loaders and the procedural `synthetic` and `synthetic_distractor` scenes:
the nerfacto train step with appearance and transient embeddings and the
whole transient zoo (withmask, RobustNeRF, NeRF-W, HA-NeRF), the finetune
stage, eval and scoring, the dense-level forward microbenchmark, and HuGS
static-mask generation with SAM.

Layout:
  core/      ray math on tensors: step functions, warps, volume rendering
  ops/       hash-grid encode, fused MLP, planar accumulate (hand-written
             CUDA kernels + plain versions), SH
  csrc/      CUDA C++ sources, built with nvcc at first use
  cameras/   the COLMAP reader and scene manager, pose alignment, numpy
             pixel->ray casting with lens distortion and fisheye cameras
  data/      host-side ray-batch producer (prefetch thread, native sampler),
             the kubric, distractor, phototourism and synthetic loaders
  models/    nerfacto fields + proposal sampling, embeddings, HA-NeRF's
             implicit mask, NeRF-W's transient head; flax->torch weight
             converter
  losses/    data / RobustNeRF / NeRF-W / HA-NeRF / interlevel / distortion
             losses
  train/     Adam, the finetune partition, train step, checkpoints, chunked
             render, the two-stage `train` driver
  eval/      the `eval` driver
  metrics/   PSNR, SSIM, LPIPS, colour correction, the scoring CLI
  hugs/      HuGS: SAM (ViT encoder, prompt encoder, mask decoder, official
             weights, predictor, automatic mask generator), the heuristics
             and the static-mask CLI (`python -m nerf_hugs_torch.hugs`)
  configs/   the config tree, the nerfacto yaml loader and the config.gin
             snapshot
  native/    the threaded ray sampler's C++ source (g++, ctypes)
  tools/     microbenchmarks (`bench_fwd_copies`, `bench_hashgrid`,
             `bench_fused_mlp`, `bench_sam`) and their inputs
             (`hashgrid_inputs`: grids, configs, scene writers in the
             kubric, distractor and phototourism layouts)
  utils/     batch dataclasses, device and precision setup, image IO, run log
"""
