"""nerf_hugs_torch: the PyTorch + CUDA port of nerf_hugs_tpu for NVIDIA Hopper.

The JAX package (`nerf_hugs_tpu`) stays the numerical reference; this package
mirrors its layout module by module and imports nothing of jax or of the JAX
package (it keeps its own copies of the jax-free modules it needs). Ported,
on the `kubric`, `distractor`, `phototourism`, `llff` and `blender`
loaders and the procedural `synthetic`, `synthetic_distractor` and
`synthetic_appearance` scenes: the three backbones (nerfacto, vanilla NeRF
and Mip-NeRF 360) in both config dialects with their embeddings and the
whole transient zoo (withmask, RobustNeRF, NeRF-W, HA-NeRF), the finetune
stage, eval and scoring, the render driver with its camera paths, the
dense-level forward microbenchmark, and HuGS static-mask generation with
SAM.

Layout:
  core/      ray math on tensors: step functions, warps, volume rendering;
             ray-box and ray-sphere intersections (numpy)
  ops/       hash-grid encode, fused MLP, planar accumulate (hand-written
             CUDA kernels + plain versions), SH
  csrc/      CUDA C++ sources, built with nvcc at first use
  cameras/   the COLMAP reader and scene manager, pose alignment, render
             paths, numpy pixel->ray casting with lens distortion, fisheye
             cameras and NDC
  data/      host-side ray-batch producer (prefetch thread, native sampler,
             render paths, near/far clipping), the kubric, distractor,
             phototourism, llff, blender and synthetic loaders
  models/    nerfacto fields + proposal sampling, vanilla NeRF's coarse and
             fine MLPs, Mip-NeRF 360's PosEnc MLPs + proposal sampling,
             embeddings, HA-NeRF's implicit masks, NeRF-W's transient
             heads; flax->torch weight converter
  losses/    data / RobustNeRF / NeRF-W / HA-NeRF / interlevel / distortion
             losses
  train/     Adam, the finetune partition, train step, checkpoints, chunked
             render, the two-stage `train` driver
  eval/      the `eval` driver
  render/    the `render` driver (test split or camera path, sharded jobs,
             videos with ffmpeg)
  metrics/   PSNR, SSIM, LPIPS, colour correction, the scoring CLI
  hugs/      HuGS: SAM (ViT encoder, prompt encoder, mask decoder, official
             weights, predictor, automatic mask generator), the heuristics
             and the static-mask CLI (`python -m nerf_hugs_torch.hugs`)
  configs/   the config tree, the nerfacto yaml loader, the gin parser and
             the config.gin snapshot
  native/    the threaded ray sampler's C++ source (g++, ctypes)
  tools/     microbenchmarks (`bench_fwd_copies`, `bench_hashgrid`,
             `bench_fused_mlp`, `bench_sam`) and their inputs
             (`hashgrid_inputs`: grids, configs, scene writers in the
             kubric, distractor, phototourism, llff and blender layouts)
  utils/     batch dataclasses, device and precision setup, image IO, run log
"""
