"""nerf_hugs_torch: the PyTorch + CUDA port of nerf_hugs_tpu for NVIDIA Hopper.

The JAX package (`nerf_hugs_tpu`) stays the numerical reference; this package
mirrors its layout module by module and imports nothing of jax or of the JAX
package (it keeps its own copies of the jax-free modules it needs). Ported so
far, in the yaml dialect on the procedural `synthetic` scene: the nerfacto
train step, eval and scoring, and the dense-level forward microbenchmark.

Layout:
  core/      ray math on tensors: step functions, warps, volume rendering
  ops/       hash-grid encode, fused MLP, planar accumulate (hand-written
             CUDA kernels + plain versions), SH
  csrc/      CUDA C++ sources, built with nvcc at first use
  cameras/   numpy pixel->ray casting
  data/      host-side ray-batch producer (prefetch thread, native sampler)
  models/    nerfacto fields + proposal sampling; flax->torch weight converter
  losses/    data / interlevel / distortion losses
  train/     Adam, train step, checkpoints, chunked render, the `train` driver
  eval/      the `eval` driver
  metrics/   PSNR, SSIM, LPIPS, colour correction, the scoring CLI
  configs/   the config tree and the nerfacto yaml loader
  native/    the threaded ray sampler's C++ source (g++, ctypes)
  tools/     microbenchmarks (`bench_fwd_copies`)
  utils/     batch dataclasses, device and precision setup, image IO, run log
"""
