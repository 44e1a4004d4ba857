"""nerf_hugs_torch: the PyTorch + CUDA port of nerf_hugs_tpu for NVIDIA Hopper.

The JAX package (`nerf_hugs_tpu`) stays the numerical reference; this package
mirrors its layout module by module and never imports jax. Ported so far:
the nerfacto train step (yaml dialect) on the procedural `synthetic` scene.

Layout:
  core/      ray math on tensors: step functions, warps, volume rendering
  ops/       hash-grid encode (hand-written CUDA kernels + plain versions), SH
  csrc/      CUDA C++ sources, built with nvcc at first use
  cameras/   numpy pixel->ray casting
  data/      host-side ray-batch producer (prefetch thread, native sampler)
  models/    nerfacto fields + proposal sampling; flax->torch weight converter
  losses/    data / interlevel / distortion losses
  train/     Adam, train step, checkpoints, chunked render, the `train` driver
  utils/     batch dataclasses, device and precision setup
"""
