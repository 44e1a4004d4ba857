"""Fused bias-free ReLU MLP (tiny-cuda-nn FullyFusedMLP semantics).

Twin of nerf_hugs_tpu/ops/fused_mlp.py. x @ W0 -> relu -> ... -> @ W_{L-1},
the last layer linear and no layer with a bias, accumulated in fp32 and
rounded to x's dtype after every layer; that per-layer rounding is part of
the semantics.

On CUDA tensors the forward is the hand-written kernel of
csrc/fused_mlp.cu, which keeps the hidden activations on chip; on CPU
tensors it is the plain version below. The backward recomputes the
activations and runs plain matmuls, line for line the JAX custom VJP
(`_fused_mlp_bwd`), which computes it with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from nerf_hugs_torch.ops import kernels

MAX_WIDTH = 256   # csrc/fused_mlp.cu kMaxWidth
MAX_LAYERS = 8    # csrc/fused_mlp.cu kMaxLayers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlp_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """Plain PyTorch forward: fp32 products, ReLU on every layer but the
    last, the result rounded to x.dtype after every layer."""
    h = x
    for i, w in enumerate(weights):
        h = h.float() @ w.float()
        if i < len(weights) - 1:
            h = torch.relu(h)
        h = h.to(x.dtype)
    return h


def _check_kernel_args(x: torch.Tensor, weights: Sequence[torch.Tensor]):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [n, d_in] tensor")
    if not 1 <= len(weights) <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1..{MAX_LAYERS} layers")
    d = x.shape[1]
    for i, w in enumerate(weights):
        if w.device != x.device or w.dtype != x.dtype:
            raise ValueError(f"weight {i} is {w.dtype} on {w.device}; x is "
                             f"{x.dtype} on {x.device}")
        if w.dim() != 2 or w.shape[0] != d or not w.is_contiguous():
            raise ValueError(f"weight {i} must be a contiguous [{d}, d_out] "
                             f"tensor, got {tuple(w.shape)}")
        d = w.shape[1]
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    if not all(1 <= k <= MAX_WIDTH for k in dims):
        raise ValueError(f"the kernel takes widths 1..{MAX_WIDTH}, got {dims}")
    return dims


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_weights(weights: Sequence[torch.Tensor]) -> list:
    """Zero-padded copies of the weights in the kernel's slice layout
    (csrc/fused_mlp.cu Mlp::w): bf16 W^T as [round_up(d_out, 64),
    round_up(d_in, 64)], fp32 W as [round_up(d_in, 32), round_up(d_out,
    64)], so every weight slice the kernel copies is whole."""
    out = []
    for w in weights:
        k, n = w.shape
        if w.dtype == torch.bfloat16:
            p = w.new_zeros(_round_up(n, 64), _round_up(k, 64))
            p[:n, :k] = w.t()
        else:
            p = w.new_zeros(_round_up(k, 32), _round_up(n, 64))
            p[:k, :n] = w
        out.append(p)
    return out


def fused_mlp_fwd(x: torch.Tensor, weights: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """The forward without autograd: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if not x.is_cuda and not any(w.is_cuda for w in weights):
        with torch.no_grad():
            return fused_mlp_plain(x, weights)
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor with the weights")
    dims = _check_kernel_args(x, weights)
    n = x.shape[0]
    out = torch.empty((n, dims[-1]), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = kernels.load()
    padded = kernel_weights(weights)
    ptrs = (ctypes.c_void_p * len(padded))(*[w.data_ptr() for w in padded])
    dims_c = (ctypes.c_int32 * len(dims))(*dims)
    with torch.cuda.device(x.device):
        status = lib.fused_mlp_fwd(
            x.data_ptr(), ptrs, dims_c, len(weights), n, out.data_ptr(),
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
    kernels.check(status, "fused_mlp_fwd")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


class _FusedMLP(torch.autograd.Function):
    """Kernel (or plain) forward; the JAX custom VJP's backward."""

    @staticmethod
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return fused_mlp_fwd(x, weights)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        # Recompute the activations, rounded to x.dtype as in the forward.
        acts = [x]
        h = x
        for w in weights[:-1]:
            h = torch.relu(h.float() @ w.float()).to(x.dtype)
            acts.append(h)
        grads_w = [None] * len(weights)
        dh = g.float()
        for i in reversed(range(len(weights))):
            grads_w[i] = (acts[i].float().t() @ dh).to(weights[i].dtype)
            dh = dh @ weights[i].float().t()
            if i > 0:
                dh = dh * (acts[i] > 0)
        return (dh.to(x.dtype), *grads_w)


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """relu-MLP x @ W0 ... @ W_{L-1} of x [n, d_in] and weights
    [d_i, d_{i+1}], differentiable in x and every weight."""
    return _FusedMLP.apply(x, *weights)


class FusedMLP:
    """Init + apply for the fused path, the JAX `FusedMLP` helper."""

    def __init__(self, layer_dims: Sequence[int]):
        self.layer_dims = tuple(layer_dims)

    def init(self, generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
        """fp32 [d_i, d_{i+1}] weights, he_uniform: uniform(+-sqrt(6 /
        fan_in)), drawn on the CPU from `generator`."""
        dims = self.layer_dims
        return tuple(
            torch.empty(dims[i], dims[i + 1]).uniform_(
                -math.sqrt(6.0 / dims[i]), math.sqrt(6.0 / dims[i]),
                generator=generator)
            for i in range(len(dims) - 1))

    def __call__(self, weights, x):
        return fused_mlp(x, tuple(weights))
