"""Fused bias-free ReLU MLP (tiny-cuda-nn FullyFusedMLP semantics).

Twin of nerf_hugs_tpu/ops/fused_mlp.py. x @ W0 -> relu -> ... -> @ W_{L-1},
the last layer linear and no layer with a bias, accumulated in fp32 and
rounded to x's dtype after every layer; that per-layer rounding is part of
the semantics.

On CUDA tensors the forward is a hand-written kernel of csrc/fused_mlp.cu,
which keeps the hidden activations on chip; on CPU tensors it is the plain
version below. The C entry point routes by dtype and widths alone. In bf16,
where `resident_plan` fits (every MLP of the shipped configs) the resident
kernel (weights held in shared memory for the whole launch, wgmma,
activations in registers) reads the weights as they are; elsewhere the
streamed kernel reads the zero-padded copies of `streamed_weights`. In
fp32 one kernel (exact FMAs on 8x8 register tiles, one activation buffer
updated in place) reads the weights as they are, holding in shared memory
the layers `f32_plan` makes resident and streaming the rest. The wrapper
counts every launch (`fused_mlp_fwd.launches`) and each kernel's
(`fused_mlp_fwd.launches_resident`, `.launches_streamed`, `.launches_f32`)
in utils/trace.py's counters. The backward recomputes the
activations and runs plain matmuls, line for line the JAX custom VJP
(`_fused_mlp_bwd`), which computes it with XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from nerf_hugs_torch.ops import kernels
from nerf_hugs_torch.utils import trace

MAX_WIDTH = 256   # csrc/fused_mlp.cu kMaxWidth
MAX_LAYERS = 8    # csrc/fused_mlp.cu kMaxLayers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The resident kernel's plan (csrc/fused_mlp.cu make_resident_plan).
SMEM_BUDGET = 232448   # kSmemBudget: the shared memory a block may have
MAX_STAGES = 8         # kMaxStages: input tiles in flight per warpgroup
# The fp32 kernel's plan (csrc/fused_mlp.cu make_f32_plan).
F32_SLICE = 32         # kSliceF32: weight rows of a streamed slice
F32_MAX_ROWS = 256     # kMaxRowsF32
HALF_SMEM = 115712     # kHalfSmem: shared memory of one of two blocks an SM


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


def _cover_width(d: int, last: bool) -> int:
    """Columns a layer's products cover (csrc/fused_mlp.cu cover_width):
    64-column chunks, the last 8, 16, 32 or 64 wide."""
    n_pad = _round_up(d, 8 if last else 16)
    full = n_pad // 64 * 64
    r = n_pad - full
    return full + next((c for c in (0, 8, 16, 32, 64) if r <= c))


def resident_plan(dims: Sequence[int]) -> Optional[dict]:
    """The resident bf16 kernel's shared-memory plan for layer widths
    `dims`, or None where the padded weights, each warpgroup's output tile
    and one input slot do not fit SMEM_BUDGET: those widths take the
    streamed kernel. The rule of csrc/fused_mlp.cu make_resident_plan.
    Cached per widths (every forward asks); do not modify the result."""
    return _resident_plan(tuple(dims))


@functools.lru_cache(maxsize=None)
def _resident_plan(dims: Tuple[int, ...]) -> Optional[dict]:
    layers = len(dims) - 1
    k_pad = [_round_up(d, 16) for d in dims[:-1]]
    n_cov = [_cover_width(d, i == layers - 1) for i, d in enumerate(dims[1:])]
    weight_bytes = sum(2 * k * c for k, c in zip(k_pad, n_cov))
    # The last hidden layer feeds the output layer chunk by chunk where the
    # output's sums fit a thread (72 columns) and every other layer's input
    # fits 64-wide fragment arrays.
    fused = layers >= 2 and n_cov[-1] <= 72 and max(k_pad[:-1]) <= 64
    max_k = 64 if max(k_pad[:layers - fused]) <= 64 else 256
    out_regs = 0 if not fused else 36 if n_cov[-1] > 8 else 4
    tile_in = 128 * dims[0] + 16
    out_bytes = 128 * dims[-1]
    for wgs in range(2 if max_k == 256 else 4, 0, -1):
        avail = SMEM_BUDGET - weight_bytes - wgs * out_bytes
        stages = min(max(avail, 0) // (wgs * tile_in), MAX_STAGES)
        if stages >= 1:
            return {"k_pad": k_pad, "n_cov": n_cov,
                    "full_layers": layers - 1 - fused,
                    "weight_bytes": weight_bytes, "max_k": max_k,
                    "out_regs": out_regs, "wgs": wgs, "stages": stages,
                    "tile_in_bytes": tile_in, "out_bytes": out_bytes,
                    "smem_bytes": weight_bytes
                    + wgs * (stages * tile_in + out_bytes)}
    return None


def is_resident(dtype: torch.dtype, dims: Sequence[int]) -> bool:
    """Whether the C entry point runs these widths on the resident bf16
    kernel."""
    return dtype == torch.bfloat16 and resident_plan(dims) is not None


def f32_plan(dims: Sequence[int]) -> dict:
    """The fp32 kernel's plan for layer widths `dims`: the threads of a
    block and the blocks an SM (256 threads two or one an SM where every
    layer stays resident in shared memory; 512 where layers stream through
    a two-stage ring of 32-row slices), the row tile (at most 64 sums a
    thread at the widest layer), which layers stay resident, and the
    shared bytes. The rule of csrc/fused_mlp.cu make_f32_plan. Cached per
    widths; do not modify the result."""
    return _f32_plan(tuple(dims))


@functools.lru_cache(maxsize=None)
def _f32_plan(dims: Tuple[int, ...]) -> dict:
    k_pad = [_round_up(d, 4) for d in dims[:-1]]
    n_cov = [_round_up(d, 8) for d in dims[1:]]
    w_bytes = [4 * k * c for k, c in zip(k_pad, n_cov)]
    astride = _round_up(max(dims), 4) + 4
    act = lambda m: 4 * m * astride
    top = lambda threads: min(64 * threads // max(n_cov) // 8 * 8,
                              F32_MAX_ROWS)

    def plan(threads, rows, bps, resident, ring_stage):
        return {"threads": threads, "rows": rows, "blocks_per_sm": bps,
                "resident": resident, "k_pad": k_pad, "n_cov": n_cov,
                "astride": astride, "ring_stage": ring_stage,
                "smem_bytes": sum(b for b, r in zip(w_bytes, resident) if r)
                + act(rows) + 2 * ring_stage,
                "slices": sum(-(-k // F32_SLICE) for k, r
                              in zip(k_pad, resident) if not r)}

    # Every layer resident: 256 threads, two blocks an SM with the tile
    # down to half of the tallest, else one block at any height.
    m = top(256)
    while m >= 8 and 2 * m >= top(256):
        if sum(w_bytes) + act(m) <= HALF_SMEM:
            return plan(256, m, 2, [True] * len(k_pad), 0)
        m = m // 2 // 8 * 8
    m = top(256)
    while m >= 8:
        if sum(w_bytes) + act(m) <= SMEM_BUDGET:
            return plan(256, m, 1, [True] * len(k_pad), 0)
        m = m // 2 // 8 * 8
    ring = 2 * F32_SLICE * max(n_cov) * 4
    m = top(512)
    while m > 8 and act(m) + ring > SMEM_BUDGET:
        m = m // 2 // 8 * 8
    resident, off = [], 0
    for b in w_bytes:
        resident.append(off + b + act(m) + ring <= SMEM_BUDGET)
        off += b if resident[-1] else 0
    stage = F32_SLICE * 4 * max((c for c, r in zip(n_cov, resident)
                                 if not r), default=0)
    return plan(512, m, 1, resident, stage)


def streamed_weights(weights: Sequence[torch.Tensor]) -> list:
    """Zero-padded copies of bf16 weights in the streamed bf16 kernel's
    slice layout (csrc/fused_mlp.cu Mlp::w): W^T as [round_up(d_out, 64),
    round_up(d_in, 64)], so every weight slice it copies is whole."""
    out = []
    for w in weights:
        k, n = w.shape
        p = w.new_zeros(_round_up(n, 64), _round_up(k, 64))
        p[:n, :k] = w.t()
        out.append(p)
    return out


def kernel_weights(weights: Sequence[torch.Tensor]) -> list:
    """The weights as the C entry point reads them for their widths and
    dtype: as the caller holds them, [d_in, d_out] with no copy, on the
    fp32 and the resident bf16 kernels; `streamed_weights` on the streamed
    bf16 kernel."""
    dims = [w.shape[0] for w in weights] + [weights[-1].shape[1]]
    if weights[0].dtype == torch.bfloat16 and not is_resident(
            torch.bfloat16, dims):
        return streamed_weights(weights)
    return list(weights)


def launch(lib, x: torch.Tensor, kernel_ws: Sequence[torch.Tensor],
           dims: Sequence[int], out: torch.Tensor) -> None:
    """One call of `lib`'s fused_mlp_fwd on x's stream, with the weights
    already in the layout it reads (`kernel_weights`); raises on a nonzero
    status."""
    ptrs = (ctypes.c_void_p * len(kernel_ws))(
        *[w.data_ptr() for w in kernel_ws])
    dims_c = (ctypes.c_int32 * len(dims))(*dims)
    index = x.get_device()
    with kernels.on_device(index):
        status = lib.fused_mlp_fwd(
            x.data_ptr(), ptrs, dims_c, len(kernel_ws), x.shape[0],
            out.data_ptr(), _DTYPE_CODES[x.dtype],
            kernels.current_stream(index))
    kernels.check(status, "fused_mlp_fwd")


def fused_mlp_fwd(x: torch.Tensor, weights: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """The forward without autograd: a CUDA kernel for CUDA tensors, the
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
    launch(kernels.load(), x, kernel_weights(weights), dims, out)
    trace.count("fused_mlp_fwd.launches")
    if x.dtype == torch.float32:
        trace.count("fused_mlp_fwd.launches_f32")
    elif is_resident(x.dtype, dims):
        trace.count("fused_mlp_fwd.launches_resident")
    else:
        trace.count("fused_mlp_fwd.launches_streamed")
    return out


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
