"""Hash-grid table gradient: a scatter-add of weighted corner contributions.

Twin of nerf_hugs_tpu/ops/hashgrid_bwd.py, which sorts the 2^d * n corner
entries by row and segment-sums them with one-hot matmuls, a TPU
workaround for its slow scatter. Here the CUDA kernel (csrc/hashgrid.cu,
`hashgrid_bwd`) recomputes each sample's corner rows and weights from the
positions and adds w * dL/dfeature into the fp32 gradient: level-major, with
a warp's same-cell payloads summed before one float2 atomic, a float4 atomic
for an aligned pair of x-corner rows, and nothing issued for a zero
dL/dfeature. At d = 2 a block takes a span of samples at one level and sums
the coarse dense levels in shared memory, one atomic per row pair a block.
The plain version does the same with `index_add_`.

The payload stays fp32: this is the JAX package's `bwd_dtype='float32'`
mode, not its bf16 default (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import torch

from nerf_hugs_torch.ops import kernels
from nerf_hugs_torch.ops.hashgrid import (HashGridSpec, check_devices,
                                          check_tensor, corner_rows_level,
                                          grid_constants, kernel_spec)
from nerf_hugs_torch.utils import trace


def hashgrid_table_grad_plain(positions: torch.Tensor, grad_out: torch.Tensor,
                              spec: HashGridSpec) -> torch.Tensor:
    """Plain PyTorch table gradient: [..., d] positions and [..., L*F]
    output gradients -> flat [num_rows * F] table gradient."""
    f = spec.features_per_level
    pos = positions.reshape(-1, spec.num_dims)
    g = grad_out.reshape(-1, spec.num_levels, f).float()
    constants = grid_constants(spec)
    out = torch.zeros(constants.num_rows, f, dtype=torch.float32,
                      device=positions.device)
    offsets = constants.level_offsets
    for lvl in range(spec.num_levels):
        rows, weights = corner_rows_level(spec, pos, lvl)        # [2^d, n]
        vals = weights[..., None] * g[None, :, lvl, :]           # [2^d, n, F]
        out.index_add_(0, (rows + int(offsets[lvl])).reshape(-1),
                       vals.reshape(-1, f))
    return out.reshape(-1)


def launch_table_grad(lib, positions: torch.Tensor, grad_out: torch.Tensor,
                      grad_table: torch.Tensor, spec: HashGridSpec) -> None:
    """One call of a kernel library's `hashgrid_bwd`, adding into the zeroed
    `grad_table`; raises on bad arguments or a launch error."""
    k = kernel_spec(spec)
    index = positions.get_device()
    args = (check_tensor("positions", positions),
            check_tensor("grad_out", grad_out),
            check_tensor("grad_table", grad_table, True),
            positions.numel() // k.num_dims, k.num_levels, k.num_dims,
            k.hash_mask, k.hash_add, k.levels_on(index))
    with kernels.on_device(index):
        status = lib.hashgrid_bwd(*args, kernels.current_stream(index))
    kernels.check(status, "hashgrid_bwd")


def hashgrid_table_grad(positions: torch.Tensor, grad_out: torch.Tensor,
                        spec: HashGridSpec) -> torch.Tensor:
    """Table gradient: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not positions.is_cuda and not grad_out.is_cuda:
        return hashgrid_table_grad_plain(positions, grad_out, spec)
    k = kernel_spec(spec)
    check_devices("positions", positions, "grad_out", grad_out)
    n = positions.numel() // k.num_dims
    if positions.shape[-1] != k.num_dims \
            or grad_out.numel() != n * k.output_dim:
        raise ValueError(f"positions {tuple(positions.shape)} and grad_out "
                         f"{tuple(grad_out.shape)} do not match the spec")
    # Whole: the kernel adds into every row.
    grad_table = positions.new_zeros(k.values)
    launch_table_grad(kernels.load(), positions, grad_out, grad_table, spec)
    if n:
        trace.count(k.counters[1])
    return grad_table
