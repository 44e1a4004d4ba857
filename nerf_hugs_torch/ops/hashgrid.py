"""Multiresolution hash-grid encoding (instant-ngp), tcnn grid.h semantics.

Twin of nerf_hugs_tpu/ops/hashgrid.py. Semantics are tiny-cuda-nn's:
  * scale_l = base * g^l - 1, N_l = ceil(scale_l) + 1;
  * grid coordinate = x * scale_l + 0.5, trilinear weights from its
    fractional part;
  * per-level compact tables: min(N_l^d, 2^log2) rows rounded up to a
    multiple of 8; dense strides N_l^d (wrapped modulo the level size)
    while N_l^d fits the cap, else the xor hash (primes 1 / 2654435761 /
    805459861) or the additive variant (`hash_impl='add'`), masked to 2^log2.

Parameters are ONE flat fp32 table per encoding, the levels concatenated in
tcnn's order ([num_rows * F], feature-minor), so a kernel takes one pointer
and per-level row offsets. Features come out level-major, feature-minor:
[..., L*F].

On CUDA tensors the encode runs the hand-written kernels of
csrc/hashgrid.cu (forward here, table gradient in ops/hashgrid_bwd.py)
joined by one autograd.Function; on CPU tensors the same Function runs
their plain PyTorch versions. The kernels take d = 3 (the nerfacto fields)
and d = 2 (the HA-NeRF implicit mask); each wrapper counts the launches at
d = 3 and at d = 2 apart, in the counters `hashgrid_fwd.launches`,
`hashgrid_fwd.launches_2d`, `hashgrid_bwd.launches` and
`hashgrid_bwd.launches_2d` of utils/trace.py. What a spec derives
(scales, level sizes and offsets) is computed once per spec
(`grid_constants`), and what a launch needs of it (the C arguments, the
checks of the spec, the level table on each device) once more
(`kernel_spec`): a wrapper call pays only its tensor checks, an allocation
and the ctypes call, with the device and the stream read through
PyTorch's raw accessors (`kernels.on_device`, `kernels.current_stream`).
Positions get no gradient, as in the JAX custom VJP: every caller feeds
positions drawn without gradient.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from nerf_hugs_torch.ops import kernels
from nerf_hugs_torch.utils import trace

_PRIMES = (1, 2654435761, 805459861)
# The dims csrc/hashgrid.cu is instantiated for.
KERNEL_DIMS = (2, 3)


def level_scales(num_levels: int, base_res: int, max_res: int) -> np.ndarray:
    """tcnn's per-level grid scale: scale_l = base * growth^l - 1."""
    if num_levels == 1:
        growth = 1.0
    else:
        growth = np.exp((np.log(max_res) - np.log(base_res))
                        / (num_levels - 1))
    return (base_res * growth ** np.arange(num_levels) - 1.0).astype(
        np.float32)


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    num_dims: int = 3
    # 'xor' is tcnn-exact; 'add' is the additive hash of the *_addhash
    # configs. They are different functions of the same parameters.
    hash_impl: str = "xor"

    def __post_init__(self):
        if self.hash_impl not in ("xor", "add"):
            raise ValueError(f"hash_impl must be 'xor' or 'add', got "
                             f"{self.hash_impl!r}")

    @property
    def table_size(self) -> int:
        """Hashed-level table size (the 2^log2 cap)."""
        return 1 << self.log2_hashmap_size

    # What the levels derive from the fields, computed once per spec by
    # grid_constants (read-only arrays, shared by every caller).
    @property
    def scales(self) -> np.ndarray:
        """tcnn's per-level grid scale (float32)."""
        return grid_constants(self).scales

    @property
    def resolutions(self) -> np.ndarray:
        """tcnn's N_l = ceil(scale_l) + 1 (grid.h `grid_resolution`)."""
        return grid_constants(self).resolutions

    @property
    def level_sizes(self) -> np.ndarray:
        """Per-level rows: min(N_l^d, 2^log2) rounded up to a multiple of 8."""
        return grid_constants(self).level_sizes

    @property
    def level_offsets(self) -> np.ndarray:
        """First row of each level in the concatenated table (multiples
        of 8, since every level size is)."""
        return grid_constants(self).level_offsets

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def num_rows(self) -> int:
        return grid_constants(self).num_rows

    def corner_offsets(self) -> np.ndarray:
        """[2^d, d] binary corner offsets, dim 0 most significant."""
        d = self.num_dims
        return np.stack(np.meshgrid(*([np.arange(2)] * d), indexing="ij"),
                        axis=-1).reshape(-1, d)

    def dense_level(self) -> np.ndarray:
        """Per level: dense indexing while N_l^d entries fit the cap."""
        return grid_constants(self).dense

    def level_multipliers(self) -> np.ndarray:
        """[L, d] per-dim index multipliers: N_l^d on dense levels, the
        tcnn primes on hashed ones."""
        return grid_constants(self).multipliers


@dataclasses.dataclass(frozen=True, eq=False)
class GridConstants:
    """What a spec derives (`grid_constants`): the per-level arrays,
    read-only, and the sizes the wrappers and kernels take."""
    scales: np.ndarray          # [L] float32
    resolutions: np.ndarray     # [L] int64 N_l
    level_sizes: np.ndarray     # [L] int64 rows
    level_offsets: np.ndarray   # [L] int64 first rows
    dense: np.ndarray           # [L] bool
    multipliers: np.ndarray     # [L, d] int64
    num_rows: int
    hash_mask: int
    hash_add: int


@functools.lru_cache(maxsize=None)
def grid_constants(spec: HashGridSpec) -> GridConstants:
    """The spec's derived constants, computed once per spec (HashGridSpec
    is frozen and hashable) from one level_scales call: the kernels'
    wrappers read them at every launch."""
    scales = level_scales(spec.num_levels, spec.base_res, spec.max_res)
    res = (np.ceil(scales.astype(np.float64)) + 1).astype(np.int64)
    dense_size = res ** spec.num_dims
    dense = dense_size <= spec.table_size
    sizes = -(-np.minimum(dense_size, spec.table_size) // 8) * 8
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    mult = np.stack([np.where(dense, res ** d, _PRIMES[d % len(_PRIMES)])
                     for d in range(spec.num_dims)], -1).astype(np.int64)
    arrays = (scales, res, sizes, offsets, dense, mult)
    for a in arrays:
        a.setflags(write=False)
    return GridConstants(*arrays, num_rows=int(sizes.sum()),
                         hash_mask=spec.table_size - 1,
                         hash_add=int(spec.hash_impl == "add"))


def level_table(spec: HashGridSpec) -> np.ndarray:
    """[L, 8] int32 per-level constants for the kernels (csrc LevelRow):
    scale bits, three multipliers, rows, row offset, dense flag, pad."""
    if spec.num_dims not in KERNEL_DIMS:
        raise ValueError("the kernels take 2 or 3 dims")
    c = grid_constants(spec)
    tab = np.zeros((spec.num_levels, 8), np.uint32)
    tab[:, 0] = c.scales.astype(np.float32).view(np.uint32)
    tab[:, 1:1 + spec.num_dims] = c.multipliers % (1 << 32)
    tab[:, 4] = c.level_sizes
    tab[:, 5] = c.level_offsets
    tab[:, 6] = c.dense
    return tab.view(np.int32)


def corner_rows_level(spec: HashGridSpec, pos: torch.Tensor, lvl: int):
    """Level-local corner rows and trilinear weights of [n, d] positions:
    ([2^d, n] int64 in [0, T_l), [2^d, n] float32), in corner_offsets
    order. Integer math in int64 keeps the low 32 bits of tcnn's uint32
    products, which is all the mask or the dense wrap reads."""
    d_dims = spec.num_dims
    c = grid_constants(spec)
    x = pos * float(c.scales[lvl]) + 0.5
    x0f = torch.floor(x)
    frac = x - x0f
    x0 = x0f.long()
    mult = c.multipliers[lvl]
    dense = bool(c.dense[lvl])
    additive = dense or spec.hash_impl == "add"
    size = int(c.level_sizes[lvl])
    rows, weights = [], []
    for c in spec.corner_offsets():
        idx, w = None, None
        for d in range(d_dims):
            t = (x0[:, d] + int(c[d])) * int(mult[d])
            wd = frac[:, d] if c[d] else 1.0 - frac[:, d]
            if d == 0:
                idx, w = t, wd
            else:
                idx = idx + t if additive else torch.bitwise_xor(idx, t)
                w = w * wd
        if dense:
            idx = torch.where(idx >= size, idx - size, idx)
        else:
            idx = torch.bitwise_and(idx, spec.table_size - 1)
        rows.append(idx)
        weights.append(w)
    return torch.stack(rows), torch.stack(weights)


def hashgrid_encode_plain(table: torch.Tensor, positions: torch.Tensor,
                          spec: HashGridSpec) -> torch.Tensor:
    """Plain PyTorch encode: [..., d] positions in [0, 1] -> [..., L*F].

    Differentiable in the table through indexing; the corners accumulate
    in the kernel's order."""
    lead = positions.shape[:-1]
    pos = positions.reshape(-1, spec.num_dims)
    f = spec.features_per_level
    tab = table.view(-1, f)
    offsets = grid_constants(spec).level_offsets
    outs = []
    for lvl in range(spec.num_levels):
        rows, weights = corner_rows_level(spec, pos, lvl)
        acc = torch.zeros(pos.shape[0], f, dtype=table.dtype,
                          device=table.device)
        for c in range(rows.shape[0]):
            acc = acc + weights[c][:, None] * tab[rows[c] + int(offsets[lvl])]
        outs.append(acc)
    return torch.stack(outs, dim=1).reshape(lead + (spec.output_dim,))


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSpec:
    """What a launch needs of a spec the kernels take (`kernel_spec`,
    checked once per spec): the C entry points' spec arguments, the sizes
    the wrappers check, the launch counters, and the level table on each
    CUDA device, copied there at its first launch."""
    values: int          # table floats: num_rows * F
    num_levels: int
    num_dims: int
    hash_mask: int
    hash_add: int
    output_dim: int
    counters: Tuple[str, str]  # the forward's and the table gradient's
    levels: np.ndarray   # level_table(spec)
    level_tables: Dict[int, Tuple[torch.Tensor, int]]  # index: (t, ptr)

    def levels_on(self, index: int) -> int:
        """The device pointer of the level table on CUDA device `index`."""
        entry = self.level_tables.get(index)
        if entry is None:
            t = torch.from_numpy(self.levels).to(f"cuda:{index}")
            entry = self.level_tables[index] = (t, t.data_ptr())
        return entry[1]


@functools.lru_cache(maxsize=None)
def kernel_spec(spec: HashGridSpec) -> KernelSpec:
    """The launch constants of a spec the kernels take, checked once per
    spec; raises on one they do not."""
    if spec.features_per_level != 2:
        raise ValueError("the kernels take features_per_level == 2")
    if spec.num_dims not in KERNEL_DIMS:
        raise ValueError(f"the kernels take 2 or 3 dims, got "
                         f"{spec.num_dims}")
    c = grid_constants(spec)
    if c.num_rows >= 1 << 31:
        raise ValueError("table rows must fit int32")
    return KernelSpec(c.num_rows * 2, spec.num_levels, spec.num_dims,
                      c.hash_mask, c.hash_add, spec.output_dim,
                      launch_counters(spec.num_dims),
                      level_table(spec), {})


def check_devices(a_name: str, a: torch.Tensor, b_name: str,
                  b: torch.Tensor) -> int:
    """Both tensors on one CUDA device; returns its index."""
    index = a.get_device()
    if index < 0:
        raise ValueError(f"{a_name} must be a CUDA tensor with {b_name}")
    if b.get_device() != index:
        raise ValueError(f"{b_name} is on {b.device}, expected {a.device}")
    return index


def check_tensor(name: str, t: torch.Tensor, aligned: bool = False) -> int:
    """Dtype and contiguity checks of one kernel argument, and with
    `aligned` (the table, the table gradient: read or added as 16-byte row
    pairs, so a view from an odd row would fault on the card) its start on
    16 bytes; returns its data pointer."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    ptr = t.data_ptr()
    if aligned and ptr % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    return ptr


def launch_encode(lib, table: torch.Tensor, positions: torch.Tensor,
                  out: torch.Tensor, spec: HashGridSpec) -> None:
    """One call of a kernel library's `hashgrid_fwd` into `out`; raises on
    bad arguments or a launch error."""
    k = kernel_spec(spec)
    index = table.get_device()
    args = (check_tensor("table", table, True),
            check_tensor("positions", positions), check_tensor("out", out),
            positions.numel() // k.num_dims, k.num_levels, k.num_dims,
            k.hash_mask, k.hash_add, k.levels_on(index))
    with kernels.on_device(index):
        status = lib.hashgrid_fwd(*args, kernels.current_stream(index))
    kernels.check(status, "hashgrid_fwd")


def hashgrid_fwd(table: torch.Tensor, positions: torch.Tensor,
                 spec: HashGridSpec) -> torch.Tensor:
    """Encode without autograd: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not table.is_cuda and not positions.is_cuda:
        with torch.no_grad():
            return hashgrid_encode_plain(table, positions, spec)
    k = kernel_spec(spec)
    check_devices("table", table, "positions", positions)
    if table.numel() != k.values:
        raise ValueError(f"table has {table.numel()} values, spec needs "
                         f"{k.values}")
    if positions.shape[-1] != k.num_dims:
        raise ValueError(f"positions must end in {k.num_dims} dims")
    out = table.new_empty(positions.shape[:-1] + (k.output_dim,))
    launch_encode(kernels.load(), table, positions, out, spec)
    if out.numel():
        trace.count(k.counters[0])
    return out


def launch_counters(num_dims: int) -> Tuple[str, str]:
    """The counters of the forward's and the table gradient's launches at
    d = num_dims."""
    suffix = "launches_2d" if num_dims == 2 else "launches"
    return f"hashgrid_fwd.{suffix}", f"hashgrid_bwd.{suffix}"


class _HashGridEncode(torch.autograd.Function):
    """Forward kernel + table-gradient kernel; no position gradient."""

    @staticmethod
    def forward(ctx, table, positions, spec):
        ctx.spec = spec
        ctx.save_for_backward(positions)
        return hashgrid_fwd(table, positions, spec)

    @staticmethod
    def backward(ctx, grad):
        from nerf_hugs_torch.ops import hashgrid_bwd
        (positions,) = ctx.saved_tensors
        grad_table = hashgrid_bwd.hashgrid_table_grad(
            positions, grad.contiguous(), ctx.spec)
        return grad_table, None, None


def hashgrid_encode(table: torch.Tensor, positions: torch.Tensor,
                    spec: HashGridSpec) -> torch.Tensor:
    """Encode [..., d] positions in [0, 1]^d -> [..., L*F] features, with
    the table gradient from the scatter kernel (or its plain version)."""
    return _HashGridEncode.apply(table, positions, spec)


class HashGridEncoding(nn.Module):
    """Owns one flat table parameter, uniform(-1e-4, 1e-4) like tcnn."""

    def __init__(self, spec: HashGridSpec, generator: torch.Generator):
        super().__init__()
        self.spec = spec
        self.table = nn.Parameter(
            torch.empty(spec.num_rows * spec.features_per_level).uniform_(
                -1e-4, 1e-4, generator=generator))

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return hashgrid_encode(self.table, positions, self.spec)
