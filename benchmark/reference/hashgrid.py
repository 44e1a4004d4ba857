"""A plain multiresolution hash encoding (instant-ngp, tiny-cuda-nn's
grid.h semantics), and the rows a set of positions touches.

Per level l: scale_l = base * g^l - 1 with g = (max / base)^(1/(L-1)),
N_l = ceil(scale_l) + 1; the grid coordinate is x * scale_l + 0.5 and
the trilinear weights come from its fractional part. A level holds
min(N_l^d, 2^log2) rows rounded up to a multiple of 8: dense strides
N_l^d (wrapped by the level's size) while N_l^d fits, else the xor of the
coordinates times the primes (1, 2654435761, 805459861) masked to 2^log2.
The levels' tables sit one after another in one flat float32 parameter
([rows * F], feature-minor); features come out level-major. Positions
take no gradient (they are sampled without one).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class Grid:
    num_levels: int
    features_per_level: int
    log2_hashmap_size: int
    base_res: int
    max_res: int
    num_dims: int = 3

    @property
    def scales(self) -> np.ndarray:
        if self.num_levels == 1:
            growth = 1.0
        else:
            growth = np.exp((np.log(self.max_res) - np.log(self.base_res))
                            / (self.num_levels - 1))
        return (self.base_res * growth ** np.arange(self.num_levels)
                - 1.0).astype(np.float32)

    @property
    def resolutions(self) -> np.ndarray:
        return (np.ceil(self.scales.astype(np.float64)) + 1).astype(np.int64)

    @property
    def dense(self) -> np.ndarray:
        return self.resolutions ** self.num_dims <= (1 << self.log2_hashmap_size)

    @property
    def level_sizes(self) -> np.ndarray:
        n = np.minimum(self.resolutions ** self.num_dims,
                       1 << self.log2_hashmap_size)
        return -(-n // 8) * 8

    @property
    def level_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.level_sizes)[:-1]])

    @property
    def num_rows(self) -> int:
        return int(self.level_sizes.sum())

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level


def corners(grid: Grid, pos: torch.Tensor, lvl: int):
    """([2^d, n] level-local rows, [2^d, n] trilinear weights) of [n, d]
    positions at level lvl; integer products in int64 keep the low 32 bits
    of the uint32 arithmetic, all that the mask or the wrap reads."""
    d = grid.num_dims
    x = pos * float(grid.scales[lvl]) + 0.5
    x0f = torch.floor(x)
    frac = x - x0f
    x0 = x0f.long()
    dense = bool(grid.dense[lvl])
    res = int(grid.resolutions[lvl])
    size = int(grid.level_sizes[lvl])
    mult = [res ** i if dense else PRIMES[i] for i in range(d)]
    rows, weights = [], []
    for c in np.stack(np.meshgrid(*([np.arange(2)] * d), indexing="ij"),
                      -1).reshape(-1, d):
        idx = w = None
        for i in range(d):
            t = (x0[:, i] + int(c[i])) * mult[i]
            wi = frac[:, i] if c[i] else 1.0 - frac[:, i]
            if i == 0:
                idx, w = t, wi
            else:
                idx = idx + t if dense else torch.bitwise_xor(idx, t)
                w = w * wi
        if dense:
            idx = torch.where(idx >= size, idx - size, idx)
        else:
            idx = torch.bitwise_and(idx, (1 << grid.log2_hashmap_size) - 1)
        rows.append(idx)
        weights.append(w)
    return torch.stack(rows), torch.stack(weights)


def _level_rows(grid: Grid, pos: torch.Tensor):
    """[(table rows [2^d, n], weights [2^d, n])] of every level."""
    out = []
    for lvl in range(grid.num_levels):
        rows, weights = corners(grid, pos, lvl)
        out.append((rows + int(grid.level_offsets[lvl]), weights))
    return out


class _Encode(torch.autograd.Function):
    """The weighted gathers; the table's gradient is their transpose, the
    weighted rows added into a zeroed table (index_add_)."""

    @staticmethod
    def forward(ctx, table, pos, grid):
        f = grid.features_per_level
        tab = table.view(-1, f)
        feats = [(w[..., None] * tab[rows]).sum(0)
                 for rows, w in _level_rows(grid, pos)]
        ctx.grid = grid
        ctx.save_for_backward(pos)
        ctx.rows = table.numel() // f
        return torch.stack(feats, dim=1).reshape(pos.shape[0], -1)

    @staticmethod
    def backward(ctx, grad):
        (pos,) = ctx.saved_tensors
        grid = ctx.grid
        f = grid.features_per_level
        g = grad.reshape(pos.shape[0], grid.num_levels, f).float()
        out = torch.zeros(ctx.rows, f, dtype=torch.float32, device=pos.device)
        for lvl, (rows, w) in enumerate(_level_rows(grid, pos)):
            out.index_add_(0, rows.reshape(-1),
                           (w[..., None] * g[None, :, lvl]).reshape(-1, f))
        return out.reshape(-1), None, None


def encode(grid: Grid, table: torch.Tensor, positions: torch.Tensor
           ) -> torch.Tensor:
    """[..., d] positions in [0, 1] -> [..., L * F] features, with the
    table's gradient (positions take none)."""
    lead = positions.shape[:-1]
    pos = positions.reshape(-1, grid.num_dims).detach()
    return _Encode.apply(table, pos, grid).reshape(lead + (grid.output_dim,))


def rows_touched(grid: Grid, positions: torch.Tensor) -> int:
    """The number of distinct table rows the corners of `positions`
    read."""
    pos = positions.reshape(-1, grid.num_dims)
    total = 0
    for lvl in range(grid.num_levels):
        rows, _ = corners(grid, pos, lvl)
        total += int(torch.unique(rows).numel())
    return total
