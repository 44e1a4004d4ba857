"""The 2-D encode and table gradient through nerf_hugs_torch's hash-grid
launch path.

The launch path (`launch_encode`, `launch_table_grad`: the spec's launch
constants from `kernel_spec`, the tensor and device checks, the level
table, the current device and stream) runs only for CUDA tensors. Here it
is driven with CPU tensors and a stand-in library that does what the C
entry points do with the arguments they are given (the level table's scale
bits, multipliers, sizes, offsets and dense flags, the hash mask and
mode), and its results are held against the JAX package.
"""

import contextlib
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_hashgrid2d import N, SPECS
from test_torch_port_ops import FWD_TOL, GRAD_TOL, positions, tables

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_tpu.ops import hashgrid as jhg
from nerf_hugs_torch.ops import hashgrid as thg
from nerf_hugs_torch.ops import hashgrid_bwd as tbwd


class StandIn:
    """A kernel library whose entry points compute, in numpy, what the C
    entry points compute from the arguments they are given. Tensors are
    found by their data pointers, as the C side takes them."""

    def __init__(self, *tensors):
        self.by_ptr = {}
        self.calls = []
        self.register(*tensors)

    def register(self, *tensors):
        for t in tensors:
            self.by_ptr[t.data_ptr()] = t

    def corners(self, pos, levels, lvl, mask, add):
        """([2^d, n] level rows, [2^d, n] weights) from one level-table
        row, for [n, d] positions."""
        dims = pos.shape[1]
        row = levels[lvl].view(np.uint32)
        scale = row[0:1].view(np.float32)[0]
        mult = row[1:1 + dims].astype(np.uint64)
        size, dense = int(row[4]), bool(row[6])
        x = pos * scale + np.float32(0.5)
        x0 = np.floor(x)
        frac = (x - x0).astype(np.float32)
        x0 = x0.astype(np.uint64)
        rows, weights = [], []
        for c in itertools.product((0, 1), repeat=dims):
            t = [((x0[:, d] + c[d]) * mult[d]) & 0xffffffff
                 for d in range(dims)]
            idx = functools.reduce(
                (lambda a, b: (a + b) & 0xffffffff) if dense or add
                else np.bitwise_xor, t)
            idx = np.where(idx >= size, idx - size, idx) if dense \
                else idx & mask
            w = [frac[:, d] if c[d] else np.float32(1) - frac[:, d]
                 for d in range(dims)]
            rows.append(idx.astype(np.int64) + int(row[5]))
            weights.append(functools.reduce(np.multiply, w))
        return rows, weights

    def hashgrid_fwd(self, table, pos, out, n, num_levels, num_dims, mask,
                     add, levels, stream):
        self.calls.append(("fwd", n, num_levels, num_dims, mask, add,
                           stream))
        tab = self.by_ptr[table].numpy().reshape(-1, 2)
        p = self.by_ptr[pos].numpy().reshape(n, num_dims)
        lt = self.by_ptr[levels].numpy()
        o = self.by_ptr[out].numpy().reshape(n, num_levels, 2)
        for lvl in range(num_levels):
            rows, weights = self.corners(p, lt, lvl, mask, add)
            acc = np.zeros((n, 2), np.float32)
            for r, w in zip(rows, weights):
                acc = acc + w[:, None] * tab[r]
            o[:, lvl] = acc
        return 0

    def hashgrid_bwd(self, pos, grad_out, grad_table, n, num_levels,
                     num_dims, mask, add, levels, stream):
        self.calls.append(("bwd", n, num_levels, num_dims, mask, add,
                           stream))
        p = self.by_ptr[pos].numpy().reshape(n, num_dims)
        g = self.by_ptr[grad_out].numpy().reshape(n, num_levels, 2)
        gt = self.by_ptr[grad_table].numpy().reshape(-1, 2)
        lt = self.by_ptr[levels].numpy()
        for lvl in range(num_levels):
            rows, weights = self.corners(p, lt, lvl, mask, add)
            for r, w in zip(rows, weights):
                np.add.at(gt, r, w[:, None] * g[:, lvl])
        return 0


def launch_path_against_jax(monkeypatch, kw, hash_impl, dims):
    """The encode and table gradient of a spec of `dims` dims through
    `launch_encode` and `launch_table_grad` (checks, spec arguments, level
    table, stream), with the stand-in library, against the JAX package's
    encode and fp32 custom VJP at their tolerances."""
    jspec = jhg.HashGridSpec(**kw, num_dims=dims, hash_impl=hash_impl,
                             bwd_dtype="float32")
    tspec = thg.HashGridSpec(**kw, num_dims=dims, hash_impl=hash_impl)
    tabs = tables(jspec, 21)
    pos = positions(N, dims, 22)
    cot = np.random.RandomState(23).randn(
        pos.shape[0], jspec.output_dim).astype(np.float32)
    jtabs = tuple(jnp.asarray(t) for t in tabs)
    want_f = np.asarray(jhg.hashgrid_encode(jtabs, jnp.asarray(pos), jspec))
    want_g = np.concatenate([np.asarray(g) for g in jax.grad(
        lambda t: jnp.sum(jhg._encode_custom(t, jnp.asarray(pos), jspec,
                                             True) * cot))(jtabs)])

    k = thg.kernel_spec(tspec)
    level_t = torch.from_numpy(k.levels)
    monkeypatch.setattr(thg.KernelSpec, "levels_on",
                        lambda self, index: level_t.data_ptr())
    monkeypatch.setattr(thg.kernels, "on_device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(thg.kernels, "current_stream", lambda index: 77)
    table = torch.from_numpy(np.concatenate(tabs))
    p, g = torch.from_numpy(pos), torch.from_numpy(cot)
    out = torch.empty(p.shape[0], tspec.output_dim)
    grad = torch.zeros(tspec.num_rows * 2)
    lib = StandIn(table, p, g, out, grad, level_t)
    thg.launch_encode(lib, table, p, out, tspec)
    tbwd.launch_table_grad(lib, p, g, grad, tspec)
    assert [c[0] for c in lib.calls] == ["fwd", "bwd"]
    assert {c[1:] for c in lib.calls} == {
        (pos.shape[0], tspec.num_levels, dims, tspec.table_size - 1,
         int(hash_impl == "add"), 77)}
    np.testing.assert_allclose(out.numpy(), want_f, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_2d_launch_path_matches_jax(monkeypatch, spec_name, hash_impl):
    """The HA-NeRF mask's d = 2 launch path against the JAX package."""
    launch_path_against_jax(monkeypatch, SPECS[spec_name], hash_impl, 2)


# Levels 0-1 dense (4^3 and 8^3 rows within 2^10), 2-3 hashed; every
# level of the second spec hashed.
SPECS_3D = {"dense+hashed": dict(num_levels=4, log2_hashmap_size=10,
                                 base_res=4, max_res=32),
            "hashed": dict(num_levels=3, log2_hashmap_size=8,
                           base_res=16, max_res=64)}


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
@pytest.mark.parametrize("spec_name", sorted(SPECS_3D))
def test_3d_launch_path_matches_jax(monkeypatch, spec_name, hash_impl):
    """The nerfacto fields' d = 3 launch path, which the trimmed wrappers
    share, against the JAX package."""
    launch_path_against_jax(monkeypatch, SPECS_3D[spec_name], hash_impl, 3)


def test_wrappers_check_devices_before_launching():
    """A CUDA tensor beside a CPU one is refused before any launch (here
    the table is a stand-in that says it lies on device 0)."""
    spec = thg.HashGridSpec(num_levels=2, log2_hashmap_size=10, num_dims=2)
    on_card = types.SimpleNamespace(get_device=lambda: 0, is_cuda=True,
                                    device="cuda:0")
    pos = torch.zeros(5, 2)
    with pytest.raises(ValueError, match="positions is on cpu"):
        thg.check_devices("table", on_card, "positions", pos)
    with pytest.raises(ValueError, match="table must be a CUDA tensor"):
        thg.check_devices("table", pos, "positions", on_card)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        thg.hashgrid_fwd(pos.new_zeros(spec.num_rows * 2), on_card, spec)
    assert thg.check_devices("a", on_card, "b", on_card) == 0


def test_launch_reads_the_raw_device_and_stream(monkeypatch):
    """The launches read the current device and stream through PyTorch's
    raw accessors: the same device needs no context, another one switches
    to it, and the stream is the accessor's handle as an int."""
    from nerf_hugs_torch.ops import kernels
    switched = []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 1,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: switched.append(index) or "ctx")
    assert kernels.on_device(1) is kernels._SAME_DEVICE
    assert kernels.on_device(0) == "ctx" and switched == [0]
    assert kernels.current_stream(3) == 1003
