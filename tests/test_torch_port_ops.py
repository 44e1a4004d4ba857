"""nerf_hugs_torch ops against nerf_hugs_tpu: hash grid, table gradient, SH.

Same numpy inputs through both packages. On the CPU the port's encode runs
its plain versions through the same autograd.Function that joins the CUDA
kernels on a GPU; the kernels themselves are compared with the plain
versions by the `cuda`-marked test here (skips without a GPU) and by
chip_smoke.py at full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ops import numpy_tcnn_encode

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_tpu.ops import hashgrid as jhg
from nerf_hugs_tpu.ops import hashgrid_bwd as jbwd
from nerf_hugs_tpu.ops import sh as jsh
from nerf_hugs_torch.ops import hashgrid as thg
from nerf_hugs_torch.ops import hashgrid_bwd as tbwd
from nerf_hugs_torch.ops import sh as tsh
from nerf_hugs_torch.utils import trace

# The port's plain encode repeats the JAX arithmetic op for op, so the
# features agree to float32 rounding of values of order 1.
FWD_TOL = 1e-6
# Scatter-adds sum in another order (index_add_ vs the one-hot matmul).
GRAD_TOL = 1e-5

SPEC_KW = dict(num_levels=4, features_per_level=2, log2_hashmap_size=10,
               base_res=4, max_res=32)


def specs(hash_impl="xor", num_dims=3):
    return (jhg.HashGridSpec(**SPEC_KW, num_dims=num_dims,
                             hash_impl=hash_impl, bwd_dtype="float32"),
            thg.HashGridSpec(**SPEC_KW, num_dims=num_dims,
                             hash_impl=hash_impl))


def positions(n, num_dims, seed):
    """Random points plus the 0 and exact-1.0 corners and per-dim edges."""
    rs = np.random.RandomState(seed)
    edges = [np.zeros(num_dims), np.ones(num_dims)]
    for d in range(num_dims):
        e = rs.rand(num_dims)
        e[d] = 1.0
        edges.append(e)
    return np.concatenate([rs.rand(n, num_dims), np.stack(edges)]
                          ).astype(np.float32)


def tables(spec, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(int(s) * spec.features_per_level).astype(np.float32)
            for s in spec.level_sizes]


@pytest.mark.parametrize("kw", [
    SPEC_KW, dict(SPEC_KW, num_dims=2),
    dict(num_levels=16, log2_hashmap_size=21, base_res=16, max_res=8192),
    dict(num_levels=7, log2_hashmap_size=17, base_res=16, max_res=2048),
    dict(num_levels=1, log2_hashmap_size=12, base_res=8, max_res=8),
])
def test_spec_properties_match_jax(kw):
    js, ts = jhg.HashGridSpec(**kw), thg.HashGridSpec(**kw)
    for name in ("scales", "resolutions", "level_sizes", "table_size",
                 "output_dim", "num_rows"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    np.testing.assert_array_equal(ts.dense_level(), js.dense_level())
    np.testing.assert_array_equal(ts.corner_offsets(), js.corner_offsets())
    assert np.all(ts.level_offsets % 8 == 0)
    np.testing.assert_array_equal(
        ts.level_offsets, np.cumsum([0] + list(js.level_sizes))[:-1])


@pytest.mark.parametrize("num_dims", [2, 3])
@pytest.mark.parametrize("hash_impl", ["xor", "add"])
def test_encode_matches_jax_and_tcnn_oracle(hash_impl, num_dims):
    jspec, tspec = specs(hash_impl, num_dims)
    tabs = tables(jspec, 0)
    pos = positions(300, num_dims, 1)
    want_jax = np.asarray(jhg.hashgrid_encode(
        tuple(jnp.asarray(t) for t in tabs), jnp.asarray(pos), jspec))
    want_np = numpy_tcnn_encode(tabs, pos, jspec)
    flat = torch.from_numpy(np.concatenate(tabs))
    got = thg.hashgrid_encode(flat, torch.from_numpy(pos), tspec).numpy()
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got, want_np, rtol=0, atol=FWD_TOL)
    plain = thg.hashgrid_encode_plain(flat, torch.from_numpy(pos), tspec)
    np.testing.assert_array_equal(plain.numpy(), got)


def test_encode_leading_dims_and_module_init():
    _, tspec = specs()
    module = thg.HashGridEncoding(tspec, torch.Generator().manual_seed(0))
    assert module.table.shape == (tspec.num_rows * 2,)
    assert float(module.table.detach().abs().max()) <= 1e-4
    pos = torch.from_numpy(positions(41, 3, 2))  # 46 rows
    flat = module(pos)
    assert flat.shape == (pos.shape[0], tspec.output_dim)
    shaped = module(pos.reshape(2, -1, 3))
    np.testing.assert_array_equal(shaped.reshape(flat.shape).detach(),
                                  flat.detach())


def test_segment_sum_plain_matches_block_segment_sum():
    rs = np.random.RandomState(0)
    t_rows, k = 1024, 5000
    vals = rs.randn(k, 2).astype(np.float32)
    cases = [
        rs.randint(0, t_rows, k).astype(np.int32),
        np.full(k, 7, np.int32),     # skew: one block loops many chunks
        np.array([0, 255, 256, 511, 512, 1023] * 10, np.int32),  # blocks
    ]
    for keys in cases:
        v = vals[:len(keys)]
        want = np.asarray(jbwd.block_segment_sum(
            jnp.asarray(keys), jnp.asarray(v), t_rows, "float32", True))
        # The plain table gradient's scatter: index_add_ of vals by row.
        got = torch.zeros(t_rows, 2).index_add_(
            0, torch.from_numpy(keys).long(), torch.from_numpy(v))
        got = got.reshape(-1).numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
def test_table_grad_matches_jax_custom_vjp(hash_impl):
    jspec, tspec = specs(hash_impl)
    tabs = tables(jspec, 3)
    pos = positions(129, 3, 4)
    cot = np.random.RandomState(5).randn(
        pos.shape[0], jspec.output_dim).astype(np.float32)
    g_jax = jax.grad(lambda t: jnp.sum(jhg._encode_custom(
        t, jnp.asarray(pos), jspec, True) * cot))(
        tuple(jnp.asarray(t) for t in tabs))
    want = np.concatenate([np.asarray(g) for g in g_jax])

    table = torch.from_numpy(np.concatenate(tabs)).requires_grad_()
    pos_t = torch.from_numpy(pos)
    cot_t = torch.from_numpy(cot)
    (thg.hashgrid_encode(table, pos_t, tspec) * cot_t).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    plain = tbwd.hashgrid_table_grad_plain(pos_t, cot_t, tspec).numpy()
    np.testing.assert_allclose(plain, want, rtol=GRAD_TOL, atol=GRAD_TOL)
    # The indexing autograd of the plain encode gives the same gradient.
    table2 = table.detach().clone().requires_grad_()
    (thg.hashgrid_encode_plain(table2, pos_t, tspec) * cot_t).sum().backward()
    np.testing.assert_allclose(table2.grad.numpy(), want, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_encode_gives_positions_no_gradient():
    _, tspec = specs()
    table = torch.randn(tspec.num_rows * 2, requires_grad=True)
    pos = torch.from_numpy(positions(10, 3, 6)).requires_grad_()
    thg.hashgrid_encode(table, pos, tspec).sum().backward()
    assert pos.grad is None
    assert table.grad is not None


def test_level_table_layout():
    _, tspec = specs("add")
    tab = thg.level_table(tspec).view(np.uint32)
    np.testing.assert_array_equal(tab[:, 0].view(np.float32), tspec.scales)
    np.testing.assert_array_equal(tab[:, 4], tspec.level_sizes)
    np.testing.assert_array_equal(tab[:, 5], tspec.level_offsets)
    np.testing.assert_array_equal(tab[:, 6], tspec.dense_level())
    # Dense levels stride N^d, hashed levels use the tcnn primes.
    np.testing.assert_array_equal(tab[0, 1:4], [1, 4, 16])
    np.testing.assert_array_equal(tab[3, 1:4], [1, 2654435761, 805459861])


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_matches_jax(degree):
    rs = np.random.RandomState(degree)
    dirs = rs.randn(500, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jsh.sh_encode(jnp.asarray(dirs), degree=degree))
    got = tsh.sh_encode(torch.from_numpy(dirs), degree=degree).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_sh_orthonormality():
    # Monte-Carlo over a Fibonacci sphere: int Y_i Y_j dOmega = delta_ij
    # (the JAX package's tests/test_ops.py:227, carried over).
    n = 200000
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    dirs = np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi), np.cos(phi)], -1)
    y = tsh.sh_encode(torch.from_numpy(dirs.astype(np.float32)),
                      degree=4).double().numpy()
    np.testing.assert_allclose((y.T @ y) * (4 * np.pi / n), np.eye(16),
                               atol=5e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels build with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hash_impl", ["xor", "add"])
def test_kernels_match_plain_versions(cuda, hash_impl):
    _, tspec = specs(hash_impl)
    table = torch.from_numpy(np.concatenate(tables(tspec, 7))).to(cuda)
    pos = torch.from_numpy(positions(5000, 3, 8)).to(cuda)
    cot = torch.randn(pos.shape[0], tspec.output_dim, device=cuda)
    fwd0 = trace.counters().get("hashgrid_fwd.launches", 0)
    got = thg.hashgrid_fwd(table, pos, tspec)
    assert trace.counters()["hashgrid_fwd.launches"] == fwd0 + 1
    want = thg.hashgrid_encode_plain(table, pos, tspec)
    torch.testing.assert_close(got, want, rtol=0, atol=FWD_TOL)
    g = tbwd.hashgrid_table_grad(pos, cot, tspec)
    g_plain = tbwd.hashgrid_table_grad_plain(pos, cot, tspec)
    torch.testing.assert_close(g, g_plain, rtol=GRAD_TOL, atol=GRAD_TOL)
    with pytest.raises(ValueError):
        thg.hashgrid_fwd(table.double(), pos, tspec)
