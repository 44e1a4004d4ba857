"""nerf_hugs_torch's 2-D hash grid, the grid of HA-NeRF's implicit mask,
against nerf_hugs_tpu's: the plain encode against `_encode_impl` and the
plain table gradient against the fp32 custom VJP (its Pallas segment-sum in
interpret mode), with dense and hashed levels and both hash_impls, on the
sets that stress how the kernels combine rows: every sample in one cell,
warps split between two cells, pixel patches (at the mask's coarse levels a
warp's lanes share a cell), lines whose ends leave the square and collapse
to the origin with a zero gradient, and the exact-1.0 edges. The
`cuda`-marked test holds the d = 2 kernels against the plain versions on
the same sets (the forward bit for bit) and skips without a GPU, as
chip_smoke.py does at the mask's full size.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ops import FWD_TOL, GRAD_TOL, positions, tables

import torch_port_util as tu
from nerf_hugs_tpu.models import nerfacto as jnerfacto
from nerf_hugs_tpu.ops import hashgrid as jhg
from nerf_hugs_torch.configs import yaml_loader
from nerf_hugs_torch.models import nerfacto as tnerfacto
from nerf_hugs_torch.ops import hashgrid as thg
from nerf_hugs_torch.ops import hashgrid_bwd as tbwd
from nerf_hugs_torch.tools import hashgrid_inputs
from nerf_hugs_torch.utils import trace

N = 32 * 9 + 5   # ragged: no multiple of a warp
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Levels 0-2 dense, level 3 hashed (32^2 rows pass 2^9), with integer
# scales, so an exact-1.0 edge takes the dense wrap; the second spec hashes
# from level 2 on. (The mask's grid: levels 0-11 dense, 12-15 hashed.)
SPECS = {"dense+hashed": dict(num_levels=4, log2_hashmap_size=9,
                              base_res=4, max_res=32),
         "mostly hashed": dict(num_levels=5, log2_hashmap_size=8,
                               base_res=8, max_res=128)}


def specs2d(kw, hash_impl):
    return (jhg.HashGridSpec(**kw, num_dims=2, hash_impl=hash_impl,
                             bwd_dtype="float32"),
            thg.HashGridSpec(**kw, num_dims=2, hash_impl=hash_impl))


def adversarial2d(name: str, seed: int):
    """(positions [N, 2], zero-gradient mask [N]) of one named set."""
    rs = np.random.RandomState(seed)
    lane = np.arange(N) % 32
    a, b = np.array([0.3, 0.6]), np.array([0.7, 0.1])
    none = np.zeros(N, bool)
    if name == "one cell":
        return np.tile(a, (N, 1)), none
    if name == "origin, zero gradient":
        return np.zeros((N, 2)), ~none
    if name == "half at the origin":
        half = rs.rand(N) < 0.5
        return np.where(half[:, None], 0.0, rs.rand(N, 2)), half
    if name == "warps split by halves":
        return np.where((lane < 16)[:, None], a, b), none
    if name == "alternating lanes":
        return np.where((lane % 2 == 0)[:, None], a, b), none
    if name == "pixel patches":
        # 16x16 patches of pixel centres of a 64x48 image, as the patch
        # sampler hands the mask its pix_coords.
        p = np.stack(np.meshgrid(np.arange(16), np.arange(16),
                                 indexing="xy"), -1).reshape(-1, 2)
        corner = rs.randint(0, [48, 32], (-(-N // 256), 1, 2))
        pix = (corner + p[None]).reshape(-1, 2)[:N]
        return (pix + 0.5) / np.array([64.0, 48.0]), none
    if name == "lines":
        lines = -(-N // 40)
        start = rs.rand(lines, 1, 2)
        direction = rs.randn(lines, 1, 2)
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        p = (start + direction * np.linspace(0, 1.5, 40)[None, :, None]
             ).reshape(-1, 2)[:N]
        inside = ((p >= 0) & (p <= 1)).all(-1)
        return p * inside[:, None], ~inside
    assert name == "edges"
    return positions(N - 4, 2, seed), none


SETS = ["one cell", "origin, zero gradient", "half at the origin",
        "warps split by halves", "alternating lanes", "pixel patches",
        "lines", "edges"]


def inputs(name: str, spec, seed: int):
    pos, zero = adversarial2d(name, seed)
    cot = np.random.RandomState(seed + 1).randn(N, spec.output_dim)
    cot[zero] = 0.0
    return pos.astype(np.float32), cot.astype(np.float32)


def jax_encode_and_vjp(jspec, tabs, pos, cot):
    jtabs = tuple(jnp.asarray(t) for t in tabs)
    want_f = np.asarray(jhg.hashgrid_encode(jtabs, jnp.asarray(pos), jspec))
    g_jax = jax.grad(lambda t: jnp.sum(jhg._encode_custom(
        t, jnp.asarray(pos), jspec, True) * cot))(jtabs)
    return want_f, np.concatenate([np.asarray(g) for g in g_jax])


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_2d_encode_and_table_grad_match_jax(spec_name, hash_impl):
    jspec, tspec = specs2d(SPECS[spec_name], hash_impl)
    assert tspec.dense_level().any() and not tspec.dense_level().all()
    tabs = tables(jspec, 5)
    pos = positions(257, 2, 6)
    cot = np.random.RandomState(7).randn(
        pos.shape[0], jspec.output_dim).astype(np.float32)
    want_f, want_g = jax_encode_and_vjp(jspec, tabs, pos, cot)
    table = torch.from_numpy(np.concatenate(tabs)).requires_grad_()
    out = thg.hashgrid_encode(table, torch.from_numpy(pos), tspec)
    np.testing.assert_allclose(out.detach().numpy(), want_f, rtol=0,
                               atol=FWD_TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), want_g, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
@pytest.mark.parametrize("name", SETS)
def test_2d_adversarial_sets_match_jax(name, hash_impl):
    jspec, tspec = specs2d(SPECS["dense+hashed"], hash_impl)
    tabs = tables(jspec, 11)
    pos, cot = inputs(name, tspec, SETS.index(name))
    want_f, want_g = jax_encode_and_vjp(jspec, tabs, pos, cot)
    table = torch.from_numpy(np.concatenate(tabs))
    pos_t, cot_t = torch.from_numpy(pos), torch.from_numpy(cot)
    np.testing.assert_allclose(
        thg.hashgrid_encode_plain(table, pos_t, tspec).numpy(), want_f,
        rtol=0, atol=FWD_TOL)
    plain = tbwd.hashgrid_table_grad_plain(pos_t, cot_t, tspec).numpy()
    np.testing.assert_allclose(plain, want_g, rtol=GRAD_TOL, atol=GRAD_TOL)
    if not cot.any():
        assert not plain.any()


def test_level_table_at_2_dims():
    _, tspec = specs2d(SPECS["dense+hashed"], "xor")
    tab = thg.level_table(tspec).view(np.uint32)
    res = tspec.resolutions
    np.testing.assert_array_equal(tab[:, 0].view(np.float32), tspec.scales)
    np.testing.assert_array_equal(tab[:, 4], tspec.level_sizes)
    np.testing.assert_array_equal(tab[:, 5], tspec.level_offsets)
    np.testing.assert_array_equal(tab[:, 6], [1, 1, 1, 0])
    # Dense levels stride (1, N); the hashed one takes the first two tcnn
    # primes; the third multiplier column stays 0.
    np.testing.assert_array_equal(tab[:3, 1:3], np.stack(
        [np.ones(3), res[:3]], -1))
    np.testing.assert_array_equal(tab[3, 1:3], [1, 2654435761])
    assert not tab[:, 3].any() and not tab[:, 7].any()
    # The x + 1 neighbour of a corner is the corner 2^(d-1) on.
    np.testing.assert_array_equal(tspec.corner_offsets(),
                                  [[0, 0], [0, 1], [1, 0], [1, 1]])


def test_mask_grid_is_what_the_models_build():
    """The smoke run's mask grid (MASK_GRID, one position per ray) is the
    grid the port's model builds from distractor_nerfacto_hanerf.yml, and
    the JAX HashImplicitMask's tables have its level sizes."""
    cfg = yaml_loader.load_yaml_config(os.path.join(
        REPO, "configs", "nerfacto", "distractor_nerfacto_hanerf.yml"))
    assert cfg.transient_type == "hanerf"
    assert hashgrid_inputs.MASK_N == cfg.batch_size
    toy = tu.tiny_config(model={
        "transient_type": "hanerf", "use_transient_embedding": True,
        "transient_embedding_dim": cfg.nerfacto.transient_embedding_dim})
    model = tnerfacto.NerfactoModel(toy, "cpu", torch.Generator())
    assert model.implicit_mask.hashgrid.spec == tnerfacto.MASK_GRID
    assert model.implicit_mask.mlp.layers[0].in_features == (
        32 + cfg.nerfacto.transient_embedding_dim)
    mask = jnerfacto.HashImplicitMask(cfg.nerfacto.transient_embedding_dim)
    shapes = jax.eval_shape(lambda: mask.init(
        jax.random.PRNGKey(0), jnp.zeros((4, 2)),
        jnp.zeros((4, cfg.nerfacto.transient_embedding_dim))))
    grid = shapes["params"]["hashgrid"]
    spec = tnerfacto.MASK_GRID
    assert [grid[f"table_{l}"].shape[0] for l in range(len(grid))] == list(
        spec.level_sizes * spec.features_per_level)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels build with nvcc")
    return torch.device("cuda")


# Off the path, 2^20 uniform positions: every block of a coarse level sums
# its span of samples in shared memory before one atomic per row pair.
UNIFORM_2D = "2^20 uniform"


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + [UNIFORM_2D])
def test_2d_kernels_match_plain(cuda, name):
    spec = tnerfacto.MASK_GRID
    table = torch.from_numpy(np.random.RandomState(3).randn(
        spec.num_rows * 2).astype(np.float32)).to(cuda)
    if name == UNIFORM_2D:
        rs = np.random.RandomState(9)
        arrays = (rs.rand(1 << 20, 2).astype(np.float32),
                  rs.randn(1 << 20, spec.output_dim).astype(np.float32))
    else:
        arrays = inputs(name, spec, SETS.index(name))
    pos, cot = (torch.from_numpy(x).to(cuda) for x in arrays)
    before = trace.counters()
    got_f = thg.hashgrid_fwd(table, pos, spec)
    got_g = tbwd.hashgrid_table_grad(pos, cot, spec)
    after = trace.counters()
    for name in ("hashgrid_fwd.launches_2d", "hashgrid_bwd.launches_2d"):
        assert after[name] == before.get(name, 0) + 1
    # Bit for bit: the forward repeats the plain version's arithmetic.
    torch.testing.assert_close(got_f, thg.hashgrid_encode_plain(
        table, pos, spec), rtol=0, atol=0)
    want_g = tbwd.hashgrid_table_grad_plain(pos, cot, spec)
    assert float((got_g - want_g).abs().max()) <= GRAD_TOL * float(
        want_g.abs().max())
