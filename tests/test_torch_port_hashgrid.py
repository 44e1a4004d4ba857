"""nerf_hugs_torch's hash-grid kernels: their argument checks, the inputs
their benchmark and the smoke run build, and the encode and table gradient
on inputs that stress how samples fall into cells.

The table-gradient kernel (csrc/hashgrid.cu) sums a warp's same-cell
payloads before one atomic, adds aligned row pairs with one vector atomic
and skips zero gradients; the forward reads aligned row pairs with one
vector load. Those paths depend on where the samples lie, and the row
pairs on a table that starts on 16 bytes, so the sets here put every sample in
one cell, split warps between two cells by halves and by alternating lanes,
cluster samples, order them along rays whose out-of-box tails collapse to
the origin with a zero gradient (as the model's do), and sit on the
exact-1.0 edges, all at a ragged n. On the CPU the port runs its plain
versions, held against the JAX package (the fp32 custom VJP, its Pallas
segment-sum in interpret mode); the `cuda`-marked test holds the kernels
against the plain versions on the same sets and skips without a GPU, as
chip_smoke.py does at full size.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_ops import FWD_TOL, GRAD_TOL, positions, specs, tables

import torch_port_util
from nerf_hugs_tpu.ops import hashgrid as jhg
from nerf_hugs_torch.configs import yaml_loader
from nerf_hugs_torch.models import nerfacto as tnerfacto
from nerf_hugs_torch.ops import hashgrid as thg
from nerf_hugs_torch.ops import hashgrid_bwd as tbwd
from nerf_hugs_torch.tools import bench_hashgrid, hashgrid_inputs

N = 32 * 9 + 5   # ragged: no multiple of a warp
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("config, names", [
    ("kubric_nerfacto_base.yml", ("field", "proposal")),
    ("kubric_nerfacto_tpu.yml", ("tpu field", "tpu proposal")),
])
def test_grids_are_the_configs(config, names):
    """The specs and main-path sample counts the smoke run and the
    benchmark use are those the model builds from the shipped configs."""
    cfg = yaml_loader.load_yaml_config(
        os.path.join(REPO, "configs", "nerfacto", config))
    nc = cfg.nerfacto
    field = tnerfacto._grid_spec(dict(
        num_levels=nc.num_levels, log2_hashmap_size=nc.log2_hashmap_size,
        base_res=nc.base_res, max_res=nc.max_res))
    proposal = tnerfacto._grid_spec(dict(nc.proposal_net_args_list[0]))
    grids = {name: (thg.HashGridSpec(**kw), n)
             for name, kw, n in hashgrid_inputs.GRIDS}
    assert grids[names[0]][0] == field
    assert grids[names[1]][0] == proposal
    if names[0] == "field":     # the timed grids: the main path's samples
        assert hashgrid_inputs.BATCH == cfg.batch_size
        assert grids["field"][1] == cfg.batch_size * nc.num_nerf_samples_per_ray
        assert grids["proposal"][1] == (
            cfg.batch_size * nc.num_proposal_samples_per_ray[0])


def _odd_row_view(spec):
    """A contiguous table view that starts one 8-byte row in: 8-byte but
    not 16-byte aligned."""
    return torch.zeros(spec.num_rows * 2 + 2)[2:]


@pytest.mark.parametrize("case, match", [
    ("ok", None),
    ("float64 positions", "float32"),
    ("strided grad_out", "contiguous"),
    ("table from an odd row", "16-byte"),
    ("grad_table from an odd row", "16-byte"),
    ("4 features per level", "features_per_level"),
    ("2 dims", None),
    ("1 dim", "2 or 3 dims"),
    ("4 dims", "2 or 3 dims"),
])
def test_kernel_argument_checks(case, match):
    spec = thg.HashGridSpec(num_levels=2, log2_hashmap_size=10)
    n = 40
    args = dict(table=torch.zeros(spec.num_rows * 2),
                positions=torch.zeros(n, 3),
                grad_out=torch.zeros(n, spec.output_dim),
                grad_table=torch.zeros(spec.num_rows * 2))
    if case == "float64 positions":
        args["positions"] = args["positions"].double()
    elif case == "strided grad_out":
        args["grad_out"] = torch.zeros(spec.output_dim, n).t()
    elif case == "table from an odd row":
        args["table"] = _odd_row_view(spec)
    elif case == "grad_table from an odd row":
        args["grad_table"] = _odd_row_view(spec)
    elif case == "4 features per level":
        spec = thg.HashGridSpec(num_levels=2, features_per_level=4,
                                log2_hashmap_size=10)
    elif case.endswith(("dim", "dims")):
        # The kernels are instantiated for d = 2 (the HA-NeRF mask) and 3.
        d = int(case.split()[0])
        spec = thg.HashGridSpec(num_levels=2, log2_hashmap_size=10,
                                num_dims=d)
        args["positions"] = torch.zeros(n, d)
    # The launches check each tensor and the spec; they ask alignment of
    # the table and the table gradient.
    def check():
        for name, t in args.items():
            thg.check_tensor(name, t, aligned=name in ("table", "grad_table"))
        return thg.kernel_spec(spec)
    if match is None:
        check()
    else:
        with pytest.raises(ValueError, match=match):
            check()
    # Alignment is asked of the named tensors only: an odd-row view of the
    # positions' storage is fine.
    if case == "ok":
        view = torch.zeros(3 * n + 2)[2:].view(n, 3)
        assert thg.check_tensor("positions", view) == view.data_ptr()


def config_grids():
    """Every hash grid the shipped nerfacto configs build: each field's,
    each proposal net's (the top-level hash_impl by default, as the model
    sets it) and the HA-NeRF mask's."""
    grids = {tnerfacto.MASK_GRID}
    for path in glob.glob(os.path.join(REPO, "configs", "nerfacto",
                                       "*nerfacto*.yml")):
        nc = yaml_loader.load_yaml_config(path).nerfacto
        grids.add(thg.HashGridSpec(
            num_levels=nc.num_levels,
            features_per_level=nc.features_per_level,
            log2_hashmap_size=nc.log2_hashmap_size, base_res=nc.base_res,
            max_res=nc.max_res, hash_impl=nc.hash_impl))
        for args in nc.proposal_net_args_list:
            grids.add(tnerfacto._grid_spec(
                {"hash_impl": nc.hash_impl, **dict(args)}))
    return sorted(grids, key=repr)


CONFIG_GRIDS = config_grids()


@pytest.mark.parametrize("spec", CONFIG_GRIDS, ids=repr)
def test_grid_constants_equal_the_jax_spec(spec):
    """The per-spec constants the wrappers and kernels read, against the
    JAX package's HashGridSpec of the same grid (its numpy properties),
    for every grid the shipped configs build."""
    js = jhg.HashGridSpec(
        num_levels=spec.num_levels,
        features_per_level=spec.features_per_level,
        log2_hashmap_size=spec.log2_hashmap_size, base_res=spec.base_res,
        max_res=spec.max_res, num_dims=spec.num_dims,
        hash_impl=spec.hash_impl, bwd_dtype="float32")
    c = thg.grid_constants(spec)
    np.testing.assert_array_equal(c.scales, js.scales)
    np.testing.assert_array_equal(c.resolutions, js.resolutions)
    np.testing.assert_array_equal(c.level_sizes, js.level_sizes)
    np.testing.assert_array_equal(c.level_offsets, np.concatenate(
        [[0], np.cumsum(js.level_sizes)[:-1]]))
    np.testing.assert_array_equal(c.dense, js.dense_level())
    primes = np.array([1, 2654435761, 805459861][:spec.num_dims])
    np.testing.assert_array_equal(c.multipliers, np.where(
        js.dense_level()[:, None],
        js.resolutions[:, None].astype(np.int64)
        ** np.arange(spec.num_dims), primes))
    assert (c.num_rows, spec.output_dim) == (js.num_rows, js.output_dim)
    assert (c.hash_mask, c.hash_add) == (js.table_size - 1,
                                         int(spec.hash_impl == "add"))
    assert c.scales.dtype == np.float32
    # Shared by every caller of the spec, and what its properties return:
    # read-only.
    assert not any(a.flags.writeable for a in (
        c.scales, c.resolutions, c.level_sizes, c.level_offsets, c.dense,
        c.multipliers))
    assert spec.level_offsets is c.level_offsets
    np.testing.assert_array_equal(thg.level_table(spec)[:, 5],
                                  c.level_offsets)


@pytest.mark.parametrize("num_dims", [3, 2])
def test_spec_constants_are_computed_once(monkeypatch, num_dims):
    """The spec's properties, two preparations of the wrappers' launches
    (kernel_spec: the spec's checks, the C arguments, the level table) and
    the plain versions derive the spec's levels once: level_scales runs
    one time, not at every property access."""
    spec = thg.HashGridSpec(num_levels=5, log2_hashmap_size=11, base_res=7,
                            max_res=301, num_dims=num_dims)
    thg.grid_constants.cache_clear()
    thg.kernel_spec.cache_clear()
    calls = []
    real = thg.level_scales
    monkeypatch.setattr(thg, "level_scales",
                        lambda *a: calls.append(a) or real(*a))
    rows = spec.num_rows
    n = 33
    for _ in range(2):
        k = thg.kernel_spec(spec)
        assert (k.values, k.num_levels, k.num_dims, k.hash_mask, k.hash_add,
                k.output_dim) == (rows * 2, 5, num_dims, 2047, 0,
                                  spec.output_dim)
        assert k.counter == ("launches_2d" if num_dims == 2 else "launches")
        np.testing.assert_array_equal(k.levels, thg.level_table(spec))
    assert len(calls) == 1
    # The plain versions read the same constants.
    thg.hashgrid_encode_plain(torch.zeros(rows * 2), torch.rand(n, num_dims),
                              spec)
    tbwd.hashgrid_table_grad_plain(torch.rand(n, num_dims),
                                   torch.ones(n, spec.output_dim), spec)
    assert len(calls) == 1


@pytest.mark.parametrize("fused", [False, True])
def test_base_yaml_is_the_shipped_config_on_the_synthetic_scene(
        tmp_path, fused):
    path = hashgrid_inputs.base_yaml(str(tmp_path), fused, steps=5)
    got = yaml_loader.load_yaml_config(path)
    want = yaml_loader.load_yaml_config(hashgrid_inputs.BASE_CONFIG)
    assert got.dataset_loader == "synthetic"
    assert got.early_exit_steps == 5
    assert got.batch_size == want.batch_size
    for key in ("num_levels", "log2_hashmap_size", "base_res", "max_res",
                "hidden_dim", "num_nerf_samples_per_ray",
                "num_proposal_samples_per_ray"):
        assert getattr(got.nerfacto, key) == getattr(want.nerfacto, key)
    assert got.nerfacto.enable_tcnn_mlp == fused
    assert all(a.get("enable_tcnn_mlp", False) == fused
               for a in got.nerfacto.proposal_net_args_list)


def test_capture_hashgrid_inputs_on_a_tiny_model(tmp_path):
    cfg = torch_port_util.write_tiny_yaml(str(tmp_path))
    captured = hashgrid_inputs.capture_hashgrid_inputs(cfg, str(tmp_path),
                                                       "cpu")
    assert sorted(captured) == ["field", "proposal"]
    for spec, p, g in captured.values():
        assert p.shape[-1] == 3 and not p.requires_grad
        assert g.shape == p.shape[:-1] + (spec.output_dim,)
        assert bool(((p >= 0) & (p <= 1)).all())
        assert torch.isfinite(g).all()
    spec = captured["field"][0]
    assert spec.num_levels == torch_port_util.TINY_MODEL["num_levels"]
    # One sample in four at the origin; one (sample, level) pair in eight
    # with a zero gradient.
    p = torch.rand(8, 3) + 0.5
    p[::4] = 0.0
    g = torch.ones(8, spec.output_dim)
    g[0, :2] = 0.0
    assert hashgrid_inputs.capture_shares(spec, p, g).startswith(
        "0.2500 of the samples out of the box (at the origin), 0.0312 of "
        "the (sample, level) pairs with a zero gradient")


@pytest.mark.parametrize("mode", [["kernels", "--captured"],
                                  ["train", "."], ["wrappers", ".", "."],
                                  ["host"]])
def test_bench_without_a_card_raises(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_hashgrid.main(mode)


@pytest.mark.parametrize("num_dims", [3, 2])
def test_bench_yardsticks_and_bounds_on_the_cpu(num_dims):
    """The library calls the benchmark and the smoke run time beside the
    kernels compute the plain versions' functions; the bounds count the
    bytes each kernel must move."""
    spec = thg.HashGridSpec(num_levels=4, log2_hashmap_size=10,
                            base_res=4, max_res=64, num_dims=num_dims)
    gen = torch.Generator().manual_seed(0)
    table = torch.rand(spec.num_rows * 2, generator=gen)
    p = torch.rand(N, num_dims, generator=gen)
    g = torch.randn(N, spec.output_dim, generator=gen)
    fwd, bwd, touched = bench_hashgrid.yardsticks(spec, table, p, g)
    torch.testing.assert_close(fwd().view(N, -1),
                               thg.hashgrid_encode_plain(table, p, spec),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bwd().view(-1),
                               tbwd.hashgrid_table_grad_plain(p, g, spec),
                               rtol=1e-5, atol=1e-6)
    assert 0 < touched <= min(spec.num_rows, N * 2 ** num_dims * 4)
    (f_ms, f_by, f_bytes), (b_ms, b_by, b_bytes) = bench_hashgrid.bounds(
        spec, table, p, g, touched)
    assert f_bytes == 4 * (p.numel() + g.numel()) + 8 * touched
    assert b_bytes == 4 * (p.numel() + g.numel() + table.numel())
    assert (f_by, b_by) == ("bytes", "bytes")
    assert b_ms == pytest.approx(b_bytes / bench_hashgrid.HBM_BYTES_PER_S
                                 * 1e3)


def test_tools_do_not_import_the_smoke_script():
    for module in (bench_hashgrid, hashgrid_inputs):
        with open(module.__file__) as f:
            assert "chip_smoke" not in f.read()


def adversarial(name: str, seed: int):
    """(positions [N, 3], zero-gradient mask [N]) of one named set."""
    rs = np.random.RandomState(seed)
    lane = np.arange(N) % 32
    a, b = np.array([0.3, 0.6, 0.2]), np.array([0.7, 0.1, 0.9])
    none = np.zeros(N, bool)
    if name == "one cell":
        return np.tile(a, (N, 1)), none
    if name == "origin, zero gradient":
        return np.zeros((N, 3)), ~none
    if name == "half at the origin":
        half = rs.rand(N) < 0.5
        return np.where(half[:, None], 0.0, rs.rand(N, 3)), half
    if name == "warps split by halves":
        return np.where((lane < 16)[:, None], a, b), none
    if name == "alternating lanes":
        return np.where((lane % 2 == 0)[:, None], a, b), none
    if name == "clustered":
        return a + 0.02 * rs.rand(N, 3), none
    if name == "rays":
        rays = -(-N // 40)
        start = rs.rand(rays, 1, 3)
        direction = rs.randn(rays, 1, 3)
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        p = (start + direction * np.linspace(0, 1.5, 40)[None, :, None]
             ).reshape(-1, 3)[:N]
        inside = ((p >= 0) & (p <= 1)).all(-1)
        return p * inside[:, None], ~inside
    assert name == "edges"
    return positions(N - 5, 3, seed), none


SETS = ["one cell", "origin, zero gradient", "half at the origin",
        "warps split by halves", "alternating lanes", "clustered", "rays",
        "edges"]


def inputs(name: str, spec, seed: int):
    pos, zero = adversarial(name, seed)
    cot = np.random.RandomState(seed + 1).randn(N, spec.output_dim)
    cot[zero] = 0.0
    return pos.astype(np.float32), cot.astype(np.float32)


@pytest.mark.parametrize("hash_impl", ["xor", "add"])
@pytest.mark.parametrize("name", SETS)
def test_adversarial_sets_match_jax(name, hash_impl):
    jspec, tspec = specs(hash_impl)
    tabs = tables(jspec, 11)
    pos, cot = inputs(name, tspec, SETS.index(name))
    jtabs = tuple(jnp.asarray(t) for t in tabs)
    want_f = np.asarray(jhg.hashgrid_encode(jtabs, jnp.asarray(pos), jspec))
    g_jax = jax.grad(lambda t: jnp.sum(jhg._encode_custom(
        t, jnp.asarray(pos), jspec, True) * cot))(jtabs)
    want_g = np.concatenate([np.asarray(g) for g in g_jax])

    table = torch.from_numpy(np.concatenate(tabs)).requires_grad_()
    pos_t, cot_t = torch.from_numpy(pos), torch.from_numpy(cot)
    out = thg.hashgrid_encode(table, pos_t, tspec)
    np.testing.assert_allclose(out.detach().numpy(), want_f, rtol=0,
                               atol=FWD_TOL)
    (out * cot_t).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), want_g, rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    plain = tbwd.hashgrid_table_grad_plain(pos_t, cot_t, tspec).numpy()
    np.testing.assert_allclose(plain, want_g, rtol=GRAD_TOL, atol=GRAD_TOL)
    if not cot.any():
        assert not plain.any()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels build with nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS)
def test_kernels_match_plain_on_adversarial_sets(cuda, name):
    # Levels of 4096 to 32768 rows, dense and hashed.
    spec = thg.HashGridSpec(num_levels=6, log2_hashmap_size=15, base_res=16,
                            max_res=256)
    table = torch.from_numpy(
        np.random.RandomState(3).randn(spec.num_rows * 2).astype(np.float32)
    ).to(cuda)
    pos, cot = (torch.from_numpy(x).to(cuda)
                for x in inputs(name, spec, SETS.index(name)))
    want_f = thg.hashgrid_encode_plain(table, pos, spec)
    want_g = tbwd.hashgrid_table_grad_plain(pos, cot, spec)
    scale = float(want_g.abs().max())
    torch.testing.assert_close(thg.hashgrid_fwd(table, pos, spec), want_f,
                               rtol=0, atol=FWD_TOL)
    got = tbwd.hashgrid_table_grad(pos, cot, spec)
    assert float((got - want_g).abs().max()) <= GRAD_TOL * scale
    # A table view from an odd row would fault in the row-pair loads.
    odd = torch.zeros(spec.num_rows * 2 + 2, device=cuda)[2:]
    with pytest.raises(ValueError, match="16-byte"):
        thg.hashgrid_fwd(odd, pos, spec)
