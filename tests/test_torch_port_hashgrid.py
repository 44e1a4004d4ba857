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
    # The wrappers name the table and the table gradient as aligned.
    check = lambda: thg.check_kernel_args(
        spec, aligned=("table", "grad_table"), **args)
    if match is None:
        check()
    else:
        with pytest.raises(ValueError, match=match):
            check()
    # Alignment is asked of the named tensors only: an odd-row view of the
    # positions' storage is fine.
    if case == "ok":
        thg.check_kernel_args(spec, positions=torch.zeros(3 * n + 2)[2:]
                              .view(n, 3))


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
                                  ["train", "."]])
def test_bench_without_a_card_raises(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_hashgrid.main(mode)


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
