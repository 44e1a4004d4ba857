"""The fused MLP at every bf16 shape the shipped nerfacto configs give it,
and the C entry point's routing rule between its two bf16 kernels.

On the CPU the port's op runs its plain version, held against the JAX
package's Pallas kernel in interpret mode and its reference at each shipped
shape. `resident_plan` mirrors the rule by which csrc/fused_mlp.cu sends a
bf16 MLP to the resident kernel (weights held in shared memory, wgmma) or
to the streamed one; every MLP of every shipped config must take the
resident kernel within the 227 KB of shared memory a block may have. The
kernels themselves are held against the plain version at the resident
design's edges by the `cuda`-marked test of test_torch_port_fused_mlp.py.
"""

import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_port_fused_mlp import (TOL, as_jax, as_torch,
                                       assert_close_to_max, make_inputs)

import torch_port_util as tu
from nerf_hugs_tpu.ops import fused_mlp as jfm
from nerf_hugs_torch.configs import yaml_loader
from nerf_hugs_torch.models.nerfacto import NerfactoModel, fused_mlp_widths
from nerf_hugs_torch.ops import fused_mlp as tfm
from nerf_hugs_torch.tools import bench_fused_mlp, hashgrid_inputs

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs" / "nerfacto").glob("*nerfacto*.yml"))
# The bf16 widths of configs/nerfacto/*nerfacto*.yml (fused_mlp_widths of
# each, all with enable_amp: true): proposal, field base and field head,
# the head's input 16 + geo_feat_dim + the appearance embedding's width,
# and NeRF-W's transient head (geo_feat_dim + the transient embedding's
# width -> hidden_dim_transient x 2 -> 5).
SHIPPED = [(10, 64, 1), (14, 64, 1), (24, 256, 65), (32, 256, 65),
           (80, 64, 64, 5), (80, 256, 256, 3), (84, 256, 256, 3),
           (128, 256, 256, 3)]
KIB_227 = 227 * 1024


def test_shipped_widths_are_those_of_the_configs():
    widths = set()
    for path in CONFIGS:
        config = yaml_loader.load_yaml_config(str(path))
        assert config.enable_amp, path.name
        widths.update(fused_mlp_widths(config).values())
    assert sorted(widths) == SHIPPED


def test_fused_mlp_widths_match_the_built_model():
    model_keys = {"enable_tcnn_mlp": True, "use_appearance_embedding": True,
                  "appearance_embedding_dim": 6,
                  "proposal_net_args_list": [dict(
                      tu.TINY_MODEL["proposal_net_args_list"][0],
                      enable_tcnn_mlp=True)]}
    config = tu.tiny_config(model=model_keys)
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    for name, dims in fused_mlp_widths(config).items():
        mlp = model.get_submodule(name)
        assert mlp.fused, name
        shapes = [tuple(getattr(mlp, f"w_{i}").shape)
                  for i in range(mlp.num_weights)]
        assert shapes == list(zip(dims[:-1], dims[1:])), name


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_shipped_mlp_takes_the_resident_kernel(path):
    config = yaml_loader.load_yaml_config(str(path))
    for name, dims in fused_mlp_widths(config).items():
        assert tfm.is_resident(torch.bfloat16, dims), (name, dims)
        plan = tfm.resident_plan(dims)
        assert plan["smem_bytes"] <= tfm.SMEM_BUDGET == KIB_227
        assert plan["wgs"] >= 1 and 1 <= plan["stages"] <= tfm.MAX_STAGES
        # Every weight, each warpgroup's input slots and its output tile
        # are in the plan; slots and tiles start on 16 bytes.
        assert plan["smem_bytes"] == plan["weight_bytes"] + plan["wgs"] * (
            plan["stages"] * plan["tile_in_bytes"] + plan["out_bytes"])
        assert plan["weight_bytes"] % 16 == plan["tile_in_bytes"] % 16 == 0


def test_resident_plan_at_the_main_shapes():
    """The plans chip_smoke.py and the benchmark run (kubric_nerfacto_base)."""
    got = {name: tfm.resident_plan(dims)
           for name, _, dims in hashgrid_inputs.FUSED_SHAPES}
    head = got["field mlp_head"]
    assert (head["k_pad"], head["n_cov"]) == ([80, 256, 256], [256, 256, 8])
    assert head["weight_bytes"] == 2 * (80 * 256 + 256 * 256 + 256 * 8)
    # Both hidden layers keep their whole output in 256-wide fragments.
    assert (head["max_k"], head["full_layers"], head["out_regs"]) == (
        256, 2, 0)
    assert (head["wgs"], head["stages"]) == (2, 2)
    # The bases' only hidden layer feeds the output layer chunk by chunk,
    # so their fragments are 64 wide and 4 warpgroups share an SM.
    base = got["field mlp_base"]
    assert (base["k_pad"], base["n_cov"]) == ([32, 256], [256, 72])
    assert (base["max_k"], base["full_layers"], base["out_regs"]) == (
        64, 0, 36)
    assert (base["wgs"], base["stages"]) == (4, 8)
    prop = got["proposal mlp_base"]
    assert (prop["k_pad"], prop["n_cov"]) == ([16, 64], [64, 8])
    assert (prop["max_k"], prop["full_layers"], prop["out_regs"]) == (
        64, 0, 4)
    assert (prop["wgs"], prop["stages"]) == (4, 8)
    # The widest shipped head keeps one warpgroup and one input slot.
    wide = tfm.resident_plan((128, 256, 256, 3))
    assert (wide["wgs"], wide["stages"]) == (1, 1)


@pytest.mark.parametrize("dims,fused", [
    ((16, 16), False), ((1, 256), False), ((17, 48, 24, 5), True),
    ((3, 200, 40, 7), False), ((32,) * 9, True), ((32, 64, 80), False)])
def test_fused_output_pair_by_widths(dims, fused):
    """The last hidden layer feeds the output layer chunk by chunk only
    where the output's sums fit a thread (72 columns) and every earlier
    input fits 64-wide fragments."""
    plan = tfm.resident_plan(dims)
    assert plan["full_layers"] == len(dims) - 2 - fused
    assert (plan["out_regs"] > 0) == fused
    assert plan["max_k"] == (64 if max(plan["k_pad"][:len(dims) - 1 - fused])
                             <= 64 else 256)


@pytest.mark.parametrize("dims,n_cov", [
    ((16, 16), [16]), ((1, 256), [256]), ((17, 48, 24, 5), [64, 32, 8]),
    ((3, 200, 40, 7), [208, 64, 8]), ((32,) * 9, [32] * 8)])
def test_resident_plan_covers_odd_widths(dims, n_cov):
    """Hidden widths pad to 16 and the output to 8, then each layer's last
    64-column chunk to 8, 16, 32 or 64."""
    plan = tfm.resident_plan(dims)
    assert plan["n_cov"] == n_cov
    assert plan["k_pad"] == [-(-d // 16) * 16 for d in dims[:-1]]
    for d, c in zip(dims[1:-1], n_cov):
        assert c >= -(-d // 16) * 16  # the next layer's K is covered


def test_routing_by_widths_alone():
    """Weights that do not fit a block (8 layers of 256) and every fp32
    call take the streamed kernel and its zero-padded layout."""
    assert tfm.resident_plan((256,) * 9) is None
    assert not tfm.is_resident(torch.bfloat16, (256,) * 9)
    assert not tfm.is_resident(torch.float32, (80, 256, 256, 3))
    ws = [torch.ones(256, 256, dtype=torch.bfloat16)] * 8
    padded = tfm.kernel_weights(ws)
    assert all(tuple(p.shape) == (256, 256) and p is not w
               for p, w in zip(padded, ws))


@pytest.mark.parametrize("dims", SHIPPED)
def test_forward_matches_jax_at_shipped_widths(dims):
    x, weights, _ = make_inputs(dims, sum(dims) + 1)
    xj = as_jax(x, "bfloat16")
    wj = tuple(as_jax(w, "bfloat16") for w in weights)
    got = tfm.fused_mlp(as_torch(x, "bfloat16"),
                        [as_torch(w, "bfloat16") for w in weights])
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0],
                                                         dims[-1])
    for want in (jfm.fused_mlp(xj, wj, 128, True),
                 jfm._forward_reference(xj, wj)):
        assert_close_to_max(got.float(), want.astype(jnp.float32),
                            TOL["bfloat16"])


@pytest.mark.parametrize("dims", SHIPPED)
def test_gradients_match_jax_at_shipped_widths(dims):
    x, weights, cot = make_inputs(dims, 5 * sum(dims))
    cot_j = jnp.asarray(cot)

    def loss(xx, ww):
        out = jfm.fused_mlp(xx, ww, 128, True)
        return jnp.sum(out.astype(jnp.float32) * cot_j)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(
        as_jax(x, "bfloat16"), tuple(as_jax(w, "bfloat16") for w in weights))
    xt = as_torch(x, "bfloat16", requires_grad=True)
    wt = [as_torch(w, "bfloat16", requires_grad=True) for w in weights]
    (tfm.fused_mlp(xt, wt).float() * torch.from_numpy(cot)).sum().backward()
    assert_close_to_max(xt.grad.float(), gx_j.astype(jnp.float32),
                        TOL["bfloat16"], "dx")
    for i, (w, g) in enumerate(zip(wt, gw_j)):
        assert_close_to_max(w.grad.float(), g.astype(jnp.float32),
                            TOL["bfloat16"], f"dw_{i}")


@pytest.mark.parametrize("dims", SHIPPED)
def test_f32_forward_matches_jax_at_shipped_widths(dims):
    """The same widths with enable_amp off: fp32 throughout, exact
    products (the fp32 kernel's plain version against the Pallas kernel in
    interpret mode and the reference)."""
    x, weights, _ = make_inputs(dims, sum(dims) + 2)
    xj = as_jax(x, "float32")
    wj = tuple(as_jax(w, "float32") for w in weights)
    got = tfm.fused_mlp(as_torch(x, "float32"),
                        [as_torch(w, "float32") for w in weights])
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],
                                                        dims[-1])
    for want in (jfm.fused_mlp(xj, wj, 128, True),
                 jfm._forward_reference(xj, wj)):
        assert_close_to_max(got, want, TOL["float32"])


@pytest.mark.parametrize("dims", SHIPPED)
def test_f32_gradients_match_jax_at_shipped_widths(dims):
    x, weights, cot = make_inputs(dims, 3 * sum(dims))
    cot_j = jnp.asarray(cot)

    def loss(xx, ww):
        return jnp.sum(jfm.fused_mlp(xx, ww, 128, True) * cot_j)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(
        as_jax(x, "float32"), tuple(as_jax(w, "float32") for w in weights))
    xt = as_torch(x, "float32", requires_grad=True)
    wt = [as_torch(w, "float32", requires_grad=True) for w in weights]
    (tfm.fused_mlp(xt, wt) * torch.from_numpy(cot)).sum().backward()
    assert_close_to_max(xt.grad, gx_j, TOL["float32"], "dx")
    for i, (w, g) in enumerate(zip(wt, gw_j)):
        assert_close_to_max(w.grad, g, TOL["float32"], f"dw_{i}")


T, F = True, False
# fp32 plans: (threads, row tile, blocks an SM, resident layers). At the
# shipped widths every layer stays resident but the heads' 256 x 256 hidden
# layers and input layers, which stream through the ring in 512-thread
# blocks of 128 rows; the field's bases hold theirs in one 256-thread block
# an SM. Then the edges: widths 1 and 256, odd widths, 8 layers, 8 layers
# of 256 (every layer streamed).
F32_PLANS = {
    (10, 64, 1): (256, 256, 2, [T, T]), (14, 64, 1): (256, 256, 2, [T, T]),
    (24, 256, 65): (256, 64, 1, [T, T]), (32, 256, 65): (256, 64, 1, [T, T]),
    (80, 64, 64, 5): (256, 128, 2, [T, T, T]),
    (80, 256, 256, 3): (512, 128, 1, [F, F, T]),
    (84, 256, 256, 3): (512, 128, 1, [F, F, T]),
    (128, 256, 256, 3): (512, 128, 1, [F, F, T]),
    (1, 256): (256, 64, 2, [T]), (256, 1): (256, 128, 1, [T]),
    (256, 256): (512, 128, 1, [F]),
    (17, 48, 24, 5): (256, 256, 2, [T, T, T]),
    (32,) * 9: (256, 256, 2, [T] * 8),
    (256,) * 9: (512, 128, 1, [F] * 8)}


def test_f32_plans_cover_the_shipped_widths():
    assert set(SHIPPED) <= set(F32_PLANS)


@pytest.mark.parametrize("dims", sorted(F32_PLANS, key=lambda d: (len(d), d)))
def test_f32_plan(dims):
    """The fp32 kernel's plan: which layers stay resident, the shared bytes
    within 227 KB (113 KB where two blocks share an SM), a row tile whose
    sums fit the block's registers, and no layer padded past a multiple of
    8 columns (4 rows)."""
    plan = tfm.f32_plan(dims)
    assert (plan["threads"], plan["rows"], plan["blocks_per_sm"],
            plan["resident"]) == F32_PLANS[dims]
    assert plan["smem_bytes"] <= tfm.SMEM_BUDGET == KIB_227
    if plan["blocks_per_sm"] == 2:
        assert plan["smem_bytes"] <= tfm.HALF_SMEM
    assert plan["n_cov"] == [-(-d // 8) * 8 for d in dims[1:]]
    assert plan["k_pad"] == [-(-d // 4) * 4 for d in dims[:-1]]
    assert plan["rows"] % 8 == 0
    assert plan["rows"] * max(plan["n_cov"]) <= 64 * plan["threads"]
    assert plan["astride"] >= max(plan["n_cov"]) and plan["astride"] % 4 == 0
    streamed = [k for k, r in zip(plan["k_pad"], plan["resident"]) if not r]
    assert plan["slices"] == sum(-(-k // tfm.F32_SLICE) for k in streamed)
    weights = sum(4 * k * c for k, c, r in zip(
        plan["k_pad"], plan["n_cov"], plan["resident"]) if r)
    assert plan["smem_bytes"] == weights + 4 * plan["rows"] * \
        plan["astride"] + 2 * plan["ring_stage"]
    assert (plan["ring_stage"] > 0) == bool(streamed)
    # 512 threads where layers stream, and then one block an SM (they
    # take an SM's registers at 128 a thread).
    assert (plan["threads"] == 512) == bool(streamed)
    assert plan["threads"] * plan["blocks_per_sm"] <= 512


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_fused_mlp.main([])
    with open(bench_fused_mlp.__file__) as f:
        assert "chip_smoke" not in f.read()


def test_bench_baseline_layouts():
    """The baseline source's layouts: bf16 as the package reads it, fp32
    zero-padded to the 32 x 64 slices of the earlier fp32 kernel."""
    x, weights, _ = make_inputs((80, 256, 3), 2)
    bf = [as_torch(w, "bfloat16") for w in weights]
    assert all(k is w for k, w in zip(bench_fused_mlp.baseline_weights(bf),
                                      bf))
    f32 = [as_torch(w, "float32") for w in weights]
    padded = bench_fused_mlp.baseline_weights(f32)
    assert [tuple(p.shape) for p in padded] == [(96, 256), (256, 64)]
    for p, w in zip(padded, f32):
        torch.testing.assert_close(p[:w.shape[0], :w.shape[1]], w, rtol=0,
                                   atol=0)
        rest = p.clone()
        rest[:w.shape[0], :w.shape[1]] = 0
        assert not rest.any()  # zeros beyond the weights


def test_bench_f32_chain_and_bound_on_the_cpu():
    """In fp32 the chain is the plain version's function within 1e-5 and
    the head's bound is its operations over the 67 TFLOP/s FMA peak."""
    x, weights, _ = make_inputs((80, 256, 256, 3), 12)
    xt = as_torch(x, "float32")
    wt = [as_torch(w, "float32") for w in weights]
    assert_close_to_max(bench_fused_mlp.cublas_chain(xt, wt),
                        tfm.fused_mlp_plain(xt, wt), TOL["float32"])
    n = 2097152
    big = torch.empty((n, 80), device="meta")
    out = torch.empty((n, 3), device="meta")
    ms, by = bench_fused_mlp.bound(big, out, wt, (80, 256, 256, 3))
    assert by == "operations"
    assert ms == pytest.approx(2 * n * (80 * 256 + 256 * 256 + 256 * 3)
                               / 67e12 * 1e3)


def test_bench_chain_and_bound_on_the_cpu():
    """The cuBLAS chain computes the plain version's function up to the
    order of sums; the bound of the head is set by its operations."""
    x, weights, _ = make_inputs((80, 256, 256, 3), 11)
    xt = as_torch(x, "bfloat16")
    wt = [as_torch(w, "bfloat16") for w in weights]
    chain = bench_fused_mlp.cublas_chain(xt, wt)
    assert_close_to_max(chain.float(), tfm.fused_mlp_plain(xt, wt).float(),
                        TOL["bfloat16"])
    n = 2097152
    big = torch.empty((n, 80), dtype=torch.bfloat16, device="meta")
    out = torch.empty((n, 3), dtype=torch.bfloat16, device="meta")
    ms, by = bench_fused_mlp.bound(big, out, wt, (80, 256, 256, 3))
    assert by == "operations"
    assert ms == pytest.approx(2 * n * (80 * 256 + 256 * 256 + 256 * 3)
                               / 989e12 * 1e3)
