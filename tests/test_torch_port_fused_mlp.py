"""nerf_hugs_torch's fused MLP against nerf_hugs_tpu's: the op (forward
and custom-VJP gradients, fp32 and bf16) and the nerfacto model with
enable_tcnn_mlp on for the field and the proposal net.

The JAX side runs its Pallas kernel in interpret mode on the CPU; the port
runs the plain version through the same autograd.Function that launches
the CUDA kernel on a GPU. The kernel itself is held against the plain
version by the `cuda`-marked test here (skips without a GPU) and by
chip_smoke.py at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_model import jitted_loss_and_grads

import torch_port_util as tu
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.ops import fused_mlp as jfm
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.ops import fused_mlp as tfm
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs
from nerf_hugs_torch.utils import trace

# Relative to each output's largest entry. fp32: the two sides sum the
# same exact products in another order. bf16: both round at the same
# places, so an fp32 sum that lands on a rounding boundary flips one bf16
# ulp; two ulps (2^-7 of the max) bound that with its downstream effect.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
WIDTHS = [(14, 64, 1), (32, 64, 17), (80, 64, 64, 3), (32, 256, 65)]
N_ROWS = 300  # not a multiple of the JAX block, so its padding is covered


def make_inputs(dims, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(N_ROWS, dims[0]).astype(np.float32)
    weights = [(rs.randn(dims[i], dims[i + 1]) / np.sqrt(dims[i])
                ).astype(np.float32) for i in range(len(dims) - 1)]
    cot = rs.randn(N_ROWS, dims[-1]).astype(np.float32)
    return x, weights, cot


def as_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def as_torch(a, dtype, requires_grad=False):
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t.requires_grad_(requires_grad)


def assert_close_to_max(got, want, tol, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", WIDTHS)
def test_forward_matches_jax_kernel_and_reference(dims, dtype):
    x, weights, _ = make_inputs(dims, sum(dims))
    xj = as_jax(x, dtype)
    wj = tuple(as_jax(w, dtype) for w in weights)
    want_kernel = jfm.fused_mlp(xj, wj, 128, True)
    want_ref = jfm._forward_reference(xj, wj)
    xt = as_torch(x, dtype)
    wt = [as_torch(w, dtype) for w in weights]
    got = tfm.fused_mlp(xt, wt)
    plain = tfm.fused_mlp_plain(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (N_ROWS, dims[-1])
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    for want in (want_kernel, want_ref):
        assert_close_to_max(got.float(), want.astype(jnp.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", WIDTHS)
def test_gradients_match_jax_custom_vjp(dims, dtype):
    x, weights, cot = make_inputs(dims, 7 * sum(dims))
    cot_j = jnp.asarray(cot)

    def loss(xx, ww):
        out = jfm.fused_mlp(xx, ww, 128, True)
        return jnp.sum(out.astype(jnp.float32) * cot_j)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(
        as_jax(x, dtype), tuple(as_jax(w, dtype) for w in weights))
    xt = as_torch(x, dtype, requires_grad=True)
    wt = [as_torch(w, dtype, requires_grad=True) for w in weights]
    (tfm.fused_mlp(xt, wt).float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    assert_close_to_max(xt.grad.float(), gx_j.astype(jnp.float32),
                        TOL[dtype], "dx")
    for i, (w, g) in enumerate(zip(wt, gw_j)):
        assert w.grad.dtype == w.dtype
        assert_close_to_max(w.grad.float(), g.astype(jnp.float32),
                            TOL[dtype], f"dw_{i}")


def test_backward_saves_only_x_and_weights():
    x, weights, _ = make_inputs((14, 64, 1), 0)
    xt = as_torch(x, "float32", requires_grad=True)
    wt = [as_torch(w, "float32", requires_grad=True) for w in weights]
    out = tfm.fused_mlp(xt, wt)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 + len(wt)
    assert saved[0] is xt or saved[0].data_ptr() == xt.data_ptr()


def test_helper_init_and_kernel_argument_checks():
    mlp = tfm.FusedMLP((80, 256, 256, 3))
    weights = mlp.init(torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in weights] == [(80, 256), (256, 256),
                                                 (256, 3)]
    for w, fan_in in zip(weights, (80, 256, 256)):
        assert w.dtype == torch.float32
        bound = np.sqrt(6.0 / fan_in)
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.9 * bound
    assert mlp(weights, torch.zeros(5, 80)).shape == (5, 3)
    x = torch.zeros(4, 80)
    assert tfm._check_kernel_args(x, weights) == [80, 256, 256, 3]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfm._check_kernel_args(x.double(), [w.double() for w in weights])
    with pytest.raises(ValueError, match="weight 1"):
        tfm._check_kernel_args(x, [weights[0], weights[0]])
    with pytest.raises(ValueError, match="weight 0"):
        tfm._check_kernel_args(x, [weights[0].bfloat16()])
    with pytest.raises(ValueError, match="widths"):
        tfm._check_kernel_args(torch.zeros(4, 300), [torch.zeros(300, 2)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_weight_layout(dtype):
    """What the kernel reads: the fp32 kernel and the resident bf16 kernel
    take the weights as they are (no copy); the streamed bf16 kernel takes
    the zero-padded slice layout, W^T."""
    _, weights, _ = make_inputs((80, 256, 3), 1)
    ws = [as_torch(w, dtype) for w in weights]
    got = tfm.kernel_weights(ws)
    assert len(got) == len(ws) and all(k is w for k, w in zip(got, ws))
    if dtype == "float32":
        # Even widths no block can hold take the fp32 weights as they are.
        big = [torch.ones(256, 256)] * 8
        assert all(k is w for k, w in zip(tfm.kernel_weights(big), big))
        return
    streamed = tfm.streamed_weights(ws)
    assert [tuple(p.shape) for p in streamed] == [(256, 128), (64, 256)]
    for p, w in zip(streamed, ws):
        w = w.t()
        assert p.dtype == w.dtype and p.is_contiguous()
        torch.testing.assert_close(p[:w.shape[0], :w.shape[1]], w, rtol=0,
                                   atol=0)
        rest = p.clone()
        rest[:w.shape[0], :w.shape[1]] = 0
        assert not rest.any()  # zeros beyond the weights


FUSED_MODEL = {"enable_tcnn_mlp": True, "proposal_net_args_list": [
    dict(tu.TINY_MODEL["proposal_net_args_list"][0], enable_tcnn_mlp=True)]}
N_RAYS = 64


@pytest.fixture(scope="module")
def fused_jax_model():
    config = tu.tiny_config(model=FUSED_MODEL)
    arrays = tu.ray_arrays(N_RAYS, 0)
    rays = jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    model, variables = jnerf.construct_model(jax.random.PRNGKey(0), rays,
                                             config)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return config, arrays, rays, params, rgb, jitted_loss_and_grads(model,
                                                                    config)


def test_fused_parameter_tree_converts(fused_jax_model):
    _, _, _, params, _, _ = fused_jax_model
    state = convert_nerfacto_params(params)
    assert set(state) >= {"field.mlp_base.w_0", "field.mlp_base.w_1",
                          "field.mlp_head.w_2", "proposal_0.mlp_base.w_1"}
    assert not any(".layers." in k for k in state)
    np.testing.assert_array_equal(state["field.mlp_head.w_0"].numpy(),
                                  params["field"]["mlp_head"]["w_0"])
    mixed = {"field": {"mlp_base": {"w_0": np.zeros((2, 2)), "Dense_1": {
        "kernel": np.zeros((2, 2)), "bias": np.zeros(2)}}}}
    with pytest.raises(ValueError, match="mixes"):
        convert_nerfacto_params(mixed)


@pytest.mark.parametrize("train_frac", [0.3, 0.3001])
def test_fused_model_matches_jax(fused_jax_model, train_frac):
    """Renderings within 1e-5, the loss gradient of every leaf within 1e-4
    of its max (fp32, the tolerances of the Dense-path slice test)."""
    config, arrays, rays, params, rgb, loss_and_grads = fused_jax_model
    (loss_j, (rend_j, hist_j, _)), grads_j = loss_and_grads(
        params, rays, jnp.asarray(rgb), jnp.float32(train_frac))
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    assert model.field.mlp_head.fused and model.proposal_0.mlp_base.fused
    model.load_state_dict(convert_nerfacto_params(params))
    batch = tstructs.Batch(rays=tstructs.Rays(**arrays), rgb=rgb).to("cpu")
    with torch.no_grad():
        rend_t, hist_t = model(batch.rays, train_frac, False, None)
    np.testing.assert_allclose(rend_t[-1]["rgb"].numpy(),
                               np.asarray(rend_j[-1]["rgb"]), rtol=1e-5,
                               atol=1e-5)
    for h_t, h_j in zip(hist_t, hist_j):
        np.testing.assert_allclose(h_t["density"].numpy(),
                                   np.asarray(h_j["density"]), rtol=1e-5,
                                   atol=1e-5)
    loss_t, _ = tstep.compute_loss(model, batch, train_frac, config, None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = convert_nerfacto_params(tu.unflatten(tu.flat_params(grads_j)))
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = np.zeros_like(g_j) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=1e-4 * float(np.abs(g_j).max()),
                                   err_msg=name)


def test_each_proposal_net_follows_its_own_switch():
    """The field follows the top-level flag, each proposal net its own
    proposal_net_args_list entry (JAX nerfacto.py:259, 272, 283)."""
    only_field = tu.tiny_config(model={"enable_tcnn_mlp": True})
    model = NerfactoModel(only_field, "cpu", torch.Generator().manual_seed(0))
    assert model.field.mlp_base.fused and model.field.mlp_head.fused
    assert not model.proposal_0.mlp_base.fused
    only_prop = tu.tiny_config(model={"proposal_net_args_list": [
        FUSED_MODEL["proposal_net_args_list"][0]]})
    model = NerfactoModel(only_prop, "cpu", torch.Generator().manual_seed(0))
    assert not model.field.mlp_base.fused
    assert model.proposal_0.mlp_base.fused
    assert {k for k, _ in model.proposal_0.named_parameters()} == {
        "hashgrid.table", "mlp_base.w_0", "mlp_base.w_1"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel builds with nvcc")
    return torch.device("cuda")


# (widths, dtype, rows, rows skipped at the start of x): every width in
# both dtypes at 2100 rows, then the bf16 resident kernel's edges: n below
# one tile, n not a multiple of 64, x starting one row in (not 16-byte
# aligned where 2 d_in is not a multiple of 16), widths 1 and 256, 8
# layers, the widest shipped head (one warpgroup a block), and 8 layers of
# 256, which no block can hold (the streamed kernel).
KERNEL_CASES = [(dims, dtype, 2100, 0) for dims in WIDTHS
                for dtype in ("float32", "bfloat16")] + [
    (dims, "bfloat16", n, skip) for dims, n, skip in (
        ((14, 64, 1), 37, 0), ((80, 256, 256, 3), 4097, 1),
        ((32, 256, 65), 100, 1), ((1, 256), 129, 0), ((256, 256), 64, 0),
        ((256, 1), 65, 1), ((17, 48, 24, 5), 1000, 1), ((32,) * 9, 513, 0),
        ((128, 256, 256, 3), 300, 1), ((256,) * 9, 200, 1))] + [
    # The fp32 kernel's edges: n below one tile, ragged from row 1, widths
    # 1, 256 and odd, 8 layers of 256 (every layer streamed), NeRF-W's
    # transient head (two blocks an SM, K split at the output layer) and
    # the widest head (two layers streamed).
    (dims, "float32", n, skip) for dims, n, skip in (
        ((14, 64, 1), 37, 0), ((80, 256, 256, 3), 4097, 1),
        ((32, 256, 65), 100, 1), ((1, 256), 129, 0), ((256, 1), 65, 1),
        ((17, 48, 24, 5), 1000, 1), ((256,) * 9, 200, 1),
        ((80, 64, 64, 5), 3000, 1), ((128, 256, 256, 3), 300, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,dtype,n,skip", KERNEL_CASES)
def test_kernel_matches_plain_version(cuda, dims, dtype, n, skip):
    x, weights, _ = make_inputs(dims, 3)
    rows = np.concatenate([x] * (-(-(n + skip) // x.shape[0])))[:n + skip]
    xt = as_torch(rows, dtype).to(cuda)[skip:]
    wt = [as_torch(w, dtype).to(cuda) for w in weights]
    fwd = tfm.fused_mlp_fwd
    counters = lambda: tuple(
        trace.counters().get(f"fused_mlp_fwd.{k}", 0)
        for k in ("launches", "launches_resident", "launches_streamed",
                  "launches_f32"))
    before = counters()
    got = fwd(xt, wt)
    resident = tfm.is_resident(xt.dtype, dims)
    bf16 = dtype == "bfloat16"
    assert counters() == (before[0] + 1, before[1] + resident,
                          before[2] + (bf16 and not resident),
                          before[3] + (not bf16))
    want = tfm.fused_mlp_plain(xt, wt)
    torch.cuda.synchronize()
    assert got.shape == (n, dims[-1])
    assert_close_to_max(got.float().cpu(), want.float().cpu(), TOL[dtype])
    with pytest.raises(ValueError):
        tfm.fused_mlp_fwd(xt, [w.t() for w in wt])
