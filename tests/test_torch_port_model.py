"""The nerfacto slice of nerf_hugs_torch against nerf_hugs_tpu: forward,
loss and every parameter gradient from the same weights and rays, plus
optax-parity Adam. Runs the deterministic path (rng=None) at toy widths."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.core import math as tmath
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs

# Forward values: float32 in both, reductions in another order.
FWD_TOL = 1e-5
# Gradients: relative to each leaf's largest entry.
GRAD_REL = 1e-4
N_RAYS = 64
UPDATE_FRAC, NO_UPDATE_FRAC = 0.3, 0.3001  # steps 3000 / 3001 of 10000


def jitted_loss_and_grads(model, config):
    """model.apply + the loss composition of train/step.py:189-233, jitted
    once (train_frac stays traced, as in the train step)."""

    def loss_fn(p, rays, rgb, train_frac):
        rend, hist = model.apply({"params": p}, None, rays,
                                 train_frac=train_frac, compute_extras=False,
                                 zero_glo=False, zero_tra=False)
        batch = jstructs.Batch(rays=rays, rgb=rgb)
        losses, stats = jzoo.compute_data_loss(batch, rays, rend, config,
                                               False)
        losses["interlevel"] = jzoo.interlevel_loss(hist, config)
        losses["distortion"] = jzoo.distortion_loss(hist, config)
        return jnp.sum(jnp.array(list(losses.values()))), (rend, hist, stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_model():
    config = tu.tiny_config()
    arrays = tu.ray_arrays(N_RAYS, 0)
    rays = jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    model, variables = jnerf.construct_model(jax.random.PRNGKey(0), rays,
                                             config)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return (config, arrays, rays, model, params, rgb,
            jitted_loss_and_grads(model, config))


def jax_loss_and_grads(jax_model, train_frac):
    _, _, rays, _, params, rgb, loss_and_grads = jax_model
    (loss, aux), grads = loss_and_grads(params, rays, jnp.asarray(rgb),
                                        jnp.float32(train_frac))
    aux = jax.tree_util.tree_map(np.asarray, aux)
    return float(loss), aux, tu.unflatten(tu.flat_params(grads))


def torch_model(jax_model):
    config, arrays, _, _, params, rgb, _ = jax_model
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(convert_nerfacto_params(params))
    batch = tstructs.Batch(rays=tstructs.Rays(**arrays), rgb=rgb).to("cpu")
    return model, batch


def assert_grads_close(model, grads_j):
    want = convert_nerfacto_params(grads_j)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = (np.zeros_like(g_j) if p.grad is None
               else p.grad.detach().numpy())
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_REL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("train_frac", [UPDATE_FRAC, NO_UPDATE_FRAC])
def test_slice_forward_loss_and_gradients_match_jax(jax_model, train_frac):
    loss_j, (rend_j, hist_j, stats_j), grads_j = jax_loss_and_grads(
        jax_model, train_frac)
    model, batch = torch_model(jax_model)
    assert model.proposal_schedule(train_frac)[1] == (
        train_frac == UPDATE_FRAC)

    with torch.no_grad():
        rend_t, hist_t = model(batch.rays, train_frac, False, None)
    np.testing.assert_allclose(rend_t[-1]["rgb"].numpy(), rend_j[-1]["rgb"],
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert len(hist_t) == len(hist_j) == 2
    for h_t, h_j in zip(hist_t, hist_j):
        for key in ("sdist", "weights", "density"):
            np.testing.assert_allclose(h_t[key].numpy(), h_j[key],
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=key)

    loss_t, stats_t = tstep.compute_loss(model, batch, train_frac,
                                         model.config, None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=FWD_TOL)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    if train_frac == NO_UPDATE_FRAC:
        # The proposal net takes no gradient on steps that skip its update.
        assert all(p.grad is None for p in model.proposal_0.parameters())
    assert_grads_close(model, grads_j)


def test_train_step_matches_jax_adam_step(jax_model):
    config, _, _, _, params, _, _ = jax_model
    loss_j, (_, _, stats_j), grads_j = jax_loss_and_grads(jax_model,
                                                          UPDATE_FRAC)
    lr_fn = functools.partial(
        jmath.learning_rate_decay, lr_init=config.lr_init,
        lr_final=config.lr_final, max_steps=config.max_steps,
        lr_delay_steps=config.lr_delay_steps,
        lr_delay_mult=config.lr_delay_mult)
    tx = optax.adam(learning_rate=lr_fn, b1=config.adam_beta1,
                    b2=config.adam_beta2, eps=config.adam_eps)
    grads_j = jax.tree_util.tree_map(jnp.nan_to_num, grads_j)
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = convert_nerfacto_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))
    g_j = convert_nerfacto_params(grads_j)

    model, batch = torch_model(jax_model)
    opt, sched = tstep.create_optimizer(config, model)
    stats = tstep.train_step(model, opt, sched, batch, UPDATE_FRAC, config,
                             None)
    np.testing.assert_allclose(float(stats["loss"]), loss_j, rtol=FWD_TOL)
    np.testing.assert_allclose(
        float(stats["psnr"]),
        float(-10.0 / np.log(10.0) * np.log(stats_j["mses"][-1])),
        rtol=FWD_TOL)
    # Adam turns a near-zero gradient into a full-rate step of either sign,
    # so only entries with a clear gradient are compared.
    for name, p in model.named_parameters():
        g = np.abs(g_j[name].numpy())
        mask = g >= 1e-6 * g.max()
        np.testing.assert_allclose(p.detach().numpy()[mask],
                                   new_j[name].numpy()[mask],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_adam_matches_optax_over_three_steps():
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(5, 3).astype(np.float32),
              "b": rs.randn(7).astype(np.float32)}
    steps = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    steps[1]["b"] = np.zeros_like(params["b"])  # a skipped (gradless) leaf
    kw = dict(lr_init=0.01, lr_final=0.001, max_steps=10, lr_delay_steps=2,
              lr_delay_mult=0.01)
    tx = optax.adam(functools.partial(jmath.learning_rate_decay, **kw),
                    b1=0.9, b2=0.999, eps=1e-15)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p_j)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in params.items()}
    opt, sched = tstep.create_adam(
        p_t.values(), functools.partial(tmath.learning_rate_decay, **kw),
        0.9, 0.999, 1e-15)
    for i, g in enumerate(steps):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        tstep.apply_gradients(
            opt, sched, p_t,
            {k: None if (i == 1 and k == "b") else torch.from_numpy(v)
             for k, v in g.items()})
        for k in params:
            mask = np.abs(steps[0][k]) >= 1e-6 * np.abs(steps[0][k]).max()
            np.testing.assert_allclose(p_t[k].detach().numpy()[mask],
                                       np.asarray(p_j[k])[mask], rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i} {k}")


def test_clip_gradients_match_jax():
    from nerf_hugs_tpu.train import step as jstep
    rs = np.random.RandomState(3)
    flat = {"field/mlp_base/Dense_0/kernel": rs.randn(6, 4),
            "field/hashgrid/table_0": rs.randn(20) * 1e-3,
            "proposal_0/mlp_base/Dense_0/bias": rs.randn(5)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    config = tu.tiny_config()
    config.grad_max_norm, config.grad_max_val = 0.5, 0.8
    want = tu.flat_params(jstep.clip_gradients(
        {"params": tu.unflatten(flat)}, config)["params"])
    got = tstep.clip_gradients(
        {k.replace("/", "."): torch.from_numpy(v) for k, v in flat.items()},
        config)
    for k, v in want.items():
        np.testing.assert_allclose(got[k.replace("/", ".")].numpy(), v,
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_amp_forward_tracks_jax_bf16(jax_model):
    """enable_amp: bf16 MLPs with fp32 params on both sides. bf16 keeps
    ~3 significant digits and the two frameworks round at slightly
    different places, hence the wider bound."""
    _, arrays, rays, _, params, _, _ = jax_model
    amp = tu.tiny_config(base={"enable_amp": True})
    model_j = jnerf.NerfactoModel(config=amp, compute_dtype=jnp.bfloat16)
    rend_j, _ = jax.jit(lambda p, r: model_j.apply(
        {"params": p}, None, r, train_frac=0.5, compute_extras=False))(
        params, rays)
    model = NerfactoModel(amp, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(convert_nerfacto_params(params))
    with torch.no_grad():
        rend_t, _ = model(tstructs.Rays(**arrays).to("cpu"), 0.5, False)
    assert model.field.mlp_base.compute_dtype == torch.bfloat16
    rgb = rend_t[-1]["rgb"].numpy()
    assert rgb.dtype == np.float32 and np.all(np.isfinite(rgb))
    np.testing.assert_allclose(rgb, rend_j[-1]["rgb"], atol=2e-2)


def test_unported_heads_raise():
    # Every head of the zoo is ported. What is still refused: NeRF-W
    # without the transient embedding its head reads (JAX builds no head
    # and then fails in the loss), and an unknown transient_type.
    with pytest.raises(ValueError, match="use_transient_embedding"):
        NerfactoModel(tu.tiny_config(model={"transient_type": "nerfw"}),
                      "cpu", torch.Generator())
    model = NerfactoModel(tu.tiny_config(model={
        "transient_type": "nerfw", "use_transient_embedding": True,
        "use_appearance_embedding": True}), "cpu", torch.Generator())
    assert model.field.mlp_transient is not None
    config = tu.tiny_config(model={"transient_type": "robustnerf"})
    config.robustnerf_inner_patch_size = 2   # within the 4x4 patch
    model = NerfactoModel(config, "cpu", torch.Generator())
    batch = tstructs.Batch(rays=tstructs.Rays(**tu.ray_arrays(16, 0)),
                           rgb=np.zeros((16, 3), np.float32)).to("cpu")
    loss, stats = tstep.compute_loss(model, batch, 0.5, config, None)
    assert torch.isfinite(loss)
    assert stats["robust_inlier_threshold"].shape == (1,)
    config.transient_type = "other"
    with pytest.raises(ValueError, match="unknown transient_type"):
        NerfactoModel(config, "cpu", torch.Generator())
