"""NeRF-W and RobustNeRF nerfacto in nerf_hugs_torch against nerf_hugs_tpu:
the dual-density compositing, the transient head and its renderings and
gradients, the NeRF-W and RobustNeRF losses, three train steps with the
robust thresholds fed back, and the configs the port refuses. The models
are phototourism_nerfacto_nerfw.yml's and distractor_nerfacto_robustnerf
0.8.yml's model sections at toy widths, run on the deterministic path
(rng=None) with the same weights and rays on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.core import render as jrender
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.core import render as trender
from nerf_hugs_torch.losses import zoo as tzoo
from nerf_hugs_torch.models import nerfacto as tnerf
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs

# Compositing: the same float32 arithmetic in the same order.
RENDER_TOL = 1e-6
# Forward values and losses: float32 in both, reductions in another order.
FWD_TOL = 1e-5
# Gradients: relative to each leaf's largest entry.
GRAD_REL = 1e-4
N_RAYS = 64            # 4 patches of 4x4
NUM_IMAGES = 5
PROPOSALS = [
    {"base_res": 4, "hidden_dim": 16, "log2_hashmap_size": 9,
     "features_per_level": 2, "num_levels": 3, "max_res": 16},
    {"base_res": 4, "hidden_dim": 16, "log2_hashmap_size": 10,
     "features_per_level": 2, "num_levels": 4, "max_res": 32}]
# phototourism_nerfacto_nerfw.yml's model section at toy widths.
NERFW_MODEL = {
    "num_proposal_iterations": 2, "num_proposal_samples_per_ray": [16, 12],
    "num_nerf_samples_per_ray": 8, "proposal_initial_sampler": "uniform",
    "proposal_net_args_list": PROPOSALS,
    "use_appearance_embedding": True, "appearance_embedding_dim": 6,
    "use_transient_embedding": True, "transient_embedding_dim": 8,
    "hidden_dim_transient": 16, "transient_type": "nerfw",
    "eval_embedding": "original", "opaque_background": True,
    "distortion_loss_mult": 0.001}
# distractor_nerfacto_robustnerf0.8.yml's at toy widths; the inner patch
# of 2 fits the 4x4 patches.
ROBUST_BASE = {"enable_scene_contraction": True, "far": 6.0,
               "robustnerf_inner_patch_size": 2}
ROBUST_MODEL = {
    "num_proposal_iterations": 2, "num_proposal_samples_per_ray": [16, 12],
    "num_nerf_samples_per_ray": 8, "proposal_initial_sampler": "piecewise",
    "proposal_net_args_list": PROPOSALS,
    "use_appearance_embedding": True, "appearance_embedding_dim": 4,
    "transient_type": "robustnerf", "robustnerf_inlier_quantile": 0.8,
    "eval_embedding": "zero", "opaque_background": True}


def make_config(base=None, **model):
    config = tu.tiny_config(base=base, model={**NERFW_MODEL, **model})
    config.model.num_embeddings = NUM_IMAGES
    return config


def robust_config():
    config = tu.tiny_config(base=ROBUST_BASE, model=ROBUST_MODEL)
    config.model.num_embeddings = NUM_IMAGES
    return config


def rays_for(n: int, seed: int, far: float = 1.2) -> dict:
    arrays = tu.ray_arrays(n, seed)
    arrays["far"] = far * arrays["far"] / 1.2
    arrays["embed_idx"] = np.random.RandomState(seed + 1).randint(
        0, NUM_IMAGES, (n, 1)).astype(np.int32)
    return arrays


def jax_rays(arrays):
    return jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()})


def torch_model(config, params):
    model = tnerf.NerfactoModel(config, "cpu",
                                torch.Generator().manual_seed(0))
    model.load_state_dict(convert_nerfacto_params(params))
    return model


def torch_batch(arrays, rgb):
    return tstructs.Batch(rays=tstructs.Rays(**arrays), rgb=rgb).to("cpu")


def jax_loss_fn(model, config):
    """model.apply + the loss composition of train/step.py:189-233 for the
    config's transient type (thresholds: RobustNeRF's carried state)."""

    def loss_fn(p, rays, rgb, train_frac, thresholds):
        rend, hist = model.apply({"params": p}, None, rays,
                                 train_frac=train_frac, compute_extras=False,
                                 zero_glo=False, zero_tra=False)
        batch = jstructs.Batch(rays=rays, rgb=rgb)
        if config.transient_type == "nerfw":
            losses, stats = jzoo.compute_nerfw_loss(batch, rend, hist, config)
        else:
            losses, stats = jzoo.compute_robustnerf_loss(batch, rend,
                                                         thresholds, config)
        losses["interlevel"] = jzoo.interlevel_loss(hist, config)
        losses["distortion"] = jzoo.distortion_loss(hist, config)
        return jnp.sum(jnp.array(list(losses.values()))), (rend, hist,
                                                           losses, stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def nerfw_model():
    config = make_config()
    arrays = rays_for(N_RAYS, 0)
    model, variables = jnerf.construct_model(jax.random.PRNGKey(0),
                                             jax_rays(arrays), config)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return config, arrays, model, params, rgb, jax_loss_fn(model, config)


def assert_grads_close(model, grads_j):
    want = convert_nerfacto_params(grads_j)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = (np.zeros_like(g_j) if p.grad is None
               else p.grad.detach().numpy())
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=GRAD_REL * float(np.abs(g_j).max()),
                                   err_msg=name)
    return want


@pytest.mark.parametrize("opaque, legacy", [(False, False), (True, False),
                                            (True, True)])
def test_dual_weights_and_combined_colour_match_jax(opaque, legacy):
    rs = np.random.RandomState(int(opaque) + 2 * int(legacy))
    n, s = 40, 12
    tdist = np.sort(rs.uniform(0.1, 3.0, (n, s + 1)), -1).astype(np.float32)
    dirs = rs.randn(n, 3).astype(np.float32)
    dens_s = rs.exponential(2.0, (n, s)).astype(np.float32)
    dens_t = rs.exponential(1.0, (n, s)).astype(np.float32)
    dens_t[:5] = 0.0                               # no transient at all
    rgb_s, rgb_t, bg = (rs.rand(n, s, 3).astype(np.float32),
                        rs.rand(n, s, 3).astype(np.float32),
                        rs.rand(n, 3).astype(np.float32))
    kw = dict(opaque_background=opaque, cumulative_from_first=legacy)
    want = jrender.compute_dual_alpha_weights(dens_s, dens_t, tdist, dirs,
                                              **kw)
    got = trender.compute_dual_alpha_weights(
        *map(torch.from_numpy, (dens_s, dens_t, tdist, dirs)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RENDER_TOL, atol=RENDER_TOL)
    want_c = jrender.composite_combined_color(rgb_s, rgb_t, bg,
                                              *[np.asarray(w) for w in want])
    got_c = trender.composite_combined_color(
        *map(torch.from_numpy, (rgb_s, rgb_t, bg)), *got)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=RENDER_TOL, atol=RENDER_TOL)
    # Without a transient density the combined weights are the static ones.
    np.testing.assert_allclose(got[0][:5].numpy(), got[2][:5].numpy(),
                               rtol=RENDER_TOL, atol=RENDER_TOL)


def test_state_dict_holds_the_transient_head(nerfw_model):
    config, _, _, params, _, _ = nerfw_model
    model = torch_model(config, params)
    state = convert_nerfacto_params(params)
    assert set(state) == set(model.state_dict())
    assert {k for k in state if "mlp_transient" in k} == {
        f"field.mlp_transient.layers.{i}.{leaf}" for i in range(3)
        for leaf in ("weight", "bias")}
    np.testing.assert_array_equal(
        state["field.mlp_transient.layers.0.weight"].numpy(),
        params["field"]["mlp_transient"]["Dense_0"]["kernel"].T)
    nc = config.nerfacto
    head = model.field.mlp_transient.layers
    assert head[0].in_features == nc.geo_feat_dim + 8
    assert [lin.out_features for lin in head] == [16, 16, 5]
    assert model.implicit_mask is None


@pytest.mark.parametrize("train_frac", [0.3, 0.3001])
def test_nerfw_model_renderings_loss_and_gradients_match_jax(nerfw_model,
                                                             train_frac):
    config, arrays, _, params, rgb, loss_and_grads = nerfw_model
    (loss_j, (rend_j, hist_j, losses_j, stats_j)), grads_j = loss_and_grads(
        params, jax_rays(arrays), jnp.asarray(rgb), jnp.float32(train_frac),
        None)
    rend_j, hist_j = jax.tree_util.tree_map(np.asarray, (rend_j, hist_j))
    model = torch_model(config, params)
    batch = torch_batch(arrays, rgb)
    with torch.no_grad():
        rend_t, hist_t = model(batch.rays, train_frac, False, None,
                               zero_glo=False, zero_tra=False)
    for key in ("rgb", "rgb_combined", "rgb_static", "rgb_transient",
                "uncertainty"):
        np.testing.assert_allclose(rend_t[-1][key].numpy(), rend_j[-1][key],
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=key)
    assert rend_t[-1]["uncertainty"].shape == (N_RAYS, 1)
    assert float(rend_t[-1]["uncertainty"].min()) >= config.model.beta_min
    assert "density_transient" in hist_t[-1]
    assert "density_transient" not in hist_t[0]
    for h_t, h_j in zip(hist_t, hist_j):
        for key in h_j:
            np.testing.assert_allclose(h_t[key].numpy(), h_j[key],
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=key)

    loss_t, stats_t = tstep.compute_loss(model, batch, train_frac, config,
                                         None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=FWD_TOL)
    assert set(stats_t["losses"]) == set(losses_j) == {
        "beta", "density", "data", "interlevel", "distortion"}
    for key in losses_j:
        np.testing.assert_allclose(stats_t["losses"][key].item(),
                                   float(losses_j[key]), rtol=FWD_TOL,
                                   err_msg=key)
    want = assert_grads_close(model, tu.unflatten(tu.flat_params(grads_j)))
    for name in ("transient_embedding.weight",
                 "field.mlp_transient.layers.0.weight"):
        assert np.abs(want[name].numpy()).max() > 0, name


def test_nerfw_eval_mode_matches_jax(nerfw_model):
    """The deterministic path with the extras under eval_embedding
    'average' with the transient embedding zeroed (enable_render_zero_tra):
    the appearance row is the table's mean, the transient head sees zeros.
    ('original' is the path of the gradient test; HA-NeRF's tests cover
    every mode of the shared lookup.)"""
    _, arrays, _, params, _, _ = nerfw_model
    config = make_config(eval_embedding="average")
    rend_j, _ = jax.jit(lambda p, r: jnerf.NerfactoModel(
        config=config).apply({"params": p}, None, r, train_frac=0.5,
                             compute_extras=True, zero_glo=False,
                             zero_tra=True))(params, jax_rays(arrays))
    model = torch_model(config, params)
    with torch.no_grad():
        rend_t, _ = model(torch_batch(arrays, None).rays, 0.5, True, None,
                          zero_glo=False, zero_tra=True)
    assert set(rend_t[-1]) == set(rend_j[-1])
    for key in ("rgb", "rgb_combined", "uncertainty", "acc",
                "distance_mean"):
        np.testing.assert_allclose(rend_t[-1][key].numpy(),
                                   np.asarray(rend_j[-1][key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)


def test_nerfw_amp_forward_tracks_jax_bf16(nerfw_model):
    """enable_amp: the transient head in bf16 on both sides, cast back to
    fp32 where JAX casts; the bf16 bound of the base model's test."""
    _, arrays, _, params, _, _ = nerfw_model
    amp = make_config(base={"enable_amp": True})
    rend_j, _ = jax.jit(lambda p, r: jnerf.NerfactoModel(
        config=amp, compute_dtype=jnp.bfloat16).apply(
        {"params": p}, None, r, train_frac=0.5, compute_extras=False,
        zero_glo=False, zero_tra=False))(params, jax_rays(arrays))
    model = torch_model(amp, params)
    assert model.field.mlp_transient.compute_dtype == torch.bfloat16
    with torch.no_grad():
        rend_t, _ = model(torch_batch(arrays, None).rays, 0.5, False, None,
                          zero_glo=False, zero_tra=False)
    for key in ("rgb_combined", "uncertainty"):
        got = rend_t[-1][key].numpy()
        assert got.dtype == np.float32 and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, np.asarray(rend_j[-1][key]),
                                   atol=2e-2, err_msg=key)


@pytest.mark.parametrize("levels", [1, 2])
def test_nerfw_loss_matches_jax(levels):
    """Losses and the gradients they send the colours, beta and the
    transient density; a coarse level has no combined colour."""
    rs = np.random.RandomState(levels)
    n, s = 50, 6
    config = make_config()
    config.data_loss_type = "charb" if levels == 2 else "mse"
    config.data_coarse_loss_mult = 0.1
    rgbs = [rs.rand(n, 3).astype(np.float32) for _ in range(levels)]
    combined = rs.rand(n, 3).astype(np.float32)
    beta = (0.03 + rs.rand(n, 1)).astype(np.float32)
    dens_t = rs.exponential(1.0, (n, s)).astype(np.float32)
    target = rs.rand(n, 4).astype(np.float32)   # RGBA: composited over bg
    bg = rs.rand(n, 3).astype(np.float32)

    def render(rgbs, combined, beta, dens_t, bg):
        rend = [{"rgb": r, "bg_rgb": bg} for r in rgbs]
        rend[-1].update(rgb_combined=combined, uncertainty=beta)
        hist = [{}] * (levels - 1) + [{"density_transient": dens_t}]
        return rend, hist

    def jloss(*args):
        rend, hist = render(*args, jnp.asarray(bg))
        batch = jstructs.Batch(rays=None, rgb=jnp.asarray(target))
        losses, stats = jzoo.compute_nerfw_loss(batch, rend, hist, config)
        return sum(losses.values()), (losses, stats)

    inputs = ([jnp.asarray(r) for r in rgbs], jnp.asarray(combined),
              jnp.asarray(beta), jnp.asarray(dens_t))
    (_, (losses_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(*inputs)

    leaves = ([torch.from_numpy(r).requires_grad_() for r in rgbs],
              *(torch.from_numpy(a).requires_grad_()
                for a in (combined, beta, dens_t)))
    rend, hist = render(*leaves, torch.from_numpy(bg))
    batch = tstructs.Batch(rays=None, rgb=torch.from_numpy(target))
    losses_t, stats_t = tzoo.compute_nerfw_loss(batch, rend, hist, config)
    assert set(losses_t) == set(losses_j) == {"beta", "density", "data"}
    for key in losses_t:
        np.testing.assert_allclose(losses_t[key].item(), losses_j[key],
                                   rtol=FWD_TOL, err_msg=key)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    sum(losses_t.values()).backward()
    got = leaves[0] + list(leaves[1:])
    want = list(grads_j[0]) + list(grads_j[1:])
    for g, w in zip(got, want):
        g = np.zeros_like(w) if g.grad is None else g.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=FWD_TOL,
                                   atol=1e-9)


def robust_errors(seed: int, n: int, p: int, ties: bool) -> np.ndarray:
    """[n, p, p, 3] patch errors; with `ties`, every value on a grid of
    eighths, so the quantile and the threshold test meet equal values."""
    rs = np.random.RandomState(seed)
    errors = rs.rand(n, p, p, 3).astype(np.float32)
    if ties:
        errors = np.floor(errors * 8) / 8
    # One patch of distractor: large errors over a block.
    errors[0, 2:p - 2, 3:p - 1] += 0.9
    return errors.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(p=16, ties=True, filter_size=3, threshold=0.5),
    dict(p=16, ties=False, filter_size=3, threshold=0.35),
    dict(p=16, ties=True, filter_size=4, threshold=0.5),
    dict(p=16, ties=False, filter_size=5, threshold=0.4),
    dict(p=16, ties=False, filter_size=3, threshold=5.0),   # all inliers
    dict(p=8, ties=True, filter_size=2, threshold=0.625),
], ids=["16-ties", "16", "16-even-filter", "16-filter-5", "16-all-inliers",
        "8-ties-even-filter"])
def test_robustnerf_mask_matches_jax(case):
    p = case["p"]
    config = robust_config()
    config.patch_size = p
    config.robustnerf_inner_patch_size = p // 2
    config.robustnerf_smoothed_filter_size = case["filter_size"]
    errors = robust_errors(p, 6, p, case["ties"])
    mask_j, stats_j = jzoo.robustnerf_mask(jnp.asarray(errors),
                                           case["threshold"], config)
    mask_t, stats_t = tzoo.robustnerf_mask(torch.from_numpy(errors),
                                           torch.tensor(case["threshold"]),
                                           config)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert set(stats_t) == set(stats_j)
    for key in stats_j:
        np.testing.assert_allclose(stats_t[key].item(), float(stats_j[key]),
                                   rtol=RENDER_TOL, atol=RENDER_TOL,
                                   err_msg=key)
    if case["threshold"] > 1:
        assert float(mask_t.min()) == 1.0
    else:
        assert 0.0 < float(mask_t.mean()) < 1.0
    config.robustnerf_inner_patch_size = p + 1
    with pytest.raises(ValueError, match="inner_patch_size"):
        tzoo.robustnerf_mask(torch.from_numpy(errors), 0.5, config)


@pytest.mark.parametrize("thresholds", [(0.3,), (0.45, 0.2), (4.0, 4.0)],
                         ids=["one-level", "two-levels", "all-inliers"])
def test_robustnerf_loss_matches_jax(thresholds):
    """The loss, its stats (the next thresholds among them) and the
    gradient it sends the renderings, at patch 16."""
    p, n_patches = 16, 4
    levels = len(thresholds)
    config = robust_config()
    config.patch_size, config.robustnerf_inner_patch_size = p, 8
    config.data_coarse_loss_mult = 0.1
    rs = np.random.RandomState(levels)
    target = np.floor(rs.rand(n_patches * p * p, 3) * 8).astype(
        np.float32) / 8
    rgbs = [np.clip(target + rs.randn(*target.shape).astype(np.float32)
                    * 0.2, 0, 1) for _ in range(levels)]
    rgbs[-1][:40] = 1.0 - target[:40]           # a distractor's rays

    def jloss(rgbs):
        rend = [{"rgb": r} for r in rgbs]
        batch = jstructs.Batch(rays=None, rgb=jnp.asarray(target))
        losses, stats = jzoo.compute_robustnerf_loss(
            batch, rend, jnp.asarray(thresholds, jnp.float32), config)
        return sum(losses.values()), (losses, stats)

    (_, (losses_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, has_aux=True)([jnp.asarray(r) for r in rgbs])
    rgbs_t = [torch.from_numpy(r).requires_grad_() for r in rgbs]
    batch = tstructs.Batch(rays=None, rgb=torch.from_numpy(target))
    losses_t, stats_t = tzoo.compute_robustnerf_loss(
        batch, [{"rgb": r} for r in rgbs_t],
        torch.tensor(thresholds, dtype=torch.float32), config)
    np.testing.assert_allclose(losses_t["data"].item(), losses_j["data"],
                               rtol=FWD_TOL)
    assert set(stats_t) == set(stats_j)
    for key in stats_j:
        np.testing.assert_allclose(stats_t[key].detach().numpy(),
                                   np.asarray(stats_j[key]), rtol=FWD_TOL,
                                   atol=RENDER_TOL, err_msg=key)
    assert stats_t["robust_inlier_threshold"].shape == (levels,)
    sum(losses_t.values()).backward()
    for got, want in zip(rgbs_t, grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=1e-9)


def test_robustnerf_three_steps_feed_thresholds_back_as_jax():
    """Three train steps of the toy RobustNeRF model: each step's
    thresholds are the previous step's robust_inlier_threshold, starting
    at ones(num_ray_levels), and Adam moves the parameters as optax does."""
    config = robust_config()
    arrays = [rays_for(N_RAYS, seed, far=6.0) for seed in (4, 5, 6)]
    rgbs = [np.random.RandomState(seed).rand(N_RAYS, 3).astype(np.float32)
            for seed in (7, 8, 9)]
    model_j, variables = jnerf.construct_model(
        jax.random.PRNGKey(1), jax_rays(arrays[0]), config)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    loss_and_grads = jax_loss_fn(model_j, config)
    tx = optax.adam(functools.partial(
        jmath.learning_rate_decay, lr_init=config.lr_init,
        lr_final=config.lr_final, max_steps=config.max_steps,
        lr_delay_steps=config.lr_delay_steps,
        lr_delay_mult=config.lr_delay_mult), b1=config.adam_beta1,
        b2=config.adam_beta2, eps=config.adam_eps)

    model = torch_model(config, params)
    opt, sched = tstep.create_optimizer(config, model)
    p_j, state = params, tx.init(params)
    thr_t = tstep.initial_inlier_thresholds(config, "cpu")
    # The one rendering reads thresholds[0], and the JAX step comes back
    # with one threshold: starting JAX at that shape spares a second trace.
    assert thr_t.shape == (3,)
    thr_j = jnp.ones(1)
    first_grads = None
    for i, (a, rgb) in enumerate(zip(arrays, rgbs)):
        frac = 0.3 + 0.0001 * i
        (loss_j, (_, _, _, stats_j)), grads = loss_and_grads(
            p_j, jax_rays(a), jnp.asarray(rgb), jnp.float32(frac), thr_j)
        grads = jax.tree_util.tree_map(jnp.nan_to_num, grads)
        updates, state = tx.update(grads, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        thr_j = stats_j["robust_inlier_threshold"]
        if first_grads is None:
            first_grads = convert_nerfacto_params(
                jax.tree_util.tree_map(np.asarray, grads))

        stats = tstep.train_step(model, opt, sched, torch_batch(a, rgb),
                                 frac, config, None, thr_t)
        thr_t = stats["robust_inlier_threshold"]
        np.testing.assert_allclose(float(stats["loss"]), float(loss_j),
                                   rtol=FWD_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(thr_t.numpy(), np.asarray(thr_j),
                                   rtol=1e-6, err_msg=f"step {i}")
        assert 0 < float(stats["robust_mask"][0]) <= 1
        new_j = convert_nerfacto_params(jax.tree_util.tree_map(np.asarray,
                                                               p_j))
        # Adam turns a near-zero gradient into a full-rate step of either
        # sign, so only entries with a clear first gradient are compared.
        for name, p in model.named_parameters():
            g = np.abs(first_grads[name].numpy())
            mask = g >= 1e-6 * g.max()
            np.testing.assert_allclose(p.detach().numpy()[mask],
                                       new_j[name].numpy()[mask], rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i} {name}")
    assert thr_t.shape == (1,) and float(thr_t[0]) < 1.0


def test_nerfw_without_the_transient_embedding_is_refused_as_jax_fails():
    """distractor_nerfacto_nerfw.yml's combination: JAX builds no transient
    head and its loss then fails on the missing uncertainty; the port
    refuses the config at model construction."""
    config = make_config(use_transient_embedding=False)
    with pytest.raises(ValueError, match="use_transient_embedding"):
        tnerf.NerfactoModel(config, "cpu", torch.Generator())
    rays = jax_rays(rays_for(16, 3))
    model_j = jnerf.NerfactoModel(config=config)
    variables = jax.eval_shape(functools.partial(
        model_j.init, train_frac=1.0, compute_extras=False, zero_glo=False,
        zero_tra=True), jax.random.PRNGKey(0), None, rays)
    assert "mlp_transient" not in variables["params"]["field"]
    rend, hist = jax.eval_shape(functools.partial(
        model_j.apply, train_frac=0.5, compute_extras=False, zero_glo=False,
        zero_tra=False), variables, None, rays)
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype), tree)
    batch = jstructs.Batch(rays=None, rgb=jnp.zeros((16, 3)))
    with pytest.raises(KeyError, match="uncertainty"):
        jzoo.compute_nerfw_loss(batch, zeros(rend), zeros(hist), config)


def test_fused_widths_route_the_transient_head():
    """enable_tcnn_mlp builds the transient head on the fused MLP, at the
    widths fused_mlp_widths lists (the shapes the smoke run checks the
    bf16 kernel on)."""
    config = make_config(enable_tcnn_mlp=True)
    widths = tnerf.fused_mlp_widths(config)
    assert widths["field.mlp_transient"] == (15 + 8, 16, 16, 5)
    model = tnerf.NerfactoModel(config, "cpu", torch.Generator())
    head = model.field.mlp_transient
    assert head.fused
    assert [tuple(getattr(head, f"w_{i}").shape) for i in range(3)] == [
        (23, 16), (16, 16), (16, 5)]
    assert "field.mlp_transient" not in tnerf.fused_mlp_widths(
        robust_config())
