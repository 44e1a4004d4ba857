"""The Mip-NeRF 360 slice of nerf_hugs_torch against nerf_hugs_tpu: the
model built from JAX's initialised variables through
convert_mipnerf360_params, at toy widths (NerfMLP 2 x 32 with a skip at
layer 1, PropMLP 2 x 16, 8 proposal and 4 NeRF samples, 3 levels), on the
deterministic path (rng=None). Every level's forward within 1e-5, the
loss within 1e-5, every parameter gradient within 1e-4 of its leaf's
largest entry, and one train step of JAX's own step function (per-module
clipping at grad_max_norm 0.001, nan_to_num, Adam)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.models.from_jax import convert_mipnerf360_params
from nerf_hugs_torch.models.mipnerf360 import MipNerf360Model
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.train.render_image import render_image
from nerf_hugs_torch.utils import structs as tstructs
from nerf_hugs_tpu.configs import gin_parser as jgin
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import mipnerf360 as jm
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_tpu.utils import structs as jstructs

FWD_TOL = 1e-5
GRAD_REL = 1e-4
# bf16 keeps ~3 significant digits and the frameworks round in other
# places: the bound of nerfacto's bf16 forward (test_torch_port_model.py).
BF16_TOL = 2e-2
N_RAYS, PATCH = 32, 4
TRAIN_FRAC = 0.4
TOY = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
       "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
       "NerfMLP.net_width_viewdirs = 16", "NerfMLP.net_depth_transient = 2",
       "NerfMLP.net_width_transient = 16", "PropMLP.net_depth = 2",
       "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
       "Model.num_nerf_samples = 4", "Model.num_levels = 3",
       "Config.randomized = False", "Config.vis_num_rays = 5",
       f"Config.batch_size = {N_RAYS}", f"Config.patch_size = {PATCH}",
       "Config.max_steps = 100", "Config.lr_delay_steps = 0"]
VARIANTS = {
    "base": [],
    "glo_contract": ["Model.num_glo_features = 4",
                     "NerfMLP.warp_fn = @coord.contract",
                     "PropMLP.warp_fn = @coord.contract",
                     "Model.raydist_fn = @jnp.reciprocal",
                     "Config.distortion_loss_mult = 0.01",
                     "Config.weight_decay_mults = {'NerfMLP_0': 1e-3, "
                     "'PropMLP_0/Dense_1': 1e-2, "
                     "'GloEmbed_0/embedding': 1e-2}"],
    "withmask": ["Config.transient_type = 'withmask'"],
    "robustnerf": ["Config.transient_type = 'robustnerf'",
                   "Config.robustnerf_inner_patch_size = 2"],
    "nerfw": ["Config.transient_type = 'nerfw'",
              "Model.num_transient_features = 8",
              "Model.num_glo_features = 4"],
    "hanerf": ["Config.transient_type = 'hanerf'",
               "Model.num_transient_features = 8"],
}


def ray_arrays():
    arrays = tu.ray_arrays(N_RAYS, 0)
    arrays["embed_idx"] = (np.arange(N_RAYS) % 3).astype(np.int32)[:, None]
    arrays["static_mask"] = (np.arange(N_RAYS) % 5 > 0).astype(
        np.float32)[:, None]
    return arrays


def jax_loss_fn(model, config):
    """model.apply + the loss composition of JAX's train step
    (nerf_hugs_tpu/train/step.py:189-233)."""

    def loss_fn(p, rays, rgb, train_frac, thresholds):
        rend, hist = model.apply({"params": p}, None, rays,
                                 train_frac=train_frac, compute_extras=False,
                                 zero_glo=False, zero_tra=False)
        batch = jstructs.Batch(rays=rays, rgb=rgb)
        kind = config.transient_type
        if kind in (None, "withmask"):
            losses, stats = jzoo.compute_data_loss(batch, rays, rend, config,
                                                   kind == "withmask")
        elif kind == "robustnerf":
            losses, stats = jzoo.compute_robustnerf_loss(batch, rend,
                                                         thresholds, config)
        elif kind == "nerfw":
            losses, stats = jzoo.compute_nerfw_loss(batch, rend, hist,
                                                    config)
        else:
            losses, stats = jzoo.compute_hanerf_loss(batch, rend, train_frac,
                                                     config)
        losses["interlevel"] = jzoo.interlevel_loss(hist, config)
        if config.distortion_loss_mult > 0:
            losses["distortion"] = jzoo.distortion_loss(hist, config)
        if config.weight_decay_mults:
            l2 = jstep.summarize_tree(p, jstep.tree_norm_sq)
            losses["weight"] = jnp.sum(jnp.array(
                [m * l2[k] for k, m in config.weight_decay_mults.items()]))
        return jnp.sum(jnp.array(list(losses.values()))), (rend, hist, stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@dataclasses.dataclass
class Case:
    jconfig: object
    tconfig: object
    arrays: dict
    rgb: np.ndarray
    jmodel: object
    params: dict
    loss_and_grads: object

    def jax_rays(self):
        return jstructs.Rays(**{k: jnp.asarray(v)
                                for k, v in self.arrays.items()})

    def batch(self, device="cpu"):
        return tstructs.Batch(rays=tstructs.Rays(**self.arrays),
                              rgb=self.rgb).to(device)

    def thresholds(self):
        return np.full(self.jconfig.num_ray_levels, 0.3, np.float32)

    def torch_model(self, config=None):
        model = MipNerf360Model(config or self.tconfig, "cpu",
                                torch.Generator().manual_seed(0))
        model.load_state_dict(convert_mipnerf360_params(self.params))
        return model

    def jax_loss(self):
        (loss, aux), grads = self.loss_and_grads(
            self.params, self.jax_rays(), jnp.asarray(self.rgb),
            jnp.float32(TRAIN_FRAC), jnp.asarray(self.thresholds()))
        return (float(loss), jax.tree_util.tree_map(np.asarray, aux),
                tu.unflatten(tu.flat_params(grads)))


def make_case(extra) -> Case:
    bindings = TOY + list(extra)
    jconfig = jgin.parse_gin_configs([], bindings)
    arrays = ray_arrays()
    rays = jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    model, variables = jm.construct_model(jax.random.PRNGKey(0), rays,
                                          jconfig)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return Case(jconfig, tgin.parse_gin_configs([], bindings), arrays, rgb,
                model, params, jax_loss_fn(model, jconfig))


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    return make_case(VARIANTS[request.param])


def assert_grads_close(model, grads_j):
    want = convert_mipnerf360_params(grads_j)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = (np.zeros_like(g_j) if p.grad is None
               else p.grad.detach().numpy())
        scale = float(np.abs(g_j).max())
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_REL * scale,
                                   err_msg=name)


def test_forward_of_every_level_matches_jax(case):
    rend_j, hist_j = case.jmodel.apply(
        {"params": case.params}, None, case.jax_rays(),
        train_frac=TRAIN_FRAC, compute_extras=True, zero_glo=False,
        zero_tra=False)
    model = case.torch_model()
    with torch.no_grad():
        rend_t, hist_t = model(case.batch().rays, TRAIN_FRAC, True, None,
                               zero_glo=False, zero_tra=False)
    assert len(rend_t) == len(rend_j) == len(hist_t) == 3
    for level, (r_t, r_j) in enumerate(zip(rend_t + hist_t,
                                           list(rend_j) + list(hist_j))):
        assert set(r_t) == set(r_j), level
        for key in r_j:
            np.testing.assert_allclose(r_t[key].numpy(), r_j[key],
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=f"{level} {key}")


def test_loss_and_gradients_match_jax(case):
    loss_j, (_, _, stats_j), grads_j = case.jax_loss()
    model = case.torch_model()
    loss_t, stats_t = tstep.compute_loss(
        model, case.batch(), TRAIN_FRAC, case.tconfig, None,
        torch.from_numpy(case.thresholds()))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=FWD_TOL)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    if case.tconfig.weight_decay_mults:
        assert "weight" in stats_t["losses"]
    assert_grads_close(model, grads_j)


def test_train_step_matches_jax_train_step(case):
    """One step of JAX's own jitted train step against the port's, from
    the same weights. Each new parameter is within 1e-6 relative of JAX's
    plus what the gradients' tolerance allows: Adam's first step is
    lr g / (|g| + eps), whose slope in g is at most lr / eps, so clipped
    gradients that agree within GRAD_REL of their leaf's largest entry
    move a parameter by at most lr / eps x GRAD_REL x that entry more."""
    mesh = jmesh.make_mesh(jax.devices()[:1])
    state, _ = jstep.create_optimizer(case.jconfig,
                                      {"params": case.params})
    step_j = jstep.create_train_step(case.jmodel, case.jconfig, mesh)
    batch_j = jstructs.Batch(rays=case.jax_rays(), rgb=jnp.asarray(case.rgb))
    new_state, stats_j, _ = step_j(jax.random.PRNGKey(0), state, batch_j,
                                   jnp.float32(TRAIN_FRAC),
                                   jnp.asarray(case.thresholds()))
    new_j = convert_mipnerf360_params(jax.tree_util.tree_map(
        np.asarray, new_state.params["params"]))
    _, _, grads_j = case.jax_loss()
    clipped = convert_mipnerf360_params(jax.tree_util.tree_map(
        np.asarray, jstep.clip_gradients({"params": grads_j},
                                         case.jconfig)["params"]))
    lr = float(jmath.learning_rate_decay(
        0, case.jconfig.lr_init, case.jconfig.lr_final,
        case.jconfig.max_steps, case.jconfig.lr_delay_steps,
        case.jconfig.lr_delay_mult))

    model = case.torch_model()
    old = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = tstep.create_optimizer(case.tconfig, model)
    stats = tstep.train_step(model, opt, sched, case.batch(), TRAIN_FRAC,
                             case.tconfig, None,
                             torch.from_numpy(case.thresholds()))
    np.testing.assert_allclose(float(stats["loss"]), float(stats_j["loss"]),
                               rtol=FWD_TOL)
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), new_j[name].numpy()
        assert not np.array_equal(got, old[name].numpy()), name
        slack = (lr / case.jconfig.adam_eps * GRAD_REL
                 * float(np.abs(clipped[name].numpy()).max()))
        np.testing.assert_array_less(np.abs(got - want),
                                     1e-6 * np.abs(want) + slack + 1e-12,
                                     err_msg=name)


def test_adam_step_on_jax_gradients_matches_jax(case):
    """The optimizer alone, with no gradient error in the way: JAX's
    clipped gradients go through optax's Adam and through the port's
    (nan_to_num, the fused OptaxAdam, the schedule's first rate), and
    every new parameter is within 1e-6 relative of JAX's, relative to the
    larger of the parameter and the step's rate (a zero-initialised bias
    moves by about the rate)."""
    _, _, grads_j = case.jax_loss()
    clipped_j = jax.tree_util.tree_map(
        jnp.nan_to_num,
        jstep.clip_gradients({"params": grads_j}, case.jconfig)["params"])
    state, _ = jstep.create_optimizer(case.jconfig,
                                      {"params": case.params})
    new_state = state.apply_gradients(grads={"params": clipped_j})
    new_j = convert_mipnerf360_params(jax.tree_util.tree_map(
        np.asarray, new_state.params["params"]))
    clipped = convert_mipnerf360_params(jax.tree_util.tree_map(
        np.asarray, clipped_j))
    lr = float(jmath.learning_rate_decay(
        0, case.jconfig.lr_init, case.jconfig.lr_final,
        case.jconfig.max_steps, case.jconfig.lr_delay_steps,
        case.jconfig.lr_delay_mult))

    model = case.torch_model()
    params = dict(model.named_parameters())
    opt, sched = tstep.create_optimizer(case.tconfig, model)
    with torch.no_grad():
        tstep.apply_gradients(opt, sched, params, clipped)
    assert set(params) == set(new_j)
    for name, p in params.items():
        got, want = p.detach().numpy(), new_j[name].numpy()
        np.testing.assert_array_less(np.abs(got - want),
                                     1e-6 * np.maximum(np.abs(want), lr),
                                     err_msg=name)


def test_per_module_clipping_matches_jax(case):
    """Clipping groups the gradients by top-level module (NerfMLP_0,
    PropMLP_0, the embeddings, the mask) as JAX's clip_gradients does, at
    the shipped grad_max_norm of 0.001."""
    assert case.tconfig.grad_max_norm == 0.001
    _, _, grads_j = case.jax_loss()
    want = convert_mipnerf360_params(jax.tree_util.tree_map(
        np.asarray, jstep.clip_gradients({"params": grads_j},
                                         case.jconfig)["params"]))
    got = tstep.clip_gradients(convert_mipnerf360_params(grads_j),
                               case.tconfig)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


def test_param_tree_names_are_flax_names(case):
    model = case.torch_model()
    flat = tu.flat_params(case.params)
    assert {"/".join(model.flax_path(n)) for n in model.state_dict()} \
        == set(flat)
    for name, v in model.state_dict().items():
        path = model.flax_path(name)
        want = flat["/".join(path)].shape
        if path[-1] == "kernel":    # a Dense kernel is [in, out]
            want = want[::-1]
        assert tuple(v.shape) == tuple(want), name
    tops = {n.split(".")[0] for n in model.state_dict()}
    from nerf_hugs_torch.models.mipnerf360 import module_names
    assert tops == set(module_names(case.tconfig))


def test_finetune_partitions_match_jax(case):
    labels_j = tu.flat_params(jstep.finetune_partitions(
        case.jconfig, {"params": case.params})["params"])
    model = case.torch_model()
    labels_t = tstep.finetune_partitions(
        case.tconfig, [n for n, _ in model.named_parameters()])
    assert {"/".join(model.flax_path(n)): v for n, v in labels_t.items()} \
        == {k: str(v) for k, v in labels_j.items()}


@pytest.fixture(scope="module")
def remat_case():
    return make_case(VARIANTS["glo_contract"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_the_gradients(remat_case, dtype):
    """torch.utils.checkpoint recomputes each level's MLP in the backward
    pass: the loss and every gradient are those of the plain run."""
    results = []
    for remat in (False, True):
        config = tgin.parse_gin_configs([], TOY + VARIANTS["glo_contract"] + [
            f"Model.compute_dtype = '{dtype}'", f"Model.remat_mlp = {remat}"])
        model = remat_case.torch_model(config)
        assert model.NerfMLP_0.remat == remat
        loss, _ = tstep.compute_loss(model, remat_case.batch(), TRAIN_FRAC,
                                     config, None)
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone() for n, p in
                                      model.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert loss_a == loss_b
    for name in grads_a:
        torch.testing.assert_close(grads_b[name], grads_a[name], rtol=0,
                                   atol=0, msg=name)


def test_bf16_remat_forward_tracks_jax(remat_case):
    """The *_tpu_bf16 overlays' model: bf16 MLP compute with fp32
    parameters and heads, and remat, on both sides."""
    extra = VARIANTS["glo_contract"] + ["Model.compute_dtype = 'bfloat16'",
                                        "Model.remat_mlp = True"]
    jconfig = jgin.parse_gin_configs([], TOY + extra)
    model_j = jm.MipNerf360Model(config=jconfig)
    rend_j, _ = jax.jit(lambda p, r: model_j.apply(
        {"params": p}, None, r, train_frac=TRAIN_FRAC, compute_extras=False,
        zero_glo=False, zero_tra=False))(remat_case.params,
                                         remat_case.jax_rays())
    model = remat_case.torch_model(tgin.parse_gin_configs([], TOY + extra))
    assert model.NerfMLP_0.compute_dtype == torch.bfloat16
    rend_t, _ = model(remat_case.batch().rays, TRAIN_FRAC, False, None,
                      zero_glo=False, zero_tra=False)
    for r_t, r_j in zip(rend_t, rend_j):
        rgb = r_t["rgb"].detach().numpy()
        assert rgb.dtype == np.float32 and np.all(np.isfinite(rgb))
        np.testing.assert_allclose(rgb, r_j["rgb"], atol=BF16_TOL)


def test_transient_checks_come_first():
    for extra, match in (
            (["Config.transient_type = 'nerfw'"], "> 0"),
            (["Config.transient_type = 'withmask'",
              "Model.num_transient_features = 4"], "== 0"),
            (["Config.transient_type = 'other'"], "unknown")):
        with pytest.raises(ValueError, match=match):
            construct_model(tgin.parse_gin_configs([], TOY + extra), "cpu",
                            torch.Generator())
    with pytest.raises(ValueError, match="use_transient_embedding"):
        construct_model(tgin.parse_gin_configs(
            [], ["Config.model_type = 'nerf'",
                 "Config.transient_type = 'nerfw'"]), "cpu",
            torch.Generator())
    with pytest.raises(ValueError, match="unknown model_type"):
        construct_model(tgin.parse_gin_configs(
            [], ["Config.model_type = 'other'"]), "cpu", torch.Generator())


def test_render_image_carries_the_ray_bags(remat_case):
    """Per-ray buffers come back as [H, W, ...] and each level's ray_*
    bag as a list subsampled to vis_num_rays; the chunking changes
    nothing."""
    model = remat_case.torch_model()
    config = remat_case.tconfig
    rays = tstructs.Rays(**{k: v.reshape(4, 8, -1)
                            for k, v in remat_case.arrays.items()})
    outs = []
    for chunk in (7, 32):
        config.render_chunk_size = chunk
        outs.append(render_image(model, rays, TRAIN_FRAC, config, "cpu"))
    a, b = outs
    assert a["rgb"].shape == (4, 8, 3) and a["acc"].shape == (4, 8)
    np.testing.assert_allclose(a["rgb"], b["rgb"], rtol=1e-6, atol=1e-6)
    assert [x.shape for x in a["ray_sdist"]] == [(5, 9), (5, 9), (5, 5)]
    assert [x.shape for x in a["ray_weights"]] == [(5, 8), (5, 8), (5, 4)]
    assert [x.shape for x in a["ray_rgbs"]] == [(5, 8, 3), (5, 8, 3),
                                                (5, 4, 3)]
    with torch.no_grad():
        want, _ = model(tstructs.Rays(**remat_case.arrays).to("cpu"),
                        TRAIN_FRAC, True, None,
                        zero_glo=config.enable_render_zero_glo,
                        zero_tra=config.enable_render_zero_tra)
    np.testing.assert_allclose(a["rgb"].reshape(-1, 3),
                               want[-1]["rgb"].numpy(), rtol=1e-6, atol=1e-6)
