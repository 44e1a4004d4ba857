"""Vanilla NeRF in nerf_hugs_torch against nerf_hugs_tpu: PointMLP alone,
the fine pass's merged intervals alone, the whole model as base, NeRF-W
and HA-NeRF (renderings within 1e-5, the loss within 1e-5, every gradient
within 1e-4 of its leaf's largest entry), one step of JAX's own train step,
the finetune partition, preflight on the shipped `model_type: nerf`
yamls, and the drivers at toy widths. The models are the shipped yamls'
model sections at toy widths (a 5-layer trunk of 32 with its skip at layer
4, 8 + 8 samples), built from JAX's initialised variables through
convert_vanilla_params and run on the deterministic path (rng=None).

The whole-model loss leaves the interlevel term out (interlevel_loss_mult
0), and a test of its own holds that term on JAX's ray history. In exact
arithmetic every fine fence between two adjacent coarse centres that no
fine sample separates is a coarse fence; torch.linspace and jnp.linspace
round the samples' stratification by one float32 ulp apart, which moves
such a fence to one side of the coarse fence or the other, and
lossfun_outer's searchsorted then counts one coarse interval more or less
(a jump of 2% of the term at these widths, while every sdist agrees within
2e-7)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.configs import config as tcfg
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.eval import main as eval_main
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.models import vanilla as tvan
from nerf_hugs_torch.models.from_jax import convert_vanilla_params
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs
from nerf_hugs_tpu.configs import config as jcfg
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import vanilla as jvan
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_tpu.utils import structs as jstructs

FWD_TOL = 1e-5
GRAD_REL = 1e-4
N_RAYS = 32
TRAIN_FRAC = 0.4
REPO = pathlib.Path(__file__).resolve().parents[1]
NERF_YAMLS = sorted((REPO / "configs" / "nerfacto").glob("*_nerf*.yml"))
NERF_YAMLS = [p for p in NERF_YAMLS if "nerfacto" not in p.stem]
# The three yamls whose loader neither package has.
ROBUST_YAMLS = ("distractor_nerf", "distractor_nerf_hanerf",
                "distractor_nerf_nerfw")
VANILLA_BASE = {"model_type": "nerf", "far": 1.2, "near": 0.05,
                "eval_images_num": 1}
VANILLA_MODEL = {
    "net_depth": 5, "net_width": 32, "max_deg_point": 4, "deg_view": 2,
    "num_coarse_nerf_samples_per_ray": 8,
    "num_fine_nerf_samples_per_ray": 8, "proposal_initial_sampler": "uniform",
    "opaque_background": True, "coarse_rgb_loss_mult": 0.5,
    "rgb_loss_type": "mse"}
VARIANTS = {
    "base": {},
    "nerfw": {"transient_type": "nerfw", "use_appearance_embedding": True,
              "appearance_embedding_dim": 8, "use_transient_embedding": True,
              "transient_embedding_dim": 8, "eval_embedding": "average"},
    "hanerf": {"transient_type": "hanerf", "use_transient_embedding": True,
               "transient_embedding_dim": 8},
}


def vanilla_config(model=None, base=None):
    """(JAX config, port config) of the toy vanilla yaml."""
    import tempfile

    from nerf_hugs_tpu.configs import yaml_loader as jyaml
    with tempfile.TemporaryDirectory() as d:
        path = tu.write_tiny_yaml(d, base={**VANILLA_BASE, **(base or {})},
                                  model={**VANILLA_MODEL, **(model or {})})
        return (jyaml.load_yaml_config(path),
                driver.load_config(path, "data", "ckpt"))


def ray_arrays():
    arrays = tu.ray_arrays(N_RAYS, 0)
    arrays["embed_idx"] = (np.arange(N_RAYS) % 3).astype(np.int32)[:, None]
    return arrays


def jax_loss_fn(model, config):
    """model.apply + the loss composition of JAX's train step
    (nerf_hugs_tpu/train/step.py:189-233)."""

    def loss_fn(p, rays, rgb, train_frac):
        rend, hist = model.apply({"params": p}, None, rays,
                                 train_frac=train_frac, compute_extras=False,
                                 zero_glo=False, zero_tra=False)
        batch = jstructs.Batch(rays=rays, rgb=rgb)
        kind = config.transient_type
        if kind is None:
            losses, stats = jzoo.compute_data_loss(batch, rays, rend, config,
                                                   False)
        elif kind == "nerfw":
            losses, stats = jzoo.compute_nerfw_loss(batch, rend, hist,
                                                    config)
        else:
            losses, stats = jzoo.compute_hanerf_loss(batch, rend, train_frac,
                                                     config)
        if config.interlevel_loss_mult > 0:
            losses["interlevel"] = jzoo.interlevel_loss(hist, config)
        losses["distortion"] = jzoo.distortion_loss(hist, config)
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

    def jax_rays(self):
        return jstructs.Rays(**{k: jnp.asarray(v)
                                for k, v in self.arrays.items()})

    def batch(self):
        return tstructs.Batch(rays=tstructs.Rays(**self.arrays),
                              rgb=self.rgb).to("cpu")

    def torch_model(self):
        model = tvan.VanillaNerfModel(self.tconfig, "cpu",
                                      torch.Generator().manual_seed(0))
        model.load_state_dict(convert_vanilla_params(self.params))
        return model

    def jax_forward(self):
        return jax.jit(lambda p, r: self.jmodel.apply(
            {"params": p}, None, r, train_frac=TRAIN_FRAC,
            compute_extras=True, zero_glo=False, zero_tra=False))(
                self.params, self.jax_rays())

    def jax_loss(self):
        (loss, aux), grads = jax_loss_fn(self.jmodel, self.jconfig)(
            self.params, self.jax_rays(), jnp.asarray(self.rgb),
            jnp.float32(TRAIN_FRAC))
        return (float(loss), jax.tree_util.tree_map(np.asarray, aux),
                tu.unflatten(tu.flat_params(grads)))


def make_case(model_keys) -> Case:
    jconfig, tconfig = vanilla_config(model_keys)
    arrays = ray_arrays()
    model, variables = jvan.construct_model(
        jax.random.PRNGKey(0), jstructs.Rays(**{
            k: jnp.asarray(v) for k, v in arrays.items()}), jconfig)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return Case(jconfig, tconfig, arrays, rgb, model, params)


# The loss without its interlevel term (see the module's docstring).
NO_INTERLEVEL = {"interlevel_loss_mult": 0.0}


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    return make_case({**VARIANTS[request.param], **NO_INTERLEVEL})


def test_point_mlp_matches_jax():
    """PointMLP alone with the appearance and transient vectors: density,
    rgb and NeRF-W's transient outputs, within 1e-5; its Dense_k layers in
    flax's call order."""
    mlp_cfg = tcfg.MLPConfig(net_depth=5, net_width=32, max_deg_point=4,
                             deg_view=2)
    jmlp = jvan.PointMLP(jcfg.MLPConfig(net_depth=5, net_width=32,
                                        max_deg_point=4, deg_view=2),
                         use_contraction=True, transient=True)
    rs = np.random.RandomState(3)
    pos = rs.randn(6, 5, 3).astype(np.float32)
    vd = rs.randn(6, 5, 3).astype(np.float32)
    emb_a = rs.randn(6, 5, 4).astype(np.float32)
    emb_t = rs.randn(6, 5, 8).astype(np.float32)
    variables = jax.jit(jmlp.init, static_argnums=1)(
        jax.random.PRNGKey(1), None, pos, vd, emb_a, emb_t)
    want = jax.jit(jmlp.apply, static_argnums=1)(variables, None, pos, vd,
                                                 emb_a, emb_t)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    tmlp = tvan.PointMLP(mlp_cfg, True, True, torch.float32,
                         torch.Generator().manual_seed(0), appearance_dim=4,
                         transient_dim=8)
    state = convert_vanilla_params({"fine": params})
    tmlp.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        got = tmlp(None, *map(torch.from_numpy, (pos, vd, emb_a, emb_t)))
    assert set(got) == set(want) == {"density", "rgb", "density_transient",
                                     "rgb_transient", "uncertainty"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)


def test_fine_intervals_merge_as_jax(case):
    """The fine pass alone: intervals drawn from JAX's coarse weights and
    merged with its coarse intervals equal JAX's fine sdist."""
    from nerf_hugs_torch.core import stepfun
    _, hist = case.jax_forward()
    sdist = torch.from_numpy(np.array(hist[0]["sdist"]))
    weights = torch.from_numpy(np.array(hist[0]["weights"]))
    logits = torch.where(sdist[..., 1:] > sdist[..., :-1], torch.log(weights),
                         torch.full_like(weights, -float("inf")))
    new_sdist = stepfun.sample_intervals(
        None, sdist, logits,
        case.tconfig.nerfacto.num_fine_nerf_samples_per_ray,
        domain=(0.0, 1.0))
    merged = tvan.merge_fine_intervals(sdist, new_sdist)
    assert merged.shape[-1] == sdist.shape[-1] + new_sdist.shape[-1] - 1
    np.testing.assert_allclose(merged.numpy(), hist[1]["sdist"], rtol=0,
                               atol=1e-6)
    assert torch.all(merged[..., 1:] >= merged[..., :-1])


def test_interlevel_term_on_jax_history_matches_jax(case):
    """The interlevel term of the port on JAX's own [coarse, fine]
    history equals JAX's within 1e-6."""
    from nerf_hugs_torch.losses import zoo as tzoo
    _, hist = case.jax_forward()
    config = dataclasses.replace(case.tconfig, interlevel_loss_mult=1.0)
    jconfig = dataclasses.replace(case.jconfig, interlevel_loss_mult=1.0)
    want = float(jzoo.interlevel_loss(hist, jconfig))
    got = float(tzoo.interlevel_loss(
        [{k: torch.from_numpy(np.array(v)) for k, v in h.items()}
         for h in hist], config))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_forward_matches_jax(case):
    rend_j, hist_j = case.jax_forward()
    model = case.torch_model()
    with torch.no_grad():
        rend_t, hist_t = model(case.batch().rays, TRAIN_FRAC, True, None,
                               zero_glo=False, zero_tra=False)
    assert len(rend_t) == len(rend_j) == 2
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
    loss_t, stats_t = tstep.compute_loss(model, case.batch(), TRAIN_FRAC,
                                         case.tconfig, None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=FWD_TOL)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    want = convert_vanilla_params(grads_j)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = np.zeros_like(g_j) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=GRAD_REL * float(
            np.abs(g_j).max()), err_msg=name)


def test_train_step_matches_jax_train_step(case):
    """One step of JAX's own jitted train step against the port's, from
    the same weights: the loss within 1e-5, and every new parameter within
    1e-6 relative of JAX's plus what the gradients' tolerance allows
    (Adam's first step lr g / (|g| + eps) moves by at most lr / eps x
    GRAD_REL x the leaf's largest gradient more)."""
    mesh = jmesh.make_mesh(jax.devices()[:1])
    state, _ = jstep.create_optimizer(case.jconfig, {"params": case.params})
    step_j = jstep.create_train_step(case.jmodel, case.jconfig, mesh)
    batch_j = jstructs.Batch(rays=case.jax_rays(), rgb=jnp.asarray(case.rgb))
    thresholds = jnp.ones(case.jconfig.num_ray_levels)
    new_state, stats_j, _ = step_j(jax.random.PRNGKey(0), state, batch_j,
                                   jnp.float32(TRAIN_FRAC), thresholds)
    new_j = convert_vanilla_params(jax.tree_util.tree_map(
        np.asarray, new_state.params["params"]))
    _, _, grads_j = case.jax_loss()
    clipped = convert_vanilla_params(jax.tree_util.tree_map(
        np.asarray, jstep.clip_gradients({"params": grads_j},
                                         case.jconfig)["params"]))
    lr = float(jmath.learning_rate_decay(
        0, case.jconfig.lr_init, case.jconfig.lr_final,
        case.jconfig.max_steps, case.jconfig.lr_delay_steps,
        case.jconfig.lr_delay_mult))

    model = case.torch_model()
    opt, sched = tstep.create_optimizer(case.tconfig, model)
    stats = tstep.train_step(model, opt, sched, case.batch(), TRAIN_FRAC,
                             case.tconfig, None)
    np.testing.assert_allclose(float(stats["loss"]), float(stats_j["loss"]),
                               rtol=FWD_TOL)
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), new_j[name].numpy()
        slack = (lr / case.jconfig.adam_eps * GRAD_REL
                 * float(np.abs(clipped[name].numpy()).max()))
        np.testing.assert_array_less(np.abs(got - want),
                                     1e-6 * np.abs(want) + slack + 1e-12,
                                     err_msg=name)


def test_param_names_are_flax_names(case):
    model = case.torch_model()
    assert set(model.state_dict()) == set(convert_vanilla_params(
        case.params))
    tops = {n.split(".")[0] for n in model.state_dict()}
    assert tops == set(tvan.module_names(case.tconfig))
    # Dense_k in flax's call order: trunk, density, bottleneck, view, rgb.
    assert model.coarse.trunk == [f"Dense_{i}" for i in range(5)]
    assert model.coarse.rgb_head == "Dense_8"


@pytest.mark.parametrize("groups", [["field"], ["appearance_embedding"],
                                    ["field", "transient_embedding"]])
def test_field_finetune_group_maps_to_coarse_and_fine(groups):
    """finetune_params group 'field' takes coarse and fine, as JAX maps it
    (nerf_hugs_tpu/train/step.py:110-120); the labels equal JAX's."""
    case = make_case(VARIANTS["nerfw"])
    jconfig = dataclasses.replace(case.jconfig, finetune_params=groups)
    tconfig = dataclasses.replace(case.tconfig, finetune_params=groups)
    labels_j = tu.flat_params(jstep.finetune_partitions(
        jconfig, {"params": case.params})["params"])
    model = case.torch_model()
    labels_t = tstep.finetune_partitions(
        tconfig, [n for n, _ in model.named_parameters()])
    flax = {"weight": "kernel"}
    as_path = lambda n: "/".join(
        n.split(".")[:-1] + [flax.get(n.split(".")[-1], n.split(".")[-1])])
    renamed = {as_path(n): v for n, v in labels_t.items()}
    renamed = {k.replace("embedding/kernel", "embedding/embedding"): v
               for k, v in renamed.items()}
    assert renamed == {k: str(v) for k, v in labels_j.items()}
    trainable = {n.split(".")[0] for n, v in labels_t.items()
                 if v == "trainable"}
    if "field" in groups:
        assert {"coarse", "fine"} <= trainable


@pytest.mark.parametrize("path", NERF_YAMLS, ids=lambda p: p.stem)
def test_preflight_on_the_nerf_yamls(path):
    """preflight takes the six kubric and phototourism nerf yamls and
    refuses the three whose `dataset_type: robust` no registry has, with
    JAX's reason (nerf_hugs_tpu/data/__init__.py:35-37)."""
    config = driver.load_config(str(path), "data", "ckpt")
    assert config.model_type == "nerf"
    if path.stem in ROBUST_YAMLS:
        with pytest.raises(ValueError, match="unknown dataset_loader"):
            driver.preflight(config)
        from nerf_hugs_tpu.configs import yaml_loader as jyaml
        with pytest.raises(ValueError, match="unknown dataset_loader"):
            jax_load_dataset("train", "", jyaml.load_yaml_config(str(path)),
                             is_training=True)
        return
    driver.preflight(config)
    names = tvan.module_names(config)
    assert names[:2] == ["coarse", "fine"]
    assert ("implicit_mask" in names) == (config.transient_type == "hanerf")


def test_nerf_yamls_are_nine():
    assert len(NERF_YAMLS) == 9


@pytest.mark.parametrize("variant", ["base", "hanerf"])
def test_train_and_eval_drivers_run_vanilla(tmp_path, variant):
    """python -m nerf_hugs_torch.{train,eval}'s mains on the CPU at toy
    widths on the synthetic scene: [coarse, fine] psnrs, a checkpoint,
    an eval of the test split."""
    cfg = tu.write_tiny_yaml(
        str(tmp_path), base={**VANILLA_BASE, "early_exit_steps": 2,
                             "eval_render_every": 100},
        model={**VANILLA_MODEL, **VARIANTS[variant]})
    ckpt = tmp_path / "ckpt"
    args = ["--config", cfg, "--data_dir", str(tmp_path), "--save_dir",
            str(ckpt), "--device", "cpu"]
    driver.main(args)
    assert (ckpt / "checkpoint_2.pt").exists()
    log = (ckpt / "run_log.log").read_text()
    assert "[train] 2/2: loss=" in log and "[train] 2: eval psnr=" in log
    if variant == "hanerf":
        assert "mask_size=" in log
    eval_main(args)
    preds = sorted(p.name for p in (ckpt / "test_preds").iterdir())
    assert "000_color.png" in preds and "000_depth.tiff" in preds
    assert (ckpt / "metrics_test_2.txt").exists()


def test_construct_model_builds_vanilla():
    _, config = vanilla_config()
    model = construct_model(config, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(model, tvan.VanillaNerfModel)
    batch = next(load_dataset("train", "", config, is_training=True)
                 ).to("cpu")
    loss, stats = tstep.compute_loss(model, batch, 0.5, config,
                                     torch.Generator().manual_seed(1))
    assert torch.isfinite(loss) and stats["mses"].shape == (2,)
