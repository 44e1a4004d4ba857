"""HA-NeRF nerfacto in nerf_hugs_torch against nerf_hugs_tpu: the implicit
mask, the appearance and transient embeddings and their eval modes, the
HA-NeRF loss, one Adam step, the converter's new leaves, and the drivers on
a kubric scene. The model is distractor_nerfacto_hanerf.yml's model
section at toy widths (two proposal nets, scene contraction, the piecewise
sampler), run on the deterministic path (rng=None) with the same weights
and rays on both sides."""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_data import make_fake_kubric_scene

import torch_port_util as tu
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.losses import zoo as tzoo
from nerf_hugs_torch.models import nerfacto as tnerf
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs

# Forward values and losses: float32 in both, reductions in another order.
FWD_TOL = 1e-5
# Gradients: relative to each leaf's largest entry.
GRAD_REL = 1e-4
N_RAYS = 64
NUM_IMAGES = 5
REPO = pathlib.Path(__file__).resolve().parents[1]
# distractor_nerfacto_hanerf.yml's model section at toy widths.
HANERF_BASE = {"enable_scene_contraction": True, "far": 6.0}
HANERF_MODEL = {
    "num_proposal_iterations": 2, "num_proposal_samples_per_ray": [16, 12],
    "num_nerf_samples_per_ray": 8, "proposal_initial_sampler": "piecewise",
    "proposal_net_args_list": [
        {"base_res": 4, "hidden_dim": 16, "log2_hashmap_size": 9,
         "features_per_level": 2, "num_levels": 3, "max_res": 16},
        {"base_res": 4, "hidden_dim": 16, "log2_hashmap_size": 10,
         "features_per_level": 2, "num_levels": 4, "max_res": 32}],
    "use_appearance_embedding": True, "appearance_embedding_dim": 4,
    "use_transient_embedding": True, "transient_embedding_dim": 8,
    "transient_type": "hanerf", "eval_embedding": "original",
    "rgb_loss_mult": 0.5, "opaque_background": True,
}


def hanerf_config(**model):
    config = tu.tiny_config(base=HANERF_BASE,
                            model={**HANERF_MODEL, **model})
    config.model.num_embeddings = NUM_IMAGES
    return config


def hanerf_rays(n: int, seed: int) -> dict:
    arrays = tu.ray_arrays(n, seed)
    arrays["far"] = 6.0 * arrays["far"] / 1.2
    arrays["embed_idx"] = np.random.RandomState(seed + 1).randint(
        0, NUM_IMAGES, (n, 1)).astype(np.int32)
    return arrays


def jax_loss_fn(model, config):
    """model.apply + the hanerf loss composition of train/step.py:189-233."""

    def loss_fn(p, rays, rgb, train_frac):
        rend, hist = model.apply({"params": p}, None, rays,
                                 train_frac=train_frac, compute_extras=False,
                                 zero_glo=False, zero_tra=False)
        batch = jstructs.Batch(rays=rays, rgb=rgb)
        losses, stats = jzoo.compute_hanerf_loss(batch, rend, train_frac,
                                                 config)
        losses["interlevel"] = jzoo.interlevel_loss(hist, config)
        losses["distortion"] = jzoo.distortion_loss(hist, config)
        return jnp.sum(jnp.array(list(losses.values()))), (rend, hist,
                                                           losses, stats)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_model():
    config = hanerf_config()
    arrays = hanerf_rays(N_RAYS, 0)
    rays = jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()})
    model, variables = jnerf.construct_model(jax.random.PRNGKey(0), rays,
                                             config)
    params = tu.unflatten(tu.flat_params(variables["params"]))
    rgb = np.random.RandomState(1).rand(N_RAYS, 3).astype(np.float32)
    return config, arrays, rays, model, params, rgb, jax_loss_fn(model,
                                                                 config)


def jax_loss_and_grads(jax_model, train_frac):
    _, _, rays, _, params, rgb, loss_and_grads = jax_model
    (loss, aux), grads = loss_and_grads(params, rays, jnp.asarray(rgb),
                                        jnp.float32(train_frac))
    aux = jax.tree_util.tree_map(np.asarray, aux)
    return float(loss), aux, tu.unflatten(tu.flat_params(grads))


def torch_model(config, params, arrays, rgb):
    model = tnerf.NerfactoModel(config, "cpu",
                                torch.Generator().manual_seed(0))
    model.load_state_dict(convert_nerfacto_params(params))
    batch = tstructs.Batch(rays=tstructs.Rays(**arrays), rgb=rgb).to("cpu")
    return model, batch


def test_state_dict_mirrors_the_flax_tree(jax_model):
    config, arrays, _, _, params, rgb, _ = jax_model
    model, _ = torch_model(config, params, arrays, rgb)
    state = convert_nerfacto_params(params)
    assert set(state) == set(model.state_dict())
    assert {k.split(".")[0] for k in state} == {
        "field", "proposal_0", "proposal_1", "appearance_embedding",
        "transient_embedding", "implicit_mask"}
    np.testing.assert_array_equal(
        state["appearance_embedding.weight"].numpy(),
        params["appearance_embedding"]["embedding"])
    np.testing.assert_array_equal(
        state["implicit_mask.mlp.layers.0.weight"].numpy(),
        params["implicit_mask"]["mlp"]["Dense_0"]["kernel"].T)
    # The colour head takes SH (16) + geo_feat + the appearance vector.
    nc = config.nerfacto
    assert model.field.mlp_head.layers[0].in_features == (
        16 + nc.geo_feat_dim + nc.appearance_embedding_dim)
    assert model.implicit_mask.mlp.layers[0].in_features == 32 + 8
    assert model.transient_embedding.weight.shape == (NUM_IMAGES, 8)


@pytest.mark.parametrize("train_frac", [0.3, 0.3001])
def test_hanerf_model_renderings_loss_and_gradients_match_jax(jax_model,
                                                              train_frac):
    config, arrays, _, _, params, rgb, _ = jax_model
    loss_j, (rend_j, hist_j, losses_j, stats_j), grads_j = \
        jax_loss_and_grads(jax_model, train_frac)
    model, batch = torch_model(config, params, arrays, rgb)
    with torch.no_grad():
        rend_t, hist_t = model(batch.rays, train_frac, False, None,
                               zero_glo=False, zero_tra=False)
    for key in ("rgb", "implicit_mask"):
        np.testing.assert_allclose(rend_t[-1][key].numpy(), rend_j[-1][key],
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=key)
    assert rend_t[-1]["implicit_mask"].shape == (N_RAYS, 1)
    assert len(hist_t) == len(hist_j) == 3
    for h_t, h_j in zip(hist_t, hist_j):
        for key in ("sdist", "weights", "density"):
            np.testing.assert_allclose(h_t[key].numpy(), h_j[key],
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=key)

    loss_t, stats_t = tstep.compute_loss(model, batch, train_frac, config,
                                         None)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=FWD_TOL)
    for key in ("data", "mask_size", "interlevel", "distortion"):
        np.testing.assert_allclose(stats_t["losses"][key].item(),
                                   losses_j[key], rtol=FWD_TOL, err_msg=key)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    want = convert_nerfacto_params(grads_j)
    assert set(want) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g_j = want[name].numpy()
        g_t = (np.zeros_like(g_j) if p.grad is None
               else p.grad.detach().numpy())
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=GRAD_REL * float(np.abs(g_j).max()),
                                   err_msg=name)
    # Every embedding row a ray used takes a gradient; the mask trains.
    for name in ("appearance_embedding.weight", "transient_embedding.weight",
                 "implicit_mask.hashgrid.table"):
        assert np.abs(want[name].numpy()).max() > 0, name


@pytest.mark.parametrize("mode", ["original", "zero", "average"])
@pytest.mark.parametrize("zero_glo, zero_tra", [(False, False),
                                                (True, False), (False, True)])
def test_eval_embedding_modes_match_jax(jax_model, mode, zero_glo, zero_tra):
    """The deterministic path under each eval_embedding mode, with and
    without zeroing either embedding, renders as the JAX model does."""
    _, arrays, rays, _, params, rgb, _ = jax_model
    config = hanerf_config(eval_embedding=mode)
    model_j = jnerf.NerfactoModel(config=config)
    rend_j, _ = model_j.apply({"params": params}, None, rays, train_frac=0.5,
                              compute_extras=True, zero_glo=zero_glo,
                              zero_tra=zero_tra)
    model, batch = torch_model(config, params, arrays, rgb)
    with torch.no_grad():
        rend_t, _ = model(batch.rays, 0.5, True, None, zero_glo=zero_glo,
                          zero_tra=zero_tra)
    for key in ("rgb", "implicit_mask", "acc", "distance_mean"):
        np.testing.assert_allclose(rend_t[-1][key].numpy(),
                                   np.asarray(rend_j[-1][key]), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=key)


def test_implicit_mask_matches_jax():
    """HashImplicitMask alone: output, table and MLP gradients, and the
    gradient it hands the transient embedding."""
    rs = np.random.RandomState(3)
    n, dim = 300, 8
    coords = rs.rand(n, 2).astype(np.float32)
    coords[:4] = [[0, 0], [1, 1], [1, 0.5], [0.25, 1]]
    emb = rs.randn(n, dim).astype(np.float32)
    cot = rs.randn(n, 1).astype(np.float32)
    mask_j = jnerf.HashImplicitMask(dim)
    variables = mask_j.init(jax.random.PRNGKey(1), jnp.asarray(coords),
                            jnp.asarray(emb))
    params = tu.unflatten(tu.flat_params(variables["params"]))
    # A hash table far from its 1e-4 init, so every level matters.
    params["hashgrid"] = {k: rs.randn(*v.shape).astype(np.float32)
                          for k, v in params["hashgrid"].items()}

    def f(p, e):
        return jnp.sum(mask_j.apply({"params": p}, jnp.asarray(coords), e)
                       * cot)

    out_j = np.asarray(mask_j.apply({"params": params}, jnp.asarray(coords),
                                    jnp.asarray(emb)))
    g_p, g_e = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(emb))

    mask_t = tnerf.HashImplicitMask(dim, torch.float32, torch.Generator())
    state = convert_nerfacto_params({"implicit_mask": params})
    mask_t.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    emb_t = torch.from_numpy(emb).requires_grad_()
    out_t = mask_t(torch.from_numpy(coords), emb_t)
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=FWD_TOL,
                               atol=FWD_TOL)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_e),
                               rtol=0, atol=GRAD_REL * float(
                                   np.abs(np.asarray(g_e)).max()))
    want = {k.split(".", 1)[1]: v.numpy() for k, v in
            convert_nerfacto_params({"implicit_mask": tu.unflatten(
                tu.flat_params(g_p))}).items()}
    for name, p in mask_t.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=0,
            atol=GRAD_REL * float(np.abs(want[name]).max()), err_msg=name)


@pytest.mark.parametrize("train_frac", [0.0, 0.0003, 0.25, 1.0])
@pytest.mark.parametrize("levels", [1, 2])
def test_hanerf_loss_matches_jax(train_frac, levels):
    """Losses and the gradients they send the renderings and the mask; a
    coarse level's term reaches the mask only through the final level."""
    rs = np.random.RandomState(levels)
    n = 50
    config = hanerf_config()
    config.data_loss_type = "charb" if levels == 2 else "mse"
    config.data_coarse_loss_mult = 0.1
    rgbs = [rs.rand(n, 3).astype(np.float32) for _ in range(levels)]
    mask = rs.rand(n, 1).astype(np.float32)
    target = rs.rand(n, 4).astype(np.float32)   # RGBA: composited over bg
    bg = rs.rand(n, 3).astype(np.float32)

    def jloss(rgbs, mask):
        rend = [{"rgb": r, "bg_rgb": bg} for r in rgbs]
        rend[-1]["implicit_mask"] = mask
        batch = jstructs.Batch(rays=None, rgb=jnp.asarray(target))
        losses, stats = jzoo.compute_hanerf_loss(batch, rend, train_frac,
                                                 config)
        return sum(losses.values()), (losses, stats)

    (total_j, (losses_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(r) for r in rgbs], jnp.asarray(mask))

    rgbs_t = [torch.from_numpy(r).requires_grad_() for r in rgbs]
    mask_t = torch.from_numpy(mask).requires_grad_()
    rend = [{"rgb": r, "bg_rgb": torch.from_numpy(bg)} for r in rgbs_t]
    rend[-1]["implicit_mask"] = mask_t
    batch = tstructs.Batch(rays=None, rgb=torch.from_numpy(target))
    losses_t, stats_t = tzoo.compute_hanerf_loss(batch, rend, train_frac,
                                                 config)
    assert set(losses_t) == set(losses_j) == {"data", "mask_size"}
    for key in losses_t:
        np.testing.assert_allclose(losses_t[key].item(), losses_j[key],
                                   rtol=FWD_TOL, err_msg=key)
    np.testing.assert_allclose(stats_t["mses"].detach().numpy(),
                               stats_j["mses"], rtol=FWD_TOL)
    np.testing.assert_allclose(stats_t["implicit_mask"].item(),
                               stats_j["implicit_mask"][0], rtol=FWD_TOL)
    sum(losses_t.values()).backward()
    for got, want in zip(rgbs_t + [mask_t], list(grads_j[0]) + [grads_j[1]]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=1e-9)


def test_train_step_matches_jax_adam_step(jax_model):
    config, arrays, _, _, params, rgb, _ = jax_model
    loss_j, _, grads_j = jax_loss_and_grads(jax_model, 0.3)
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

    model, batch = torch_model(config, params, arrays, rgb)
    opt, sched = tstep.create_optimizer(config, model)
    stats = tstep.train_step(model, opt, sched, batch, 0.3, config, None)
    np.testing.assert_allclose(float(stats["loss"]), loss_j, rtol=FWD_TOL)
    assert "mask_size" in stats["losses"]
    # Adam turns a near-zero gradient into a full-rate step of either sign,
    # so only entries with a clear gradient are compared.
    for name, p in model.named_parameters():
        g = np.abs(g_j[name].numpy())
        mask = g >= 1e-6 * g.max()
        np.testing.assert_allclose(p.detach().numpy()[mask],
                                   new_j[name].numpy()[mask],
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_converter_refuses_unknown_leaves(jax_model):
    params = jax_model[4]
    good = convert_nerfacto_params(params)
    assert good["transient_embedding.weight"].shape == (NUM_IMAGES, 8)
    bad_trees = [
        {**params, "appearance_embedding": {
            "embedding": np.zeros((2, 4)), "scale": np.zeros(1)}},
        {**params, "implicit_mask": {**params["implicit_mask"],
                                     "hashgrid": {"table_0": np.zeros(8),
                                                  "offsets": np.zeros(1)}}},
        {**params, "implicit_mask": {**params["implicit_mask"],
                                     "mlp": {"Dense_0": np.zeros((2, 2))}}},
        {**params, "beta": np.zeros(3)},
    ]
    for tree in bad_trees:
        with pytest.raises(ValueError, match="unexpected flax"):
            convert_nerfacto_params(tree)


def test_hanerf_needs_the_transient_embedding_and_enough_rows(tmp_path):
    with pytest.raises(ValueError, match="use_transient_embedding"):
        tnerf.NerfactoModel(hanerf_config(use_transient_embedding=False),
                            "cpu", torch.Generator())
    make_fake_kubric_scene(str(tmp_path))
    config = hanerf_config()
    config.dataset_loader = "kubric"
    from nerf_hugs_torch.data import load_dataset
    dataset = load_dataset("test", str(tmp_path), config, is_training=False)
    # Test rows 3 and 4 follow the three train images: 5 rows suffice.
    driver.check_num_embeddings(config, dataset)
    config.model.num_embeddings = 4
    with pytest.raises(ValueError, match="Number of embeddings"):
        driver.check_num_embeddings(config, dataset)


def test_python_m_train_and_eval_hanerf_on_a_kubric_scene(tmp_path):
    make_fake_kubric_scene(str(tmp_path / "scene"))
    cfg = tu.write_tiny_yaml(
        str(tmp_path), base={
            **HANERF_BASE, "dataset_type": "kubric", "early_exit_steps": 3,
            "eval_render_every": 100, "eval_dataset_limit": 2},
        model={**HANERF_MODEL, "eval_embedding": "zero"})
    args = ["--config", cfg, "--data_dir", str(tmp_path / "scene"),
            "--save_dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    run = lambda module: subprocess.run(
        [sys.executable, "-m", module] + args, cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    proc = run("nerf_hugs_torch.train")
    assert proc.returncode == 0, proc.stderr
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("[train] ") and "steps/s" in line]
    assert len(lines) == 3, proc.stdout
    for line in lines:
        terms = dict(t.split("=") for t in line.split() if "=" in t)
        assert np.isfinite(float(terms["loss"]))
        assert float(terms["mask_size"]) > 0 and "data" in terms
    assert "[train] 3: eval psnr=" in proc.stdout
    assert (tmp_path / "ckpt" / "checkpoint_3.pt").exists()
    state = torch.load(tmp_path / "ckpt" / "checkpoint_3.pt",
                       weights_only=True)["model"]
    assert "implicit_mask.hashgrid.table" in state
    assert json.loads((tmp_path / "ckpt" / "model_compat.json").read_text()
                      ) == {"hash_impl": "xor",
                            "proposal_hash_impls": ["xor", "xor"]}

    proc = run("nerf_hugs_torch.eval")
    assert proc.returncode == 0, proc.stderr
    assert "Evaluating checkpoint step 3" in proc.stdout
    assert "mean: psnr=" in proc.stdout
    assert "evaluation complete" in proc.stdout
    preds = sorted(os.listdir(tmp_path / "ckpt" / "test_preds"))
    assert "000_color.png" in preds and "001_color.png" in preds
    assert not any("mask" in p for p in preds)
