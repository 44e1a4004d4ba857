"""The finetune stage of nerf_hugs_torch against nerf_hugs_tpu: the
finetune_params partition, one finetune step (a data-only loss; Adam on
the trainable groups, the rest frozen), and the two-stage driver on a
phototourism capture, with eval reading the finetune checkpoint."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_transient import (NERFW_MODEL, jax_rays, make_config,
                                       rays_for)

import torch_port_util as tu
from nerf_hugs_tpu.losses import zoo as jzoo
from nerf_hugs_tpu.models import nerfacto as jnerf
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.models import nerfacto as tnerf
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_torch.utils import structs as tstructs
from nerf_hugs_torch.tools import hashgrid_inputs

FWD_TOL = 1e-5
N_RAYS = 64


def every_group_config(groups):
    """A toy model with every param group (HA-NeRF's mask and both
    embeddings) finetuning `groups`."""
    config = make_config(transient_type="hanerf")
    config.finetune_params = tuple(groups)
    return config


def jax_labels(config) -> dict:
    """{flax top-level module: label} of the JAX partition, on the
    abstract parameter tree (no compile)."""
    variables = jax.eval_shape(functools.partial(
        jnerf.NerfactoModel(config=config).init, train_frac=1.0,
        compute_extras=False, zero_glo=False, zero_tra=False),
        jax.random.PRNGKey(0), None, jax_rays(rays_for(8, 0)))
    labels = jstep.finetune_partitions(config, variables)["params"]
    out = {}
    for top, tree in labels.items():
        (label,) = set(jax.tree_util.tree_leaves(tree))
        out[top] = label
    return out


@pytest.mark.parametrize("groups", [
    ["appearance_embedding"], ["field"], ["proposal"],
    ["transient_embedding", "implicit_mask"],
    ["field", "appearance_embedding"]])
def test_finetune_partitions_match_jax(groups):
    config = every_group_config(groups)
    want = jax_labels(config)
    model = tnerf.NerfactoModel(config, "cpu", torch.Generator())
    names = [n for n, _ in model.named_parameters()]
    got = tstep.finetune_partitions(config, names)
    assert {n.split(".")[0] for n in names} == set(want) == set(
        tnerf.module_names(config))
    for name, label in got.items():
        assert label == want[name.split(".")[0]], name
    assert any(v == "trainable" for v in got.values())


@pytest.mark.parametrize("groups, missing", [
    (["appearance_embedding", "nope"], "nope"),
    (["implicit_mask"], "implicit_mask")])   # no mask on a NeRF-W model
def test_finetune_partitions_refuse_unknown_groups_as_jax(groups, missing):
    config = make_config()
    config.finetune_enable, config.finetune_params = True, tuple(groups)
    names = [n for n, _ in tnerf.NerfactoModel(
        config, "cpu", torch.Generator()).named_parameters()]
    with pytest.raises(ValueError, match=f"'{missing}'"):
        tstep.finetune_partitions(config, names)
    with pytest.raises(ValueError, match=f"'{missing}'"):
        jax_labels(config)
    with pytest.raises(ValueError, match=f"'{missing}'"):
        driver.preflight(config)


def test_finetune_step_moves_only_the_appearance_embedding_as_jax():
    """One finetune step of the toy NeRF-W model: the data loss of the
    static colour alone, Adam on the finetune_* schedule over
    appearance_embedding, every other parameter frozen; the table-gradient
    path never runs."""
    config = make_config()
    config.finetune_params = ("appearance_embedding",)
    arrays = rays_for(N_RAYS, 2)
    rgb = np.random.RandomState(3).rand(N_RAYS, 3).astype(np.float32)
    model_j, variables = jnerf.construct_model(jax.random.PRNGKey(2),
                                               jax_rays(arrays), config)
    params = tu.unflatten(tu.flat_params(variables["params"]))

    def loss_fn(p, rays, rgb):
        rend, _ = model_j.apply({"params": p}, None, rays, train_frac=1.0,
                                compute_extras=False, zero_glo=False,
                                zero_tra=False)
        losses, _ = jzoo.compute_data_loss(
            jstructs.Batch(rays=rays, rgb=rgb), rays, rend, config, False)
        return jnp.sum(jnp.array(list(losses.values())))

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jax_rays(arrays), jnp.asarray(rgb))
    state, _ = jstep.create_finetune_optimizer(config, {"params": params})
    state = jax.jit(lambda st, g: st.apply_gradients(grads=g))(
        state, {"params": jax.tree_util.tree_map(jnp.nan_to_num, grads)})
    new_j = convert_nerfacto_params(jax.tree_util.tree_map(
        np.asarray, state.params["params"]))

    model = tnerf.NerfactoModel(config, "cpu", torch.Generator())
    model.load_state_dict(convert_nerfacto_params(params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = tstep.create_finetune_optimizer(config, model)
    assert [p.shape for g in opt.param_groups for p in g["params"]] == [
        model.appearance_embedding.weight.shape]
    batch = tstructs.Batch(rays=tstructs.Rays(**arrays), rgb=rgb).to("cpu")
    stats = tstep.train_step(model, opt, sched, batch, 1.0, config, None,
                             is_finetune=True)
    np.testing.assert_allclose(float(stats["loss"]), float(loss_j),
                               rtol=FWD_TOL)
    assert set(stats["losses"]) == {"data"}
    for name, p in model.named_parameters():
        if name == "appearance_embedding.weight":
            assert p.requires_grad and p.grad is not None
            rows = np.unique(arrays["embed_idx"])
            assert not torch.equal(p[rows], before[name][rows])
            np.testing.assert_allclose(p.detach().numpy(),
                                       new_j[name].numpy(), rtol=1e-6,
                                       atol=1e-7)
        else:
            # Frozen: no gradient taken (the hash-grid tables' backward
            # never runs), the value unchanged, as set_to_zero leaves it.
            assert not p.requires_grad and p.grad is None, name
            assert torch.equal(p.detach(), before[name]), name
            np.testing.assert_array_equal(new_j[name].numpy(),
                                          before[name].numpy(), name)


FINETUNE_BASE = {
    "dataset_type": "phototourism", "downsample_factor": 2,
    "near": 0.001, "far": 2.0, "bound": 2, "early_exit_steps": 2,
    "finetune_enable": True, "finetune_num_steps": 2,
    "finetune_batch_size": 64, "finetune_patch_size": 4,
    "finetune_num_img_per_batch": 2,
    "finetune_params": ["appearance_embedding"],
    "eval_render_every": 100, "eval_dataset_limit": 2}


def test_two_stage_driver_on_a_phototourism_capture(tmp_path, capsys):
    """Train then finetune on a toy capture of the smoke run's writer,
    resume within the finetune stage, then eval reads the finetune
    checkpoint."""
    data_dir = hashgrid_inputs.write_colmap_scene(
        str(tmp_path), "phototourism", num_train=3, num_test=2, size=32)
    ckpt = str(tmp_path / "ckpt")
    args = lambda cfg: ["--config", cfg, "--data_dir", data_dir,
                        "--save_dir", ckpt, "--device", "cpu"]
    cfg = tu.write_tiny_yaml(str(tmp_path), base=FINETUNE_BASE,
                             model=NERFW_MODEL)
    driver.main(args(cfg))
    out = capsys.readouterr().out
    for stage, steps in (("train", 2), ("finetune", 2)):
        for step in range(1, steps + 1):
            line = next(l for l in out.splitlines()
                        if l.startswith(f"[{stage}] {step}/{steps}: loss="))
            terms = dict(t.split("=") for t in line.split() if "=" in t)
            assert np.isfinite(float(terms["loss"]))
            # The finetune stage's loss is the data term alone.
            assert ({"beta", "density", "interlevel"} <= set(terms)) == (
                stage == "train"), line
    assert "[finetune] 2: eval psnr=" in out and "training complete" in out
    assert checkpoints.latest_step(ckpt) == 2
    assert checkpoints.latest_step(os.path.join(ckpt, "finetune")) == 2
    train_state = torch.load(os.path.join(ckpt, "checkpoint_2.pt"),
                             weights_only=True)["model"]
    ft = torch.load(os.path.join(ckpt, "finetune", "checkpoint_2.pt"),
                    weights_only=True)
    for name, value in ft["model"].items():
        moved = not torch.equal(value, train_state[name])
        assert moved == (name == "appearance_embedding.weight"), name
    assert len(ft["optimizer"]["state"]) == 1      # Adam: one leaf

    # Resume: two more finetune steps, none of the train stage.
    cfg = tu.write_tiny_yaml(str(tmp_path), base={
        **FINETUNE_BASE, "finetune_num_steps": 4}, model=NERFW_MODEL)
    driver.main(args(cfg))
    out = capsys.readouterr().out
    assert "[finetune] 3/4: loss=" in out and "[finetune] 1/4" not in out
    assert "[train] 1/" not in out and "[train] 3/" not in out

    from nerf_hugs_torch.eval import main as eval_main
    eval_main(args(cfg))
    out = capsys.readouterr().out
    assert f"Evaluating checkpoint step 4 from {ckpt}/finetune" in out
    assert "mean: psnr=" in out and "evaluation complete" in out
    assert os.path.exists(os.path.join(ckpt, "metrics_test_finetune_4.txt"))
    preds = sorted(os.listdir(os.path.join(ckpt, "test_preds")))
    assert "000_color.png" in preds and "001_color.png" in preds
