"""nerf_hugs_torch as two processes over gloo on the CPU, against
nerf_hugs_tpu in one process on the global batch.

Two ranks (tests/torch_port_mp_worker.py, spawned with torchrun's
environment and a timeout) train tests/mh_config.py's Mip-NeRF 360 config,
rebuilt as a port config, and the toy RobustNeRF nerfacto of
test_torch_port_transient.py for three deterministic steps from JAX's
initial weights, each on its own share of every global batch drawn by the
port's loader. The ranks must hold bit-equal parameters and losses; the
parameters must equal JAX's train step on the global batch (rank 0's rays,
then rank 1's) at the tolerances of test_torch_port_transient.py's three
steps (1e-6 relative, 1e-7 absolute, on the entries whose first JAX
gradient is at least 1e-6 of its leaf's largest), the losses within 1e-5
and RobustNeRF's carried thresholds within 1e-6 of JAX's quantile over the
global batch. The ranks' host-split render of test image 0 equals the
port's one-process render of the same weights within 1e-6 absolute
(test_multihost.py's tolerance), and JAX's one-process render within the
port's own render tolerance against JAX, 1e-6 relative plus 1e-6 absolute
(test_torch_port_mipnerf360.py): on the Mip-NeRF 360 case the port's one
process already differs from JAX by up to 1.2e-6 at 0.57. Then the train, eval and render drivers as two ranks: only rank
0 writes, and the eval's PSNR equals a one-process eval's.
"""

import glob
import os
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tu
from mh_config import tiny_mh_config
from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_tpu.train.render_image import render_image as jax_render
from nerf_hugs_tpu.utils import structs as jstructs
from nerf_hugs_torch.configs import yaml_loader as tyaml
from nerf_hugs_torch.configs.config import Config, MLPConfig
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.models.from_jax import (convert_mipnerf360_params,
                                             convert_nerfacto_params)
from nerf_hugs_torch.train.render_image import render_image
from test_torch_port_mipnerf360 import jax_loss_fn as mip_loss_fn
from test_torch_port_transient import ROBUST_BASE, ROBUST_MODEL
from test_torch_port_transient import jax_loss_fn as robust_loss_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mp_worker.py")
WORLD = 2
STEPS = 3
TIMEOUT_S = 240
FWD_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-6, 1e-7
THRESHOLD_TOL = 1e-6
RENDER_TOL = 1e-6
CASES = ("mipnerf360", "robustnerf")
# A chunk that does not split evenly: the host split pads it.
CHUNK = 333


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(args, world: int = WORLD, timeout: float = TIMEOUT_S):
    """Run `python args...` as `world` ranks with torchrun's environment
    (world None: one process without it); returns [(returncode, output)]
    in rank order. Every rank is killed if any outlives `timeout`."""
    port = free_port()
    procs = []
    for rank in range(world or 1):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env.update({"OMP_NUM_THREADS": "2", "PYTHONPATH": REPO})
        if world:
            env.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                        "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable] + list(args), cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        deadline = time.time() + timeout
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.time(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def port_mh_config() -> Config:
    """tests/mh_config.py's config with the port's classes."""
    config = Config(
        dataset_loader="synthetic", batch_size=512, patch_size=1,
        image_num_per_batch=4, near=0.5, far=6.0, max_steps=10,
        lr_init=2e-3, lr_final=2e-4, lr_delay_steps=2,
        grad_max_norm=0.0, grad_max_val=0.0, data_loss_type="mse",
        interlevel_loss_mult=1.0, distortion_loss_mult=0.0,
        render_chunk_size=512)
    config.model.num_prop_samples = 8
    config.model.num_nerf_samples = 4
    config.model.num_levels = 2
    config.nerf_mlp = MLPConfig(net_depth=2, net_width=32,
                                bottleneck_width=16, net_width_viewdirs=16,
                                max_deg_point=4)
    config.prop_mlp = MLPConfig(net_depth=2, net_width=16, disable_rgb=True,
                                max_deg_point=4)
    return config


def case_configs(name: str, tmp: str):
    """(JAX config, port config, flax -> state_dict, JAX loss fn maker)."""
    if name == "mipnerf360":
        configs = tiny_mh_config(), port_mh_config()
        convert, loss_fn = convert_mipnerf360_params, mip_loss_fn
    else:
        path = tu.write_tiny_yaml(tmp, ROBUST_BASE, ROBUST_MODEL)
        from nerf_hugs_tpu.configs import yaml_loader as jyaml
        configs = jyaml.load_yaml_config(path), tyaml.load_yaml_config(path)
        convert, loss_fn = convert_nerfacto_params, robust_loss_fn
    for c in configs:
        c.data_dir = ""
        c.randomized = False
        c.render_chunk_size = CHUNK
        c.model.num_embeddings = 8
    return configs + (convert, loss_fn)


def cat_batches(batches) -> jstructs.Batch:
    """The global batch: rank 0's rays, then rank 1's."""
    cat = lambda xs: jnp.asarray(np.concatenate(xs))
    rays = jstructs.Rays(**{
        k: cat([getattr(b.rays, k) for b in batches])
        for k in batches[0].rays.__dataclass_fields__})
    return jstructs.Batch(rays=rays, rgb=cat([b.rgb for b in batches]))


def jax_run(jconfig, loss_fn, state, train_step, batches):
    """JAX's train step on the global batches; the first step's gradients
    (the comparison's mask), the losses, the thresholds fed back and the
    final parameters."""
    p0 = jax.tree_util.tree_map(np.asarray, state.params["params"])
    thresholds = jnp.ones(1)
    out = {"loss": [], "thresholds": []}
    for i, batch in enumerate(batches):
        frac = 0.3 + 0.0001 * i
        if i == 0:
            _, grads = loss_fn(p0, batch.rays, batch.rgb, jnp.float32(frac),
                               thresholds)
            out["grads"] = jax.tree_util.tree_map(np.asarray, grads)
        state, stats, _ = train_step(jax.random.PRNGKey(0), state, batch,
                                     jnp.float32(frac), thresholds)
        out["loss"].append(float(stats["loss"]))
        if jconfig.transient_type == "robustnerf":
            thresholds = stats["robust_inlier_threshold"]
            out["thresholds"].append(np.asarray(thresholds))
    out["params"] = jax.tree_util.tree_map(np.asarray,
                                           state.params["params"])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both cases through two port ranks and through JAX."""
    tmp = str(tmp_path_factory.mktemp("mp"))
    mesh = jmesh.make_mesh(jax.devices()[:1])
    cases = {}
    for name in CASES:
        jconfig, tconfig, convert, loss_maker = case_configs(name, tmp)
        model, state, render_fn, train_step, _ = jstep.setup_model(
            jconfig, jax.random.PRNGKey(0), mesh)
        params = tu.unflatten(tu.flat_params(state.params["params"]))
        init = convert(params)
        torch.save({"config": tconfig, "state": init},
                   os.path.join(tmp, f"{name}.pt"))
        test_rays = jax_load_dataset("test", "", jconfig,
                                     is_training=False
                                     ).generate_ray_batch(0).rays
        rgb = np.asarray(jax_render(render_fn, test_rays, 1.0, state.params,
                                    jconfig, mesh)["rgb"])
        one = construct_model(tconfig, "cpu",
                              torch.Generator().manual_seed(0))
        one.load_state_dict(init)
        port_rgb = render_image(one, load_dataset(
            "test", "", tconfig, is_training=False).generate_ray_batch(0).rays,
            1.0, tconfig, "cpu")["rgb"]
        cases[name] = dict(jconfig=jconfig, state=state, init=init,
                           convert=convert, train_step=train_step,
                           loss_fn=loss_maker(model, jconfig), jax_rgb=rgb,
                           port_rgb=port_rgb)
    results = launch([WORKER, "steps", tmp])
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and "WORKER_DONE" in out, f"rank {rank}:\n{out}"
    for name, case in cases.items():
        ranks = [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                            weights_only=False) for r in range(WORLD)]
        batches = [cat_batches([ranks[r]["batches"][i]
                                for r in range(WORLD)])
                   for i in range(STEPS)]
        case["ranks"] = ranks
        case["batches"] = batches
        case["jax"] = jax_run(case["jconfig"], case["loss_fn"],
                              case["state"], case["train_step"], batches)
    return cases


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_bit_equal_parameters(run, name):
    a, b = (r["state"] for r in run[name]["ranks"])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", CASES)
def test_ranks_report_the_same_stats(run, name):
    a, b = run[name]["ranks"]
    assert a["loss"] == b["loss"] and a["psnr"] == b["psnr"]
    assert len(a["loss"]) == STEPS and all(np.isfinite(a["loss"]))
    for ta, tb in zip(a["thresholds"], b["thresholds"]):
        assert torch.equal(ta, tb)


@pytest.mark.parametrize("name", CASES)
def test_ranks_draw_disjoint_halves_of_the_batch(run, name):
    a, b = run[name]["ranks"]
    for ba, bb in zip(a["batches"], b["batches"]):
        half = run[name]["jconfig"].batch_size // WORLD
        assert ba.rgb.shape[0] == bb.rgb.shape[0] == half
        assert not np.array_equal(ba.rays.origins, bb.rays.origins) or \
            not np.array_equal(ba.rays.directions, bb.rays.directions)


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_on_the_global_batch(run, name):
    case = run[name]
    np.testing.assert_allclose(case["ranks"][0]["loss"], case["jax"]["loss"],
                               rtol=FWD_TOL)
    want = case["convert"](tu.unflatten(tu.flat_params(
        case["jax"]["params"])))
    grads = case["convert"](tu.unflatten(tu.flat_params(
        case["jax"]["grads"])))
    got = case["ranks"][0]["state"]
    moved = 0
    for k, v in want.items():
        g = np.abs(grads[k].numpy())
        mask = g >= 1e-6 * g.max()
        moved += int(mask.sum())
        np.testing.assert_allclose(got[k].numpy()[mask], v.numpy()[mask],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    assert moved > 0


def test_robust_thresholds_are_jax_global_quantiles(run):
    case = run["robustnerf"]
    got = case["ranks"][0]["thresholds"]
    assert len(got) == STEPS
    for t, want in zip(got, case["jax"]["thresholds"]):
        np.testing.assert_allclose(t.numpy(), want, rtol=THRESHOLD_TOL)
    assert float(got[-1][0]) < 1.0


@pytest.mark.parametrize("name", CASES)
def test_host_split_render_matches_one_process_and_jax(run, name):
    case = run[name]
    for rank in case["ranks"]:
        np.testing.assert_allclose(rank["rgb"], case["port_rgb"],
                                   rtol=0, atol=RENDER_TOL)
        np.testing.assert_allclose(rank["rgb"], case["jax_rgb"],
                                   rtol=RENDER_TOL, atol=RENDER_TOL)
    np.testing.assert_array_equal(case["ranks"][0]["rgb"],
                                  case["ranks"][1]["rgb"])


@pytest.mark.parametrize("name", CASES)
def test_replicate_gives_every_rank_rank_zeros_weights(run, name):
    # Rank 1 perturbed its copy before mesh.replicate.
    assert all(r["replicated"] for r in run[name]["ranks"])


def test_a_hanging_collective_fails_on_its_timeout():
    """Rank 0 waits at a barrier; rank 1 stays away for 6 s, twice the
    group's 3 s timeout, so rank 0's failure is the timeout's."""
    (rc, out), _ = launch([WORKER, "hang", "3"], timeout=90)
    m = re.search(r"TIMED_OUT after (\S+)s", out)
    assert rc == 3 and m, out
    assert 2.5 <= float(m.group(1)) < 6, out


# The drivers: a tiny synthetic nerfacto run.
DRIVER_BASE = {"num_steps": 3, "batch_size": 64, "eval_images_num": 2,
               "render_chunk_size": 100}


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("drivers"))
    cfg = tu.write_tiny_yaml(tmp, DRIVER_BASE)
    ckpt = os.path.join(tmp, "ck")
    flags = ["--config", cfg, "--data_dir", tmp, "--save_dir", ckpt,
             "--device", "cpu", "--dist_backend", "gloo"]
    train = launch(["-m", "nerf_hugs_torch.train"] + flags)
    written = sorted(os.listdir(ckpt))
    events = os.listdir(os.path.join(ckpt, "tb_train"))
    evals = launch(["-m", "nerf_hugs_torch.eval"] + flags)
    with open(glob.glob(os.path.join(ckpt, "metrics_test_*.txt"))[0]) as f:
        metrics_2 = f.read()
    renders = launch(["-m", "nerf_hugs_torch.render"] + flags)
    one = launch(["-m", "nerf_hugs_torch.eval"] + flags[:-2], world=None)
    with open(glob.glob(os.path.join(ckpt, "metrics_test_*.txt"))[0]) as f:
        metrics_1 = f.read()
    return dict(ckpt=ckpt, train=train, evals=evals, renders=renders,
                one=one, metrics=(metrics_2, metrics_1), written=written,
                events=events)


def test_train_driver_as_two_ranks_writes_once(drivers):
    (rc0, out0), (rc1, out1) = drivers["train"]
    assert rc0 == 0 and rc1 == 0, out0 + out1
    steps = lambda out: re.findall(r"\[train\] (\d+)/3: loss=", out)
    assert steps(out0) == ["1", "2", "3"] and steps(out1) == []
    assert "eval psnr=" in out0 and "eval psnr=" not in out1
    assert drivers["written"] == sorted([
        "checkpoint_3.pt", "config.gin", "model_compat.json", "run_log.log",
        "tb_train"])
    assert len(drivers["events"]) == 1
    with open(os.path.join(drivers["ckpt"], "run_log.log")) as f:
        log = f.read()
    assert log.count("Number of parameters") == 1
    assert log.count("[train] 3/3") == 1


def test_eval_driver_as_two_ranks_matches_one_process(drivers):
    for rc, out in drivers["evals"] + drivers["one"]:
        assert rc == 0, out
    (_, out0), (_, out1) = drivers["evals"]
    assert "mean: psnr=" in out0 and "mean: psnr=" not in out1
    two, one = drivers["metrics"]
    read = lambda text: dict(line.split() for line in text.splitlines())
    a, b = read(two), read(one)
    assert set(a) == set(b) and "psnr" in a
    for k in a:
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6,
                                   err_msg=k)


def test_render_driver_as_two_ranks_writes_the_frames_once(drivers):
    (rc0, out0), (rc1, out1) = drivers["renders"]
    assert rc0 == 0 and rc1 == 0, out0 + out1
    assert "render complete" in out0 and "render complete" in out1
    frames = glob.glob(os.path.join(drivers["ckpt"], "render",
                                    "test_preds_step_3", "color_*.png"))
    preds = glob.glob(os.path.join(drivers["ckpt"], "test_preds",
                                   "*_color.png"))
    assert len(frames) == len(preds) > 0
