"""The transient methods' quality runs of the port against the JAX
package's, on the CPU at toy widths: Mip-NeRF 360's initial weights
(models/jax_init.py::init_mipnerf360_) against flax's init under train.py's
key, the train driver starting from them, the collapse diagnosis
(nerf_hugs_torch/tools/diagnose_nerfw_collapse.py) against
tools/diagnose_nerfw_collapse.py on a checkpoint JAX's train.py writes,
chip_smoke.py's TRANSIENT_RUNS against the commands of the JAX package's
distractor queue, and remat leaving a train step bit-equal."""

import json
import os
import pathlib
import re
import shlex
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_port_util as tu
from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model, jax_init
from nerf_hugs_torch.models.from_jax import convert_mipnerf360_params
from nerf_hugs_torch.tools import diagnose_nerfw_collapse as tdiag
from nerf_hugs_torch.tools import validate_quality as tvq
from nerf_hugs_torch.train import driver as tdriver
from nerf_hugs_torch.train import step as tstep
from nerf_hugs_tpu import models as jmodels
from nerf_hugs_tpu.configs import gin_parser as jgin
from nerf_hugs_tpu.utils import structs as jstructs
from tools import validate_quality as jvq

REPO = pathlib.Path(__file__).resolve().parents[1]
GIN = REPO / "configs" / "mipnerf360"
# The distractor gins at toy widths (NerfMLP 2 x 32 with a skip at layer
# 1, transient head 2 x 16, PropMLP 2 x 16, 8 + 4 samples).
TOY = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
       "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
       "NerfMLP.net_width_viewdirs = 16", "NerfMLP.net_depth_transient = 2",
       "NerfMLP.net_width_transient = 16", "PropMLP.net_depth = 2",
       "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
       "Model.num_nerf_samples = 4", "Config.batch_size = 512",
       "Config.image_num_per_batch = 2", "Config.render_chunk_size = 512"]
# A small synthetic_distractor scene for the steps of the CPU tests: 4
# images of 32x32 at the queue's factor 2.
SMALL_SCENE = ["Config.dataset_loader = 'synthetic_distractor'",
               "Config.synthetic_num_images = 4",
               "Config.synthetic_height = 64", "Config.synthetic_width = 64",
               "Config.factor = 2"]
TRANSIENT = {"none": "base", "nerfw": "nerfw", "hanerf": "hanerf"}
# The collapse tool: PSNRs (dB) and means, full precision.
PSNR_TOL, MEAN_TOL = 1e-4, 1e-5
DIAG_KEYS = ("combined_psnr", "static_only_psnr", "static_acc",
             "combined_static_part_mean", "transient_part_mean", "beta_mean")


def gin_path(transient: str) -> str:
    return str(GIN / f"distractor_1024_glo4_{TRANSIENT[transient]}.gin")


def jax_initial_state(gin: str, bindings) -> dict:
    """train.py's initial Mip-NeRF 360 weights, drawn by flax, as a
    state_dict of the port: PRNGKey(20200823) folded with host 0, split,
    the first half to setup_model (train.py:105-127)."""
    config = jgin.parse_gin_configs([gin], list(bindings))
    rng = jax.random.fold_in(jax.random.PRNGKey(20200823), 0)
    init_key, _ = jax.random.split(rng)
    _, variables = jmodels.construct_model(init_key, jstructs.dummy_rays(),
                                           config)
    return convert_mipnerf360_params(
        tu.unflatten(tu.flat_params(jax.device_get(variables["params"]))))


def assert_jax_initial_weights(got: dict, want: dict) -> None:
    """Dense kernels and zero biases bit for bit, the embeddings (erfinv)
    within 1e-5."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith(("GloEmbed_0", "TransientEmbed_0")):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("transient", sorted(TRANSIENT))
def test_mipnerf360_starts_from_jax_initial_weights(transient):
    want = jax_initial_state(gin_path(transient), TOY)
    config = tgin.parse_gin_configs([gin_path(transient)], TOY)
    assert config.model.num_glo_features == 4
    assert config.transient_type == (None if transient == "none"
                                     else transient)
    model = construct_model(config, "cpu", torch.Generator().manual_seed(3))
    jax_init.init_mipnerf360_(model)
    assert_jax_initial_weights(model.state_dict(), want)


def test_the_train_driver_starts_mipnerf360_from_jax_initial_weights(
        tmp_path, monkeypatch):
    """The model the driver hands its train stage holds train.py's draws;
    remat (the distractor queue's binding) leaves them as they are."""
    seen = []
    monkeypatch.setattr(tdriver, "run_stage",
                        lambda stage, model, *args: seen.append(
                            {k: v.clone()
                             for k, v in model.state_dict().items()}))
    bindings = TOY + SMALL_SCENE + ["Model.remat_mlp = True"]
    argv = ["--gin_configs", gin_path("hanerf")]
    for b in bindings:
        argv += ["--gin_bindings", b]
    tdriver.main(argv + ["--data_dir", "synthetic", "--save_dir",
                         str(tmp_path / "ck"), "--device", "cpu"])
    (state,) = seen
    assert_jax_initial_weights(state, jax_initial_state(gin_path("hanerf"),
                                                        bindings))


# ---------------------------------------------------------------------------
# The four commands of the JAX package's distractor queue.

def queue_command(script: str, run: str) -> list:
    """The validate_quality arguments of `run NAME TIMEOUT python
    tools/validate_quality.py ARGS` in a queue script, less --save-dir."""
    text = (REPO / script).read_text().replace("\\\n", " ")
    (line,) = [ln for ln in text.splitlines()
               if ln.split()[:2] == ["run", run]]
    words = shlex.split(line)
    assert words[3:5] == ["python", "tools/validate_quality.py"], line
    args = words[5:]
    i = args.index("--save-dir")
    return args[:i] + args[i + 2:]


def driver_config(module, argv):
    return module.load_config_from_args(module.parse_args(
        argv + ["--data_dir", "synthetic", "--save_dir", "unused"]))


@pytest.mark.parametrize("name", sorted(chip_smoke.TRANSIENT_RUNS))
def test_transient_runs_are_the_jax_queue_commands(name, tmp_path):
    import train as jtrain
    run = chip_smoke.TRANSIENT_RUNS[name]
    assert list(run.args) == queue_command(run.script, run.run)
    args = tvq.parse_args(list(run.args))
    j_none, j_argv, j_steps = jvq._gin_override_args(args.config,
                                                     str(tmp_path), args)
    assert j_none is None
    t_argv, t_steps = tvq.gin_override_args(args.config, args)
    assert (t_argv, t_steps) == (j_argv, j_steps) and t_steps == 3000
    assert tgin.config_str(driver_config(tdriver, t_argv)) == \
        jgin.config_str(driver_config(jtrain, j_argv))
    # The card runs leave remat out and nothing else.
    card = chip_smoke.transient_args(run)
    i = run.args.index("Model.remat_mlp = True")
    assert run.args[i - 1] == "--binding"
    assert card == list(run.args[:i - 1] + run.args[i + 1:])
    assert "Model.remat_mlp = True" not in card


def test_strongreg_gin_is_nerfw_plus_the_binding():
    binding = ["Config.nerfw_density_loss_mult = 0.3"]
    for parser in (tgin, jgin):
        strong = parser.parse_gin_configs(
            [str(GIN / "distractor_1024_glo4_nerfw_strongreg.gin")], [])
        nerfw = parser.parse_gin_configs(
            [str(GIN / "distractor_1024_glo4_nerfw.gin")], binding)
        assert parser.config_str(strong) == parser.config_str(nerfw)
        assert strong.nerfw_density_loss_mult == 0.3


# ---------------------------------------------------------------------------
# Remat only trades memory.

@pytest.mark.parametrize("transient", sorted(TRANSIENT))
def test_remat_leaves_a_train_step_bit_identical(transient):
    """One train step (sample jitter, loss, gradients, clipping, Adam) from
    JAX's initial weights with and without Model.remat_mlp: the parameters
    after it are bit-equal, so the card's quality runs may leave remat
    out."""
    states = []
    for remat in (True, False):
        config = tgin.parse_gin_configs(
            [gin_path(transient)],
            TOY + SMALL_SCENE + [f"Model.remat_mlp = {remat}"])
        model = construct_model(config, "cpu",
                                torch.Generator().manual_seed(0))
        assert model.NerfMLP_0.remat == remat
        jax_init.init_mipnerf360_(model)
        dataset = load_dataset("train", "", config, is_training=True)
        batch = next(iter(dataset)).to("cpu")
        optimizer, scheduler = tstep.create_optimizer(config, model)
        rng = torch.Generator().manual_seed(config.seed + 1)
        stats = tstep.train_step(
            model, optimizer, scheduler, batch, 0.0, config, rng,
            tstep.initial_inlier_thresholds(config, "cpu"))
        assert np.isfinite(float(stats["loss"]))
        states.append(model.state_dict())
    remat, plain = states
    for k, v in plain.items():
        assert torch.equal(remat[k], v), k


# ---------------------------------------------------------------------------
# The collapse diagnosis against the JAX tool's.

# Runs tools/diagnose_nerfw_collapse.py as it is, keeping each view's
# ground truth and renders, and prints the line's numbers at full
# precision (the tool's own expressions) as one JSON line.
JAX_TOOL = """
import importlib, json, sys
import numpy as np
sys.path.insert(0, {repo!r})
sys.argv = ["tools/diagnose_nerfw_collapse.py"] + {argv!r}
tool = importlib.import_module("tools.diagnose_nerfw_collapse")
import nerf_hugs_tpu.data as jd
import nerf_hugs_tpu.train.render_image as jr
gts, renders = [], []
load, render = jd.load_dataset, jr.render_image
def load_dataset(*args, **kwargs):
    ds = load(*args, **kwargs)
    generate = ds.generate_ray_batch
    def kept(idx):
        batch = generate(idx)
        gts.append(np.asarray(batch.rgb)[..., :3])
        return batch
    ds.generate_ray_batch = kept
    return ds
def render_image(*args, **kwargs):
    renders.append(render(*args, **kwargs))
    return renders[-1]
jd.load_dataset, jr.render_image = load_dataset, render_image
tool.main()
def psnr(x, y):
    return float(-10.0 / np.log(10.0)
                 * np.log(np.mean((np.clip(x, 0, 1) - y) ** 2)))
views = []
for gt, full, static in zip(gts, renders[0::2], renders[1::2]):
    comb = np.asarray(full.get("rgb_combined", full["rgb"]))
    views.append({{
        "combined_psnr": psnr(comb, gt),
        "static_only_psnr": psnr(np.asarray(static["rgb"]), gt),
        "static_acc": float(np.mean(np.asarray(static["acc"]))),
        "combined_static_part_mean": float(np.mean(np.asarray(
            full["rgb_static"]))),
        "transient_part_mean": float(np.mean(np.asarray(
            full["rgb_transient"]))),
        "beta_mean": float(np.mean(np.asarray(full["uncertainty"])))}})
print("JAX_VIEWS " + json.dumps(views))
"""


def run_jax(argv, timeout=600) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable] + argv, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def line_numbers(line: str) -> list:
    return [float(x) for x in chip_smoke.DIAGNOSE_LINE.match(line).groups()]


def test_collapse_tool_prints_jax_line(tmp_path, capsys, monkeypatch):
    """A toy NeRF-W gin (the shipped one at TOY widths), trained 2 steps by
    JAX's train.py on the tool's scene; JAX's tool reads the orbax
    checkpoint, the port's tool the same weights through
    tools/convert_reference_checkpoint (from the msgpack file flax's
    serializer writes of the checkpoint's params)."""
    import flax.serialization
    import orbax.checkpoint as ocp
    from nerf_hugs_torch.tools import convert_reference_checkpoint
    gin = tmp_path / "toy_nerfw.gin"
    gin.write_text((GIN / "distractor_1024_glo4_nerfw.gin").read_text()
                   + "\n".join(TOY) + "\n")
    jck = tmp_path / "jax"
    train = ["train.py", "--gin_configs", str(gin)]
    for b in list(tdiag.BINDINGS) + [
            "Config.max_steps = 2", "Config.checkpoint_every = 2",
            "Config.train_render_every = 0", "Config.print_every = 1",
            "Config.data_dir = 'synthetic'",
            f"Config.checkpoint_dir = '{jck}'"]:
        train += ["--gin_bindings", b]
    run_jax(train)
    argv = ["--save-dir", str(jck), "--config", str(gin), "--views", "1"]
    out = run_jax(["-c", JAX_TOOL.format(repo=str(REPO), argv=argv)])
    (j_line,) = re.findall(r"^view 0: .*$", out, re.M)
    (j_views,) = re.findall(r"^JAX_VIEWS (.*)$", out, re.M)
    (j_view,) = json.loads(j_views)
    assert f"restored step 2 from {jck}" in out

    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(str(jck / "checkpoint_2"))
    (tmp_path / "msgpack").mkdir()
    (tmp_path / "msgpack" / "checkpoint_2").write_bytes(
        flax.serialization.msgpack_serialize({
            "params": jax.tree_util.tree_map(np.asarray, tree["params"]),
            "step": int(tree["step"])}))
    conv = ["--reference_checkpoint", str(tmp_path / "msgpack"),
            "--gin_configs", str(gin), "--output_dir",
            str(tmp_path / "torch"), "--device", "cpu"]
    for b in tdiag.BINDINGS:
        conv += ["--gin_bindings", b]
    convert_reference_checkpoint.main(conv)
    views = []
    diagnose_view = tdiag.diagnose_view
    monkeypatch.setattr(tdiag, "diagnose_view", lambda *a: views.append(
        diagnose_view(*a)) or views[-1])
    capsys.readouterr()
    tdiag.main(["--save-dir", str(tmp_path / "torch"), "--config", str(gin),
                "--views", "1", "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert f"restored step 2 from {tmp_path / 'torch'}" in t_out
    (t_line,) = re.findall(r"^view 0: .*$", t_out, re.M)
    (view,) = views
    for k in DIAG_KEYS:
        tol = PSNR_TOL if k.endswith("psnr") else MEAN_TOL
        assert abs(view[k] - j_view[k]) <= tol, (k, view[k], j_view[k])
    # Printed to 2 (PSNR) and 4 decimals: at most one unit of the last.
    np.testing.assert_allclose(line_numbers(t_line), line_numbers(j_line),
                               rtol=0, atol=1.0001e-2)
    assert t_line == tdiag.view_line(0, view, 0.03)
    assert line_numbers(t_line)[-1] == 0.03


def test_diagnose_defaults_follow_validate_quality(tmp_path):
    args = tdiag.parse_args([])
    assert args.config == "configs/mipnerf360/distractor_1024_glo4_nerfw.gin"
    assert (args.views, args.device) == (2, "cuda")
    # validate_quality's default --save-dir for the same config
    # (tools/validate_quality.py's exact_config_argv).
    assert args.save_dir == os.path.join(
        tempfile.gettempdir(), "validate_distractor_1024_glo4_nerfw")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tdiag.main(["--save-dir", str(tmp_path), "--config",
                    str(GIN / "distractor_1024_glo4_nerfw.gin"),
                    "--device", "cpu"])


def test_the_walk_for_jax_imports_covers_the_diagnosis():
    """test_torch_port_driver.py::test_port_imports_no_jax walks every
    module of nerf_hugs_torch/, the collapse diagnosis among them."""
    from test_torch_port_driver import FORBIDDEN, _imported_modules
    path = REPO / "nerf_hugs_torch" / "tools" / "diagnose_nerfw_collapse.py"
    assert path in sorted((REPO / "nerf_hugs_torch").rglob("*.py"))
    imported = list(_imported_modules(path))
    assert "nerf_hugs_torch.train.render_image" in imported
    assert not [m for m in imported if m.split(".")[0] in FORBIDDEN]
