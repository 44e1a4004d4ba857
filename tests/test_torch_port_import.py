"""The import of the reference's released checkpoints into the port
against the JAX package's: the nerfacto and vanilla-NeRF torch snapshots
(models/nerfacto_import.py, models/torch_compat.py), flax msgpack
checkpoints (utils/flax_msgpack.py) and the converter CLI
(tools/convert_reference_checkpoint.py), on the CPU at toy widths.

No released checkpoint is in the repository: the snapshots are made in
the released layout from a seeded generator at the toy models' shapes
(tools/released_snapshots.py). Tolerances: the converted trees bit-equal
to JAX's (values and dtypes); renderings of the port's model from its
tree within 1e-5 of JAX's model from JAX's tree (the nerfacto and vanilla
parity tests' forward tolerance); the msgpack reader's arrays bit-equal
to flax's; the CLI's eval PNG equal to that of a model loaded straight
from the tree.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.models import from_jax
from nerf_hugs_torch.models import nerfacto_import, torch_compat
from nerf_hugs_torch.tools import released_snapshots
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.utils import flax_msgpack
from nerf_hugs_torch.utils import structs as tstructs
from test_torch_port_hanerf import HANERF_BASE, HANERF_MODEL
from test_torch_port_transient import NERFW_MODEL
from test_torch_port_vanilla import VANILLA_BASE, VANILLA_MODEL, VARIANTS

REPO = pathlib.Path(__file__).resolve().parents[1]
FWD_TOL = 1e-5
N_RAYS = 32
TRAIN_FRAC = 0.4

# Dense nerfacto with one proposal net, NeRF-W (two proposal nets,
# embeddings, the transient head), HA-NeRF (two proposal nets and the
# implicit mask's 2-D grid).
NERFACTO = {"dense": ({}, {}),
            "nerfw": ({}, NERFW_MODEL),
            "hanerf": (HANERF_BASE, HANERF_MODEL)}


def configs(base, model):
    """(JAX config, port config, yaml path) of the toy yaml."""
    import tempfile

    from nerf_hugs_tpu.configs import yaml_loader as jyaml
    d = tempfile.mkdtemp()
    path = tu.write_tiny_yaml(d, base=base, model=model)
    return (jyaml.load_yaml_config(path),
            driver.load_config(path, "data", "ckpt"), path)


def numpy_state(snapshot: dict) -> dict:
    return {k: v.numpy() for k, v in snapshot["model"].items()}


def assert_trees_equal(want, got):
    want, got = tu.flat_params(want), tu.flat_params(got)
    assert sorted(want) == sorted(got)
    for key in want:
        assert want[key].dtype == got[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def rays():
    arrays = tu.ray_arrays(N_RAYS, 0)
    arrays["embed_idx"] = (np.arange(N_RAYS) % 3).astype(np.int32)[:, None]
    return arrays


def assert_renders_match(jax_model, jax_tree, port_model, port_tree):
    from nerf_hugs_tpu.utils import structs as jstructs
    arrays = rays()
    rend_j, _ = jax.jit(lambda p, r: jax_model.apply(
        p, None, r, train_frac=TRAIN_FRAC, compute_extras=True,
        zero_glo=False, zero_tra=False))(
            jax.tree_util.tree_map(jnp.asarray, jax_tree),
            jstructs.Rays(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    port_model.load_state_dict(port_tree)
    with torch.no_grad():
        rend_t, _ = port_model(tstructs.Rays(**arrays).to("cpu"), TRAIN_FRAC,
                               True, None, zero_glo=False, zero_tra=False)
    assert len(rend_t) == len(rend_j)
    for level, (r_t, r_j) in enumerate(zip(rend_t, rend_j)):
        for key in r_j:
            if key in r_t:
                np.testing.assert_allclose(
                    r_t[key].numpy(), np.asarray(r_j[key]), rtol=FWD_TOL,
                    atol=FWD_TOL, err_msg=f"{level} {key}")
    assert np.isfinite(rend_t[-1]["rgb"].numpy()).all()


@pytest.mark.parametrize("variant", list(NERFACTO))
def test_nerfacto_snapshot_converts_as_jax(variant):
    from nerf_hugs_tpu.models import nerfacto as jnerf
    from nerf_hugs_tpu.models import nerfacto_import as jimport
    from nerf_hugs_tpu.utils import structs as jstructs
    from nerf_hugs_torch.models.nerfacto import NerfactoModel

    jconfig, tconfig, _ = configs(*NERFACTO[variant])
    model = NerfactoModel(tconfig, "cpu", torch.Generator().manual_seed(0))
    sd = numpy_state(released_snapshots.nerfacto_snapshot(model, tconfig, 7,
                                                         25000))
    assert sd["field.mlp_base.0.params"].dtype == np.float16
    sd = {k: v for k, v in sd.items()
          if not k.endswith(nerfacto_import._IGNORED_SUFFIXES)}
    want = jimport.convert_nerfacto_state_dict(sd, jconfig)
    got = nerfacto_import.convert_nerfacto_state_dict(sd, tconfig)
    assert_trees_equal(want, got)
    if variant == "hanerf":
        assert "implicit_mask" in got["params"]
    jax_model, _ = jnerf.construct_model(
        jax.random.PRNGKey(0), jstructs.Rays(**{
            k: jnp.asarray(v) for k, v in rays().items()}), jconfig)
    assert_renders_match(jax_model, want, model,
                         from_jax.convert_nerfacto_params(got))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vanilla_snapshot_converts_as_jax(variant):
    from nerf_hugs_tpu.models import torch_compat as jcompat
    from nerf_hugs_tpu.models import vanilla as jvan
    from nerf_hugs_tpu.utils import structs as jstructs
    from nerf_hugs_torch.models.vanilla import VanillaNerfModel

    jconfig, tconfig, _ = configs(VANILLA_BASE,
                                  {**VANILLA_MODEL, **VARIANTS[variant]})
    model = VanillaNerfModel(tconfig, "cpu", torch.Generator().manual_seed(0))
    sd = numpy_state(released_snapshots.vanilla_snapshot(model, tconfig, 8,
                                                        300000))
    want = jcompat.convert_nerf_model_state_dict(sd, jconfig)
    got = torch_compat.convert_nerf_model_state_dict(sd, tconfig)
    assert_trees_equal(want, got)
    jax_model, _ = jvan.construct_model(
        jax.random.PRNGKey(0), jstructs.Rays(**{
            k: jnp.asarray(v) for k, v in rays().items()}), jconfig)
    assert_renders_match(jax_model, want, model,
                         from_jax.convert_vanilla_params(got))


def _refusal(fn, *args) -> str:
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_refusals_raise_as_jax():
    """The fused tcnn-MLP blob, Linear keys the shipped layer counts leave
    behind, a grid of the wrong size, a trunk of the wrong depth."""
    from nerf_hugs_tpu.models import nerfacto_import as jimport
    from nerf_hugs_tpu.models import torch_compat as jcompat
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.models.vanilla import VanillaNerfModel

    jconfig, tconfig, _ = configs({}, {})
    model = NerfactoModel(tconfig, "cpu", torch.Generator().manual_seed(0))
    sd = numpy_state(released_snapshots.nerfacto_snapshot(model, tconfig, 1,
                                                         1))
    blob = {**sd, "field.mlp_base.params": np.zeros(4, np.float16)}
    extra = {**sd, "field.mlp_head.6.weight": np.zeros((3, 3), np.float32),
             "field.mlp_head.6.bias": np.zeros(3, np.float32)}
    short = {**sd, "field.mlp_base.0.params":
             sd["field.mlp_base.0.params"][:-2]}
    for bad in (blob, extra, short):
        want = _refusal(jimport.convert_nerfacto_state_dict, bad, jconfig)
        got = _refusal(nerfacto_import.convert_nerfacto_state_dict, bad,
                       tconfig)
        assert got == want
    jconfig, tconfig, _ = configs(VANILLA_BASE, VANILLA_MODEL)
    model = VanillaNerfModel(tconfig, "cpu", torch.Generator().manual_seed(0))
    sd = numpy_state(released_snapshots.vanilla_snapshot(model, tconfig, 1,
                                                        1))
    shallow = {k: v for k, v in sd.items()
               if not k.startswith("field.coarse.mlp_base.0.0.")}
    assert _refusal(torch_compat.convert_nerf_model_state_dict, shallow,
                    tconfig) == _refusal(
        jcompat.convert_nerf_model_state_dict, shallow, jconfig)


def test_torch_load_reads_snapshots_and_warns_before_trusting(tmp_path):
    """weights_only first; a file it refuses is read fully after a
    warning; a missing file raises."""
    import argparse
    path = tmp_path / "snap.pth"
    torch.save({"model": {"w": torch.ones(2)}, "state": {"global_step": 5}},
               path)
    ckpt = torch_compat.torch_load_checkpoint(str(path))
    assert torch_compat.snapshot_step(ckpt) == 5
    odd = tmp_path / "odd.pth"
    torch.save({"model": argparse.Namespace(a=1)}, odd)
    with pytest.warns(UserWarning, match="weights_only"):
        torch_compat.torch_load_checkpoint(str(odd))
    with pytest.raises(OSError):
        torch_compat.torch_load_checkpoint(str(tmp_path / "missing.pth"))


TOY_GIN = ["NerfMLP.net_depth = 2", "NerfMLP.net_width = 32",
           "NerfMLP.skip_layer = 1", "NerfMLP.bottleneck_width = 16",
           "NerfMLP.net_width_viewdirs = 16", "PropMLP.net_depth = 2",
           "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
           "Model.num_nerf_samples = 4", "Model.num_glo_features = 4"]


def jax_mipnerf360_variables(bindings):
    from nerf_hugs_tpu.configs import gin_parser
    from nerf_hugs_tpu.models import mipnerf360 as jmip
    from nerf_hugs_tpu.utils import structs as jstructs
    config = gin_parser.parse_gin_configs([], bindings)
    _, variables = jmip.construct_model(
        jax.random.PRNGKey(2), jstructs.Rays(**{
            k: jnp.asarray(v) for k, v in rays().items()}), config)
    return jax.device_get(variables)


def test_msgpack_reads_flax_checkpoints(tmp_path):
    """A msgpack_serialize'd TrainState of a JAX MipNerf360Model, with the
    other leaf kinds flax writes beside it, reads to flax's own tree."""
    import ml_dtypes
    from flax import serialization

    variables = jax_mipnerf360_variables(TOY_GIN)
    rs = np.random.RandomState(0)
    extras = {"ints": [0, 127, 128, -1, -32, -33, 2 ** 40, -2 ** 40],
              "floats": [0.5, -1e300], "text": "x" * 40, "none": None,
              "flags": [True, False], "blob": b"\x00\x01" * 200,
              "scalar": np.float32(1.5), "int64": rs.randint(0, 9, (3, 2)),
              "half": rs.rand(5).astype(np.float16),
              "bf16": rs.rand(4).astype(ml_dtypes.bfloat16),
              "wide": {f"k{i}": i for i in range(20)},
              "empty": np.zeros((0, 3), np.float32)}
    state = {"params": variables, "step": 12345, "opt_state": extras}
    data = serialization.msgpack_serialize(state)
    want = serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)

    def same(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            assert isinstance(b, list) and len(a) == len(b), path
            for x, y in zip(a, b):
                same(x, y, path)
        elif isinstance(a, (np.ndarray, np.generic)) and \
                a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(b, np.asarray(a, np.float32))
        elif isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b), path
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:
            assert type(a) is type(b) and a == b, path
    same(want, got, "")

    ckpt_dir = tmp_path / "ref"
    ckpt_dir.mkdir()
    (ckpt_dir / "checkpoint_12345").write_bytes(data)
    (ckpt_dir / "checkpoint_900").write_bytes(b"\xc0")
    params, step = flax_msgpack.extract_reference_params(str(ckpt_dir))
    assert step == 12345 and sorted(params) == ["params"]
    same(params, {"params": want["params"]["params"]}, "params")

    complex_data = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.msgpack_restore(complex_data)
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        flax_msgpack.msgpack_restore(chunked)


def test_cli_converts_a_mipnerf360_msgpack_checkpoint(tmp_path):
    """The gin dialect: the checkpoint the CLI writes restores the state
    from_jax makes of the variables, at the file's step."""
    from flax import serialization
    from nerf_hugs_torch.tools import convert_reference_checkpoint as conv
    from nerf_hugs_torch.train import checkpoints

    variables = jax_mipnerf360_variables(TOY_GIN)
    path = tmp_path / "checkpoint_777"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": variables, "step": 777, "opt_state": {}}))
    out = tmp_path / "out"
    conv.main(["--reference_checkpoint", str(path), "--output_dir", str(out),
               "--device", "cpu"] + [f"--gin_bindings={b}" for b in TOY_GIN])
    saved = torch.load(out / "checkpoint_777.pt", weights_only=True)
    assert saved["step"] == 777
    want = from_jax.convert_mipnerf360_params(variables)
    assert sorted(saved["model"]) == sorted(want)
    for k, v in want.items():
        torch.testing.assert_close(saved["model"][k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="parameter"):
        conv.main(["--reference_checkpoint", str(path), "--output_dir",
                   str(tmp_path / "bad"), "--device", "cpu"]
                  + [f"--gin_bindings={b}" for b in TOY_GIN[:-1]])
    assert not (tmp_path / "bad").exists()


def run_module(module: str, args: list) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", module] + args, cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cli_converts_a_nerfacto_snapshot_for_eval(tmp_path):
    """python -m ...convert_reference_checkpoint on a released-layout
    nerfacto .pth writes a directory whose eval colour PNG equals that of
    the model loaded straight from the converted tree; the emitted
    config.yml composites with legacy_cumulative_deltas."""
    import yaml
    from PIL import Image

    from nerf_hugs_torch.eval import main as eval_main
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.train import checkpoints
    from nerf_hugs_torch.train import step as step_lib

    base = {"early_exit_steps": 2, "synthetic_num_images": 2}
    _, tconfig, cfg = configs(base, {})
    model = NerfactoModel(tconfig, "cpu", torch.Generator().manual_seed(0))
    snap = released_snapshots.nerfacto_snapshot(model, tconfig, 3, 4)
    torch.save(snap, tmp_path / "ckpt_4.pth")
    out = tmp_path / "out"
    log = run_module("nerf_hugs_torch.tools.convert_reference_checkpoint",
                     ["--reference_checkpoint", str(tmp_path / "ckpt_4.pth"),
                      "--config", cfg, "--output_dir", str(out),
                      "--device", "cpu"])
    assert "legacy_cumulative_deltas: true" in log
    emitted = yaml.safe_load((out / "config.yml").read_text())
    assert emitted["model"]["legacy_cumulative_deltas"] is True
    assert (out / "model_compat.json").exists()
    run_module("nerf_hugs_torch.eval", ["--config", str(out / "config.yml"),
                                        "--data_dir", str(tmp_path),
                                        "--save_dir", str(out),
                                        "--device", "cpu"])

    # The same tree loaded straight into the model, through the same eval.
    config = driver.load_config(str(out / "config.yml"), "data", "ckpt")
    assert config.nerfacto.legacy_cumulative_deltas
    tree = nerfacto_import.convert_nerfacto_state_dict(
        numpy_state(snap), config)
    direct = NerfactoModel(config, "cpu", torch.Generator().manual_seed(1))
    direct.load_state_dict(from_jax.convert_nerfacto_params(tree))
    ref = tmp_path / "direct"
    optimizer, scheduler = step_lib.create_optimizer(config, direct)
    checkpoints.save_checkpoint(str(ref), direct, optimizer, scheduler, 4)
    eval_main(["--config", str(out / "config.yml"), "--data_dir",
               str(tmp_path), "--save_dir", str(ref), "--device", "cpu"])
    pngs = sorted(p.name for p in (out / "test_preds").glob("*_color.png"))
    assert pngs
    for name in pngs:
        a, b = (np.asarray(Image.open(d / "test_preds" / name))
                for d in (out, ref))
        np.testing.assert_array_equal(a, b, err_msg=name)
