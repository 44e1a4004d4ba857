"""Where the JAX package starts a run from flax's initial draws, the port
starts from the same draws, made without JAX (models/jax_init.py):
vanilla NeRF's (init_vanilla_) against flax's init of
nerf_hugs_tpu/models/vanilla.py, the train driver starting a vanilla yaml
from them, the quality tool's legacy mode starting all three backbones
from JAX's PRNGKey(0), and the quality A/B's --init and --init-seeds
reaching every backbone; chip_smoke.py's VANILLA_RUNS, the card's
held-out vanilla runs. Dense kernels and zero biases bit for bit, the
embeddings (torch.erfinv against XLA's polynomial) within 1e-5."""

import pathlib

import jax
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import jax_initial_weights as jiw
from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.models import construct_model, jax_init
from nerf_hugs_torch.tools import quality_ab
from nerf_hugs_torch.tools import validate_quality as tvq
from nerf_hugs_torch.train import driver as tdriver
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import step as jstep
from test_torch_port_transient_quality import SMALL_SCENE, TOY, gin_path
from tools import validate_quality as jvq

REPO = pathlib.Path(__file__).resolve().parents[1]
NERFACTO = REPO / "configs" / "nerfacto"
# The PointMLPs at test widths (a 5-layer trunk of 32 whose skip at layer
# 4 widens the layer after it); NeRF-W's transient head, the embeddings
# and HA-NeRF's 4 x 256 mask keep the yaml's widths.
TEST_WIDTHS = {"net_depth": 5, "net_width": 32, "max_deg_point": 4,
               "deg_view": 2}
# Each shipped yaml with the model widths its case runs at (None: the
# yaml's own).
CASES = {"kubric_nerf_base": None, "kubric_nerf_hanerf": TEST_WIDTHS,
         "kubric_nerf_nerfw": TEST_WIDTHS,
         "phototourism_nerf_nerfw": TEST_WIDTHS}
# The driver's synthetic scene, small.
SMALL_BASE = {"dataset_type": "synthetic", "synthetic_num_images": 4,
              "synthetic_height": 16, "synthetic_width": 16,
              "batch_size": 64, "patch_size": 4, "num_img_per_batch": 2,
              "eval_images_num": 1, "finetune_enable": False}
EMBEDDINGS = ("_embedding.weight", "GloEmbed_0.weight",
              "TransientEmbed_0.weight")


def shipped_yaml(directory, name: str, model=None, base=None) -> str:
    """configs/nerfacto/{name}.yml with the model and base keys given
    replaced, written into `directory`."""
    with open(NERFACTO / f"{name}.yml") as f:
        raw = yaml.safe_load(f)
    raw["model"].update(model or {})
    raw["base"].update(base or {})
    path = pathlib.Path(directory) / f"{name}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def assert_jax_initial_weights(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(EMBEDDINGS):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def case_state(tmp_path_factory):
    """{name: (yaml path, train.py's initial weights drawn by flax)}, one
    JAX init a config."""
    directory = tmp_path_factory.mktemp("vanilla_init")
    states = {}

    def get(name):
        if name not in states:
            path = shipped_yaml(directory, name, CASES[name])
            states[name] = (path, jiw.initial_state_dict(path))
        return states[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_vanilla_starts_from_jax_initial_weights(name, case_state):
    path, want = case_state(name)
    config = tdriver.load_config(path, "data", "ckpt")
    assert config.model_type == "nerf"
    model = construct_model(config, "cpu", torch.Generator().manual_seed(3))
    jax_init.init_vanilla_(model)
    assert_jax_initial_weights(model.state_dict(), want)
    if name.endswith("nerfw"):
        # The fine MLP's transient head: Dense_9-15 after its 9 layers.
        assert "fine.Dense_15.weight" in want
        assert "coarse.Dense_9.weight" not in want
    assert ("appearance_embedding.weight" in want) == name.startswith(
        "phototourism")


def captured_initial_state(monkeypatch, argv: list) -> dict:
    """The state_dict of the model the train driver hands its first
    stage, the stages themselves not run."""
    seen = []
    monkeypatch.setattr(tdriver, "run_stage",
                        lambda stage, model, *args: seen.append(
                            {k: v.clone()
                             for k, v in model.state_dict().items()}))
    tdriver.main(argv + ["--device", "cpu"])
    return seen[0]


def test_the_train_driver_starts_vanilla_from_jax_initial_weights(
        tmp_path, monkeypatch):
    path = shipped_yaml(tmp_path, "kubric_nerf_hanerf", TEST_WIDTHS,
                        SMALL_BASE)
    state = captured_initial_state(monkeypatch, [
        "--config", path, "--data_dir", "synthetic", "--save_dir",
        str(tmp_path / "ck")])
    assert "implicit_mask.Dense_4.weight" in state
    assert_jax_initial_weights(state, jiw.initial_state_dict(path))


@pytest.mark.parametrize("model_type", sorted(tvq.LEGACY_CONFIGS))
def test_legacy_mode_starts_from_jax_prngkey0(model_type):
    """JAX's tool builds each legacy model with setup_model(config,
    PRNGKey(0), mesh), at the legacy widths."""
    jconfig = getattr(jvq, f"{model_type}_config")(False)
    _, state, _, _, _ = jstep.setup_model(jconfig, jax.random.PRNGKey(0),
                                          jmesh.make_mesh())
    want = jiw.to_port(jconfig.model_type, state.params)
    got = tvq.legacy_model(tvq.LEGACY_CONFIGS[model_type](False), "cpu")
    assert_jax_initial_weights(got.state_dict(), want)


# A gin (Mip-NeRF 360 NeRF-W at toy widths) and a vanilla yaml.
AB_CONFIGS = ("gin", "vanilla")


def ab_run(kind: str, tmp_path):
    """(train driver argv, the config the driver loads, JAX's initial
    weights under key 1) of one backbone at toy widths."""
    if kind == "gin":
        argv = ["--gin_configs", gin_path("nerfw")]
        for b in TOY + SMALL_SCENE:
            argv += ["--gin_bindings", b]
        config = tgin.parse_gin_configs([gin_path("nerfw")],
                                        TOY + SMALL_SCENE)
        state = jiw.initial_state_dict(gin_path("nerfw"), key=1,
                                       bindings=TOY + SMALL_SCENE)
        return argv, config, state
    path = shipped_yaml(tmp_path, "kubric_nerf_nerfw", TEST_WIDTHS,
                        SMALL_BASE)
    return (["--config", path], tdriver.load_config(path, "synthetic", ""),
            jiw.initial_state_dict(path, key=1))


@pytest.mark.parametrize("kind", AB_CONFIGS)
def test_quality_ab_init_routes_reach_every_backbone(kind, tmp_path,
                                                     monkeypatch):
    """--init-seeds S: the driver trains from torch's draws at S, not
    from JAX's; --init W.pt: from the saved state_dict (here JAX's draws
    under key 1, from tests/jax_initial_weights.py)."""
    for name in jax_init.INITS.values():
        monkeypatch.setattr(jax_init, name, getattr(jax_init, name))
    argv, config, jax_key1 = ab_run(kind, tmp_path)
    argv += ["--data_dir", "synthetic", "--save_dir", str(tmp_path / "ck")]
    quality_ab.start_from("5")
    got = captured_initial_state(monkeypatch, argv)
    want = construct_model(config, "cpu", torch.Generator().manual_seed(5))
    assert set(got) == set(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    torch.save(jax_key1, tmp_path / "key1.pt")
    quality_ab.start_from(str(tmp_path / "key1.pt"))
    got = captured_initial_state(monkeypatch, argv)
    assert set(got) == set(jax_key1)
    for k, v in jax_key1.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", sorted(chip_smoke.VANILLA_RUNS))
def test_vanilla_runs_are_shipped_vanilla_yamls(name):
    """`chip_smoke.py --vanilla NAME`: 3000 steps of a shipped vanilla
    yaml through the quality tool, recorded, a LOCALIZATION line expected
    where the tool prints one."""
    run = chip_smoke.VANILLA_RUNS[name]
    args = tvq.parse_args(chip_smoke.transient_args(run))
    assert chip_smoke.transient_args(run) == list(run.args)
    assert args.steps == 3000 and args.distractor == name.endswith(
        "distractor")
    assert not run.gated and run.script is None and run.psnr is None
    config = tdriver.load_config(args.config, "", "")
    assert config.model_type == "nerf" and not config.enable_amp
    assert run.localizes == (config.transient_type
                             in tvq.LOCALIZATION_SIGNAL)
