"""nerf_hugs_torch's gin dialect against nerf_hugs_tpu's: every shipped
configs/mipnerf360/*.gin parses into the same Config, the overlays'
include lines resolve, bad bindings raise the same errors, and the
drivers' preflight takes every config whose loader is ported."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from nerf_hugs_torch.configs import gin_parser as tgin
from nerf_hugs_torch.losses import zoo as tzoo
from nerf_hugs_torch.train import driver
from nerf_hugs_tpu.configs import gin_parser as jgin

REPO = pathlib.Path(__file__).resolve().parents[1]
GINS = sorted((REPO / "configs" / "mipnerf360").glob("*.gin"))
# The two bindings of scripts/{train,eval}_mipnerf360_*.sh.
SCRIPT_BINDINGS = ["Config.data_dir = '/data/kubric_dataset/kubric_car'",
                   "Config.checkpoint_dir = './nerf_results/x/kubric_car'"]
OVERLAYS = [p for p in GINS if p.stem.endswith("_tpu_bf16")]


def test_every_mipnerf360_gin_is_covered():
    assert len(GINS) == 24
    assert len(OVERLAYS) == 4


@pytest.mark.parametrize("bindings", [[], SCRIPT_BINDINGS],
                         ids=["alone", "script_bindings"])
@pytest.mark.parametrize("path", GINS, ids=lambda p: p.stem)
def test_gin_parse_matches_jax(path, bindings):
    ours = tgin.parse_gin_configs([str(path)], bindings)
    theirs = jgin.parse_gin_configs([str(path)], bindings)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tgin.config_str(ours) == jgin.config_str(theirs)


@pytest.mark.parametrize("path", OVERLAYS, ids=lambda p: p.stem)
def test_bf16_overlays_include_their_base(path):
    """`include 'X.gin'` resolves relative to the overlay: the overlay is
    its base with bf16 MLP compute and per-level remat."""
    overlay = tgin.parse_gin_configs([str(path)])
    base = path.with_name(path.stem.replace("_tpu_bf16", "") + ".gin")
    want = tgin.parse_gin_configs([str(base)])
    want.model.compute_dtype = "bfloat16"
    want.model.remat_mlp = True
    assert dataclasses.asdict(overlay) == dataclasses.asdict(want)


@pytest.mark.parametrize("binding,match", [
    ("train/Config.batch_size = 1024", "scopes"),
    ("Renderer.chunk = 3", "unknown gin section"),
    ("Config.no_such_field = 3", "does not exist"),
    ("NerfMLP.no_such_field = 3", "does not exist"),
    ("Config.batch_size = %gin.REQUIRED", "macro"),
    ("Config.batch_size = not a literal", "cannot parse"),
    ("just words", "unparseable"),
])
def test_bad_bindings_raise_as_jax(binding, match):
    with pytest.raises(jgin.GinParseError, match=match) as theirs:
        jgin.parse_gin_configs([], [binding])
    with pytest.raises(tgin.GinParseError, match=match) as ours:
        tgin.parse_gin_configs([], [binding])
    assert str(ours.value) == str(theirs.value)


def test_references_and_tuples_parse_as_jax():
    bindings = ["Model.raydist_fn = @jnp.reciprocal",
                "NerfMLP.warp_fn = @coord.contract",
                "MLP.net_activation = @jax.nn.silu",
                "Model.bg_intensity_range = [0.0, 1.0]",
                "Config.weight_decay_mults = {'NerfMLP_0': 0.1}",
                "Config.batch_size = 4096  # a comment"]
    ours = tgin.parse_gin_configs([], bindings)
    theirs = jgin.parse_gin_configs([], bindings)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.model.bg_intensity_range == (0.0, 1.0)
    assert ours.nerf_mlp.net_activation == ours.prop_mlp.net_activation \
        == "silu"


def test_finetune_aliases_follow_the_final_batch():
    ours = tgin.parse_gin_configs([], ["Config.batch_size = 2048",
                                       "Config.patch_size = 4"])
    assert (ours.finetune_batch_size, ours.finetune_patch_size) == (2048, 4)
    ours = tgin.parse_gin_configs([], ["Config.batch_size = 2048",
                                       "Config.finetune_batch_size = 512"])
    assert ours.finetune_batch_size == 512


def test_kubric_robustnerf_gin_needs_patch_size_binding():
    """kubric_1024_robustnerf0.8.gin inherits patch_size 1 while the inner
    patch defaults to 8: the port trips the same guard JAX pins
    (tests/test_configs.py), and the documented binding restores it."""
    path = str(REPO / "configs/mipnerf360/kubric_1024_robustnerf0.8.gin")
    config = tgin.parse_gin_configs([path])
    assert config.patch_size == 1
    errors = torch.full((4, 1, 1, 3), 0.01)
    with pytest.raises(ValueError, match="inner_patch_size"):
        tzoo.robustnerf_mask(errors, 0.5, config)
    fixed = tgin.parse_gin_configs([path], ["Config.patch_size = 16"])
    mask, stats = tzoo.robustnerf_mask(torch.full((4, 16, 16, 3), 0.01),
                                       0.5, fixed)
    assert mask.shape == (4, 16, 16, 1)
    assert float(stats["mask"]) == 1.0


@pytest.mark.parametrize("path", GINS, ids=lambda p: p.stem)
def test_preflight_takes_every_gin_with_a_ported_loader(path):
    """The drivers' checks before they build anything pass on every
    shipped gin, the llff and blender ones included (the robustnerf kubric
    config's patch quirk only shows in the loss)."""
    config = tgin.parse_gin_configs([str(path)], SCRIPT_BINDINGS)
    assert config.model_type == "mipnerf360"
    driver.preflight(config)


def test_registries_resolve_to_torch_functions():
    from nerf_hugs_torch.configs import config as tconfig
    from nerf_hugs_torch.core import coord, math as tmath
    x = torch.linspace(-3, 3, 13)
    for name, want in (("relu", np.maximum(x.numpy(), 0)),
                       ("identity", x.numpy()),
                       ("sigmoid", 1 / (1 + np.exp(-x.numpy())))):
        np.testing.assert_allclose(tconfig.resolve_activation(name)(x),
                                   want, rtol=1e-6, atol=1e-7)
    assert tconfig.resolve_activation("safe_exp") is tmath.safe_exp
    assert tconfig.resolve_activation("exp") is tmath.safe_exp
    assert tconfig.resolve_activation("none") is None
    for name in ("reciprocal", "log", "exp", "sqrt", "square"):
        assert tconfig.resolve_raydist_fn(name).__name__ == name
    assert tconfig.resolve_raydist_fn("piecewise") == "piecewise"
    assert tconfig.resolve_raydist_fn(None) is None
    assert tconfig.resolve_warp_fn("contract") is coord.contract
    with pytest.raises(ValueError, match="unknown"):
        tconfig.resolve_activation("tanhh")
    with pytest.raises(ValueError, match="unknown"):
        tconfig.resolve_warp_fn("spherical")
