"""nerf_hugs_torch's own copies of the JAX package's jax-free modules: the
config tree and yaml loader, and the native ray sampler, against the
originals."""

import dataclasses
import pathlib

import numpy as np
import pytest

from nerf_hugs_torch.configs import config as tconfig
from nerf_hugs_torch.configs import yaml_loader as tyaml
from nerf_hugs_torch.data import native_sampler as tsampler
from nerf_hugs_torch.models.nerfacto import fused_mlp_widths
from nerf_hugs_torch.train import driver
from nerf_hugs_tpu.configs import config as jconfig
from nerf_hugs_tpu.configs import yaml_loader as jyaml
from nerf_hugs_tpu.data import native_sampler as jsampler

REPO = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / "configs" / "nerfacto").glob("*.yml"))
NERFACTO_YAMLS = [p for p in YAMLS if "nerfacto" in p.stem]


def test_every_nerfacto_yaml_is_covered():
    assert len(YAMLS) == 30
    assert len(NERFACTO_YAMLS) == 21


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.stem)
def test_yaml_loader_matches_jax(path):
    got = tyaml.load_yaml_config(str(path))
    assert isinstance(got, tconfig.Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jyaml.load_yaml_config(str(path)))


@pytest.mark.parametrize("path", NERFACTO_YAMLS, ids=lambda p: p.stem)
def test_train_preflight_accepts_every_shipped_nerfacto_config(path):
    """The trainer's checks before it builds anything (model_type,
    transient_type with its embeddings, the data loader, the finetune
    groups) pass on every shipped nerfacto config but one: NeRF-W without
    the transient embedding, which JAX cannot train either."""
    config = driver.load_config(str(path), "data", "ckpt")
    if path.stem == "distractor_nerfacto_nerfw":
        with pytest.raises(ValueError, match="use_transient_embedding"):
            driver.preflight(config)
        return
    driver.preflight(config)
    widths = fused_mlp_widths(config)
    assert ("field.mlp_transient" in widths) == (
        config.transient_type == "nerfw")


def test_config_defaults_and_derived_values_match_jax():
    assert tconfig.BACKGROUND_VALUES == jconfig.BACKGROUND_VALUES
    for name in ("MLPConfig", "ModelConfig", "NerfactoConfig", "Config"):
        ours, theirs = getattr(tconfig, name), getattr(jconfig, name)
        assert [(f.name, f.type) for f in dataclasses.fields(ours)] == [
            (f.name, f.type) for f in dataclasses.fields(theirs)], name
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    for model_type in ("nerfacto", "nerf", "mipnerf360"):
        assert (tconfig.Config(model_type=model_type).num_ray_levels
                == jconfig.Config(model_type=model_type).num_ray_levels)
    ours = tconfig.Config(batch_size=128, patch_size=4)
    assert (ours.finetune_batch_size, ours.finetune_patch_size) == (128, 4)


def test_native_sampler_matches_jax():
    ours_lib, theirs_lib = tsampler.load_library(), jsampler.load_library()
    if ours_lib is None or theirs_lib is None:
        pytest.skip("g++ toolchain unavailable")
    assert pathlib.Path(tsampler._LIB_PATH).parent == (
        REPO / "nerf_hugs_torch" / "_build")
    rs = np.random.RandomState(0)
    n_imgs, h, w = 3, 20, 28
    data = dict(
        images=[rs.rand(h, w, 3).astype(np.float32) for _ in range(n_imgs)],
        masks=[rs.rand(h, w, 1).astype(np.float32) for _ in range(n_imgs)],
        nears=[np.full((h, w, 1), 0.1 + i, np.float32)
               for i in range(n_imgs)],
        fars=[np.full((h, w, 1), 5.0 + i, np.float32)
              for i in range(n_imgs)],
        embed_idxs=[7, 8, 9])
    ours = tsampler.NativeSampler(**data)
    theirs = jsampler.NativeSampler(**data)
    for seed, dilation, half in ((3, 1, False), (11, 2, True)):
        got = ours.sample(seed, 6, 4, dilation, 3, half_image=half)
        want = theirs.sample(seed, 6, 4, dilation, 3, half_image=half)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
