"""chip_smoke.py's table of the shipped configs against the repository and
against the JAX package, on the CPU.

SHIPPED_RUNS names the phase of chip_smoke.py that trains or refuses each
file under configs/{nerfacto,mipnerf360,hugs}/ on the card. Held here: it
names every file and nothing else, every phase it names is a phase of the
script, the script's record of the configs given to its drivers is held
to it, each config it lists as refused (REFUSED) raises the port's error
in the train driver's preflight, as JAX's loader or model fails on it, and
every other train config passes the port's preflight.
"""

import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

import chip_smoke
from nerf_hugs_torch.configs import gin_parser
from nerf_hugs_torch.hugs.segment import SegmentConfig
from nerf_hugs_torch.train import driver

REPO = pathlib.Path(__file__).resolve().parents[1]
SHIPPED = sorted(str(p.relative_to(REPO)) for d in chip_smoke.SHIPPED_DIRS
                 for p in (REPO / "configs" / d).iterdir())
TRAIN_CONFIGS = [p for p in SHIPPED if not p.startswith("configs/hugs/")]


def port_config(path: str):
    if path.endswith(".yml"):
        return driver.load_config(str(REPO / path), "data", "ckpt")
    return gin_parser.parse_gin_configs([str(REPO / path)], [])


def test_shipped_runs_names_every_shipped_config():
    assert sorted(chip_smoke.SHIPPED_RUNS) == SHIPPED
    assert len(SHIPPED) == 56
    # The script's own check passes on this checkout.
    chip_smoke.check_coverage()


def test_every_named_phase_is_a_phase_of_the_script():
    phases = set(re.findall(r"^  (\d+)\. ", chip_smoke.__doc__, re.M))
    assert set(map(str, range(1, 23))) <= phases
    assert set(chip_smoke.SHIPPED_RUNS.values()) <= phases
    # Phase 21 runs what SHIPPED_RUNS gives it, each config once.
    swept = [f"configs/{c}" for c, _ in chip_smoke.SWEEP]
    assert len(swept) == len(set(swept)) == 28
    # The runs evaluated by the in-train eval alone are sweep runs.
    assert chip_smoke.SWEEP_COVERED <= set(swept)
    assert len(chip_smoke.REFUSED) == 4


def test_check_driven_holds_each_config_to_its_phase(tmp_path, monkeypatch):
    """driven() records the shipped file behind each driver flag (a yaml
    copy, an absolute gin path, a path relative to the checkout), done()
    gives the records their phases, and check_driven fails the script
    unless every SHIPPED_RUNS config was given to a driver in its phase."""
    monkeypatch.setattr(chip_smoke, "DRIVEN", [])
    monkeypatch.setattr(chip_smoke, "COPIES", {})
    runs = {"configs/nerfacto/kubric_nerfacto_base.yml": "7",
            "configs/mipnerf360/360.gin": "17",
            "configs/hugs/kubric.yml": "13"}
    monkeypatch.setattr(chip_smoke, "SHIPPED_RUNS", runs)
    copy = chip_smoke.shipped_yaml(str(tmp_path), "kubric_nerfacto_base")
    chip_smoke.config_args(copy, "data", "ckpt")
    for entry in chip_smoke.DRIVEN:
        entry[1] = "7-12"
    chip_smoke.config_args(
        [f"--gin_configs={REPO / 'configs/mipnerf360/360.gin'}"], "d", "c")
    chip_smoke.driven(["--config", "configs/hugs/kubric.yml"])
    for entry in chip_smoke.DRIVEN:
        entry[1] = entry[1] or "17"
    assert chip_smoke.DRIVEN == [
        ["configs/nerfacto/kubric_nerfacto_base.yml", "7-12"],
        ["configs/mipnerf360/360.gin", "17"],
        ["configs/hugs/kubric.yml", "17"]]
    # The HuGS yaml ran in phase 17, not in the 13 that the table names.
    with pytest.raises(SystemExit):
        chip_smoke.check_driven()
    chip_smoke.DRIVEN[-1][1] = "13"
    chip_smoke.check_driven()


@pytest.mark.parametrize("path", sorted(chip_smoke.REFUSED))
def test_refused_configs_fail_in_preflight_as_in_jax(path):
    """The port's preflight raises REFUSED's error. JAX has no loader for
    the vanilla yamls' `robust` (the same ValueError) and builds NeRF-W
    without a transient head, whose loss then fails with a KeyError: the
    port refuses that config before building anything (ROADMAP Queue 3)."""
    from nerf_hugs_tpu.configs import yaml_loader as jyaml
    from nerf_hugs_tpu.data import load_dataset as jax_load_dataset
    error, message = chip_smoke.REFUSED[path]
    with pytest.raises(error, match=re.escape(message)):
        driver.preflight(port_config(path))
    jconfig = jyaml.load_yaml_config(str(REPO / path))
    if "dataset_loader" in message:
        with pytest.raises(error, match=re.escape(message)):
            jax_load_dataset("train", "", jconfig, is_training=True)
        return
    from nerf_hugs_tpu.losses import zoo as jzoo
    from nerf_hugs_tpu.models import nerfacto as jnerf
    from nerf_hugs_tpu.utils import structs as jstructs
    n = 4
    rs = np.random.RandomState(0)
    dirs = rs.randn(n, 3).astype(np.float32)
    ones = np.ones((n, 1), np.float32)
    rays = jstructs.Rays(
        pix_coords=np.zeros((n, 2), np.float32),
        origins=np.zeros((n, 3), np.float32), directions=dirs,
        viewdirs=dirs / np.linalg.norm(dirs, axis=-1, keepdims=True),
        radii=0.01 * ones, lossmult=ones, static_mask=ones,
        near=0.05 * ones, far=ones, embed_idx=np.zeros((n, 1), np.int32),
        cam_idx=np.zeros((n, 1), np.int32))
    model = jnerf.NerfactoModel(config=jconfig)
    variables = jax.eval_shape(functools.partial(
        model.init, train_frac=1.0, compute_extras=False, zero_glo=False,
        zero_tra=True), jax.random.PRNGKey(0), None, rays)
    assert "mlp_transient" not in variables["params"]["field"]
    rend, hist = jax.eval_shape(functools.partial(
        model.apply, train_frac=0.5, compute_extras=False, zero_glo=False,
        zero_tra=False), variables, None, rays)
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype), tree)
    batch = jstructs.Batch(rays=None, rgb=jnp.zeros((n, 3)))
    with pytest.raises(KeyError, match="uncertainty"):
        jzoo.compute_nerfw_loss(batch, zeros(rend), zeros(hist), jconfig)


@pytest.mark.parametrize("path", [p for p in TRAIN_CONFIGS
                                  if p not in chip_smoke.REFUSED])
def test_other_train_configs_pass_preflight(path):
    driver.preflight(port_config(path))


@pytest.mark.parametrize("path", [p for p in SHIPPED
                                  if p.startswith("configs/hugs/")])
def test_hugs_configs_build_the_segmentation_config(path):
    """Phase 13 runs the HuGS yamls through `python -m
    nerf_hugs_torch.hugs --config`, which builds a SegmentConfig."""
    with open(REPO / path) as f:
        SegmentConfig(**(yaml.safe_load(f) or {}))
