"""`python -m nerf_hugs_torch.tools.validate_released_assets` against the
JAX package's tools/validate_released_assets.py, on the CPU.

The drop of tests/test_released_assets_dryrun.py (its tiny gin, a flax
checkpoint written by flax, released renders made by JAX, the LPIPS
fixture) runs through both tools: the released renders' scores within
1e-4 dB PSNR, 1e-5 SSIM and 1e-5 LPIPS (the metrics' parity tolerances),
ours against the released renders above JAX's bar of 45 dB
(tests/test_released_assets_dryrun.py), the same report keys. The
inventories and config guesses are held equal; a tiny nerfacto torch
snapshot takes the twin's torch branch; a corrupt checkpoint gives an
error row and `python -m` exits 1; the flax msgpack writer is held
byte-equal to flax; the SAM check's parameter count equals that of JAX's
conversion; without --work_dir the report goes under the temporary
directory (the JAX tool writes to a fixed /tmp/asset_validation).
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

import torch_port_util as tu
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.tools import released_snapshots
from nerf_hugs_torch.tools import validate_released_assets as twin
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.utils import flax_msgpack
from test_released_assets_dryrun import TINY_GIN, _make_lpips_fixture
from tools import validate_released_assets as jax_tool

REPO = pathlib.Path(__file__).resolve().parents[1]
PSNR_TOL, SSIM_TOL, LPIPS_TOL = 1e-4, 1e-5, 1e-5
SHIPPED_STEMS = sorted(
    os.path.splitext(os.path.basename(p))[0]
    for p in glob.glob(str(REPO / "configs" / "*" / "*.gin"))
    + glob.glob(str(REPO / "configs" / "*" / "*.yml")))


def touch(path: pathlib.Path, data: bytes = b"") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


# Drops with every kind of entry, in each of the layouts discover globs.
DROPS = {
    "top-level files": ["lpips_alex.pth", "sam_vit_h.pth",
                        "data/scene0/x", "data/scene1/x",
                        "checkpoints/exp_a/scene0/ckpt_8.pth",
                        "checkpoints/exp_b/scene1/checkpoint_3",
                        "rendering_results/exp_a/scene0/test_preds/"
                        "000_color.png",
                        "segmentation_results/scene0/000.png"],
    "subdirectories": ["lpips/weights.pth", "lpips/other.pth",
                       "sam/sam_vit_b.pth", "data/scene0/x",
                       "checkpoints/exp_a/scene0/checkpoint_1",
                       "rendering_results/exp_b/scene2/test_preds/x.png"],
    "lpips .pt": ["lpips_v0.1.pt", "rendering_results/e/s/test_preds/x"],
    "empty": [],
}


@pytest.mark.parametrize("layout", sorted(DROPS))
def test_discover_gives_jax_inventory(tmp_path, layout):
    """(i) The same inventory as JAX's discover on each drop layout."""
    for rel in DROPS[layout]:
        touch(tmp_path / rel)
    assert twin.discover(str(tmp_path)) == jax_tool.discover(str(tmp_path))


@pytest.mark.parametrize("stem", SHIPPED_STEMS)
def test_guess_config_matches_jax(stem):
    """(ii) Every shipped config stem as the experiment name, alone, with a
    prefix and with a suffix, takes JAX's guess (the longest stem it
    contains)."""
    for experiment in (stem, f"released_{stem}", f"{stem}_run2",
                       f"mipnerf360_{stem}_v1"):
        got = twin._guess_config(experiment, "scene0", {})
        assert got == jax_tool._guess_config(experiment, "scene0", {})
        assert got is not None and os.path.splitext(
            os.path.basename(got))[0] in experiment


def test_guess_config_map_precedence_matches_jax():
    """(ii) --config_map: experiment/scene before experiment before the
    name heuristic, as JAX's."""
    config_map = {"kubric_1024_withmask/car": "a.gin",
                  "kubric_1024_withmask": "b.gin", "unknown_exp": "c.yml"}
    cases = [("kubric_1024_withmask", "car", "a.gin"),
             ("kubric_1024_withmask", "chair", "b.gin"),
             ("unknown_exp", "car", "c.yml"),
             ("no_such_config", "car", None)]
    for experiment, scene, want in cases:
        got = twin._guess_config(experiment, scene, config_map)
        assert got == jax_tool._guess_config(experiment, scene, config_map)
        assert got == want


@pytest.fixture(scope="module")
def jax_drop(tmp_path_factory):
    """The drop of tests/test_released_assets_dryrun.py, made by JAX: the
    tiny gin's initial weights as a flax msgpack checkpoint at step 5 (its
    max_steps), their renders of the test split and the LPIPS fixture."""
    import flax.serialization

    from nerf_hugs_tpu.configs import gin_parser
    from nerf_hugs_tpu.data import load_dataset
    from nerf_hugs_tpu.parallel import mesh as mesh_lib
    from nerf_hugs_tpu.train import step as train_step_lib
    from nerf_hugs_tpu.train.render_image import render_image
    from nerf_hugs_tpu.utils import io as nh_io

    root = tmp_path_factory.mktemp("released")
    assets = root / "drop"
    gin_path = root / "tiny_assets.gin"
    gin_path.write_text(TINY_GIN)
    config = gin_parser.parse_gin_configs([str(gin_path)], [])
    mesh = mesh_lib.make_mesh()
    _, state, render_fn, _, _ = train_step_lib.setup_model(
        config, jax.random.PRNGKey(0), mesh)
    # The released format: a msgpack TrainState file (flax's save_checkpoint
    # now writes orbax directories, which the released drop does not hold).
    touch(assets / "checkpoints" / "exp_tiny" / "scene0" / "checkpoint_5",
          flax.serialization.msgpack_serialize(
              {"params": jax.device_get(state.params), "step": 5,
               "opt_state": {}}))
    params = mesh_lib.replicate(state.params, mesh)
    test_ds = load_dataset("test", "", config, is_training=False)
    rel_dir = assets / "rendering_results" / "exp_tiny" / "scene0" / \
        "test_preds"
    os.makedirs(rel_dir)
    for idx in range(test_ds.size):
        batch = test_ds.generate_ray_batch(idx)
        rendering = render_image(render_fn, batch.rays, 1.0, params,
                                 config, mesh)
        rgb = np.clip(np.nan_to_num(rendering["rgb"]), 0, 1)
        nh_io.save_img_u8(rgb, str(rel_dir / f"{idx:03d}_color.png"))
        nh_io.save_img_u8(np.asarray(batch.rgb),
                          str(rel_dir / f"{idx:03d}_gt.png"))
    _make_lpips_fixture(str(assets / "lpips_alex_fixture.pth"))
    config_map = root / "config_map.json"
    config_map.write_text(json.dumps({"exp_tiny": str(gin_path)}))
    return root, assets, config_map


def assert_scores_agree(got: dict, want: dict) -> None:
    """The metrics' parity tolerances. The dry-run's 16x20 images are
    below AlexNet's windows, where both packages' LPIPS is NaN."""
    assert sorted(got) == sorted(want)
    for key, tol in (("psnr", PSNR_TOL), ("ssim", SSIM_TOL),
                     ("lpips", LPIPS_TOL)):
        if key in want and np.isnan(want[key]):
            assert np.isnan(got[key]), key
        elif key in want:
            assert abs(got[key] - want[key]) <= tol, (key, got, want)


@pytest.mark.parametrize("image_type", ["whole", "half_right", "half_left"])
def test_score_renders_matches_jax(tmp_path, image_type):
    """The released renders' scores of both tools, LPIPS included, on
    64x80 pairs (AlexNet's windows fit) for each image type."""
    from nerf_hugs_torch.utils import io as nh_io
    rs = np.random.RandomState(3)
    preds = tmp_path / "exp" / "scene0" / "test_preds"
    preds.mkdir(parents=True)
    for i in range(2):
        gt = rs.rand(64, 80, 3)
        nh_io.save_img_u8(gt, str(preds / f"{i:03d}_gt.png"))
        nh_io.save_img_u8(np.clip(gt + 0.1 * rs.randn(64, 80, 3), 0, 1),
                          str(preds / f"{i:03d}_color.png"))
    weights = str(tmp_path / "lpips_alex_fixture.pth")
    _make_lpips_fixture(weights)
    exp = str(tmp_path / "exp")
    want = jax_tool.score_renders(exp, "scene0", image_type, weights)
    got = twin.score_renders(exp, "scene0", image_type, weights, "cpu")
    assert not np.isnan(want["lpips"])
    assert_scores_agree(got, want)


def test_full_chain_agrees_with_jax_tool(jax_drop):
    """(iii) Both tools on the dry-run drop: the released scores agree, ours
    reproduce the released renders above 45 dB, the reports have the same
    rows and keys."""
    root, assets, config_map = jax_drop
    args = ["--assets_dir", str(assets), "--config_map", str(config_map)]
    jax_rows, jax_extras = jax_tool.main(args + ["--work_dir",
                                                 str(root / "work_jax")])
    rows, extras = twin.main(args + ["--work_dir", str(root / "work_port"),
                                     "--device", "cpu"])
    assert extras["lpips"]["ok"] and sorted(extras) == sorted(jax_extras)
    assert sorted(extras["lpips"]) == sorted(jax_extras["lpips"])
    assert extras["lpips"]["converted_params"] == \
        jax_extras["lpips"]["converted_params"]
    for key in ("d(img,img)", "d(black,white)"):
        assert abs(extras["lpips"][key] - jax_extras["lpips"][key]) \
            <= LPIPS_TOL
    assert len(rows) == len(jax_rows) == 1
    row, jax_row = rows[0], jax_rows[0]
    assert "error" not in row, row.get("error")
    assert sorted(row) == sorted(jax_row)
    assert (row["experiment"], row["scene"], row["config"]) == (
        jax_row["experiment"], jax_row["scene"], jax_row["config"])
    released, jax_released = row["released_scores"], jax_row["released_scores"]
    assert sorted(released) == sorted(jax_released) == ["lpips", "psnr",
                                                        "ssim"]
    assert_scores_agree(released, jax_released)
    ours, jax_ours = row["our_scores"], jax_row["our_scores"]
    assert sorted(ours) == sorted(jax_ours)
    assert np.isfinite(ours["psnr"]) and np.isfinite(ours["ssim"])
    assert np.isnan(ours["lpips"]) == np.isnan(jax_ours["lpips"])
    assert row["ours_vs_released_psnr"] > 45, row
    assert jax_row["ours_vs_released_psnr"] > 45, jax_row
    reports = {tag: json.loads((root / f"work_{tag}" /
                                "PAPER_COMPARISON.json").read_text())
               for tag in ("jax", "port")}
    assert sorted(reports["port"]) == sorted(reports["jax"])
    assert [sorted(r) for r in reports["port"]["rows"]] == \
        [sorted(r) for r in reports["jax"]["rows"]]
    md = {tag: (root / f"work_{tag}" / "PAPER_COMPARISON.md").read_text()
          .splitlines() for tag in ("jax", "port")}
    # The same lines but the numbers, which agree within the tolerances.
    assert len(md["port"]) == len(md["jax"])
    assert md["port"][-3:-1] == md["jax"][-3:-1]
    assert "exp_tiny" in md["port"][-1] and "scene0" in md["port"][-1]


def tiny_nerfacto_drop(root: pathlib.Path, corrupt: bool = False):
    """A drop holding a released-layout torch snapshot of the tiny nerfacto
    model (`exp_tiny/scene0`) and, with `corrupt`, a .pth of other bytes
    (`exp_corrupt/scene0`); returns (drop, config map)."""
    cfg = tu.write_tiny_yaml(str(root), base={"synthetic_num_images": 2,
                                              "num_steps": 4})
    config = driver.load_config(cfg, "data", "ckpt")
    model = NerfactoModel(config, "cpu", torch.Generator().manual_seed(0))
    assets = root / "drop"
    ckpt = assets / "checkpoints" / "exp_tiny" / "scene0" / "ckpt_4.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save(released_snapshots.nerfacto_snapshot(model, config, 3, 4),
               ckpt)
    (assets / "data" / "scene0").mkdir(parents=True)
    maps = {"exp_tiny": cfg}
    if corrupt:
        touch(assets / "checkpoints" / "exp_corrupt" / "scene0" /
              "ckpt_4.pth", b"not a checkpoint")
        maps["exp_corrupt"] = cfg
    config_map = root / "config_map.json"
    config_map.write_text(json.dumps(maps))
    return assets, config_map


def test_torch_snapshot_takes_the_emitted_config(tmp_path):
    """(iv) A tiny nerfacto torch snapshot is converted, evaluated with the
    config.yml the converter emits (legacy_cumulative_deltas) and scored
    to finite numbers."""
    assets, config_map = tiny_nerfacto_drop(tmp_path)
    rows, extras = twin.main(["--assets_dir", str(assets), "--work_dir",
                              str(tmp_path / "work"), "--config_map",
                              str(config_map), "--device", "cpu"])
    assert extras == {} and len(rows) == 1
    row = rows[0]
    assert "error" not in row, row.get("error")
    assert sorted(row["our_scores"]) == ["psnr", "ssim"]
    assert all(np.isfinite(v) for v in row["our_scores"].values())
    out = tmp_path / "work" / "exp_tiny" / "scene0"
    emitted = yaml.safe_load((out / "config.yml").read_text())
    assert emitted["model"]["legacy_cumulative_deltas"] is True
    assert (out / "checkpoint_4.pt").exists()
    assert sorted(p.name for p in (out / "test_preds").glob("*_color.png"))


def test_corrupt_checkpoint_is_an_error_row_and_exit_1(tmp_path):
    """(v) `python -m` on a drop with a corrupt checkpoint: that pair's row
    holds the error, the other pair's row is complete, the report is
    written, and the exit code is 1."""
    assets, config_map = tiny_nerfacto_drop(tmp_path, corrupt=True)
    work = tmp_path / "work"
    proc = subprocess.run(
        [sys.executable, "-m",
         "nerf_hugs_torch.tools.validate_released_assets",
         "--assets_dir", str(assets), "--work_dir", str(work),
         "--config_map", str(config_map), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f"report: {work / 'PAPER_COMPARISON.md'}" in proc.stdout
    rows = {r["experiment"]: r for r in json.loads(
        (work / "PAPER_COMPARISON.json").read_text())["rows"]}
    assert sorted(rows) == ["exp_corrupt", "exp_tiny"]
    assert "error" in rows["exp_corrupt"]
    assert "our_scores" not in rows["exp_corrupt"]
    assert "error" not in rows["exp_tiny"]
    assert all(np.isfinite(v) for v in rows["exp_tiny"]["our_scores"].values())
    md = (work / "PAPER_COMPARISON.md").read_text()
    assert "| exp_corrupt | scene0 | — | — | — |" in md


def msgpack_trees():
    """Trees of what flax checkpoints hold: a TrainState of Dense layers and
    an embedding, and every scalar kind and length class msgpack encodes."""
    rng = np.random.RandomState(0)
    dense = lambda i, o: {"kernel": rng.randn(i, o).astype(np.float32),
                          "bias": rng.randn(o).astype(np.float32)}
    train_state = {"params": {"params": {
        "NerfMLP_0": {f"Dense_{k}": dense(8, 8) for k in range(12)},
        "PropMLP_0": {"Dense_0": dense(3, 16)},
        "GloEmbed_0": {"embedding": rng.randn(40, 4).astype(np.float32)}}},
        "step": 8, "opt_state": {}}
    scalars = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
        "floats": [0.0, -1.5, 1e300], "flags": [True, False, None],
        "strings": ["", "s" * 31, "t" * 32, "u" * 300, "ü" * 40000],
        "bytes": [b"", b"x" * 300, b"y" * 70000],
        "numpy": [np.float32(1.5), np.int32(-3), np.float64(2.0),
                  np.bool_(True), np.uint8(7)],
        "arrays": {"bf16": rng.randn(3, 4).astype(ml_dtypes.bfloat16),
                   "f16": rng.randn(5).astype(np.float16),
                   "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
                   "empty": np.zeros((0, 3), np.float32),
                   "zero_d": np.array(2.5, np.float32),
                   "big": rng.randn(200, 100).astype(np.float32)},
        "long": list(range(20)), "wide": {f"k{i}": i for i in range(20)}}
    return {"train_state": train_state, "scalars": scalars}


def assert_bit_equal(want, got):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_bit_equal(want[k], got[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(want, got):
            assert_bit_equal(a, b)
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(
            want)
        assert got.tobytes() == np.asarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", ["train_state", "scalars"])
def test_msgpack_serialize_matches_flax(tmp_path, name):
    """(vi) msgpack_serialize writes flax's bytes; flax's msgpack_restore
    reads the tree back bit for bit, and so does the port's reader (which
    widens bfloat16 to float32 exactly)."""
    import flax.serialization
    from flax.training import checkpoints as flax_checkpoints

    tree = msgpack_trees()[name]
    data = flax_msgpack.msgpack_serialize(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    assert_bit_equal(tree, flax.serialization.msgpack_restore(data))
    ours = flax_msgpack.msgpack_restore(data)
    if name == "scalars":
        bf16 = ours["arrays"].pop("bf16")
        want = tree["arrays"].pop("bf16")
        assert bf16.dtype == np.float32
        assert np.array_equal(bf16, want.astype(np.float32))
    assert_bit_equal(tree, ours)
    if name == "train_state":
        path = tmp_path / "checkpoint_8"
        path.write_bytes(data)
        restored = flax_checkpoints.restore_checkpoint(str(tmp_path), None)
        assert_bit_equal(tree, restored)
        params, step = flax_msgpack.extract_reference_params(str(tmp_path))
        assert step == 8
        assert_bit_equal(tree["params"], params)


def test_msgpack_serialize_refuses_what_flax_cannot_read():
    with pytest.raises(TypeError):
        flax_msgpack.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(TypeError):
        flax_msgpack.msgpack_serialize({"c": 1j})


def test_check_sam_counts_jax_parameters(tmp_path):
    """(vii) check_sam on the official vit_b schema (zeros) loads strictly
    and counts the parameters of JAX's conversion of the same state
    dict."""
    from nerf_hugs_tpu.hugs.sam import modeling as jmodeling
    from nerf_hugs_tpu.hugs.sam import weights as jweights
    from sam_official_schema import make_official_sam_state_dict

    config = jmodeling.make_sam_config("vit_b")
    sd = make_official_sam_state_dict(config, fill="zeros")
    path = tmp_path / "sam_vit_b.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    want = sum(x.size for x in jax.tree_util.tree_leaves(
        jweights.convert_state_dict(sd, config)))
    del sd
    got = twin.check_sam(str(path), "cpu")
    assert got == {"path": str(path), "converted_param_count": want,
                   "ok": True}
    assert twin.sam_model_type(torch.load(path, weights_only=True)) == "vit_b"


def test_work_dir_defaults_under_the_temporary_directory(tmp_path,
                                                         monkeypatch):
    """Without --work_dir the report lands in asset_validation under the
    temporary directory that TMPDIR names, not in a fixed /tmp path."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    (tmp_path / "drop").mkdir()
    rows, extras = twin.main(["--assets_dir", str(tmp_path / "drop"),
                              "--device", "cpu"])
    assert rows == [] and extras == {}
    work = tmp_path / "tmp" / "asset_validation"
    assert sorted(p.name for p in work.iterdir()) == [
        "PAPER_COMPARISON.json", "PAPER_COMPARISON.md"]
