"""The port's quality tool, nerf_hugs_torch/tools/validate_quality.py,
against the JAX tool, tools/validate_quality.py (imported as it is): the
patched yaml of every shipped nerfacto config, the gin argv of every shipped
Mip-NeRF 360 config, the three legacy configs, the scoring of the held-out
split and the LOCALIZATION ratios on the same weights, and both dialects
end to end on the CPU.

The scoring and end-to-end tests cut the tool's scene (SCENE_OVERRIDES:
32 images of 192x256) to 4 images of 48x64 on both sides alike, by
patching the module dict: the CPU renders a full scene's 1.5M test rays
in minutes."""

import argparse
import dataclasses
import os
import pathlib
import re

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_port_util as tu
from test_torch_port_hanerf import HANERF_BASE, HANERF_MODEL
from test_torch_port_mipnerf360_driver import TINY as GIN_TINY
from test_torch_port_transient import NERFW_MODEL
from nerf_hugs_tpu.configs import yaml_loader as jyaml
from nerf_hugs_tpu.metrics import image as jimage
from nerf_hugs_tpu.parallel import mesh as jmesh
from nerf_hugs_tpu.train import checkpoints as jckpt
from nerf_hugs_tpu.train import render_image as jrender
from nerf_hugs_tpu.train import step as jstep
from nerf_hugs_torch.configs import yaml_loader as tyaml
from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.tools import validate_quality as tvq
from nerf_hugs_torch.train import checkpoints as tckpt
from nerf_hugs_torch.train import step as tstep
from tools import validate_quality as jvq

REPO = pathlib.Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / "configs" / "nerfacto").glob("*.yml"))
GINS = sorted((REPO / "configs" / "mipnerf360").glob("*.gin"))
# --steps, --eval-every, --distractor.
VARIANTS = {"defaults": (0, 0, False), "steps": (1000, 0, False),
            "eval_every": (3000, 250, False), "distractor": (0, 0, True)}
# The cut scene of the scoring and end-to-end tests (both tools alike).
SMALL_SCENE = {"num_images": 4, "height": 48, "width": 64,
               "world_scale": 0.35}
# Per-image PSNR (dB), SSIM and the localization ratios (relative).
PSNR_TOL, SSIM_TOL, RATIO_RTOL = 1e-4, 1e-5, 1e-4
STEP = 4
RESULT_RE = re.compile(
    r"^RESULT config=(\S+) steps=(\d+) test_psnr=(-?\d+\.\d\d) "
    r"test_ssim=(-?\d\.\d{4}) per_image_psnr=\[(.*)\]$", re.M)


def tool_args(*argv) -> argparse.Namespace:
    """The port's parsed flags; the JAX tool reads the same attributes."""
    return tvq.parse_args(list(argv))


def variant_argv(variant: str) -> list:
    steps, eval_every, distractor = VARIANTS[variant]
    argv = ["--config", "x.yml"]
    if steps:
        argv += ["--steps", str(steps)]
    if eval_every:
        argv += ["--eval-every", str(eval_every)]
    return argv + (["--distractor"] if distractor else [])


def test_every_jax_flag_is_a_port_flag():
    source = (REPO / "tools" / "validate_quality.py").read_text()
    jax_flags = set(re.findall(r'add_argument\("(--[\w-]+)"', source))
    assert {"--config", "--steps", "--eval-every", "--save-dir",
            "--distractor", "--amp", "--score-only",
            "--binding"} == jax_flags
    parser_flags = set(re.findall(
        r'add_argument\("(--[\w-]+)"',
        (REPO / "nerf_hugs_torch" / "tools" /
         "validate_quality.py").read_text()))
    assert parser_flags == jax_flags | {"--device"}
    args = tool_args("nerfacto", "300", "--amp")
    assert (args.model_type, args.steps_pos, args.amp, args.device) == (
        "nerfacto", 300, True, "cuda")
    with pytest.raises(SystemExit):
        tool_args()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.stem)
def test_yaml_patch_matches_jax(path, variant, tmp_path):
    args = tool_args(*variant_argv(variant))
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j_out, j_argv, j_steps = jvq._yaml_override_file(str(path),
                                                     str(tmp_path / "j"), args)
    t_argv, t_steps = tvq.yaml_override_file(str(path), str(tmp_path / "t"),
                                             args)
    t_out = str(tmp_path / "t" / "validate_config.yml")
    with open(j_out) as f, open(t_out) as g:
        patched = yaml.safe_load(g)
        assert patched == yaml.safe_load(f)
    assert (t_argv, t_steps) == (["--config", t_out], j_steps)
    assert j_argv == ["--config", j_out]
    assert patched["base"]["dataset_type"].startswith("synthetic")
    # The port's loader reads what it patched, as JAX's reads its own.
    assert (tyaml.load_yaml_config(t_out).dataset_loader
            == jyaml.load_yaml_config(j_out).dataset_loader)


@pytest.mark.parametrize("extra", [(), ("--steps", "700", "--distractor",
                                        "--binding", "Model.remat_mlp = True",
                                        "--binding", "Config.seed = 3")],
                         ids=["defaults", "bindings"])
@pytest.mark.parametrize("path", GINS, ids=lambda p: p.stem)
def test_gin_argv_matches_jax(path, extra, tmp_path):
    args = tool_args("--config", str(path), *extra)
    try:
        want = jvq._gin_override_args(str(path), str(tmp_path), args)
    except Exception as e:  # a gin JAX cannot parse alone
        with pytest.raises(type(e)):
            tvq.gin_override_args(str(path), args)
        return
    assert want[0] is None
    assert tvq.gin_override_args(str(path), args) == want[1:]
    if extra:
        assert want[1][-4:] == ["--gin_bindings", "Model.remat_mlp = True",
                                "--gin_bindings", "Config.seed = 3"]


def config_fields(config) -> dict:
    """A Config's fields, nested dataclasses and tuples made plain."""
    def plain(v):
        if dataclasses.is_dataclass(v):
            return {f.name: plain(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v.name if hasattr(v, "name") and not isinstance(v, str) else v
    return plain(config)


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("model_type", ["nerfacto", "nerf", "mipnerf360"])
def test_legacy_configs_match_jax(model_type, amp):
    want = getattr(jvq, f"{model_type}_config")(amp)
    got = tvq.LEGACY_CONFIGS[model_type](amp)
    assert config_fields(got) == config_fields(want)


# ---------------------------------------------------------------------------
# Scoring and localization on the same weights.

class RecordingHarness(jimage.MetricHarness):
    """JAX's harness, keeping every image's metrics at full precision."""
    records = []

    def __call__(self, *args, **kwargs):
        out = super().__call__(*args, **kwargs)
        RecordingHarness.records.append({k: float(v) for k, v in out.items()})
        return out


def seeded_params(params: dict, seed: int) -> dict:
    """The flax params with every leaf drawn from a numpy seed: hash tables
    in [-1, 1] (so the scene is no empty box), the rest at 0.3 / sqrt of
    the fan-in."""
    rs = np.random.RandomState(seed)
    flat = tu.flat_params(params)
    out = {}
    for k, v in sorted(flat.items()):
        scale = 1.0 if "table" in k else 0.3 / np.sqrt(max(v.shape[0], 1))
        out[k] = (scale * rs.uniform(-1, 1, v.shape)).astype(v.dtype)
    return tu.unflatten(out)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """For each tiny config (base, HA-NeRF, NeRF-W): one checkpoint of the
    same seeded weights per package, scored by each tool with
    --score-only; returns {name: (JAX's records, JAX's output, the port's
    config, model and output)}."""
    mp = pytest.MonkeyPatch()
    for k, v in SMALL_SCENE.items():
        mp.setitem(jvq.SCENE_OVERRIDES, k, v)
        mp.setitem(tvq.SCENE_OVERRIDES, k, v)
    mp.setattr(jimage, "MetricHarness", RecordingHarness)
    rendered = []
    jax_render = jrender.render_image

    def recording_render(render_fn, rays, *args, **kwargs):
        out = jax_render(render_fn, rays, *args, **kwargs)
        rendered.append((np.asarray(rays.static_mask), out))
        return out

    mp.setattr(jrender, "render_image", recording_render)
    variants = {"base": ({}, {}),
                "hanerf": (HANERF_BASE, HANERF_MODEL),
                "nerfw": (HANERF_BASE, NERFW_MODEL)}
    results = {}
    import contextlib
    import io
    try:
        for seed, (name, (base, model)) in enumerate(variants.items()):
            root = tmp_path_factory.mktemp(f"score_{name}")
            cfg = tu.write_tiny_yaml(str(root), base, model)
            args = tool_args("--config", cfg, "--steps", str(STEP),
                             "--save-dir", str(root / "jax"), "--score-only",
                             "--device", "cpu")
            os.makedirs(args.save_dir)
            patched, _, _ = jvq._yaml_override_file(cfg, args.save_dir, args)
            jconfig = jyaml.load_yaml_config(patched)
            mesh = jmesh.make_mesh()
            _, state, _, _, _ = jstep.setup_model(
                jconfig, jax.random.PRNGKey(0), mesh)
            params = seeded_params(jax.device_get(state.params), seed)
            jckpt.save_checkpoint(args.save_dir,
                                  state.replace(params=params), STEP)

            t_dir = str(root / "torch")
            os.makedirs(t_dir)
            (_, tpatched), _ = tvq.yaml_override_file(cfg, t_dir, args)
            tconfig = tyaml.load_yaml_config(tpatched)
            tmodel = NerfactoModel(tconfig, "cpu",
                                   torch.Generator().manual_seed(0))
            tmodel.load_state_dict(convert_nerfacto_params(params))
            opt, sched = tstep.create_optimizer(tconfig, tmodel)
            tckpt.save_checkpoint(t_dir, tmodel, opt, sched, STEP)

            RecordingHarness.records = []
            rendered.clear()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                jvq.run_exact_config(args)
            j_records, j_renders = list(RecordingHarness.records), \
                list(rendered)
            tout = io.StringIO()
            with contextlib.redirect_stdout(tout):
                tvq.main(["--config", cfg, "--steps", str(STEP),
                          "--save-dir", t_dir, "--score-only",
                          "--device", "cpu"])
            results[name] = (j_records, j_renders, out.getvalue(), tconfig,
                             tmodel, tout.getvalue())
    finally:
        mp.undo()
    return results


@pytest.mark.parametrize("name", ["base", "hanerf", "nerfw"])
def test_scoring_matches_jax(scored, name):
    j_records, _, j_out, tconfig, tmodel, t_out = scored[name]
    psnrs, ssims = tvq.score(tmodel, tconfig, "cpu")
    assert len(psnrs) == len(j_records) == SMALL_SCENE["num_images"]
    np.testing.assert_allclose(psnrs, [r["psnr"] for r in j_records],
                               rtol=0, atol=PSNR_TOL)
    np.testing.assert_allclose(ssims, [r["ssim"] for r in j_records],
                               rtol=0, atol=SSIM_TOL)
    # Seeded weights render a scene: not the flat background.
    assert np.ptp(psnrs) > 0.01
    (j_line,), (t_line,) = (RESULT_RE.findall(j_out),
                            RESULT_RE.findall(t_out))
    assert t_line[:2] == j_line[:2] == ("tiny_nerfacto", str(STEP))
    got = [float(t_line[2]), float(t_line[3])] + [
        float(x) for x in t_line[4].split(",")]
    want = [float(j_line[2]), float(j_line[3])] + [
        float(x) for x in j_line[4].split(",")]
    # Printed to 2 (PSNR) and 4 (SSIM) decimals: one unit of the last.
    np.testing.assert_allclose(got, want, rtol=0, atol=0.0100001)
    assert tvq.result_line("tiny_nerfacto", STEP, psnrs, ssims) in t_out


@pytest.mark.parametrize("name,key", [("hanerf", "implicit_mask"),
                                      ("nerfw", "uncertainty")])
def test_localization_matches_jax(scored, name, key):
    _, j_renders, j_out, tconfig, tmodel, t_out = scored[name]
    # JAX's ratio (tools/validate_quality.py:182-185) over its last
    # renders, those of the first 4 train views.
    ratios = []
    for mask, rendering in j_renders[SMALL_SCENE["num_images"]:]:
        signal = np.asarray(rendering[key])[..., 0]
        inside = mask[..., 0] < 0.5
        if inside.any() and (~inside).any():
            ratios.append(float(signal[inside].mean()
                                / max(signal[~inside].mean(), 1e-6)))
    assert len(ratios) == tvq.LOCALIZATION_VIEWS
    assert tvq.localization_line("tiny_nerfacto", key, ratios) in j_out
    got = tvq.localization(tmodel, tconfig, "cpu", key)
    np.testing.assert_allclose(got, ratios, rtol=RATIO_RTOL)
    assert tvq.localization_line("tiny_nerfacto", key, got) in t_out
    assert t_out.index("RESULT") < t_out.index("LOCALIZATION")


def test_score_only_without_a_checkpoint_raises(tmp_path):
    cfg = tu.write_tiny_yaml(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tvq.main(["--config", cfg, "--score-only", "--save-dir",
                  str(tmp_path / "empty"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# Both dialects end to end on the CPU.

# The tiny gin bindings without the cadence the tool sets itself.
GIN_BINDINGS = [b for b in GIN_TINY if not b.startswith(
    ("Config.max_steps", "Config.train_render_every",
     "Config.checkpoint_every"))]


def run_tool(monkeypatch, capsys, argv) -> str:
    for k, v in SMALL_SCENE.items():
        monkeypatch.setitem(tvq.SCENE_OVERRIDES, k, v)
    tvq.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("dialect", ["yaml", "gin"])
def test_end_to_end_and_score_only(dialect, tmp_path, monkeypatch, capsys):
    if dialect == "yaml":
        config, tag = tu.write_tiny_yaml(str(tmp_path)), "tiny_nerfacto"
        extra = []
    else:
        config = str(REPO / "configs" / "mipnerf360" / "kubric_1024_base.gin")
        tag = "kubric_1024_base"
        extra = [a for b in GIN_BINDINGS for a in ("--binding", b)]
    argv = ["--config", config, "--steps", "4", "--eval-every", "2",
            "--save-dir", str(tmp_path / "run"), "--device", "cpu"] + extra
    out = run_tool(monkeypatch, capsys, argv)
    evals = re.findall(r"\[train\] (\d+): eval psnr=(\S+)", out)
    assert [e[0] for e in evals] == ["2", "4"], out
    (line,) = RESULT_RE.findall(out)
    assert line[:2] == (tag, "4")
    per_image = [float(x) for x in line[4].split(",")]
    assert len(per_image) == SMALL_SCENE["num_images"]
    assert all(np.isfinite(per_image)) and np.isfinite(float(line[2]))
    assert "TIMING" not in out  # the card's line only
    assert sorted(os.listdir(tmp_path / "run")).count("checkpoint_4.pt") == 1
    again = run_tool(monkeypatch, capsys, argv + ["--score-only"])
    assert "[train]" not in again
    assert RESULT_RE.search(again).group(0) == RESULT_RE.search(out).group(0)


def test_train_rate_reads_the_driver_lines():
    log = ("[train] 1/300: loss=1 psnr=1 lr=1 0.50 steps/s 8192 rays/s\n"
           "[train] 100: eval psnr=1\n"
           "[train] 100/300: loss=1 psnr=1 lr=1 20.00 steps/s 1 rays/s x=1\n"
           "[train] 300/300: loss=1 psnr=1 lr=1 40.00 steps/s 1 rays/s x=1\n")
    # 99 steps at 20/s and 200 at 40/s: 299 steps in 9.95 s.
    assert tvq.train_rate(log) == pytest.approx(299 / 9.95)


def test_device_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tu.write_tiny_yaml(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvq.main(["--config", cfg, "--steps", "1", "--save-dir",
                  str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvq.main(["nerfacto", "1"])


# ---------------------------------------------------------------------------
# The A/B tool's variants.

def test_quality_ab_edits_only_the_given_base_keys(tmp_path):
    from nerf_hugs_torch.tools import quality_ab
    path = REPO / "configs" / "nerfacto" / "kubric_nerfacto_base.yml"
    out = quality_ab.edited_config(str(path), str(tmp_path), "seed_3",
                                   seed=3, enable_amp=False)
    assert out == str(tmp_path / "seed_3" / "kubric_nerfacto_base.yml")
    with open(path) as f, open(out) as g:
        want, got = yaml.safe_load(f), yaml.safe_load(g)
    want["base"].update(seed=3, enable_amp=False)
    assert got == want


def test_quality_ab_routes_the_table_gradient_to_bf16_payloads(monkeypatch):
    """--plain-bf16: each payload w * g rounded to bf16 before the sum, as
    JAX's block_segment_sum casts its values (bwd_dtype='bfloat16')."""
    from nerf_hugs_torch.ops import hashgrid, hashgrid_bwd
    from nerf_hugs_torch.tools import quality_ab
    monkeypatch.setattr(hashgrid, "hashgrid_fwd", hashgrid.hashgrid_fwd)
    monkeypatch.setattr(hashgrid_bwd, "hashgrid_table_grad",
                        hashgrid_bwd.hashgrid_table_grad)
    spec = hashgrid.HashGridSpec(num_levels=4, log2_hashmap_size=10,
                                 base_res=4, max_res=32)
    rs = np.random.RandomState(0)
    pos = torch.from_numpy(rs.rand(300, 3).astype(np.float32))
    g = torch.from_numpy(rs.randn(300, spec.output_dim).astype(np.float32))
    want = hashgrid_bwd.hashgrid_table_grad_plain(pos, g, spec)
    quality_ab.route_to_plain(bf16_payload=True)
    got = hashgrid_bwd.hashgrid_table_grad(pos, g, spec)
    assert got.shape == want.shape and not torch.equal(got, want)
    # Rounding to bf16 (7 stored mantissa bits) moves a payload by at most
    # 2^-8 of itself, and the trilinear weights are >= 0, so a row moves by
    # at most 2^-8 of the sum of its payloads' magnitudes.
    bound = 2.0 ** -8 * hashgrid_bwd.hashgrid_table_grad_plain(
        pos, g.abs(), spec) + 1e-6
    assert bool(((got - want).abs() <= bound).all())
    quality_ab.route_to_plain()
    assert hashgrid_bwd.hashgrid_table_grad is \
        hashgrid_bwd.hashgrid_table_grad_plain
    table = torch.from_numpy(rs.rand(spec.num_rows * 2).astype(np.float32))
    np.testing.assert_array_equal(
        hashgrid.hashgrid_fwd(table, pos, spec).numpy(),
        hashgrid.hashgrid_encode_plain(table, pos, spec).numpy())


def test_quality_ab_starts_from_other_initial_weights(tmp_path,
                                                      monkeypatch):
    """--init: the train driver's nerfacto model starts from a saved
    state_dict (tests/jax_initial_weights.py writes JAX's draws under
    another key); --init-seeds: from torch's draws at another seed."""
    import jax_initial_weights
    from nerf_hugs_torch.models import construct_model, jax_init
    from nerf_hugs_torch.tools import quality_ab
    # start_from replaces every backbone's init: restore them all after.
    for name in jax_init.INITS.values():
        monkeypatch.setattr(jax_init, name, getattr(jax_init, name))
    cfg = tu.write_tiny_yaml(str(tmp_path))
    config = tyaml.load_yaml_config(cfg)
    state = jax_initial_weights.initial_state_dict(cfg, key=1)
    torch.save(state, tmp_path / "init.pt")
    quality_ab.start_from(str(tmp_path / "init.pt"))
    model = construct_model(config, "cpu", torch.Generator().manual_seed(5))
    jax_init.init_nerfacto_(model)
    got = model.state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    quality_ab.start_from("5")
    jax_init.init_nerfacto_(model)
    want = construct_model(config, "cpu", torch.Generator().manual_seed(5))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


# distractor_nerfacto_*.yml's and the fused MLP's model sections at toy
# widths: the proposal nets, embeddings, transient heads, HA-NeRF's mask.
INIT_VARIANTS = {"base": ({}, {}), "fused": ({}, {"enable_tcnn_mlp": True}),
                 "hanerf": (HANERF_BASE, HANERF_MODEL),
                 "nerfw": (HANERF_BASE, NERFW_MODEL)}


@pytest.mark.parametrize("name", sorted(INIT_VARIANTS))
def test_nerfacto_starts_from_jax_initial_weights(name, tmp_path):
    """models/jax_init.py draws train.py's initial weights without JAX: the
    tables, Dense kernels and fused weights bit for bit, the embeddings
    (erfinv) within 1e-5 of JAX's."""
    import jax_initial_weights
    from nerf_hugs_torch.models import jax_init
    cfg = tu.write_tiny_yaml(str(tmp_path), *INIT_VARIANTS[name])
    want = jax_initial_weights.initial_state_dict(cfg)
    model = NerfactoModel(tyaml.load_yaml_config(cfg), "cpu",
                          torch.Generator().manual_seed(0))
    jax_init.init_nerfacto_(model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("_embedding.weight"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], v), k


def test_jax_prng_pieces_match_jax():
    from nerf_hugs_torch.models import jax_init
    key = jax.random.fold_in(jax.random.PRNGKey(20200823), 0)
    assert jax_init.fold_in((0, 20200823), 0) == tuple(
        int(v) for v in np.asarray(key))
    assert jax_init.split((0, 20200823)) == [
        tuple(int(v) for v in k)
        for k in np.asarray(jax.random.split(jax.random.PRNGKey(20200823)))]
    k = (123456789, 987654321)
    for lo, hi in ((-1e-4, 1e-4), (-1.0, 1.0)):
        want = np.asarray(jax.random.uniform(
            jax.numpy.asarray(np.array(k, np.uint32)), (4097,),
            jax.numpy.float32, lo, hi))
        np.testing.assert_array_equal(
            jax_init.uniform(k, (4097,), lo, hi).numpy(), want)


def test_the_train_driver_starts_nerfacto_from_jax_initial_weights(
        tmp_path, monkeypatch):
    from nerf_hugs_torch.models import jax_init
    from nerf_hugs_torch.train import driver
    seen = []
    monkeypatch.setattr(jax_init, "init_nerfacto_",
                        lambda model: seen.append(type(model).__name__))
    monkeypatch.setattr(driver, "run_stage", lambda *args: None)
    cfg = tu.write_tiny_yaml(str(tmp_path))
    driver.main(["--config", cfg, "--data_dir", str(tmp_path), "--save_dir",
                 str(tmp_path / "ck"), "--device", "cpu"])
    assert seen == ["NerfactoModel"]
