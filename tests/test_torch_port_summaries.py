"""The port's tensorboard summaries against the JAX package's: the event
writer (nerf_hugs_torch/utils/summary.py) against flax's SummaryWriter,
the visualization suite (utils/vis.py) and stepfun.resample against
nerf_hugs_tpu's, and the train driver's tb_train files against those of
the repo's train.py on the same yaml and gin configs, on the CPU.

Tolerances: records, scalars, histograms and decoded PNG pixels bit-equal;
resample within 1e-6; every image of the suite within 1e-5, where a pixel
of a colormapped image may differ by one step of the table (at most 0.1%
of its pixels); learning rates equal to JAX's schedule within 2^-21
relative (four float32 steps: JAX evaluates its log-lerp in float32, the
port in float64).
"""

import ast
import io
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.core import stepfun
from nerf_hugs_torch.utils import summary, vis
from nerf_hugs_torch.utils.turbo import TURBO

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def _records(path) -> list:
    """The payloads of a TFRecord file, with both CRCs checked."""
    data, out, i = pathlib.Path(path).read_bytes(), [], 0
    while i < len(data):
        length = data[i:i + 8]
        (n,) = struct.unpack("<Q", length)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            summary.masked_crc32c(length)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            summary.masked_crc32c(payload)
        out.append(payload)
        i += 16 + n
    return out


def _accumulate(log_dir):
    from tensorboard.backend.event_processing.plugin_event_accumulator \
        import EventAccumulator
    acc = EventAccumulator(str(log_dir), size_guidance={"tensors": 0})
    acc.Reload()
    return acc


def _png(data: bytes) -> np.ndarray:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img)


def _write_all(writer, rs):
    """The same calls for either writer: scalars, histograms (spread, a
    constant array, one value, none) and images of every accepted shape,
    float (out of range and NaN included) and uint8."""
    writer.scalar("train_loss", 0.123456789, 1)
    writer.scalar("train_losses/data", np.float32(2.5), 0)
    writer.scalar("train_avg_psnr_timed", 31.0, 12)
    writer.histogram("train_loss_hist", rs.randn(17).astype(np.float32), 2)
    writer.histogram("constant", np.full(5, 3.0), 3)
    writer.histogram("one", [7.0], 4)
    writer.histogram("none", np.zeros(0), 4)
    float_image = rs.rand(6, 7, 3).astype(np.float32) * 1.2 - 0.1
    float_image[0, 0] = np.nan
    images = {"hw": rs.rand(6, 7).astype(np.float32),
              "hw1": rs.rand(6, 7, 1),
              "hw3": float_image,
              "khw3": rs.rand(4, 6, 7, 3).astype(np.float32),
              "khw": rs.rand(2, 6, 7).astype(np.float32),
              "uint8": rs.randint(0, 256, (6, 7, 3)).astype(np.uint8)}
    for name, image in images.items():
        writer.image(f"render_{name}", image, 5)
    writer.flush()
    writer.close()


def test_writer_matches_flax(tmp_path):
    from flax.metrics.tensorboard import SummaryWriter as FlaxWriter
    _write_all(FlaxWriter(str(tmp_path / "flax")), np.random.RandomState(0))
    ours = summary.SummaryWriter(str(tmp_path / "port"))
    _write_all(ours, np.random.RandomState(0))
    name = pathlib.Path(ours.path).name.split(".")
    assert name[:3] == ["events", "out", "tfevents"] and name[-1] == "v2"

    # Every record but the PNGs' bytes equal flax's, field for field
    # (the wall time, the first 9 bytes, aside).
    [want] = (tmp_path / "flax").iterdir()
    want, got = _records(want), _records(ours.path)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        if b"images" not in a:
            assert a[9:] == b[9:]

    flax_acc, port_acc = (_accumulate(tmp_path / d) for d in ("flax", "port"))
    tags = flax_acc.Tags()["tensors"]
    assert sorted(tags) == sorted(port_acc.Tags()["tensors"])
    assert flax_acc.PluginTagToContent("images").keys() == \
        port_acc.PluginTagToContent("images").keys()
    for plugin in ("scalars", "histograms", "images"):
        assert flax_acc.PluginTagToContent(plugin) == \
            port_acc.PluginTagToContent(plugin)
    from tensorboard.util import tensor_util
    for tag in tags:
        a, b = flax_acc.Tensors(tag), port_acc.Tensors(tag)
        assert [e.step for e in a] == [e.step for e in b]
        for ea, eb in zip(a, b):
            x, y = (tensor_util.make_ndarray(e.tensor_proto) for e in (ea, eb))
            assert x.dtype == y.dtype and x.shape == y.shape
            if x.dtype == object:
                assert list(x[:2]) == list(y[:2])
                for pa, pb in zip(x[2:], y[2:]):
                    np.testing.assert_array_equal(_png(pa), _png(pb))
            else:
                assert x.tobytes() == y.tobytes()


def test_crc32c_and_histogram_rules():
    from tensorboard.compat.tensorflow_stub import pywrap_tensorflow
    assert summary.crc32c(b"123456789") == 0xE3069283
    rs = np.random.RandomState(1)
    # Below and above the length where the lanes start.
    for n in (0, 1, 63, 4095, 4096, 70001):
        data = rs.randint(0, 256, n).astype(np.uint8).tobytes()
        assert summary.masked_crc32c(data) == \
            pywrap_tensorflow.masked_crc32c(data)
    buckets = summary.histogram_buckets([1.0, 2.0, 3.0, 10.0])
    assert buckets.shape == (30, 3) and buckets[:, 2].sum() == 4
    assert buckets[0, 0] == 1.0 and buckets[-1, 1] == 10.0
    assert buckets[-1, 2] == 1


def _rendering(rs, h, w, rays: bool, transient: bool) -> dict:
    acc = rs.rand(h, w).astype(np.float32)
    acc[:3] = 0
    mean = rs.uniform(0.5, 3.0, (h, w)).astype(np.float32)
    out = {"rgb": rs.rand(h, w, 3).astype(np.float32), "acc": acc,
           "distance_mean": mean, "distance_median": mean * 1.01,
           "distance_percentile_5": mean * 0.9,
           "distance_percentile_95": mean * 1.2}
    if transient:
        for key in ("rgb_cc", "rgb_combined", "rgb_static", "rgb_transient"):
            out[key] = rs.rand(h, w, 3).astype(np.float32)
        out["implicit_mask"] = rs.rand(h, w).astype(np.float32)
    if rays:
        ends = (65, 65, 33)    # Mip-NeRF 360's two proposal levels, NeRF
        out["ray_sdist"] = [np.sort(rs.rand(6, n), -1).astype(np.float32)
                            for n in ends]
        weights = [rs.rand(6, n - 1).astype(np.float32) for n in ends]
        out["ray_weights"] = [w / w.sum(-1, keepdims=True) for w in weights]
        out["ray_rgbs"] = [rs.rand(6, n - 1, 3).astype(np.float32) * 1.2
                           for n in ends]
    return out


class _Rays:
    def __init__(self, origins, directions):
        self.origins, self.directions = origins, directions


def _lut_step() -> float:
    """The largest change between neighbouring entries of either table."""
    gray_step = 1 / 255
    return max(float(np.abs(np.diff(TURBO, axis=0)).max()), gray_step)


@pytest.mark.parametrize("rays,transient", [(False, False), (False, True),
                                            (True, False)])
def test_visualize_suite_matches_jax(rays, transient):
    import jax.numpy as jnp
    from nerf_hugs_tpu.utils import vis as jax_vis

    rs = np.random.RandomState(3)
    h, w = 24, 20
    rendering = _rendering(rs, h, w, rays, transient)
    origins = rs.randn(h, w, 3).astype(np.float32)
    directions = rs.randn(h, w, 3).astype(np.float32)
    conv = lambda f: {k: ([f(x) for x in v] if k.startswith("ray_") else f(v))
                      for k, v in rendering.items()}
    want = jax_vis.visualize_suite(
        conv(jnp.asarray), _Rays(jnp.asarray(origins),
                                 jnp.asarray(directions)))
    got = vis.visualize_suite(conv(torch.from_numpy), _Rays(
        torch.from_numpy(origins), torch.from_numpy(directions)))
    assert list(want) == list(got)
    colormapped = ("depth_mean", "depth_median", "ray_weights")
    for key in want:
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.shape == b.shape, key
        err = np.abs(a - b).reshape(a.shape[0], a.shape[1], -1).max(-1)
        off = err > 1e-5
        if key in colormapped:
            assert off.sum() <= 1e-3 * off.size, (key, off.sum())
            assert err.max() <= _lut_step() + 1e-6, key
        else:
            assert not off.any(), (key, err.max())


@pytest.mark.parametrize("resolution", [2048, 64, 5])
def test_visualize_rays_tiling_matches_jax(resolution):
    """Strips repeated to fill `resolution` rows with a blank row between
    rays, and untiled when the rows exceed it."""
    import jax.numpy as jnp
    from nerf_hugs_tpu.utils import vis as jax_vis

    rs = np.random.RandomState(4)
    rendering = _rendering(rs, 2, 2, True, False)
    args = [rendering["ray_sdist"], rendering["ray_weights"],
            [np.clip(r, 0, 1) for r in rendering["ray_rgbs"]]]
    want = jax_vis.visualize_rays(args[0], (0, 1), *[
        [jnp.asarray(x) for x in a] for a in args[1:]],
        resolution=resolution)
    got = vis.visualize_rays([torch.from_numpy(x) for x in args[0]], (0, 1),
                             *[[torch.from_numpy(x) for x in a]
                               for a in args[1:]], resolution=resolution)
    for a, b in zip(want, got):
        assert np.asarray(a).shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_colormaps_match_matplotlib():
    """matplotlib's lookup for floats: floor(x * 256), 1 taking the last
    entry, below 0 the first, above 1 the last, NaN black."""
    import matplotlib
    rs = np.random.RandomState(5)
    x = np.concatenate([rs.rand(1000), np.arange(257) / 256,
                        [0.0, 1.0, -0.1, 1.1, np.nan, np.nextafter(1, 0)]])
    x = x.astype(np.float32)
    for name, fn in (("turbo", vis.turbo), ("gray", vis.gray)):
        want = matplotlib.colormaps[name](x)[:, :3].astype(np.float32)
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("use_avg", [False, True])
def test_resample_matches_jax(use_avg):
    import jax.numpy as jnp
    from nerf_hugs_tpu.core import stepfun as jax_stepfun

    rs = np.random.RandomState(6)
    t = np.sort(rs.uniform(-0.1, 1.1, (4, 40)), -1).astype(np.float32)
    tp = np.sort(rs.rand(4, 17), -1).astype(np.float32)
    vp = rs.rand(4, 16).astype(np.float32)
    want = jax_stepfun.resample(jnp.asarray(t), jnp.asarray(tp),
                                jnp.asarray(vp), use_avg=use_avg)
    got = stepfun.resample(*map(torch.from_numpy, (t, tp, vp)),
                           use_avg=use_avg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _tb_train(ckpt) -> dict:
    """{tag: [(step, value)]} of {ckpt}/tb_train."""
    from tensorboard.util import tensor_util
    acc = _accumulate(pathlib.Path(ckpt) / "tb_train")
    return {tag: [(e.step, tensor_util.make_ndarray(e.tensor_proto))
                  for e in acc.Tensors(tag)]
            for tag in acc.Tags()["tensors"]}


def _same_summaries(want: dict, got: dict) -> None:
    """Equal tags at equal steps; train_avg_psnr_timed's steps are wall
    seconds, so only their count is compared; learning rates within four
    float32 steps of JAX's."""
    assert sorted(want) == sorted(got)
    for tag in want:
        steps = lambda d: [s for s, _ in d[tag]]
        if tag == "train_avg_psnr_timed":
            assert len(steps(want)) == len(steps(got))
        else:
            assert steps(want) == steps(got), tag
    for (_, a), (_, b) in zip(want["learning_rate"], got["learning_rate"]):
        np.testing.assert_allclose(b, a, rtol=2 ** -21, atol=0)
    for tag, events in got.items():
        for _, value in events:
            if value.dtype != object:
                assert np.isfinite(value).all(), tag


def test_yaml_driver_writes_jax_summaries(tmp_path):
    """The tiny nerfacto yaml: 3 steps, an in-train eval at steps 2 and 3,
    through python -m nerf_hugs_torch.train and the repo's train.py."""
    import train as jax_train
    cfg = tu.write_tiny_yaml(str(tmp_path), base={"early_exit_steps": 3,
                                                  "train_render_every": 2})
    args = ["--config", cfg, "--data_dir", str(tmp_path), "--save_dir"]
    jax_train.main(args + [str(tmp_path / "jax")])
    from test_torch_port_mipnerf360_driver import run_module
    run_module("nerf_hugs_torch.train",
               args + [str(tmp_path / "port"), "--device", "cpu"])
    want, got = _tb_train(tmp_path / "jax"), _tb_train(tmp_path / "port")
    _same_summaries(want, got)
    assert "render_depth_mean" in got and "train_losses/data" in got


def test_gin_driver_writes_jax_summaries(tmp_path):
    """kubric_1024_base.gin at the toy widths of the gin driver tests: the
    Mip-NeRF 360 ray strips among the images."""
    import train as jax_train
    from nerf_hugs_torch.tools.hashgrid_inputs import write_kubric_scene
    from test_torch_port_mipnerf360_driver import gin_args, run_module
    scene = write_kubric_scene(str(tmp_path / "kubric"), 4, 2, 32)
    port = gin_args("kubric_1024_base", scene, tmp_path / "port")
    run_module("nerf_hugs_torch.train", port)
    jax_train.main([a for a in gin_args("kubric_1024_base", scene,
                                        tmp_path / "jax")
                    if a not in ("--device", "cpu")])
    want, got = _tb_train(tmp_path / "jax"), _tb_train(tmp_path / "port")
    _same_summaries(want, got)
    assert "render_ray_colors" in got and "render_ray_weights" in got


LEAN = ("nerf_hugs_torch/utils/vis.py", "nerf_hugs_torch/utils/summary.py",
        "nerf_hugs_torch/utils/turbo.py", "nerf_hugs_torch/utils/"
        "flax_msgpack.py", "nerf_hugs_torch/models/nerfacto_import.py",
        "nerf_hugs_torch/models/torch_compat.py",
        "nerf_hugs_torch/tools/convert_reference_checkpoint.py",
        "nerf_hugs_torch/tools/released_snapshots.py")


def test_summaries_and_import_need_no_tensorflow_stack():
    """The card has none of these: the new modules import none of them."""
    heavy = {"matplotlib", "tensorboard", "tensorflow", "PIL", "msgpack",
             "jax", "flax", "nerf_hugs_tpu"}
    for rel in LEAN:
        tree = ast.parse((REPO / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            assert not [n for n in names if n.split(".")[0] in heavy], rel
