"""The readers' arithmetic on synthetic windows and traces, the FLOP
counts against a hand count, and the hash-grid bounds."""

import json
import os

import pytest
import torch

from benchmark import devtrace, peaks, roofline
from benchmark.manifest import Manifest
from benchmark.reference import hashgrid, mipnerf360, nerfacto
from h100bench_util import REPO


def reader(name):
    return Manifest(REPO).reader(name)


def stalled_window():
    """99 steps of 40 ms and one stalled step of 400 ms, 16384 rays each,
    in a window that ends 10 ms after the last step (the drain)."""
    step_ms = [40.0] * 99 + [400.0]
    return {"steps": 100, "rays": 100 * 16384, "step_ms": step_ms,
            "seconds": (sum(step_ms) + 10.0) / 1e3, "setup_s": 12.5,
            "spans": [("data", 0.0, 0.002), ("train_step", 0.002, 0.03),
                      ("data", 0.04, 0.041), ("train_step", 0.041, 0.07),
                      ("readback", 0.07, 0.09)],
            "trace": None}


def test_rate_is_every_ray_over_the_whole_window():
    w = stalled_window()
    assert reader("train_rays_per_s").read(w) == pytest.approx(
        100 * 16384 / 4.37)


def test_p95_is_over_every_step_and_sees_a_stall():
    w = stalled_window()
    assert reader("step_ms_p95.train").read(w) == pytest.approx(40.0)
    w["step_ms"] = [40.0] * 90 + [400.0] * 10
    assert reader("step_ms_p95.train").read(w) == pytest.approx(400.0)


def test_host_spans_are_means_a_step():
    w = stalled_window()
    assert reader("data_ms.train").read(w) == pytest.approx(1.5)
    assert reader("step_host_ms.train").read(w) == pytest.approx(28.5)
    assert reader("setup_s").read(w) == 12.5


def synthetic_trace():
    """Two steps of 100 ms: GEMMs, a hash-grid kernel, elementwise passes
    and an idle gap of 30 ms in step two while the host is in `data`."""
    ops = [("nvjet_tst_128x256", 0.000, 0.020),
           ("hashgrid_fwd_kernel<3>", 0.020, 0.030),
           ("vectorized_elementwise_kernel<mul>", 0.030, 0.100),
           ("nvjet_tst_128x256", 0.100, 0.120),
           ("hashgrid_bwd_kernel<3>", 0.120, 0.135),
           ("Memset (Device)", 0.135, 0.140),
           ("reduce_kernel<sum>", 0.170, 0.200)]
    spans = [("data", 0.138, 0.171), ("train_step", 0.171, 0.199)]
    return devtrace.Trace(ops, spans, 0.0, 0.200, steps=2)


def test_trace_sums_busy_idle_and_classes():
    t = synthetic_trace()
    assert t.busy_s == pytest.approx(0.170)
    assert t.ms_per_step(devtrace.GEMM) == pytest.approx(20.0)
    w = {"trace": t}
    assert reader("gemm_ms.train").read(w) == pytest.approx(20.0)
    assert reader("elementwise_ms.train").read(w) == pytest.approx(35.0)
    assert reader("idle_share.train").read(w) == pytest.approx(15.0)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0][0] == "data" and gaps[0][1] == pytest.approx(0.030)
    assert t.breakdown()["device_ops"][0][0].startswith("vectorized")


def test_readers_find_nothing_without_a_trace():
    w = stalled_window()
    for name in ("gemm_ms.train", "elementwise_ms.train", "train_mfu",
                 "idle_share.train", "hashgrid_fwd_roofline",
                 "hashgrid_bwd_roofline"):
        assert reader(name).read(dict(w, run=None)) is None


def tiny_values():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "kubric_nerfacto_base.json")) as f:
        v = json.load(f)["values"]
    v.update({"batch_size": 10, "nerfacto.num_levels": 2,
              "nerfacto.features_per_level": 2, "nerfacto.hidden_dim": 4,
              "nerfacto.geo_feat_dim": 3, "nerfacto.hidden_dim_color": 5,
              "nerfacto.num_nerf_samples_per_ray": 7,
              "nerfacto.num_proposal_samples_per_ray": [11],
              "nerfacto.proposal_net_args_list": [
                  {"base_res": 16, "features_per_level": 2, "hidden_dim": 6,
                   "log2_hashmap_size": 8, "max_res": 32,
                   "num_levels": 3}]})
    return v


def test_nerfacto_flops_by_hand():
    # field: mlp_base 4x4 + 4x4, mlp_head 19x5 + 5x5 + 5x3; proposal 6x6 + 6x1
    field = 4 * 4 + 4 * 4 + 19 * 5 + 5 * 5 + 5 * 3
    proposal = 6 * 6 + 6 * 1
    hand = 2 * 3 * 10 * (field * 7 + proposal * 11)
    assert nerfacto.step_flops(tiny_values()) == hand


def test_mipnerf360_flops_by_hand():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "kubric_1024_base_tpu_bf16.json")) as f:
        v = json.load(f)["values"]
    v.update({"batch_size": 10, "model.num_nerf_samples": 3,
              "model.num_prop_samples": 5, "model.num_levels": 3,
              "nerf_mlp.net_depth": 6, "nerf_mlp.net_width": 8,
              "nerf_mlp.skip_layer": 4, "nerf_mlp.bottleneck_width": 4,
              "nerf_mlp.net_depth_viewdirs": 1, "nerf_mlp.net_width_viewdirs": 2,
              "prop_mlp.net_depth": 2, "prop_mlp.net_width": 4})
    feat = 2 * 21 * 12   # 21 basis directions, 12 octaves, sin and cos
    nerf = [(feat, 8), (8, 8), (8, 8), (8, 8), (8, 8), (8 + feat, 8),
            (8, 1), (8, 4), (4 + 3 + 24, 2), (2, 3)]
    prop = [(feat, 4), (4, 4), (4, 1)]
    macs = lambda layers: sum(a * b for a, b in layers)
    hand = 2 * 10 * (3 * (3 * macs(nerf) - feat * 8)
                     + 10 * (3 * macs(prop) - feat * 4))
    assert mipnerf360.step_flops(v) == hand


def test_hashgrid_bounds_count_bytes_once():
    spec = hashgrid.Grid(2, 2, 8, 4, 8)
    pos = torch.full((5, 3), 0.5)        # every sample in one cell
    b = roofline.bounds_ms(spec, pos)
    io = 5 * 3 * 4 + 5 * 4 * 4
    rows = hashgrid.rows_touched(spec, pos)
    assert rows == 16                    # 8 corners at each of 2 levels
    flops = 6 * 8 * 5 * 2
    fwd_bytes = io + rows * 2 * 4
    expect = max(fwd_bytes / peaks.HBM_BYTES_PER_S,
                 flops / peaks.FLOPS["float32"]) * 1e3
    assert b["fwd"][0] == pytest.approx(expect)
    assert b["bwd"][0] == pytest.approx(
        (io + spec.num_rows * 2 * 4) / peaks.HBM_BYTES_PER_S * 1e3)
    assert b["bwd"][1] == "bytes"


def test_roofline_reader_against_its_bound():
    spec = hashgrid.Grid(2, 2, 8, 4, 8)
    pos = torch.rand(64, 3, generator=torch.Generator().manual_seed(0))

    class Run:
        captures = {"hashgrid": {"field": (spec, pos)}}

    bound = roofline.bounds_ms(spec, pos)["fwd"][0]
    trace = devtrace.Trace([("hashgrid_fwd_kernel<3>", 0.0, 2 * bound
                             * 4e-3)], [], 0.0, 1.0, steps=2)
    w = {"trace": trace, "run": Run()}
    assert reader("hashgrid_fwd_roofline").read(w) == pytest.approx(25.0)
    assert reader("hashgrid_bwd_roofline").read(w) is None


def test_mfu_over_the_bf16_peak():
    w = dict(stalled_window(), trace=synthetic_trace(),
             flops_per_step=1e12, gemm_dtype="bfloat16")
    assert reader("train_mfu").read(w) == pytest.approx(
        100 * 100e12 / (4.37 * peaks.FLOPS["bfloat16"]))
