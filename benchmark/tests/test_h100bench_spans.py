"""The readers of the program's own spans and counters (benchmark/spans.py
and its eleven metrics) on synthetic windows, with the idle intersections
computed by hand; a drop, a missing device trace or a program without the
trace module reads nothing; only the traced run prepares them."""

import threading
import time
import types

import pytest

from benchmark import devtrace, spans
from benchmark.manifest import Manifest
from h100bench_util import REPO, run_cell, tiny_checkout

SPAN_READERS = ("data_wait_ms.train", "data_copy_ms.train",
                "data_assemble_ms.train", "step_forward_ms.train",
                "step_backward_ms.train", "step_update_ms.train",
                "idle_share_data.train", "idle_share_step.train",
                "idle_share_step_loader.train", "hashgrid_launches.train",
                "setup_optimizer_s")
MAIN, LOADER = 1, 2


def reader(name):
    return Manifest(REPO).reader(name)


def rec(name, start, end, parent=None, thread=MAIN):
    return types.SimpleNamespace(name=name, start=start, end=end,
                                 parent=parent, thread=thread)


class FakeTrace:
    """The program's trace module as the readers see it."""

    def __init__(self, found, counters):
        self.found, self.now, self.on = found, counters, False

    def enable(self):
        self.on = True

    def counters(self):
        return dict(self.now)

    def records(self):
        return list(self.found)


# Two steps in a window of 200 ms. Host, main thread: data.wait, data.copy,
# then step with its three children; the loader thread's data.assemble.
RECORDS = [
    rec("data.wait", 0.000, 0.004), rec("data.copy", 0.004, 0.010),
    rec("step.forward", 0.010, 0.050, "step"),
    rec("step.backward", 0.050, 0.070, "step"),
    rec("step.update", 0.070, 0.085, "step"), rec("step", 0.010, 0.090),
    rec("data.assemble", 0.020, 0.050, thread=LOADER),
    rec("data.assemble", 0.085, 0.095, thread=LOADER),
    rec("data.wait", 0.100, 0.101), rec("data.copy", 0.101, 0.131),
    rec("step.forward", 0.131, 0.170, "step"),
    rec("step.backward", 0.170, 0.190, "step"),
    rec("step.update", 0.190, 0.195, "step"), rec("step", 0.131, 0.199),
    rec("data.assemble", 0.120, 0.160, thread=LOADER),
    # Ends after the window: not read.
    rec("data.assemble", 0.190, 0.250, thread=LOADER),
    rec("data.wait", 0.199, 0.300)]
# Device busy [0, 5], [12, 80], [105, 125], [140, 200] ms: idle [5, 12],
# [80, 105], [125, 140], 47 ms in all.
OPS = [("k", 0.000, 0.005), ("k", 0.012, 0.040), ("k", 0.030, 0.080),
       ("k", 0.105, 0.125), ("k", 0.140, 0.200)]
BEFORE = {"hashgrid_fwd.launches": 10, "hashgrid_bwd.launches": 10,
          "hashgrid_fwd.launches_2d": 3, "setup.optimizer_s": 2.5,
          "trace.dropped": 7}
NOW = dict(BEFORE, **{"hashgrid_fwd.launches": 14,
                      "hashgrid_bwd.launches": 14,
                      "hashgrid_fwd.launches_2d": 9})


@pytest.fixture
def program(monkeypatch):
    fake = FakeTrace(RECORDS, NOW)
    monkeypatch.setattr(spans, "_program_trace", lambda: fake)
    return fake


def window(run, with_trace=True):
    trace = devtrace.Trace(OPS, [], 0.0, 0.200, steps=2)
    return {"steps": 2, "start": 0.0, "end": 0.200, "run": run,
            "trace": trace if with_trace else None}


def prepared(program):
    run = types.SimpleNamespace()
    program.now = BEFORE
    for name in SPAN_READERS:
        reader(name).prepare(run)
    program.now = NOW
    return run


def test_prepare_turns_spans_on_and_keeps_the_counters(program):
    run = prepared(program)
    assert program.on
    assert run.captures["trace"] == BEFORE


def test_host_spans_a_step_and_a_batch(program):
    w = window(prepared(program))
    want = {"data_wait_ms.train": (4 + 1) / 2,
            "data_copy_ms.train": (6 + 30) / 2,
            "step_forward_ms.train": (40 + 39) / 2,
            "step_backward_ms.train": (20 + 20) / 2,
            "step_update_ms.train": (15 + 5) / 2,
            "data_assemble_ms.train": (30 + 10 + 40) / 3}
    for name, ms in want.items():
        assert reader(name).read(w) == pytest.approx(ms), name


def test_idle_shares_by_hand(program):
    w = window(prepared(program))
    # Data spans [0, 10], [100, 131] against idle: [5, 10], [100, 105],
    # [125, 131] = 16 ms of 200.
    assert reader("idle_share_data.train").read(w) == pytest.approx(8.0)
    # Step spans [10, 90], [131, 199]: [10, 12], [80, 90], [131, 140] = 21.
    assert reader("idle_share_step.train").read(w) == pytest.approx(10.5)
    # ... while the loader assembles ([20, 50], [85, 95], [120, 160]):
    # [85, 90], [131, 140] = 14.
    assert reader("idle_share_step_loader.train").read(w) \
        == pytest.approx(7.0)
    assert reader("idle_share.train").read(w) == pytest.approx(23.5)


def test_launches_a_step_and_setup_seconds(program):
    w = window(prepared(program))
    # The d = 3 counters alone: (4 + 4) launches over 2 steps.
    assert reader("hashgrid_launches.train").read(w) == pytest.approx(4.0)
    assert reader("setup_optimizer_s").read(w) == pytest.approx(2.5)


def test_nothing_after_a_drop_or_without_a_device_trace(program):
    run = prepared(program)
    program.now = dict(NOW, **{"trace.dropped": 8})
    for name in SPAN_READERS:
        assert reader(name).read(window(run)) is None, name
    program.now = NOW
    for name in SPAN_READERS:
        assert reader(name).read(window(run, with_trace=False)) is None
        assert reader(name).read(window(types.SimpleNamespace())) is None


def test_nothing_from_a_program_without_the_trace_module(monkeypatch):
    monkeypatch.setattr(spans, "_program_trace", lambda: None)
    run = types.SimpleNamespace()
    for name in SPAN_READERS:
        reader(name).prepare(run)       # does not raise
        assert reader(name).read(window(run)) is None
    assert not hasattr(run, "captures")


def test_the_program_records_read_on_the_window():
    """The program's own records: spans of this thread and of another, in
    a window with an idle device."""
    from nerf_hugs_torch.utils import trace
    run = types.SimpleNamespace()
    trace.drain()
    spans.prepare(run)
    try:
        start = time.perf_counter()
        with trace.span("step"):
            with trace.span("step.forward"):
                time.sleep(0.01)
            worker = threading.Thread(target=lambda: trace.span(
                "data.assemble").__enter__().__exit__(None, None, None))
            worker.start()
            worker.join(timeout=10)
        end = time.perf_counter()
    finally:
        trace.disable()
    assert not worker.is_alive()
    w = {"steps": 1, "start": start, "end": end, "run": run,
         "trace": devtrace.Trace([], [], start, end, steps=1)}
    found = trace.records()
    step = [r for r in found if r.name == "step"][0]
    assembled = [r for r in found if r.name == "data.assemble"][0]
    assert assembled.thread != step.thread
    assert reader("step_forward_ms.train").read(w) >= 10.0
    assert reader("idle_share_step.train").read(w) == pytest.approx(
        100 * (step.end - step.start) / (end - start))
    assert reader("idle_share_step_loader.train").read(w) == pytest.approx(
        100 * (assembled.end - assembled.start) / (end - start))
    trace.drain()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


def test_only_the_traced_run_prepares(root, monkeypatch):
    from nerf_hugs_torch.utils import trace
    calls = []
    monkeypatch.setattr(spans, "prepare", lambda run: calls.append(run))
    trace.disable()
    code, result = run_cell(root, "tiny_nerfacto.train", trace=0)
    assert code == 0 and result["correct"]
    assert calls == [] and not trace.enabled()
    code, result = run_cell(root, "tiny_nerfacto.train", trace=1)
    assert code == 0 and result["correct"]
    # Every reader of the tiny cell's list prepares (hashgrid_launches.train
    # lists nerfacto_base.train alone).
    assert len(calls) == len(SPAN_READERS) - 1
    # On the CPU there is no device trace: the readers report nothing.
    assert not set(result["metrics"]) & set(SPAN_READERS)
