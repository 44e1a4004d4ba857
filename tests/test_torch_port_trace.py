"""nerf_hugs_torch/utils/trace.py: spans off and on, the ring's bound, and
the spans and counters of the data layer, the train step, set-up and the
train driver's --trace print line, on the CPU."""

import queue
import threading
import time
import types

import numpy as np
import pytest
import torch

import torch_port_util as tu
from nerf_hugs_torch.configs import yaml_loader
from nerf_hugs_torch.data import base as data_base
from nerf_hugs_torch.data import load_dataset
from nerf_hugs_torch.models import construct_model
from nerf_hugs_torch.train import driver
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.utils import structs, trace


@pytest.fixture
def tracing():
    """Spans on for the test, off and the ring empty after it."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_off_records_nothing_and_hands_back_one_no_op(monkeypatch):
    trace.disable()
    trace.drain()

    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(trace, "time",
                        types.SimpleNamespace(perf_counter=no_clock))
    a, b = trace.span("a"), trace.span("b")
    assert a is b
    with a, trace.span("c"):
        pass
    assert trace.records() == [] and not trace.enabled()


def test_on_records_nested_spans_with_parent_thread_and_times(tracing):
    t0 = time.perf_counter()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        with trace.span("inner2"):
            pass
    t1 = time.perf_counter()
    inner, inner2, outer = trace.records()
    me = threading.get_ident()
    assert (outer.name, outer.parent, outer.thread) == ("outer", None, me)
    assert (inner.name, inner.parent, inner.thread) == ("inner", "outer", me)
    assert (inner2.name, inner2.parent) == ("inner2", "outer")
    assert t0 <= outer.start <= inner.start <= inner.end <= inner2.start \
        <= inner2.end <= outer.end <= t1
    # A span on another thread has its own stack: no parent here.
    worker = threading.Thread(target=lambda: trace.span("other").__enter__()
                              .__exit__(None, None, None))
    with trace.span("outer"):
        worker.start()
        worker.join(timeout=10)
    assert not worker.is_alive()
    other = [r for r in trace.records() if r.name == "other"][0]
    assert other.parent is None and other.thread == worker.ident
    assert trace.drain() and trace.records() == []


def test_ring_is_bounded_and_counts_what_it_drops(tracing):
    dropped = trace.counters().get("trace.dropped", 0)
    for i in range(trace.RING_SIZE + 3):
        with trace.span(f"s{i}" if i < 3 else "s"):
            pass
    kept = trace.records()
    assert len(kept) == trace.RING_SIZE
    assert kept[0].name == "s"      # the three oldest went
    assert trace.counters()["trace.dropped"] == dropped + 3


def test_counters_and_timed_count_with_spans_off():
    trace.disable()
    before = trace.counters()
    trace.count("test.events")
    trace.count("test.events", 2)
    with trace.timed("test.phase_s"):
        time.sleep(0.01)
    after = trace.counters()
    assert after["test.events"] == before.get("test.events", 0) + 3
    assert after["test.phase_s"] - before.get("test.phase_s", 0) >= 0.01
    after["test.events"] = -1       # a snapshot, not the registry
    assert trace.counters()["test.events"] != -1


class TinyLoader(data_base.Dataset):
    """A loader of one fixed batch of n rays, whose producer first waits
    for `release`: Dataset's own prefetch thread and queue."""

    def __init__(self, n: int, release: threading.Event):
        threading.Thread.__init__(self, daemon=True)
        self._queue = queue.Queue(3)
        rays = structs.Rays(**tu.ray_arrays(n, 0))
        rgb = np.zeros((n, 3), np.float32)

        def next_fn():
            assert release.wait(timeout=30)
            return structs.Batch(rays=rays, rgb=rgb)

        self._next_fn = next_fn
        self.start()

    def _load_renderings(self, config):
        raise NotImplementedError


def test_loader_spans_on_their_threads_and_starved_gets(tracing):
    release = threading.Event()
    loader = TinyLoader(8, release)
    starved = trace.counters().get("data.starved", 0)
    timer = threading.Timer(0.05, release.set)
    timer.start()
    batch = next(loader).to("cpu")    # the queue is empty: starved
    timer.join(timeout=10)
    assert isinstance(batch.rgb, torch.Tensor)
    assert trace.counters()["data.starved"] == starved + 1
    deadline = time.time() + 30
    while loader._queue.qsize() < 3 and time.time() < deadline:
        time.sleep(0.01)
    next(loader).to("cpu")            # a ready batch: not starved
    assert trace.counters()["data.starved"] == starved + 1
    found = trace.records()
    me = threading.get_ident()
    by_name = lambda name: [r for r in found if r.name == name]
    assert len(by_name("data.wait")) == len(by_name("data.copy")) == 2
    assert all(r.thread == me for r in by_name("data.wait")
               + by_name("data.copy"))
    assembled = by_name("data.assemble")
    assert len(assembled) >= 3
    assert all(r.thread == loader.ident and r.parent is None
               for r in assembled)
    # The first get waited for the stalled producer's first batch.
    first_wait = by_name("data.wait")[0]
    assert first_wait.end >= assembled[0].end


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny nerfacto config, its model, optimizer and train loader."""
    tmp = str(tmp_path_factory.mktemp("trace"))
    config = yaml_loader.load_yaml_config(tu.write_tiny_yaml(tmp))
    config.data_dir = tmp
    model = construct_model(config, "cpu", torch.Generator().manual_seed(0))
    before = trace.counters().get("setup.optimizer_s", 0)
    optimizer, scheduler = step_lib.create_optimizer(config, model)
    optimizer_s = trace.counters()["setup.optimizer_s"] - before
    dataset = load_dataset("train", tmp, config, is_training=True)
    return config, model, optimizer, scheduler, dataset, optimizer_s


def test_create_adam_adds_its_seconds(tiny_run):
    assert tiny_run[-1] > 0
    before = trace.counters()["setup.optimizer_s"]
    step_lib.create_adam([torch.nn.Parameter(torch.zeros(3))],
                         lambda count: 1e-3, 0.9, 0.999, 1e-15)
    assert trace.counters()["setup.optimizer_s"] > before


def test_train_step_spans_its_three_phases_in_order(tiny_run, tracing):
    config, model, optimizer, scheduler, dataset, _ = tiny_run
    batch = next(dataset).to("cpu")
    trace.drain()
    step_lib.train_step(model, optimizer, scheduler, batch, 0.0, config,
                        torch.Generator().manual_seed(1))
    found = [r for r in trace.records() if r.thread == threading.get_ident()]
    names = [r.name for r in found]
    assert names == ["step.forward", "step.backward", "step.update", "step"]
    step = found[-1]
    assert step.parent is None
    assert all(r.parent == "step" and step.start <= r.start <= r.end
               <= step.end for r in found[:3])
    assert all(a.end <= b.start for a, b in zip(found[:2], found[1:3]))


def test_driver_trace_flag_adds_the_spans_to_the_print_line(tmp_path):
    cfg = tu.write_tiny_yaml(str(tmp_path), base={
        "early_exit_steps": 2, "eval_render_every": 0})
    ckpt = tmp_path / "ckpt"
    try:
        driver.main(["--config", cfg, "--data_dir", str(tmp_path),
                     "--save_dir", str(ckpt), "--device", "cpu", "--trace"])
    finally:
        trace.disable()
        trace.drain()
    lines = [line for line in (ckpt / "run_log.log").read_text()
             .splitlines() if "# [train] " in line]
    assert len(lines) == 2
    for line in lines:
        for name in driver.TraceLine.SPANS:
            assert f" {name}=" in line and line.count(f"{name}=") == 1
        assert " data.starved=" in line
    ms = float(lines[1].split(" step.forward=")[1].split("ms")[0])
    assert ms > 0
