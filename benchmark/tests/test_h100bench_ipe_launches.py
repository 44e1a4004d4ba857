"""The reader of the encoding kernel's launch counter (`ipe_launches.train`)
on synthetic windows: launches a step over the window, and nothing where the
program has no such counter (a program from before the kernel), no trace
module or no device trace of the window."""

import types

import pytest

from benchmark import spans
from benchmark.manifest import Manifest
from h100bench_util import REPO

NAME = "ipe_launches.train"


class FakeTrace:
    """The program's trace module as the reader sees it: its counters."""

    def __init__(self, counters):
        self.now = counters

    def enable(self):
        pass

    def counters(self):
        return dict(self.now)


def read(monkeypatch, before, now, steps=4, device_trace=True):
    fake = FakeTrace(before)
    monkeypatch.setattr(spans, "_program_trace", lambda: fake)
    reader = Manifest(REPO).reader(NAME)
    run = types.SimpleNamespace()
    reader.prepare(run)
    fake.now = now
    # Counters are read beside a device trace of the window (spans.py).
    return reader.read({"steps": steps, "start": 0.0, "end": 1.0,
                        "run": run, "trace": types.SimpleNamespace()
                        if device_trace else None})


def test_launches_a_step(monkeypatch):
    # Three levels, each encoded in the forward and again in remat's
    # recomputation: 6 a step. The gradient kernel's counter is not read.
    got = read(monkeypatch, {"ipe.launches": 12, "ipe_bwd.launches": 0},
               {"ipe.launches": 36, "ipe_bwd.launches": 5})
    assert got == pytest.approx(6.0)
    # First counted inside the window.
    assert read(monkeypatch, {}, {"ipe.launches": 24}) == pytest.approx(6.0)


def test_nothing_without_the_counter(monkeypatch):
    assert read(monkeypatch, {"hashgrid_fwd.launches": 3},
                {"hashgrid_fwd.launches": 7}) is None
    assert read(monkeypatch, {}, {"ipe.launches": 6}, steps=0) is None
    assert read(monkeypatch, {}, {"ipe.launches": 6},
                device_trace=False) is None
    monkeypatch.setattr(spans, "_program_trace", lambda: None)
    reader = Manifest(REPO).reader(NAME)
    run = types.SimpleNamespace()
    reader.prepare(run)                 # does not raise
    assert reader.read({"steps": 2, "run": run,
                        "trace": types.SimpleNamespace()}) is None
