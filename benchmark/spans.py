"""The program's own spans and counters (nerf_hugs_torch/utils/trace.py)
in a traced window, for the readers of benchmark/metrics/ that read them.

`prepare(run)` turns the program's span recording on and keeps a snapshot
of its counters on the run, before the window; `records(window)` gives the
records whose end falls in the window. Both read the program's spans on
the device trace's clock (time.perf_counter), so they are read beside the
device trace of the same window: a run without one reads none of them,
and neither does a program without the trace module, nor a window in
which the program's ring dropped records.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark import devtrace


def _program_trace():
    """The program's trace module; None where the program has none."""
    try:
        from nerf_hugs_torch.utils import trace
    except ImportError:
        return None
    return trace


def prepare(run) -> None:
    trace = _program_trace()
    if trace is None:
        return
    trace.enable()
    run.__dict__.setdefault("captures", {}).setdefault(
        "trace", trace.counters())


def counters(window) -> Optional[tuple]:
    """(counters at prepare, counters now); None where the window has no
    device trace, the program no trace module or the run no snapshot, or
    the program's ring dropped records since the snapshot."""
    trace = _program_trace()
    before = getattr(window.get("run"), "captures", {}).get("trace")
    if window.get("trace") is None or trace is None or before is None:
        return None
    now = trace.counters()
    if now.get("trace.dropped", 0) != before.get("trace.dropped", 0):
        return None
    return before, now


def records(window) -> Optional[list]:
    """The program's records whose end falls in the window; None as
    `counters` finds none."""
    if counters(window) is None:
        return None
    start, end = window["start"], window["end"]
    return [r for r in _program_trace().records() if start <= r.end <= end]


def ms_per_step(window, name: str) -> Optional[float]:
    """Host ms a step of the spans `name` in the window."""
    found = records(window)
    if found is None or not window["steps"]:
        return None
    return sum(r.end - r.start for r in found
               if r.name == name) * 1e3 / window["steps"]


def intersect(a, b) -> List[list]:
    """The intersection of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(trace) -> List[list]:
    """The device trace's idle intervals: its window less its busy
    union."""
    edges = [trace.start] + [x for iv in trace.busy for x in iv] \
        + [trace.end]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_share(window, *groups) -> Optional[float]:
    """The share (%) of the traced window in which the device idled while
    the host was inside a span of each group of names at once."""
    found = records(window)
    if found is None:
        return None
    trace = window["trace"]
    common = idle(trace)
    for names in groups:
        common = intersect(common, devtrace.merge(
            (r.start, r.end) for r in found if r.name in names))
    return 100.0 * sum(b - a for a, b in common) / trace.window_s
