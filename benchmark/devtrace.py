"""The device trace of a window: torch.profiler's CUDA activity (kernels,
copies and fills), put on the host's clock, and the sums the per-layer
readers take from it.

The trace's clock is tied to the host's by a marker: with the device idle,
the host notes the time and launches one fill, the trace's first
operation; the gap between the two is the launch latency, some
microseconds.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

# Kernel classes by name (cuBLAS's Hopper GEMMs are named nvjet_*).
GEMM = r"nvjet|gemm|xmma|cutlass|cublas"
ADAM = r"adam"
SORT = r"sort|radix|searchsorted"
REDUCE = r"reduce"
HASHGRID_FWD = r"hashgrid_fwd"
HASHGRID_BWD = r"hashgrid_bwd"
COPY = r"^Memcpy|^Memset"


class Profiler:
    """torch.profiler over a window, with the clock marker."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark_s = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        marker = torch.empty(1, device=self.device)
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_s = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def device_ops(self) -> List[Tuple[str, float, float]]:
        """[(name, start, end)] of every device operation, in seconds on
        the host's perf_counter clock, by start."""
        from torch.autograd import DeviceType
        ops = sorted((e.start_ns() * 1e-9,
                      (e.start_ns() + e.duration_ns()) * 1e-9, e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
        if not ops:
            return []
        offset = ops[0][0] - self.mark_s
        return [(name, a - offset, b - offset) for a, b, name in ops[1:]]


def merge(intervals):
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The window's device operations, its host spans and its length."""

    def __init__(self, ops, spans, start: float, end: float, steps: int):
        self.ops = [(n, max(a, start), min(b, end)) for n, a, b in ops
                    if b > start and a < end]
        self.spans = sorted(spans, key=lambda s: s[1])
        self.start, self.end, self.steps = start, end, steps
        self.busy = merge([(a, b) for _, a, b in self.ops])
        self.totals = defaultdict(float)   # device seconds by name
        for n, a, b in self.ops:
            self.totals[n] += b - a

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def ms_per_step(self, pattern: str, exclude=()) -> Optional[float]:
        """Device ms a step of the operations whose name matches `pattern`
        and none of `exclude`; None when there are none."""
        keep = re.compile(pattern, re.I)
        drop = [re.compile(p, re.I) for p in exclude]
        hits = [t for n, t in self.totals.items()
                if keep.search(n) and not any(d.search(n) for d in drop)]
        if not hits or not self.steps:
            return None
        return sum(hits) * 1e3 / self.steps

    def span_label(self, t: float) -> str:
        """The host span running at host time t."""
        starts = [s[1] for s in self.spans]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and self.spans[i][2] >= t:
            return self.spans[i][0]
        return "between spans"

    def breakdown(self) -> dict:
        """The 10 operations that took most device time, and the 10 longest
        idle gaps labelled by the host span they began in."""
        ops = sorted(((n[:160], t) for n, t in self.totals.items()),
                     key=lambda kv: -kv[1])[:10]
        edges = [self.start] + [x for iv in self.busy for x in iv] \
            + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.span_label(a), b - a]
                              for a, b in gaps[:10]]}
