"""Spans and counters of nerf_hugs_torch: the program's one record of where
its host time goes and what it counts.

    with trace.span("step.forward"):    # recorded after trace.enable()
        ...
    trace.count("data.starved")         # always counted
    with trace.timed("setup.optimizer_s"):
        ...                             # seconds added to a counter

A span records (name, start, end, parent, thread): its times are
`time.perf_counter()`, the clock a device trace is mapped onto, its parent
the enclosing span of the same thread. Records go into a ring of
RING_SIZE entries; a record that pushes out the oldest adds one to the
counter `trace.dropped`. Spans record only between `enable()` and
`disable()`, and the program's callers are the only switch: with tracing
off `span` hands back one shared no-op context, without reading the
clock. Counters are one dict add and are always on; `timed` (set-up
phases, which run once) adds its seconds to a counter whether spans are on
or not. `counters()` and `records()` give snapshots, `drain()` takes the
records out of the ring.

Each counter is added to by one thread (a loader's starved gets by the
thread that iterates it, a kernel's launches by the thread that launches
it), so the adds take no lock; the ring takes one, as spans come from the
loader's producer thread and its consumer at once.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

RING_SIZE = 65536


class Record(NamedTuple):
    name: str
    start: float           # time.perf_counter() seconds
    end: float
    parent: Optional[str]  # the enclosing span's name on the same thread
    thread: int            # threading.get_ident() of the recording thread


_counters: Dict[str, float] = collections.defaultdict(int)
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()
_local = threading.local()
_enabled = False
_OFF = contextlib.nullcontext()


def enable() -> None:
    """Record spans from now on."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record no more spans (those open still record when they end)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] += n


def counters() -> Dict[str, float]:
    """A snapshot of every counter."""
    return dict(_counters)


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """Add the seconds the block takes to the counter `name`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count(name, time.perf_counter() - t0)


class _Span:
    __slots__ = ("name", "start", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        record = Record(self.name, self.start, end, self.parent,
                        threading.get_ident())
        with _ring_lock:
            if len(_ring) == RING_SIZE:
                count("trace.dropped")
            _ring.append(record)
        return False


def span(name: str):
    """A context that records the span `name` while tracing is on; the
    shared no-op context while it is off."""
    return _Span(name) if _enabled else _OFF


def records() -> List[Record]:
    """A snapshot of the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def drain() -> List[Record]:
    """The ring's records, oldest first, leaving it empty."""
    with _ring_lock:
        out = list(_ring)
        _ring.clear()
    return out
