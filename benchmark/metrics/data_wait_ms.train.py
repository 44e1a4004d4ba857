"""Host ms a step in the program's span `data.wait`: the loader's get from
its prefetch queue (data/base.py), which waits when the producer thread
has no batch ready."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.ms_per_step(window, "data.wait")
