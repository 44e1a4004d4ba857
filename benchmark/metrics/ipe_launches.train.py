"""Integrated-positional-encoding kernel launches a step: the change over
the window in the program's counter `ipe.launches` (the forward kernel of
nerf_hugs_torch/ops/ipe.py), over the window's steps. Nothing where the
program has no such counter."""

from benchmark import spans

NAME = "ipe.launches"


def prepare(run):
    spans.prepare(run)


def read(window):
    found = spans.counters(window)
    if found is None or not window["steps"]:
        return None
    before, now = found
    if NAME not in now:
        return None
    return (now[NAME] - before.get(NAME, 0)) / window["steps"]
