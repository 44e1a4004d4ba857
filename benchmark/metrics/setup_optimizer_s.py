"""Seconds of set-up in the program's counter `setup.optimizer_s`: the
construction of the fused Adam and its schedule (train/step.py
create_adam)."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    found = spans.counters(window)
    return None if found is None else found[0].get("setup.optimizer_s")
