"""The share of the traced window in which the device idled while the
host was inside the program's span `step` (train/step.py train_step)."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.idle_share(window, ("step",))
