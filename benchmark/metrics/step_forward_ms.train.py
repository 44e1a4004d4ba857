"""Host ms a step in the program's span `step.forward`: launching the
loss's forward pass (train/step.py compute_loss), with whatever waits for
the device it makes."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.ms_per_step(window, "step.forward")
