"""Host ms a step in the program's span `step.update`: the gradients' mean
over the ranks, clipping and the fused Adam with its schedule
(train/step.py), with whatever waits for the device they make."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.ms_per_step(window, "step.update")
