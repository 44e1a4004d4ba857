"""Host ms a step in the program's span `data.copy`: the batch's copy to
the device (utils/structs.py Batch.to), with whatever wait for the
device's queue the copy makes."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.ms_per_step(window, "data.copy")
