"""The share of the traced window in which the device idled while the
host was in the data layer: inside the program's spans `data.wait` (the
loader's queue) or `data.copy` (the batch's copy to the device)."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.idle_share(window, ("data.wait", "data.copy"))
