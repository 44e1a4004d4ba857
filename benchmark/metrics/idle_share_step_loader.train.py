"""The share of the traced window in which the device idled while the
host was inside the program's span `step` and, at the same time, the
loader's producer thread inside `data.assemble`: the part of the step's
idle that the two threads' contention for the interpreter may explain."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    return spans.idle_share(window, ("step",), ("data.assemble",))
