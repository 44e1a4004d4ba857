"""Host ms a batch in the program's span `data.assemble`: the loader's
producer thread building one batch (data/base.py: patch sampling, pixel
gather and ray casting) while the train loop runs."""

from benchmark import spans


def prepare(run):
    spans.prepare(run)


def read(window):
    found = spans.records(window)
    times = [r.end - r.start for r in found or ()
             if r.name == "data.assemble"]
    return sum(times) * 1e3 / len(times) if times else None
