"""Host ms a step waiting on the data layer: the benchmark's span around
the loader's next batch (its prefetch queue) and the batch's copy to the
device."""


def read(window):
    spans = [b - a for name, a, b in window["spans"] if name == "data"]
    return sum(spans) * 1e3 / len(spans) if spans else None
