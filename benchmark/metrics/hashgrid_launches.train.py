"""Hash-grid kernel launches a step: the change over the window in the
program's counters `hashgrid_fwd.launches` and `hashgrid_bwd.launches`
(d = 3), over the window's steps."""

from benchmark import spans

NAMES = ("hashgrid_fwd.launches", "hashgrid_bwd.launches")


def prepare(run):
    spans.prepare(run)


def read(window):
    found = spans.counters(window)
    if found is None or not window["steps"]:
        return None
    before, now = found
    return sum(now.get(k, 0) - before.get(k, 0)
               for k in NAMES) / window["steps"]
