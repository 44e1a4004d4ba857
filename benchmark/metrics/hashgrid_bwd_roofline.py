"""The hash-grid table-gradient kernels' share of their roofline: the sum
of a step's launches' least times (benchmark/roofline.py; bytes by shape
alone) over their device time a step."""

from benchmark import devtrace, roofline


def prepare(run):
    roofline.capture_hashgrid_inputs(run)


def read(window):
    trace = window["trace"]
    bound = roofline.step_bound_ms(window["run"], "bwd")
    if trace is None or bound is None:
        return None
    ms = trace.ms_per_step(devtrace.HASHGRID_BWD)
    return None if not ms else 100.0 * bound[0] / ms
