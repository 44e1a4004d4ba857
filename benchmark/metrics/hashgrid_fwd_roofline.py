"""The hash-grid forward kernels' share of their roofline: the sum of a
step's launches' least times (benchmark/roofline.py, the positions of the
window's last step) over their device time a step."""

from benchmark import devtrace, roofline


def prepare(run):
    roofline.capture_hashgrid_inputs(run)


def read(window):
    trace = window["trace"]
    bound = roofline.step_bound_ms(window["run"], "fwd")
    if trace is None or bound is None:
        return None
    ms = trace.ms_per_step(devtrace.HASHGRID_FWD)
    return None if not ms else 100.0 * bound[0] / ms
