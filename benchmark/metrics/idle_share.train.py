"""The share of the traced window in which no operation ran on the
device."""


def read(window):
    trace = window["trace"]
    if trace is None:
        return None
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s
