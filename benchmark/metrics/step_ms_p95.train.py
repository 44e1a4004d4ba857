"""The 95th percentile of the window's step times: the intervals between
CUDA events recorded on the stream after consecutive steps (the first
after an event at the window's start), so that a stall shows in the step
it delays without the host waiting for the device."""

import numpy as np


def read(window):
    if not window["step_ms"]:
        return None
    return float(np.percentile(window["step_ms"], 95))
