"""The whole step's share of the card's peak: the model's matrix-product
operations of the window's steps (the reference's step_flops: forward,
weight and input gradients, a recomputed forward not counted) over the
traced window's wall time x the peak of the configuration's GEMM dtype."""

from benchmark import peaks


def read(window):
    if window["trace"] is None:
        return None
    flops = window["flops_per_step"] * window["steps"]
    return 100.0 * flops / (window["seconds"]
                            * peaks.FLOPS[window["gemm_dtype"]])
