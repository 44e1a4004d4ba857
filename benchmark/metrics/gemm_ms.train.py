"""Device ms a step of the matrix products (cuBLAS and CUTLASS kernels)."""

from benchmark import devtrace


def read(window):
    trace = window["trace"]
    return None if trace is None else trace.ms_per_step(devtrace.GEMM)
