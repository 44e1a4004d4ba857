"""Device ms a step of the kernels outside the GEMM, hash-grid, Adam,
sort and reduce classes (and outside copies and fills): the eager passes
of sampling, encoding, compositing and the losses."""

from benchmark import devtrace

OTHERS = (devtrace.GEMM, devtrace.HASHGRID_FWD, devtrace.HASHGRID_BWD,
          devtrace.ADAM, devtrace.SORT, devtrace.REDUCE, devtrace.COPY)


def read(window):
    trace = window["trace"]
    return None if trace is None else trace.ms_per_step(".", OTHERS)
