"""On the card, at each cell's own size: the program passes its cell's
limits, and the fp8 control (the reference in the program's place one
precision below the configuration's bf16) and the half-batch fault fail
them. Skips without a CUDA card; run it on the card with

    python -m pytest benchmark/tests/test_h100bench_control.py -q -m cuda
"""

import pytest
import torch

from h100bench_util import REPO

CELLS = ("nerfacto_base.train", "mip360_bf16.train")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,passes", [("program", True), ("fp8", False),
                                         ("half", False)])
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_the_limits(cell, mode, passes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    from benchmark import control
    from benchmark.manifest import Manifest
    manifest = Manifest(REPO)
    limits = manifest.limits(manifest.cell(cell))
    reading = control.reading(manifest, cell, 9400000001, mode,
                              torch.device("cuda", 0))
    within = all(reading[k] <= v for k, v in limits.items())
    assert within == passes, {k: reading[k] for k in limits}
