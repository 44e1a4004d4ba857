"""A run end to end on the CPU at tiny widths: a cell added by files and
entries alone, the last line's keys, and the faults that must read as not
correct."""

import pytest

from h100bench_util import run_cell, tiny_checkout

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("cell", ["tiny_nerfacto.train", "tiny_mip.train"])
def test_a_cell_added_by_files_runs_and_is_correct(root, cell):
    code, result = run_cell(root, cell, seed=2 ** 31 + 11)
    assert code == 0
    assert list(result) == KEYS
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # The end-to-end metrics list no cells: every cell reports them.
    assert set(result["metrics"]) == {"setup_s", "train_rays_per_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(result["device"])


def test_traced_run_reads_the_host_spans(root):
    code, result = run_cell(root, "tiny_nerfacto.train", trace=1)
    assert code == 0 and result["correct"]
    # No device trace on the CPU: only the host-clock readers find data.
    assert set(result["metrics"]) == {"data_ms.train", "step_host_ms.train"}


@pytest.mark.parametrize("fault", ["frozen", "half"])
@pytest.mark.parametrize("cell", ["tiny_nerfacto.train", "tiny_mip.train"])
def test_a_broken_step_reads_not_correct(root, cell, fault):
    from benchmark import control
    code, result = run_cell(root, cell, seed=9,
                            trainee_factory=control.faulty(fault))
    assert code == 0
    assert result["correct"] is False, result["checks"]
