"""BENCHMARK.json against the benchmark's contract, and the files every
cell, configuration and metric is found by."""

import json
import os
import re

import pytest

from benchmark import check
from benchmark.manifest import Manifest, readers
from h100bench_util import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(REPO)


def test_top_level_keys_and_command(manifest):
    doc = manifest.doc
    assert set(doc) == KEYS
    assert doc["command"] == ["python3", "benchmark/run.py"]
    assert doc["paths"] == ["benchmark"]
    assert 1 <= doc["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_entry_keys(manifest):
    doc = manifest.doc
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in doc[k]]
    assert all(NAME.match(n) for n in names), names
    assert len({e["name"] for e in doc["end_to_end"] + doc["per_layer"]}) \
        == len(doc["end_to_end"]) + len(doc["per_layer"])
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in doc["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in doc["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"])
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}
    assert "setup_s" in {m["name"] for m in doc["end_to_end"]}


def test_cells_configs_traffic_and_limits_found_by_name(manifest):
    for w in manifest.doc["workloads"]:
        cell = manifest.cell(w["name"])
        doc = manifest.config(cell)
        assert doc["name"] == cell["config"]
        assert manifest.reference(doc["reference"]).param_specs(doc["values"])
        assert {"scene", "checked_steps", "warmup_steps"} \
            <= set(manifest.traffic(cell))
        limits = manifest.limits(cell)
        assert limits and set(limits) <= set(check.NUMBERS)
        assert {"data_gap", "loss_gap"} <= set(limits)
        assert all(v is not None and v >= 0 for v in limits.values())


def test_every_metric_has_a_reader(manifest):
    for w in manifest.doc["workloads"]:
        cell = manifest.cell(w["name"])
        for kind in ("end_to_end", "per_layer"):
            found = readers(manifest, cell, kind)
            assert found and all(hasattr(r, "read")
                                 for _, r in found.values())
        e2e = {m["name"] for m in manifest.metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_config_files_hold_what_the_program_resolves(manifest, tmp_path):
    from benchmark.harness import load_config
    for c in manifest.doc["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            doc = json.load(f)
        load_config(doc, str(tmp_path), str(tmp_path), 1)  # raises on a gap
