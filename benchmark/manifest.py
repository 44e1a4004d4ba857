"""What a run finds by name: the cell of BENCHMARK.json, its
configuration's file, its traffic's file, its own file (the limits of its
comparison) and the reader of each metric it reports.

    benchmark/configs/<config>.json     what the configuration runs
    benchmark/traffic/<traffic>.json    the scene and the loop's parameters
    benchmark/workloads/<cell>.json     the cell's limits
    benchmark/metrics/<metric>.py       read(window) -> number or None
    benchmark/reference/<reference>.py  the plain model a config names

A new configuration, traffic mix, cell or metric is a new file and an
entry in BENCHMARK.json; no file here changes.

A traffic file's `scene` gives the capture's num_train, size, factor and
world_scale, and with "static_masks": true HuGS's static mask of each
train frame (0 on its distractor square). A reference's `loss(params,
rays, rgb, train_frac, generator, values, precision)` is handed, for each
ray, the float32 [n, k] fields origins, directions, viewdirs, radii, near,
far (harness.RAY_FIELDS), pix_coords (the pixel's centre over the image's
width and height), static_mask (in [0, 1]) and the int32 [n, 1] embed_idx
(the image's place in the train split) (harness.PIXEL_FIELDS), all recast
from the scene's files; it reads those it needs. check.py's data_gap takes
the program's gap from the recast in every one of them and in the colours.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    """BENCHMARK.json at `root` and the benchmark's files under
    root/benchmark."""

    def __init__(self, root: str):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        self.doc = _read_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.doc["configs"]
                     if c["name"] == cell["config"])
        doc = _read_json(os.path.join(self.root, entry["file"]))
        if doc.get("name") != entry["name"]:
            raise ValueError(f"{entry['file']} is not the file of "
                             f"{entry['name']}")
        return doc

    def traffic(self, cell: dict) -> dict:
        return _read_json(os.path.join(self.bench_dir, "traffic",
                                       f"{cell['traffic']}.json"))

    def limits(self, cell: dict) -> dict:
        return _read_json(os.path.join(self.bench_dir, "workloads",
                                       f"{cell['name']}.json"))["limits"]

    def metrics(self, cell: dict, kind: str) -> List[dict]:
        """The `end_to_end` or `per_layer` entries this cell reports."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{metric}.py"), f"metric_{metric}")

    def reference(self, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, "reference",
                                        f"{name}.py"), f"reference_{name}")


def load_module(path: str, name: str) -> ModuleType:
    """The module of a file, by its path (a metric's name holds dots)."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def readers(manifest: Manifest, cell: dict, kind: str) -> Dict[str, tuple]:
    """{metric name: (entry, reader module)} of a cell."""
    return {m["name"]: (m, manifest.reader(m["name"]))
            for m in manifest.metrics(cell, kind)}
