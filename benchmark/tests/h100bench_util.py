"""A checkout of the benchmark at tiny sizes for the CPU tests: a copy of
benchmark/ beside a BENCHMARK.json whose cells are added as a later change
adds them, by new files and entries."""

from __future__ import annotations

import copy
import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_SCENE = {"num_train": 4, "size": 32, "factor": 2, "world_scale": 0.5}
TINY_NERFACTO = {
    "base": {"batch_size": 256, "patch_size": 4, "num_img_per_batch": 4,
             "num_steps": 25000},
    "model": {"hidden_dim": 16, "hidden_dim_color": 16, "geo_feat_dim": 15,
              "num_levels": 4, "log2_hashmap_size": 12, "max_res": 64,
              "num_nerf_samples_per_ray": 8,
              "num_proposal_samples_per_ray": [16],
              "proposal_net_args_list": [
                  {"base_res": 16, "features_per_level": 2, "hidden_dim": 8,
                   "log2_hashmap_size": 10, "max_res": 32,
                   "num_levels": 2}]}}
TINY_MIP = ["Config.batch_size = 256", "Config.image_num_per_batch = 4",
            "Config.patch_size = 4", "NerfMLP.net_depth = 6",
            "NerfMLP.net_width = 32", "NerfMLP.bottleneck_width = 16",
            "NerfMLP.net_width_viewdirs = 16", "PropMLP.net_depth = 2",
            "PropMLP.net_width = 16", "Model.num_prop_samples = 8",
            "Model.num_nerf_samples = 6"]
OPEN_LIMITS = {"data_gap": 1e-5, "loss_gap": 0.05, "grad_norm_gap": 0.05,
               "change_norm_gap": 0.05}


def make_checkout(tmp: str) -> str:
    """tmp/ with BENCHMARK.json and benchmark/ copied from the repo."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp


def add_config(root: str, name: str, like: str, program, values_from=None):
    """A configuration file `name` made from the file of `like` with
    `program` in place of its program text; its values are the program's
    resolution of that text (the keys of `like`)."""
    from benchmark.harness import _plain, dotted, load_config
    with open(os.path.join(root, "benchmark", "configs",
                           f"{like}.json")) as f:
        doc = json.load(f)
    doc = copy.deepcopy(doc)
    doc["name"], doc["program"] = name, program
    probe = dict(doc, values={})
    os.makedirs(os.path.join(root, "probe"), exist_ok=True)
    config = load_config(probe, os.path.join(root, "probe"), root, 0)
    doc["values"] = {k: _plain(dotted(config, k)) for k in doc["values"]}
    path = os.path.join("benchmark", "configs", f"{name}.json")
    with open(os.path.join(root, path), "w") as f:
        json.dump(doc, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": name, "source": "tiny widths",
                                "file": path, "reduced": [],
                                "why": "CPU test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)


def add_cell(root: str, name: str, config: str, limits=None,
             scene=None, warmup_steps: int = 4) -> None:
    """A cell `name` of `config` with its own traffic file (`name`) and
    limits."""
    traffic = {"scene": scene or TINY_SCENE, "checked_steps": 3,
               "warmup_steps": warmup_steps}
    for sub, doc in (("traffic", traffic),
                     ("workloads", {"limits": limits or OPEN_LIMITS})):
        with open(os.path.join(root, "benchmark", sub, f"{name}.json"),
                  "w") as f:
            json.dump(doc, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": name, "config": config,
                                  "traffic": name, "chips": 1,
                                  "why": "CPU test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)


def tiny_checkout(tmp: str) -> str:
    """A checkout with the tiny cells tiny_nerfacto.train and
    tiny_mip.train."""
    root = make_checkout(tmp)
    with open(os.path.join(root, "benchmark", "configs",
                           "kubric_nerfacto_base.json")) as f:
        base = json.load(f)["program"]
    program = copy.deepcopy(base)
    program["base"].update(TINY_NERFACTO["base"])
    program["model"].update(TINY_NERFACTO["model"])
    add_config(root, "tiny_nerfacto", "kubric_nerfacto_base", program)
    with open(os.path.join(root, "benchmark", "configs",
                           "kubric_1024_base_tpu_bf16.json")) as f:
        mip = json.load(f)["program"]
    add_config(root, "tiny_mip", "kubric_1024_base_tpu_bf16", mip + TINY_MIP)
    add_cell(root, "tiny_nerfacto.train", "tiny_nerfacto")
    add_cell(root, "tiny_mip.train", "tiny_mip")
    return root


def run_cell(root: str, cell: str, seed: int = 3, seconds: float = 0.5,
             trace: int = 0, trainee_factory=None):
    """(exit code, result line) of a run of `cell` on the CPU."""
    import contextlib
    import io
    from benchmark import run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace),
                         "--sidecar-dir", os.path.join(root, "sidecar")],
                        root=root, trainee_factory=trainee_factory,
                        device_check=lambda n: torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return code, json.loads(lines[-1]) if lines else None
