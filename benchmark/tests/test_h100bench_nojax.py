"""Nothing the benchmark runs imports the JAX side: a fresh interpreter
imports the runner, the harness, the control, every reader and reference,
and the port's modules a run drives, then lists sys.modules by whole
top-level names."""

import json
import os
import subprocess
import sys

from h100bench_util import REPO

PROBE = r"""
import glob, json, os, sys
sys.path.insert(0, {repo!r})
import benchmark.run, benchmark.control, benchmark.harness, benchmark.check
from benchmark.manifest import Manifest
m = Manifest({repo!r})
for path in glob.glob(os.path.join({repo!r}, "benchmark", "metrics", "*.py")):
    m.reader(os.path.basename(path)[:-3])
for path in glob.glob(os.path.join({repo!r}, "benchmark", "reference", "*.py")):
    name = os.path.basename(path)[:-3]
    if name != "__init__":
        m.reference(name)
import nerf_hugs_torch.train.driver, nerf_hugs_torch.train.step
import nerf_hugs_torch.models, nerf_hugs_torch.configs.yaml_loader
import nerf_hugs_torch.configs.gin_parser
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def test_no_module_of_the_jax_side_is_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-S", "-c",
                          PROBE.format(repo=REPO)], capture_output=True,
                         text=True, env=env, cwd=REPO)
    if out.returncode:
        # -S drops site-packages on some installations: retry with them.
        out = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO)],
                             capture_output=True, text=True, env=env,
                             cwd=REPO)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmark" in tops and "nerf_hugs_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "optax", "nerf_hugs_tpu"}


def test_the_comparison_is_by_whole_names(monkeypatch):
    from benchmark import run
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nerf_hugs_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping.sub", sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "nerf_hugs_tpu.models", sys)
    assert "nerf_hugs_tpu" in run.forbidden_modules()
