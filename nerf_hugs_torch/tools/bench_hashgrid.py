"""Times the hash-grid kernels of csrc/hashgrid.cu against an earlier
hashgrid.cu with the same C interface, in one process on one card, and the
train step of several checkouts.

    python -m nerf_hugs_torch.tools.bench_hashgrid kernels \\
        [--baseline OLD_HASHGRID_CU] [--captured] [--out JSON]
    python -m nerf_hugs_torch.tools.bench_hashgrid train ROOT [ROOT ...] \\
        [--steps 48] [--runs RUN [RUN ...]] [--profile] [--out JSON]

`kernels` loads the package's kernels (ops/kernels.py) and, with
--baseline, builds the given hashgrid.cu with the same nvcc flags into a
scratch library (for example the parent commit's, unpacked with
`git archive`). On the field's and the proposal's grids of
kubric_nerfacto_base it times each build's forward and table gradient
(gradient zeroing included, as the wrapper does) on uniform positions of
the main path's [16384, samples per ray, 3] shapes and, with --captured,
on the positions and output gradients the full-width model hands its
encoders in one batch of compute_loss + backward
(hashgrid_inputs.capture_hashgrid_inputs). Every build's outputs are first
checked against the plain versions (forward within 1e-6 absolute, table
gradient within 1e-5 of its largest entry). Each reading is a median of 10
CUDA-event runs; the builds are timed in turns, A B B A three times, six
readings each.

`train` runs `python -m nerf_hugs_torch.train` from each checkout ROOT in
the order given (e.g. parent, change, change, parent), once per RUN in the
order given, and reports the steps/s over steps 9 to the last from the
driver's print lines. A RUN is `base-synthetic` (the default: Dense
kubric_nerfacto_base on the procedural scene of hashgrid_inputs.base_yaml),
`base-kubric` (the same on the scene of hashgrid_inputs.write_kubric_scene,
through the kubric loader), `hanerf-distractor` and
`robustnerf-distractor` (distractor_nerfacto_hanerf.yml and
distractor_nerfacto_robustnerf0.8.yml on the capture of
hashgrid_inputs.write_colmap_scene in the distractor layout),
`nerfw-phototourism` (phototourism_nerfacto_nerfw.yml on the capture in the
phototourism layout, its finetune stage as long as the train stage, both
reported) or
`fused-synthetic` (base-synthetic with enable_tcnn_mlp on for the field
and the proposal). With --profile it then runs, per distinct ROOT, RUN
and stage, 8 warm-up and 5 profiled steps under torch.profiler
(RobustNeRF's thresholds carried from step to step; the finetune stage
from the model as initialised) and reports device ms per step of
the hash-grid kernels, of the fused MLP's forward kernels and of all
kernels, and the host's wall ms per profiled step.

Needs a card; the builds need nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

from nerf_hugs_torch.ops import hashgrid, hashgrid_bwd, kernels
from nerf_hugs_torch.tools import hashgrid_inputs

RUNS = 10


def build_baseline(src: str, tmp: str,
                   names=("hashgrid_fwd", "hashgrid_bwd")):
    """Build `src` with the flags of ops/kernels.py into a library in `tmp`
    and bind its entry points `names` with the package's signatures."""
    path = os.path.join(tmp, "libbaseline.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", path,
                           src], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    for line in proc.stdout.splitlines():
        if re.search(r"Used \d+ registers|spill", line):
            print(f"ptxas baseline: {line.strip()}", flush=True)
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = kernels.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def runners(lib):
    """(forward, table gradient) callables of one build on (spec, table,
    positions, grad_out)."""

    def fwd(spec, table, p, g):
        out = torch.empty(p.shape[:-1] + (spec.output_dim,),
                          device=table.device)
        hashgrid.launch_encode(lib, table, p, out, spec)
        return out

    def bwd(spec, table, p, g):
        grad = torch.zeros_like(table)
        hashgrid_bwd.launch_table_grad(lib, p, g, grad, spec)
        return grad

    return fwd, bwd


def median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def input_sets(captured: bool, tmp: str):
    """[(label, spec, positions, grad_out)] at kubric_nerfacto_base."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = hashgrid_inputs.BATCH
    sets = []
    for name, kw, n_main in hashgrid_inputs.GRIDS[:2]:
        spec = hashgrid.HashGridSpec(**kw)
        shape = (batch, n_main // batch)
        sets.append((f"{name} uniform", spec,
                     torch.rand(shape + (3,), generator=gen, device="cuda"),
                     torch.randn(shape + (spec.output_dim,), generator=gen,
                                 device="cuda")))
    if captured:
        inputs = hashgrid_inputs.capture_hashgrid_inputs(
            hashgrid_inputs.base_yaml(tmp, fused=False), tmp, "cuda")
        for name in ("field", "proposal"):
            spec, p, g = inputs[name]
            print(f"capture {name}: "
                  + hashgrid_inputs.capture_shares(spec, p, g), flush=True)
            sets.append((f"{name} captured", spec, p, g))
    return sets


def kernels_main(args) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        builds = [("shipped", runners(kernels.load()))]
        if args.baseline:
            builds.insert(0, ("baseline", runners(
                build_baseline(args.baseline, tmp))))
        report = {"device": smi, "sets": {}}
        for label, spec, p, g in input_sets(args.captured, tmp):
            table = torch.rand(spec.num_rows * 2, generator=torch.Generator(
                device="cuda").manual_seed(1), device="cuda") * 2 - 1
            want_f = hashgrid.hashgrid_encode_plain(table, p, spec)
            want_b = hashgrid_bwd.hashgrid_table_grad_plain(p, g, spec)
            scale = float(want_b.abs().max())
            for name, (fwd, bwd) in builds:
                err_f = float((fwd(spec, table, p, g) - want_f).abs().max())
                err_b = float((bwd(spec, table, p, g) - want_b).abs().max())
                if not (err_f <= 1e-6 and err_b <= 1e-5 * scale):
                    raise RuntimeError(f"{name} disagrees with the plain "
                                       f"versions on {label}: {err_f}, "
                                       f"{err_b / scale}")
            del want_f, want_b
            times = {name: {"fwd": [], "bwd": []} for name, _ in builds}
            for order in (builds, builds[::-1]) * 3:   # A B B A, three times
                for name, (fwd, bwd) in order:
                    for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                        times[name][kind].append(median_ms(
                            lambda: fn(spec, table, p, g)))
            report["sets"][label] = times
            for name, t in times.items():
                print(f"{label:18s} {name:9s} fwd " + " / ".join(
                    f"{x:.3f}" for x in t["fwd"]) + " ms   table-grad "
                    + " / ".join(f"{x:.3f}" for x in t["bwd"]) + " ms",
                    flush=True)
            del table
    return report


def train_rates(root: str, cfg: str, data_dir: str, tmp: str, run: int,
                first: int) -> dict:
    """{stage: steps/s over steps `first`..last} of one training run from
    `root` (the finetune stage too where the config has one)."""
    save_dir = os.path.join(tmp, "exp", f"run{run}")
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-m", "nerf_hugs_torch.train",
                    "--config", cfg, "--data_dir", data_dir, "--save_dir",
                    save_dir, "--device", "cuda"], cwd=root, env=env,
                   check=True, stdout=subprocess.DEVNULL)
    with open(os.path.join(save_dir, "run_log.log")) as f:
        log = f.read()
    shutil.rmtree(save_dir)       # the checkpoint and Adam state
    out = {}
    for stage in ("train", "finetune"):
        rates = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
            rf"\[{stage}\] (\d+)/\d+: .* (\S+) steps/s", log)}
        steps = [s for s in sorted(rates) if s >= first]
        if steps:
            out[stage] = len(steps) / sum(1.0 / rates[s] for s in steps)
    return out


PROFILE_WORKER = r"""
import json, sys, time, torch
from torch.profiler import ProfilerActivity, profile
from nerf_hugs_torch.models.nerfacto import NerfactoModel
from nerf_hugs_torch.train import driver, step as step_lib
cfg, data_dir, stage = sys.argv[1], sys.argv[2], sys.argv[5]
warm, active = int(sys.argv[3]), int(sys.argv[4])
config = driver.load_config(cfg, data_dir, data_dir + "/profile_ckpt")
model = NerfactoModel(config, "cuda",
                      torch.Generator().manual_seed(config.seed))
finetune = stage == "finetune"
optimizer, scheduler = (step_lib.create_finetune_optimizer if finetune
                        else step_lib.create_optimizer)(config, model)
dataset = driver.stage_dataset(stage, config)
rng = torch.Generator(device="cuda").manual_seed(config.seed + 1)
thresholds = [step_lib.initial_inlier_thresholds(config, "cuda")]
def run(step):
    frac = 1.0 if finetune else (step - 1) / max(config.max_steps - 1, 1)
    stats = step_lib.train_step(model, optimizer, scheduler,
                                next(dataset).to("cuda"), frac, config, rng,
                                thresholds[0], finetune)
    thresholds[0] = stats.get("robust_inlier_threshold", thresholds[0])
for step in range(1, warm + 1):
    run(step)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.time()
    for step in range(warm + 1, warm + active + 1):
        run(step)
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3 / active
ms = {}
for e in prof.key_averages():
    if e.device_type == torch.autograd.DeviceType.CUDA:
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        ms[e.key] = [t / 1e3 / active, e.count / active]
print("PROFILE " + json.dumps({"kernels": ms, "wall_ms": wall}))
"""


def profile_steps(root: str, cfg: str, data_dir: str, stage: str = "train",
                  warm: int = 8, active: int = 5) -> dict:
    """Device ms and launches per step of `stage` (`train` or
    `finetune`, from the model as initialised), by kernel name, of
    `active` profiled steps after `warm` steps, in a process importing
    `root`."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", PROFILE_WORKER, cfg, data_dir,
                          str(warm), str(active), stage], cwd=root, env=env,
                         check=True, capture_output=True, text=True).stdout
    report = json.loads(out.split("PROFILE ", 1)[1])
    ms = report["kernels"]
    group = lambda key: sum(v[0] for k, v in ms.items() if key in k)
    return {"hashgrid_fwd_ms": group("hashgrid_fwd"),
            "hashgrid_bwd_ms": group("hashgrid_bwd"),
            "fused_mlp_ms": group("fused_mlp"),
            "device_ms": sum(v[0] for v in ms.values()),
            "wall_ms": report["wall_ms"],
            "hashgrid_kernels": {k: v for k, v in ms.items()
                                 if "hashgrid" in k}}


RUNS_TRAIN = ("base-synthetic", "base-kubric", "hanerf-distractor",
              "robustnerf-distractor", "nerfw-phototourism",
              "fused-synthetic")
# The shipped configs of the transient runs.
SHIPPED_RUNS = {"hanerf-distractor": "distractor_nerfacto_hanerf",
                "robustnerf-distractor": "distractor_nerfacto_robustnerf0.8",
                "nerfw-phototourism": "phototourism_nerfacto_nerfw"}


def run_inputs(run: str, tmp: str, steps: int):
    """(config path, data dir) of one RUN."""
    scene_name = run.split("-")[1]
    scene = os.path.join(tmp, scene_name)
    if scene_name == "kubric" and not os.path.isdir(scene):
        hashgrid_inputs.write_kubric_scene(scene)
    if run in SHIPPED_RUNS:
        data_dir = hashgrid_inputs.write_colmap_scene(
            os.path.join(tmp, f"scene_{run}"), scene_name)
        return hashgrid_inputs.shipped_yaml(
            tmp, SHIPPED_RUNS[run], steps=steps, finetune_num_steps=steps), \
            data_dir
    mlp = run.split("-")[0]
    cfg = hashgrid_inputs.base_yaml(tmp, fused=mlp == "fused", steps=steps,
                                    scene=scene_name)
    return cfg, (scene if scene_name == "kubric" else tmp)


def train_main(args) -> dict:
    report = {"rates": [], "profiles": {}}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = {run: run_inputs(run, tmp, args.steps)
                  for run in dict.fromkeys(args.runs)}
        stages = {}
        i = 0
        for root in args.roots:
            for run in args.runs:
                rates = train_rates(os.path.abspath(root), *inputs[run], tmp,
                                    i, 9)
                i += 1
                for stage, rate in rates.items():
                    report["rates"].append({"root": root, "run": run,
                                            "stage": stage,
                                            "steps_per_s": rate})
                    print(f"{stage} {root} {run}: {rate:.3f} steps/s over "
                          f"steps 9-{args.steps}", flush=True)
                stages[run] = list(rates)
        if args.profile:
            for root in dict.fromkeys(args.roots):
                for run, stage in ((r, s) for r in dict.fromkeys(args.runs)
                                   for s in stages[r]):
                    prof = profile_steps(os.path.abspath(root), *inputs[run],
                                         stage)
                    report["profiles"][f"{root} {run} {stage}"] = prof
                    print(f"profile {root} {run} {stage}: per step "
                          f"hashgrid_fwd "
                          f"{prof['hashgrid_fwd_ms']:.3f} ms, hashgrid_bwd "
                          f"{prof['hashgrid_bwd_ms']:.3f} ms, fused MLP "
                          f"forward {prof['fused_mlp_ms']:.3f} ms, all kernels "
                          f"{prof['device_ms']:.3f} ms, wall "
                          f"{prof['wall_ms']:.3f} ms (busy share "
                          f"{prof['device_ms'] / prof['wall_ms']:.3f}); "
                          f"{prof['hashgrid_kernels']}", flush=True)
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--baseline", help="a hashgrid.cu with the same C "
                   "interface, timed beside the package's kernels")
    k.add_argument("--captured", action="store_true",
                   help="also time on the main path's captured inputs")
    t = sub.add_parser("train")
    t.add_argument("roots", nargs="+", help="checkouts to train from")
    t.add_argument("--steps", type=int, default=48)
    t.add_argument("--runs", nargs="+", choices=RUNS_TRAIN,
                   default=["base-synthetic"],
                   help="configs and scenes to train, in this order")
    t.add_argument("--profile", action="store_true")
    for p in (k, t):
        p.add_argument("--out", help="write the report here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_hashgrid needs a CUDA device")
    report = kernels_main(args) if args.mode == "kernels" else \
        train_main(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
