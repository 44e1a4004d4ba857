"""Times the hash-grid kernels of csrc/hashgrid.cu against an earlier
hashgrid.cu with the same C interface, in one process on one card, and the
train step of several checkouts.

    python -m nerf_hugs_torch.tools.bench_hashgrid kernels \\
        [--baseline OLD_HASHGRID_CU] [--captured] [--out JSON]
    python -m nerf_hugs_torch.tools.bench_hashgrid train ROOT [ROOT ...] \\
        [--steps 48] [--runs RUN [RUN ...]] [--profile] [--out JSON]
    python -m nerf_hugs_torch.tools.bench_hashgrid wrappers ROOT [ROOT ...] \\
        [--out JSON]
    python -m nerf_hugs_torch.tools.bench_hashgrid host [--reps 2000] \\
        [--out JSON]

`kernels` loads the package's kernels (ops/kernels.py) and, with
--baseline, builds the given hashgrid.cu with the same nvcc flags into a
scratch library (for example the parent commit's, unpacked with
`git archive`). On the field's and the proposal's grids of
kubric_nerfacto_base it times each build's forward and table gradient
(gradient zeroing included, as the wrapper does) on uniform positions of
the main path's [16384, samples per ray, 3] shapes, and on HA-NeRF's 2-D
mask grid (models/nerfacto.py MASK_GRID) at its 16384 pixel centres of
16x16 patches (one position per ray) and at 2^20 uniform positions; with
--captured also on the positions and output gradients the full-width
models hand their encoders in one batch of compute_loss + backward
(hashgrid_inputs.capture_hashgrid_inputs: kubric_nerfacto_base's field and
proposal, distractor_nerfacto_hanerf's mask on a written distractor
capture). Every build's outputs are first checked against the plain
versions (forward within 1e-6 absolute, table gradient within 1e-5 of its
largest entry). Each wrapper reading is a median of 10 CUDA-event runs
around one wrapper call (the host's launch path included); the builds are
timed in turns, A B B A three times, six readings each. Then each
kernel alone, the mean device time of 20 calls from a torch.profiler
trace; the library yardsticks (`yardsticks`: embedding_bag and
index_add_ on the corner rows and weights computed beforehand); and the
bounds (`bounds`).

`wrappers` times, in a process importing each checkout ROOT in the order
given (e.g. parent, change, change, parent), that checkout's own wrappers
`hashgrid_fwd` and `hashgrid_table_grad` (its host path and its kernels)
on the same inputs, made from a seed: HA-NeRF's mask grid at its 16384
pixel centres and at 2^20 uniform positions, and kubric_nerfacto_base's
field and proposal grids on uniform positions of their main-path shapes;
each reading a median of 50 CUDA-event runs around one call (the host's
jitter moves a 0.03-0.08 ms call). At the pixel centres, where the host
sets a call's time, also the mean host microseconds a call over 1000
calls back to back (`fwd_host_us`, `bwd_host_us`), the device
synchronised before and after them.

`host` breaks the hash-grid wrappers' host path into its steps: the mean
host microseconds per call of each (kernel_spec, the device and tensor
checks, the output allocation, the level table's pointer, the current
device, the raw stream, the ctypes call without and with a launch, the
launch counter), of the PyTorch calls an earlier path made in their place
(torch.device, torch.empty and torch.zeros with a device argument,
torch.cuda.current_stream) and of the two wrappers whole, at HA-NeRF's
mask grid on its 16384 pixel centres.

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
# NVIDIA H100 SXM data sheet: memory rate and the fp32 FMA peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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


def yardsticks(spec, table, p, g):
    """One PyTorch call for each kernel's function, fed the corner rows
    and weights computed here (outside any timing): (embedding_bag with
    per-sample weights for the forward's weighted gather, index_add_ into
    a zeroed gradient for the table gradient's scatter, the number of
    distinct table rows the samples touch)."""
    pos = p.reshape(-1, spec.num_dims)
    offsets = hashgrid.grid_constants(spec).level_offsets
    rows, weights = [], []
    for lvl in range(spec.num_levels):
        r, w = hashgrid.corner_rows_level(spec, pos, lvl)
        rows.append(r.t() + int(offsets[lvl]))
        weights.append(w.t())
    corners = 2 ** spec.num_dims
    rows = torch.stack(rows, 1).reshape(-1, corners)        # [n * L, 2^d]
    weights = torch.stack(weights, 1).reshape(-1, corners)
    f = spec.features_per_level
    tab = table.view(-1, f)
    keys = rows.reshape(-1)
    vals = (weights[..., None] * g.reshape(-1, 1, f)).reshape(-1, f)
    fwd = lambda: torch.nn.functional.embedding_bag(
        rows, tab, per_sample_weights=weights, mode="sum")
    bwd = lambda: torch.zeros_like(tab).index_add_(0, keys, vals)
    return fwd, bwd, int(torch.unique(keys).numel())


def bounds(spec, table, p, g, rows_touched: int):
    """((ms, set by, bytes) of the forward, the same of the table
    gradient): the least time the card could take, the larger of the
    bytes over the memory rate and the fp32 operations over the FMA peak.
    Each kernel reads the positions and the [n, L*F] array (output
    gradient) or writes it (features) once; the forward reads the table
    rows these samples touch, the table gradient writes the whole table.
    Per sample and level the work is (d - 1) products for each of the 2^d
    corner weights and 4 operations per corner of the weighted sums."""
    n = p.numel() // spec.num_dims
    flops = (spec.num_dims - 1 + 4) * 2 ** spec.num_dims * n \
        * spec.num_levels
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    row_bytes = spec.features_per_level * table.element_size()
    out = []
    for nbytes in (size(p, g) + rows_touched * row_bytes,
                   size(p, g, table)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        out.append((t_bytes, "bytes", nbytes) if t_bytes >= t_ops
                   else (t_ops, "operations", nbytes))
    return tuple(out)


def device_ms(fn, kernel: str, runs: int = 20):
    """Mean device ms per call of `fn` of the CUDA kernels whose name holds
    `kernel`, from a torch.profiler trace (None if it recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if kernel in e.key)
    return total / runs / 1e3 if total > 0 else None


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
    """[(label, spec, positions, grad_out)] at kubric_nerfacto_base's
    grids and HA-NeRF's mask grid."""
    from nerf_hugs_torch.models.nerfacto import MASK_GRID
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = hashgrid_inputs.BATCH
    sets = []
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    for name, kw, n_main in hashgrid_inputs.GRIDS[:2]:
        spec = hashgrid.HashGridSpec(**kw)
        shape = (batch, n_main // batch)
        sets.append((f"{name} uniform", spec,
                     torch.rand(shape + (3,), generator=gen, device="cuda"),
                     randn(*shape, spec.output_dim)))
    n_mask = hashgrid_inputs.MASK_N
    sets.append(("mask pixel centres", MASK_GRID,
                 hashgrid_inputs.pixel_centres(gen, n_mask),
                 randn(n_mask, MASK_GRID.output_dim)))
    sets.append(("mask 2^20 uniform", MASK_GRID,
                 torch.rand((1 << 20, 2), generator=gen, device="cuda"),
                 randn(1 << 20, MASK_GRID.output_dim)))
    if captured:
        inputs = hashgrid_inputs.capture_hashgrid_inputs(
            hashgrid_inputs.base_yaml(tmp, fused=False), tmp, "cuda")
        scene = hashgrid_inputs.write_colmap_scene(
            os.path.join(tmp, "distractor"), "distractor")
        inputs.update(hashgrid_inputs.capture_hashgrid_inputs(
            hashgrid_inputs.shipped_yaml(tmp, "distractor_nerfacto_hanerf"),
            scene, "cuda", ("mask",)))
        for name in ("field", "proposal", "mask"):
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
            for name, (fwd, bwd) in builds:
                for kind, fn in (("fwd", fwd), ("bwd", bwd)):
                    times[name][f"{kind}_alone"] = device_ms(
                        lambda: fn(spec, table, p, g), f"hashgrid_{kind}")
            shown = lambda v: "not measured" if v is None else f"{v:.4f}"
            for name, t in times.items():
                print(f"{label:18s} {name:9s} fwd " + " / ".join(
                    f"{x:.4f}" for x in t["fwd"]) + " ms (alone "
                    f"{shown(t['fwd_alone'])})   table-grad " + " / ".join(
                        f"{x:.4f}" for x in t["bwd"]) + " ms (alone "
                    f"{shown(t['bwd_alone'])})", flush=True)
            lib_fwd, lib_bwd, touched = yardsticks(spec, table, p, g)
            (fb, fby, _), (bb, bby, _) = bounds(spec, table, p, g, touched)
            times["library"] = {"fwd": median_ms(lib_fwd),
                                "bwd": median_ms(lib_bwd)}
            times["bound"] = {"fwd": fb, "fwd_by": fby, "bwd": bb,
                              "bwd_by": bby}
            print(f"{label:18s} embedding_bag {times['library']['fwd']:.4f} "
                  f"ms, index_add_ {times['library']['bwd']:.4f} ms; bounds "
                  f"fwd {fb:.4f} ms ({fby}), table-grad {bb:.4f} ms ({bby})",
                  flush=True)
            report["sets"][label] = times
            del table, lib_fwd, lib_bwd
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


# Makes its own inputs (the same in every checkout from the seed): a
# checkout may predate hashgrid_inputs.pixel_centres.
WRAPPER_WORKER = r"""
import json, statistics, time, torch
from nerf_hugs_torch.ops import hashgrid, hashgrid_bwd
from nerf_hugs_torch.models.nerfacto import MASK_GRID
gen = torch.Generator(device="cuda").manual_seed(0)
def pixel_centres(n, size=256, patch=16):
    d = torch.arange(patch, device="cuda")
    offs = torch.stack(torch.meshgrid(d, d, indexing="xy"), -1).reshape(-1, 2)
    corner = torch.randint(0, size - patch + 1, (n // patch ** 2, 1, 2),
                           generator=gen, device="cuda")
    return ((corner + offs).reshape(-1, 2).float() + 0.5) / size
def median_ms(fn):
    fn()
    times = []
    for _ in range(50):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
def host_us(fn, reps=1000):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6
sets = [("mask pixel centres", MASK_GRID, pixel_centres(16384)),
        ("mask 2^20 uniform", MASK_GRID,
         torch.rand((1 << 20, 2), generator=gen, device="cuda"))]
for name, kw, shape in (
        ("field uniform", dict(num_levels=16, log2_hashmap_size=21,
                               base_res=16, max_res=8192), (16384, 128)),
        ("proposal uniform", dict(num_levels=7, log2_hashmap_size=17,
                                  base_res=16, max_res=2048), (16384, 256))):
    sets.append((name, hashgrid.HashGridSpec(**kw),
                 torch.rand(shape + (3,), generator=gen, device="cuda")))
out = {}
for name, spec, p in sets:
    table = torch.rand(spec.num_rows * 2, generator=gen, device="cuda")
    g = torch.randn(p.shape[:-1] + (spec.output_dim,), generator=gen,
                    device="cuda")
    fwd = lambda: hashgrid.hashgrid_fwd(table, p, spec)
    bwd = lambda: hashgrid_bwd.hashgrid_table_grad(p, g, spec)
    out[name] = {"fwd": median_ms(fwd), "bwd": median_ms(bwd)}
    if name == "mask pixel centres":
        out[name].update(fwd_host_us=host_us(fwd), bwd_host_us=host_us(bwd))
    del table, g
print("WRAPPERS " + json.dumps(out))
"""


def wrappers_main(args) -> dict:
    report = {"runs": []}
    for root in args.roots:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
        out = subprocess.run([sys.executable, "-c", WRAPPER_WORKER],
                             cwd=os.path.abspath(root), env=env, check=True,
                             capture_output=True, text=True).stdout
        times = json.loads(out.split("WRAPPERS ", 1)[1])
        report["runs"].append({"root": root, "times": times})
        for name, t in times.items():
            host = (f"; back to back {t['fwd_host_us']:.2f} / "
                    f"{t['bwd_host_us']:.2f} us a call"
                    if "fwd_host_us" in t else "")
            print(f"wrappers {root} {name}: fwd {t['fwd']:.4f} ms, "
                  f"table-grad {t['bwd']:.4f} ms{host}", flush=True)
    return report


def host_main(args) -> dict:
    """Host microseconds per call of each step of the hash-grid wrappers'
    launch path, and of the PyTorch calls an earlier path made instead, at
    HA-NeRF's mask grid on its 16384 pixel centres: the mean of `reps`
    calls after a warm-up, the device synchronised before each step."""
    import time
    from nerf_hugs_torch.models.nerfacto import MASK_GRID as spec
    reps = args.reps
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = hashgrid_inputs.MASK_N
    p = hashgrid_inputs.pixel_centres(gen, n)
    g = torch.randn((n, spec.output_dim), generator=gen, device="cuda")
    table = torch.rand(spec.num_rows * 2, generator=gen, device="cuda")
    out = torch.empty((n, spec.output_dim), device="cuda")
    lib = kernels.load()
    k = hashgrid.kernel_spec(spec)
    index = table.get_device()
    device = table.device
    shape = (n, spec.output_dim)
    fwd_args = lambda count: (
        table.data_ptr(), p.data_ptr(), out.data_ptr(), count, k.num_levels,
        k.num_dims, k.hash_mask, k.hash_add, k.levels_on(index),
        kernels.current_stream(index))
    args0, args_n = fwd_args(0), fwd_args(n)
    level_tables = {(spec, device): None}
    steps = {
        # This path's steps.
        "kernel_spec (cached per spec)": lambda: hashgrid.kernel_spec(spec),
        "check_devices (get_device)": lambda: hashgrid.check_devices(
            "table", table, "positions", p),
        "check_tensor x3": lambda: (hashgrid.check_tensor("table", table,
                                                          True),
                                    hashgrid.check_tensor("positions", p),
                                    hashgrid.check_tensor("out", out)),
        "table.new_empty (features)": lambda: table.new_empty(shape),
        "positions.new_zeros (table gradient)": lambda: p.new_zeros(
            k.values),
        "levels_on (by device index)": lambda: k.levels_on(index),
        "on_device (current_device)": lambda: kernels.on_device(index),
        "current_stream (raw)": lambda: kernels.current_stream(index),
        "ctypes hashgrid_fwd, n = 0 (no launch)": lambda: lib.hashgrid_fwd(
            *args0),
        "ctypes hashgrid_fwd, launch": lambda: lib.hashgrid_fwd(*args_n),
        "count_launch": lambda: hashgrid.count_launch(hashgrid.hashgrid_fwd,
                                                      k),
        # What an earlier path called instead.
        "torch.device + dict lookup by (spec, device)":
            lambda: level_tables.get((spec, torch.device(device))),
        "tensor.device x2 and compare": lambda: table.device == p.device,
        "torch.empty(device=...)": lambda: torch.empty(
            shape, dtype=torch.float32, device=device),
        "torch.zeros(device=...)": lambda: torch.zeros(
            k.values, dtype=torch.float32, device=device),
        "torch.cuda.current_stream(device).cuda_stream":
            lambda: torch.cuda.current_stream(device).cuda_stream,
        # The wrappers whole.
        "hashgrid_fwd (wrapper)": lambda: hashgrid.hashgrid_fwd(table, p,
                                                                 spec),
        "hashgrid_table_grad (wrapper)": lambda: hashgrid_bwd
        .hashgrid_table_grad(p, g, spec),
    }
    report = {}
    for name, fn in steps.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        report[name] = us
        print(f"host {name}: {us:.2f} us", flush=True)
    return report


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
    w = sub.add_parser("wrappers")
    w.add_argument("roots", nargs="+", help="checkouts whose wrappers to "
                   "time, in this order")
    h = sub.add_parser("host")
    h.add_argument("--reps", type=int, default=2000)
    for p in (k, t, w, h):
        p.add_argument("--out", help="write the report here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_hashgrid needs a CUDA device")
    report = {"kernels": kernels_main, "train": train_main,
              "wrappers": wrappers_main, "host": host_main}[args.mode](args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
