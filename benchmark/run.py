"""The benchmark of nerf_hugs_torch on one NVIDIA H100:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

runs the cell of BENCHMARK.json named CELL from seed N: set-up, the
checked first steps, S seconds of training, then the comparison with the
plain reference. The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device, with --trace 1 breakdown,
and last the numbers compared with their limits); the last lines of
standard error repeat those numbers. Details go to a sidecar file in
--sidecar-dir (default $TMPDIR/benchmark). Without a CUDA card, with fewer
cards than the cell asks for, or with JAX loaded in the process at the
end, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and sys.path[0] == os.path.dirname(
        os.path.abspath(__file__)):
    # The checkout's root, not benchmark/, heads the search path: the
    # package is imported as `benchmark`.
    sys.path[0] = ROOT
# The JAX side, compared by whole top-level module names.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_hugs_tpu")


def since_process_start() -> float:
    """Seconds from the process's start to T0 (0 where /proc is absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK")
                   - (time.perf_counter() - T0), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sidecar-dir", default=None)
    return p.parse_args(argv)


def set_environment(root: str) -> None:
    """Every kernel cache inside the checkout, at fixed paths; one
    intra-op host thread (torch's OpenMP pool of one thread a core spins
    after each small host conversion and takes cores from the loader's
    thread: on the card's 8-core host it moved nerfacto's rate by 5-10%
    from run to run)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def device_or_exit(count: int):
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark runs on an NVIDIA GPU")
    if torch.cuda.device_count() < count:
        sys.exit(f"the cell asks for {count} devices, "
                 f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def measure(args, manifest, device, trainee_factory=None):
    """Set-up, checked steps, window and comparison of one run; returns
    (result line, sidecar)."""
    import torch

    from benchmark import check, devtrace, harness
    from benchmark.manifest import readers
    torch.set_num_threads(1)
    on_card = device.type == "cuda"
    run = harness.Run(manifest, args.workload, args.seed, device,
                      tmp_root=os.environ.get("TMPDIR"))
    try:
        run.setup(trainee_factory)
        run.checked_and_warm_steps()
        setup_s = since_process_start() + time.perf_counter() - T0
        kind = "per_layer" if args.trace else "end_to_end"
        metric_readers = readers(manifest, run.cell, kind)
        for _, reader in metric_readers.values():
            if hasattr(reader, "prepare"):
                reader.prepare(run)
        profiler = None
        if args.trace and on_card:
            profiler = devtrace.Profiler(device)
            with profiler:
                window = run.window(args.seconds)
        else:
            window = run.window(args.seconds)
        # The peak of the window, before any reader or the reference runs.
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        t_read = time.perf_counter()
        window.update(setup_s=setup_s, run=run,
                      flops_per_step=run.reference.step_flops(run.values),
                      gemm_dtype=run.doc["gemm_dtype"], trace=None)
        if profiler is not None:
            window["trace"] = devtrace.Trace(
                profiler.device_ops(), window["spans"], window["start"],
                window["end"], window["steps"])
        metrics = {}
        for name, (entry, reader) in metric_readers.items():
            t = time.perf_counter()
            value = reader.read(window)
            run.timings[f"read_{name}_s"] = time.perf_counter() - t
            if value is not None:
                metrics[name] = {"value": float(value), "unit": entry["unit"]}
        read_s = time.perf_counter() - t_read
        device_info = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
        if window["trace"] is not None:
            device_info.update(busy_s=window["trace"].busy_s,
                               window_s=window["trace"].window_s)
        print(f"memory_peak_bytes {peak}", flush=True)
        run.trainee.close()
        run.trainee = None
        run.dataset = None
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        verdict = check.judge(run, manifest.limits(run.cell))
        result = {"correct": verdict["correct"],
                  "attempted": window["steps"], "failed": window["failed"],
                  "metrics": metrics, "device": device_info}
        if window["trace"] is not None:
            result["breakdown"] = window["trace"].breakdown()
        result["checks"] = verdict["checks"]
        sidecar = {
            "workload": args.workload, "seed": args.seed,
            "trace": args.trace, "setup_s": setup_s, "timings": run.timings,
            "window_s": window["seconds"], "steps": window["steps"],
            "step_ms": window["step_ms"], "read_s": read_s,
            "check_s": time.perf_counter() - t_check,
            "memory_peak_bytes": int(peak),
            "verdict": {k: v for k, v in verdict.items() if k != "checks"}}
        return result, sidecar
    finally:
        run.close()


def main(argv=None, root: str = ROOT, trainee_factory=None,
         device_check=device_or_exit) -> int:
    args = parse_args(argv)
    set_environment(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.manifest import Manifest
    manifest = Manifest(root)
    cell = manifest.cell(args.workload)
    device = device_check(cell["chips"])
    result, sidecar = measure(args, manifest, device, trainee_factory)
    found = forbidden_modules()
    if found:
        print(f"JAX side loaded in the process: {found}", file=sys.stderr)
        return 3
    sidecar_dir = args.sidecar_dir or os.path.join(
        os.environ.get("TMPDIR", tempfile.gettempdir()), "benchmark")
    os.makedirs(sidecar_dir, exist_ok=True)
    path = os.path.join(sidecar_dir, f"{args.workload}.{args.seed}."
                        f"trace{args.trace}.json")
    with open(path, "w") as f:
        json.dump(sidecar, f)
    print(f"sidecar {path}", flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
