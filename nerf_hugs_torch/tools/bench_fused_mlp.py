"""Times the bf16 fused-MLP forward of csrc/fused_mlp.cu against an earlier
fused_mlp.cu with the same C interface, in one process on one card.

    python -m nerf_hugs_torch.tools.bench_fused_mlp \\
        [--baseline OLD_FUSED_MLP_CU] [--out JSON]

At the fused-MLP shapes of kubric_nerfacto_base with enable_tcnn_mlp
(hashgrid_inputs.FUSED_SHAPES: 16384 rays times the samples per ray) and at
the widest shipped head (phototourism_nerfacto_nerfw's, 128 inputs with
its 48-wide appearance embedding; the resident kernel holds it with one
warpgroup a block), in bf16, each build is first checked against fused_mlp_plain (within 2^-7 of
the output's largest entry). Then, per shape: the package's kernel and the
baseline's, each one launch through ops/fused_mlp.py::launch on weights
already in the layout it reads (the package's: `kernel_weights`; the
baseline's: the streamed layout, zero-padded W^T), as medians of 10
CUDA-event runs taken in turns A B B A three times, and each kernel alone
from a torch.profiler trace; the plain version; the cuBLAS bf16 chain
torch.relu(x @ W0) @ W1 ... (bf16 operands, fp32 sums, each product rounded
to bf16 once: the same function up to the order of the sums, checked
against the plain version too), which the port never calls; and the bound,
the larger of the bytes moved (x, the weights and the output, once each)
over 3.35 TB/s and the products' operations over 989 TFLOP/s (H100 SXM
data sheet). --baseline builds the given source with the flags of
ops/kernels.py into a scratch library, e.g. the parent commit's unpacked
with `git archive`.

Needs a card; the builds need nvcc.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import tempfile

import torch

from nerf_hugs_torch.ops import fused_mlp, kernels
from nerf_hugs_torch.tools import hashgrid_inputs
from nerf_hugs_torch.tools.bench_hashgrid import build_baseline, median_ms

# (name, samples per ray, layer widths), as hashgrid_inputs.FUSED_SHAPES.
SHAPES = hashgrid_inputs.FUSED_SHAPES + (
    ("wide field mlp_head", 128, (128, 256, 256, 3)),)
TOL = 2.0 ** -7            # of the output's largest entry
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


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


def cublas_chain(x, weights):
    """The MLP as bf16 torch.matmul + relu: one cuBLAS GEMM per layer."""
    h = x
    for i, w in enumerate(weights):
        h = h @ w
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def bound(x, out, weights, dims):
    """(least ms, what sets it) of one forward."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, out, *weights))
    flops = 2 * x.shape[0] * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def ptxas_lines(log: str) -> list:
    """Registers, spills, warnings and C75xx notes (C7511: wgmma chains
    serialised) of a ptxas -v report."""
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in ("registers", "spill", "arning",
                                       "C75"))]


def make_inputs(dims, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dims[0]), generator=gen, device="cuda").bfloat16()
    ws = [((torch.rand((a, b), generator=gen, device="cuda") * 2 - 1)
           * math.sqrt(6.0 / a)).bfloat16()
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


def bench_shape(name, dims, n, builds, seed) -> dict:
    x, ws = make_inputs(dims, n, seed)
    want = fused_mlp.fused_mlp_plain(x, ws)
    row = {"dims": list(dims), "rows": n}
    runners = {}
    for label, lib, layout, kernel in builds:
        kws = layout(ws)
        out = torch.empty_like(want)
        run = (lambda lib=lib, kws=kws, out=out:
               fused_mlp.launch(lib, x, kws, dims, out))
        run()
        torch.cuda.synchronize()
        err = rel_err(out, want)
        if not (math.isfinite(err) and err <= TOL):
            raise RuntimeError(f"{label} disagrees with the plain version "
                               f"at {name}: {err} of the max")
        row[f"{label}_err"] = err
        runners[label] = (run, kernel)
    chain = cublas_chain(x, ws)
    row["cublas_err"] = rel_err(chain, want)
    times = {label: [] for label in runners}
    order = list(runners)
    for turn in (order, order[::-1]) * 3:          # A B B A, three times
        for label in turn:
            times[label].append(median_ms(runners[label][0]))
    for label, (run, kernel) in runners.items():
        row[label] = times[label]
        row[f"{label}_median"] = statistics.median(times[label])
        row[f"{label}_alone"] = device_ms(run, kernel)
    row["plain"] = median_ms(lambda: fused_mlp.fused_mlp_plain(x, ws))
    row["cublas"] = median_ms(lambda: cublas_chain(x, ws))
    row["bound_ms"], row["bound_by"] = bound(x, want, ws, dims)
    shown = lambda v: "not measured" if v is None else f"{v:.4f}"
    print(f"{name} [{n}, {dims[0]}] -> "
          + " -> ".join(str(d) for d in dims[1:]) + ": "
          + "; ".join(f"{label} " + " / ".join(f"{t:.4f}" for t in
                                                times[label])
                      + f" ms (median {row[label + '_median']:.4f}, alone "
                      f"{shown(row[label + '_alone'])}, err "
                      f"{row[label + '_err']:.2e})" for label in runners)
          + f"; plain {row['plain']:.4f}; cuBLAS bf16 chain "
          f"{row['cublas']:.4f} (err {row['cublas_err']:.2e}); bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="a fused_mlp.cu with the same C "
                        "interface whose bf16 calls take the streamed "
                        "layout, timed beside the package's kernel")
    parser.add_argument("--out", help="write the report here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_mlp needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    report = {"device": smi, "ptxas": {}, "shapes": {}}
    lib = kernels.load()
    report["ptxas"]["package"] = ptxas_lines(
        kernels.build_log.get("fused_mlp.cu", ""))
    with tempfile.TemporaryDirectory() as tmp:
        builds = [("package", lib, fused_mlp.kernel_weights,
                   "fused_mlp_resident_kernel")]
        if args.baseline:
            base = build_baseline(args.baseline, tmp, ("fused_mlp_fwd",))
            builds.insert(0, ("baseline", base, fused_mlp.streamed_weights,
                              "fused_mlp_bf16_kernel"))
        for line in report["ptxas"]["package"]:
            print(f"ptxas package: {line}", flush=True)
        for i, (name, per_ray, dims) in enumerate(SHAPES):
            report["shapes"][name] = bench_shape(
                name, dims, hashgrid_inputs.BATCH * per_ray, builds, i)
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
