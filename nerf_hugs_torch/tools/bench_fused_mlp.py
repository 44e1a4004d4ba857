"""Times the fused-MLP forward of csrc/fused_mlp.cu against an earlier
fused_mlp.cu with the same C interface, in one process on one card.

    python -m nerf_hugs_torch.tools.bench_fused_mlp \\
        [--dtype bfloat16|float32] [--baseline OLD_FUSED_MLP_CU] [--out JSON]

At the fused-MLP shapes of kubric_nerfacto_base with enable_tcnn_mlp
(hashgrid_inputs.FUSED_SHAPES: 16384 rays times the samples per ray) and at
the widest shipped head (phototourism_nerfacto_nerfw's, 128 inputs with
its 48-wide appearance embedding), in the given dtype (bf16 by default;
float32 is what a config with enable_amp off runs, with NeRF-W's transient
head 80 -> 64 -> 64 -> 5 added), each build is first checked against
fused_mlp_plain (within 2^-7 of the output's largest entry in bf16, 1e-5
in fp32). Then, per shape: the package's kernel and the baseline's, each
one launch through ops/fused_mlp.py::launch on weights already in the
layout it reads (the package's: `kernel_weights`; the baseline's: its own,
`baseline_weights`), as medians of 10 CUDA-event runs taken in turns A B B
A three times, and each kernel alone from a torch.profiler trace; the
plain version; the cuBLAS chain torch.relu(x @ W0) @ W1 ... in the same
dtype (bf16: fp32 sums, each product rounded to bf16 once; fp32: TF32 off,
as ops/fused_mlp.py is held to exact fp32 products), the same function up
to the order of the sums, checked against the plain version too, which the
port never calls; and the bound, the larger of the bytes moved (x, the
weights and the output, once each) over 3.35 TB/s and the products'
operations over the dtype's peak, 989 TFLOP/s bf16 on the tensor cores and
67 TFLOP/s fp32 on the FMA units (H100 SXM data sheet). --baseline builds
the given source with the flags of ops/kernels.py into a scratch library,
e.g. the parent commit's unpacked with `git archive`.

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
from nerf_hugs_torch.tools.bench_hashgrid import (build_baseline, device_ms,
                                                median_ms)

# (name, samples per ray, layer widths), as hashgrid_inputs.FUSED_SHAPES.
SHAPES = hashgrid_inputs.FUSED_SHAPES + (
    ("wide field mlp_head", 128, (128, 256, 256, 3)),)
# fp32 adds NeRF-W's transient head (geo_feat_dim 15 + the 65-wide
# transient embedding -> 64 -> 64 -> 5).
SHAPES_F32 = SHAPES + (("nerfw mlp_transient", 128, (80, 64, 64, 5)),)
TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}   # of the output's max
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
KERNEL_NAMES = {"bfloat16": "fused_mlp_resident_kernel",
                "float32": "fused_mlp_f32_kernel"}


def cublas_chain(x, weights):
    """The MLP as torch.matmul + relu in x's dtype: one cuBLAS GEMM per
    layer."""
    h = x
    for i, w in enumerate(weights):
        h = h @ w
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def bound(x, out, weights, dims):
    """(least ms, what sets it) of one forward, at the peak of x's dtype."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, out, *weights))
    flops = 2 * x.shape[0] * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
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


def baseline_weights(weights) -> list:
    """The weights as the earlier fused_mlp.cu reads them: bf16 as the
    package does (`kernel_weights`: the resident kernel's widths as they
    are, the streamed kernel's zero-padded W^T), fp32 zero-padded to
    [round_up(d_in, 32), round_up(d_out, 64)] for its 32 x 64 slices."""
    if weights[0].dtype == torch.bfloat16:
        return fused_mlp.kernel_weights(weights)
    out = []
    for w in weights:
        k, n = w.shape
        p = w.new_zeros(-(-k // 32) * 32, -(-n // 64) * 64)
        p[:k, :n] = w
        out.append(p)
    return out


def make_inputs(dims, n, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dims[0]), generator=gen, device="cuda").to(dtype)
    ws = [((torch.rand((a, b), generator=gen, device="cuda") * 2 - 1)
           * math.sqrt(6.0 / a)).to(dtype)
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws


def bench_shape(name, dims, n, builds, seed, dtype) -> dict:
    x, ws = make_inputs(dims, n, seed, dtype)
    dtype_name = str(dtype).split(".")[-1]
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
        if not (math.isfinite(err) and err <= TOL[dtype_name]):
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
          + f"; plain {row['plain']:.4f}; cuBLAS {dtype_name} chain "
          f"{row['cublas']:.4f} (err {row['cublas_err']:.2e}); bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16")
    parser.add_argument("--baseline", help="a fused_mlp.cu with the same C "
                        "interface that reads `baseline_weights`, timed "
                        "beside the package's kernel")
    parser.add_argument("--out", help="write the report here as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_mlp needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dtype = getattr(torch, args.dtype)
    kernel = KERNEL_NAMES[args.dtype]
    report = {"device": smi, "dtype": args.dtype, "ptxas": {}, "shapes": {}}
    lib = kernels.load()
    report["ptxas"]["package"] = ptxas_lines(
        kernels.build_log.get("fused_mlp.cu", ""))
    with tempfile.TemporaryDirectory() as tmp:
        builds = [("package", lib, fused_mlp.kernel_weights, kernel)]
        if args.baseline:
            base = build_baseline(args.baseline, tmp, ("fused_mlp_fwd",))
            builds.insert(0, ("baseline", base, baseline_weights, kernel))
        for line in report["ptxas"]["package"]:
            print(f"ptxas package: {line}", flush=True)
        shapes = SHAPES_F32 if args.dtype == "float32" else SHAPES
        for i, (name, per_ray, dims) in enumerate(shapes):
            report["shapes"][name] = bench_shape(
                name, dims, hashgrid_inputs.BATCH * per_ray, builds, i,
                dtype)
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
