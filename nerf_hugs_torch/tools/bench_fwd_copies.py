"""Microbenchmark of the hash grid's dense-level forward: gathers of paired
corner rows followed by a weighted planar accumulation.

The port of tools/bench_fwd_copies.py. At one dense level's real shape
(kubric_nerfacto_base's field: n = 16384 x 128 samples, F = 2, paired-corner
16-byte rows, tables of C = N^3 rows for N in 65..127) it times:

  A. planar: four `index_select` gathers of [n, 2F] rows, then the
     weighted accumulation as elementwise PyTorch;
  C. pallas_accum: the same four gathers (library calls, as they stayed
     XLA in JAX), then the accumulation as one pass of the hand-written
     kernel `ops.accum.planar_accum` (csrc/accum.cu); it must agree with A
     within the tool's tolerance (rtol = atol = 1e-5);
  D. quad: 32-byte rows of 4 corners, 2 gathers per sample;
  O. oct_pack: 64-byte rows of all 8 corners, 1 gather per sample;
  rebuild4_only / rebuild8_only: the torch.cat + torch.roll table rebuilds
     that D and O need;
and, behind --all, B (a gather that emits [2F, n]) and E (the row-major
gathers de-interleaved by an fp32 matmul with a one-hot selection matrix),
both checked against A like C. It also prints C's kernel alone beside the
least time the card could take for its bytes.

    python -m nerf_hugs_torch.tools.bench_fwd_copies [n_log2] [--all] \\
        [--device cuda|cpu]

Times are medians of 10 runs after a warm-up: CUDA events on the card, the
host clock with --device cpu. The run is on the card unless --device cpu
is given; without a card that is an error. A failed check ends the run.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from nerf_hugs_torch.ops.accum import F, planar_accum
from nerf_hugs_torch.utils.device import pin_fp32_precision, resolve_device

SIZES = (65, 81, 97, 113, 127)   # dense levels of N^3 rows (C = N^3)
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet


# --- candidates -------------------------------------------------------------

def planar(tab2, idx, w):
    """A: tab2 [C, 2F]; idx [4, n] int32; w [8, n] -> [n, F]."""
    accs = [torch.zeros(idx.shape[1], device=w.device) for _ in range(F)]
    for c in range(4):
        vals = tab2.index_select(0, idx[c])              # [n, 2F]
        for j in range(F):
            accs[j] = (accs[j] + w[c] * vals[:, j]
                       + w[c + 4] * vals[:, F + j])
    return torch.stack(accs, dim=-1)


def transposed(tab2, idx, w):
    """B: a gather that emits [2F, n], so feature reads are contiguous."""
    accs = [torch.zeros(idx.shape[1], device=w.device) for _ in range(F)]
    for c in range(4):
        vals_t = tab2.t().index_select(1, idx[c])        # [2F, n]
        for j in range(F):
            accs[j] = (accs[j] + w[c] * vals_t[j]
                       + w[c + 4] * vals_t[F + j])
    return torch.stack(accs, dim=-1)


def pallas_accum(tab2, idx, w):
    """C: the gathers stay library calls; the weighted planar accumulation
    is one pass of the hand-written kernel."""
    vals = [tab2.index_select(0, idx[c]) for c in range(4)]  # [n, 2F] x4
    return planar_accum(*vals, w)


def quad(tab4, idx2, w):
    """D: 32-byte rows fetch 4 corners per gather (2 gathers per sample)."""
    accs = [torch.zeros(idx2.shape[1], device=w.device) for _ in range(F)]
    for c in range(2):
        vals = tab4.index_select(0, idx2[c])             # [n, 4F]
        for q in range(4):
            for j in range(F):
                accs[j] = accs[j] + w[c * 4 + q] * vals[:, q * F + j]
    return torch.stack(accs, dim=-1)


def oct_pack(tab8, idx1, w):
    """O: 64-byte rows fetch all 8 corners per gather (1 per sample)."""
    accs = [torch.zeros(idx1.shape[0], device=w.device) for _ in range(F)]
    vals = tab8.index_select(0, idx1)                    # [n, 8F]
    for q in range(8):
        for j in range(F):
            accs[j] = accs[j] + w[q] * vals[:, q * F + j]
    return torch.stack(accs, dim=-1)


def build4(tab2, N):
    """[C, 2F] -> [C, 4F]: each row joined by the row N further on."""
    return torch.cat([tab2, torch.roll(tab2, -N, dims=0)], dim=-1)


def build8(tab2, N):
    """[C, 2F] -> [C, 8F]: the quad rows joined by those N^2 further on."""
    t4 = build4(tab2, N)
    return torch.cat([t4, torch.roll(t4, -N * N, dims=0)], dim=-1)


def _selection_matrix(cols, device):
    """[128, 128] one-hot S with S[s*cols + j, j*(128//cols) + s] = 1:
    right-multiplying a [m, 128] row-major block of (128//cols) samples x
    cols features de-interleaves it into cols planar lane groups."""
    g = 128 // cols
    s_mat = np.zeros((128, 128), np.float32)
    for s in range(g):
        for j in range(cols):
            s_mat[s * cols + j, j * g + s] = 1.0
    return torch.from_numpy(s_mat).to(device)


def mxu_transpose(tab2, idx, w):
    """E: row-major gathers, de-interleaved to planar columns by an fp32
    matmul with a one-hot matrix (TF32 off keeps it exact)."""
    cols = 2 * F
    g = 128 // cols                      # samples per 128-wide row
    n = idx.shape[1]
    s_mat = _selection_matrix(cols, w.device)
    accs = [torch.zeros(n, device=w.device) for _ in range(F)]
    for c in range(4):
        vals = tab2.index_select(0, idx[c])              # [n, 2F]
        p = (vals.reshape(n // g, 128) @ s_mat).reshape(n // g, cols, g)
        for j in range(F):
            vj = p[:, j, :].reshape(n)
            vfj = p[:, F + j, :].reshape(n)
            accs[j] = accs[j] + w[c] * vj + w[c + 4] * vfj
    return torch.stack(accs, dim=-1)


# --- harness ----------------------------------------------------------------

def make_inputs(N: int, n: int, device):
    """The table [N^3, 2F] ~ N(0, 1), corner rows [4, n] int32 and weights
    [8, n] ~ U(0, 1), drawn on the device from one generator seeded SEED
    (anew for each N, as the JAX tool reuses its key)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    C = N ** 3
    tab2 = torch.randn((C, 2 * F), generator=gen, device=device)
    idx = torch.randint(0, C, (4, n), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand((8, n), generator=gen, device=device)
    return tab2, idx, w


def time_ms(fn, device, runs: int = 10) -> float:
    """Median ms of `runs` calls after one warm-up call: CUDA events on the
    card, the host clock on the CPU. At n = 2^21 a run streams the indices
    (32 MB), the weights (64 MB) and the gathered rows (128 MB), more than
    the card's 50 MB L2, so no run finds the last one's data in cache and
    no flush is needed."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.bench_fwd_copies",
        description="Time the dense-level forward's gather + planar "
                    "accumulation candidates.")
    parser.add_argument("n_log2", nargs="?", type=int, default=21,
                        help="samples n = 2^n_log2 (default 21)")
    parser.add_argument("--all", action="store_true",
                        help="also time B (transposed gather) and E "
                             "(one-hot matmul de-interleave)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run every candidate at every size; returns {N: {name: ms}}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    pin_fp32_precision()
    n = 1 << args.n_log2
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    report = {}
    for N in SIZES:
        C = N ** 3
        tab2, idx, w = make_inputs(N, n, device)
        tab4, tab8 = build4(tab2, N), build8(tab2, N)
        idx2, idx1 = idx[:2], idx[0]

        ref = planar(tab2, idx, w)
        checks = {"C_pallas_accum": pallas_accum}
        if args.all:
            checks.update(B_transposed_gather=transposed,
                          E_mxu_deinterleave=mxu_transpose)
        for name, fn in checks.items():
            torch.testing.assert_close(fn(tab2, idx, w), ref, rtol=1e-5,
                                       atol=1e-5, msg=lambda m, name=name:
                                       f"{name} disagrees with A: {m}")
        results = {
            "A_planar": time_ms(lambda: planar(tab2, idx, w), device),
            "C_pallas_accum": time_ms(lambda: pallas_accum(tab2, idx, w),
                                      device),
            "D_quad_32B": time_ms(lambda: quad(tab4, idx2, w), device),
            "O_oct_64B": time_ms(lambda: oct_pack(tab8, idx1, w), device),
            "rebuild4_only": time_ms(lambda: build4(tab2, N), device),
            "rebuild8_only": time_ms(lambda: build8(tab2, N), device),
        }
        if args.all:
            results["B_transposed_gather"] = time_ms(
                lambda: transposed(tab2, idx, w), device)
            results["E_mxu_deinterleave"] = time_ms(
                lambda: mxu_transpose(tab2, idx, w), device)
        vals = [tab2.index_select(0, idx[c]) for c in range(4)]
        results["C_accum_kernel_only"] = time_ms(
            lambda: planar_accum(*vals, w), device)

        print(f"--- C={C} rows (N={N}), n={n} samples "
              f"(4 paired descriptors each) on {where} ---", flush=True)
        for k, v in results.items():
            print(f"{k:24s} {v:8.3f} ms   {4 * n / v / 1e3:7.1f} M desc/s",
                  flush=True)
        if device.type == "cuda":
            # The least time for the card to read every input and write the
            # output once; the 32 flops per sample are negligible beside its
            # 104 bytes.
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*vals, w, ref))
            print(f"{'C_accum_bound':24s} "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:8.3f} ms   (memory: "
                  f"{nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s)", flush=True)
        report[N] = results
        del tab2, idx, w, tab4, tab8, ref, vals
    return report


if __name__ == "__main__":
    main()
