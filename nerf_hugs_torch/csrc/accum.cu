// Weighted planar accumulation of four paired-corner gathers for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (nerf_hugs_torch/ops/kernels.py).
//
// planar_accum replaces the Pallas `_accum_kernel` that `pallas_accum`
// launches (tools/bench_fwd_copies.py:94-120, candidate C of that
// microbenchmark of the hash grid's dense-level forward). For each sample i
// and feature j < F = 2 it computes
//   o[i, j] = sum_{c < 4} w[c, i] * v_c[i, j] + w[c + 4, i] * v_c[i, F + j]
// in fp32, accumulated in that order from zero. Every product and every sum
// is rounded on its own (__fmul_rn / __fadd_rn, no fused multiply-adds), so
// the kernel follows its plain version (ops/accum.py) op for op.
//
// On the TPU the kernel exists to turn the row-major [n, 2F] gather outputs
// into planar accumulators in one pass instead of as XLA relayout copies.
// Hopper has no layout to fix: a thread reads a whole 16-byte row as one
// float4. What bounds the kernel is memory: per sample it must read four
// 16-byte rows and eight 4-byte weights and write one 8-byte output, 104
// bytes against 32 flops, so 218.1 MB and about 0.065 ms at n = 2^21 and
// 3.35 TB/s. The design moves each of those bytes once, in full
// transactions: one thread per sample, one read-only float4 load per row,
// the eight weight reads of a warp coalesced (consecutive threads read
// consecutive samples of each weight row), one float2 store. The weights'
// row stride is an argument, so a column slice w[:, a:b] needs no copy; the
// last block masks the ragged edge, so any n is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    planar_accum_kernel(const float4* __restrict__ v0,
                        const float4* __restrict__ v1,
                        const float4* __restrict__ v2,
                        const float4* __restrict__ v3,
                        const float* __restrict__ w, int64_t w_stride,
                        float2* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // All loads are issued before any arithmetic, so a thread has its four
  // rows and eight weights in flight at once.
  const float4 v[4] = {__ldg(v0 + i), __ldg(v1 + i), __ldg(v2 + i),
                       __ldg(v3 + i)};
  float wc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) wc[k] = __ldg(w + k * w_stride + i);
  // Row layout [v(j=0), v(j=1), v(F+0), v(F+1)] = [x, y, z, w].
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc0 = __fadd_rn(__fadd_rn(acc0, __fmul_rn(wc[c], v[c].x)),
                     __fmul_rn(wc[c + 4], v[c].z));
    acc1 = __fadd_rn(__fadd_rn(acc1, __fmul_rn(wc[c], v[c].y)),
                     __fmul_rn(wc[c + 4], v[c].w));
  }
  out[i] = make_float2(acc0, acc1);
}

}  // namespace

// v0..v3: [n, 4] fp32, 16-byte aligned rows; w: [8, >= n] fp32 with row
// stride w_stride (elements) and unit column stride; out: [n, 2] fp32.
// Returns the launch's cudaError_t.
extern "C" int planar_accum(const void* v0, const void* v1, const void* v2,
                            const void* v3, const void* w, int64_t w_stride,
                            void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  planar_accum_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float4*)v0, (const float4*)v1, (const float4*)v2,
      (const float4*)v3, (const float*)w, w_stride, (float2*)out, n);
  return (int)cudaGetLastError();
}
