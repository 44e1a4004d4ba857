// Multiresolution hash-grid encode for Hopper (sm_90a): forward and
// table gradient, with a plain C interface loaded through ctypes
// (nerf_hugs_torch/ops/kernels.py).
//
// Semantics are tiny-cuda-nn grid.h, as in nerf_hugs_tpu/ops/hashgrid.py:
// grid coordinate x * scale_l + 0.5, trilinear weights from its fraction,
// dense levels indexed with strides N_l^d and wrapped by one conditional
// subtract, hashed levels combined with xor (tcnn) or add, masked to 2^log2.
// Features per level F = 2, so a table row is one 8-byte float2.
//
// The table is one flat float32 array, levels concatenated in tcnn order;
// each level starts at a row offset that is a multiple of 8 rows, so every
// row load stays 8-byte aligned. Per-level constants live in a small device
// table of 8 int32 per level (see LevelRow), read through the read-only
// cache: every thread of a warp reads the same few rows of it.
//
// hashgrid_fwd replaces the XLA gather encode `_encode_impl`
// (nerf_hugs_tpu/ops/hashgrid.py:448-537; it has no Pallas source). One
// thread per (sample, level), sample-major so a warp writes its 32 float2
// outputs contiguously. The kernel is bound by the latency of its eight
// random row gathers: the field's tables (182.6 MiB at
// kubric_nerfacto_base) do not fit the 50 MB L2, the proposal's 5.4 MiB do.
// The design issues all eight independent loads before any of them is
// used, so a thread keeps eight gathers in flight.
//
// hashgrid_bwd replaces the Pallas segment-sum `_kernel` with its driver
// `block_segment_sum` (nerf_hugs_tpu/ops/hashgrid_bwd.py:48-239) and the
// custom VJP backward `_encode_custom_bwd` (hashgrid.py:579-647). The TPU
// sorts the corner entries by row and segment-sums them with one-hot
// matmuls because it has no fast scatter; Hopper has float2 atomics in
// L2, so each thread recomputes its corner rows and weights from the
// positions and adds w * dL/dfeature straight into the fp32 table gradient.
// Recomputing instead of saving rows and weights keeps 2^d * 8 bytes per
// sample and level out of device memory (about 2.1 GB for the field at
// kubric_nerfacto_base). The kernel is bound by atomic throughput on
// colliding rows (the coarse dense levels take every sample) and by the
// random access to the 182.6 MiB gradient; the payload stays fp32, the
// JAX package's bwd_dtype='float32' mode. Positions get no gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One row of the per-level device table, 8 int32:
//   [0] scale (float bits)  [1..3] per-dim multiplier: N_l^d on dense
//   levels, the tcnn primes on hashed ones  [4] level rows
//   [5] row offset of the level  [6] 1 if dense  [7] unused
struct LevelRow {
  float scale;
  uint32_t mult[3];
  uint32_t size;
  uint32_t offset;
  uint32_t dense;
  uint32_t pad;
};

__device__ __forceinline__ LevelRow load_level(const int4* __restrict__ lt,
                                               int l) {
  const int4 a = __ldg(lt + 2 * l);
  const int4 b = __ldg(lt + 2 * l + 1);
  LevelRow r;
  r.scale = __int_as_float(a.x);
  r.mult[0] = (uint32_t)a.y;
  r.mult[1] = (uint32_t)a.z;
  r.mult[2] = (uint32_t)a.w;
  r.size = (uint32_t)b.x;
  r.offset = (uint32_t)b.y;
  r.dense = (uint32_t)b.z;
  r.pad = 0;
  return r;
}

// Corner rows (absolute, in the concatenated table) and trilinear weights
// of one sample at one level, in the corner order of
// HashGridSpec.corner_offsets (dim 0 most significant). The rounding
// follows the plain version op for op: no fused multiply-adds.
template <int D>
__device__ __forceinline__ void level_corners(const float* __restrict__ p,
                                              const LevelRow& lv,
                                              uint32_t hash_mask,
                                              bool hash_add,
                                              uint32_t* row, float* w) {
  uint32_t x0[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = __fadd_rn(__fmul_rn(__ldg(p + d), lv.scale), 0.5f);
    const float xf = floorf(x);
    frac[d] = __fsub_rn(x, xf);
    x0[d] = (uint32_t)xf;
  }
  const bool additive = lv.dense || hash_add;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    uint32_t idx = 0;
    float wc = 1.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t bit = (c >> (D - 1 - d)) & 1u;
      const uint32_t t = (x0[d] + bit) * lv.mult[d];
      idx = d == 0 ? t : (additive ? idx + t : (idx ^ t));
      const float wd = bit ? frac[d] : __fsub_rn(1.0f, frac[d]);
      wc = d == 0 ? wd : __fmul_rn(wc, wd);
    }
    if (lv.dense) {
      // Only the x == 1 edge corner passes the level size, by less than
      // one size: one subtract is the modulo.
      idx = idx >= lv.size ? idx - lv.size : idx;
    } else {
      idx &= hash_mask;
    }
    row[c] = lv.offset + idx;
    w[c] = wc;
  }
}

template <int D>
__global__ void __launch_bounds__(256)
hashgrid_fwd_kernel(const float2* __restrict__ table,
                    const float* __restrict__ pos, float2* __restrict__ out,
                    int64_t n, int num_levels, uint32_t hash_mask,
                    int hash_add, const int4* __restrict__ levels) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * num_levels) return;
  const int64_t s = i / num_levels;
  const int l = (int)(i - s * num_levels);
  const LevelRow lv = load_level(levels, l);
  uint32_t row[1 << D];
  float w[1 << D];
  level_corners<D>(pos + s * D, lv, hash_mask, hash_add != 0, row, w);
  float2 v[1 << D];
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) v[c] = __ldg(table + row[c]);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], v[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], v[c].y));
  }
  out[i] = acc;
}

__device__ __forceinline__ void atomic_add2(float2* addr, float2 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(addr, v);  // one vector atomic on sm_90
#else
  atomicAdd(&addr->x, v.x);
  atomicAdd(&addr->y, v.y);
#endif
}

template <int D>
__global__ void __launch_bounds__(256)
hashgrid_bwd_kernel(const float* __restrict__ pos,
                    const float2* __restrict__ grad_out,
                    float2* __restrict__ grad_table, int64_t n,
                    int num_levels, uint32_t hash_mask, int hash_add,
                    const int4* __restrict__ levels) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * num_levels) return;
  const int64_t s = i / num_levels;
  const int l = (int)(i - s * num_levels);
  const LevelRow lv = load_level(levels, l);
  uint32_t row[1 << D];
  float w[1 << D];
  level_corners<D>(pos + s * D, lv, hash_mask, hash_add != 0, row, w);
  const float2 g = __ldg(grad_out + i);
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    atomic_add2(grad_table + row[c],
                make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y)));
  }
}

constexpr int kThreads = 256;

unsigned int num_blocks(int64_t n, int num_levels) {
  return (unsigned int)((n * num_levels + kThreads - 1) / kThreads);
}

}  // namespace

// table: [rows, 2] fp32; pos: [n, 3] fp32; out: [n, num_levels, 2] fp32;
// levels: [num_levels, 8] int32 device table. num_dims must be 3 (the
// 2-D grids of the HA-NeRF mask are not ported). Returns a cudaError_t.
extern "C" int hashgrid_fwd(const float* table, const float* pos, float* out,
                            int64_t n, int num_levels, int num_dims,
                            uint32_t hash_mask, int hash_add,
                            const int32_t* levels, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = num_blocks(n, num_levels);
  const float2* t2 = (const float2*)table;
  float2* o2 = (float2*)out;
  const int4* lt = (const int4*)levels;
  if (num_dims == 3) {
    hashgrid_fwd_kernel<3><<<blocks, kThreads, 0, st>>>(
        t2, pos, o2, n, num_levels, hash_mask, hash_add, lt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// pos: [n, 3] fp32; grad_out: [n, num_levels, 2] fp32; grad_table:
// [rows, 2] fp32, zeroed by the caller. num_dims must be 3. Returns a
// cudaError_t.
extern "C" int hashgrid_bwd(const float* pos, const float* grad_out,
                            float* grad_table, int64_t n, int num_levels,
                            int num_dims, uint32_t hash_mask, int hash_add,
                            const int32_t* levels, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = num_blocks(n, num_levels);
  const float2* g2 = (const float2*)grad_out;
  float2* gt2 = (float2*)grad_table;
  const int4* lt = (const int4*)levels;
  if (num_dims == 3) {
    hashgrid_bwd_kernel<3><<<blocks, kThreads, 0, st>>>(
        pos, g2, gt2, n, num_levels, hash_mask, hash_add, lt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
