// Multiresolution hash-grid encode for Hopper (sm_90a): forward and
// table gradient, with a plain C interface loaded through ctypes
// (nerf_hugs_torch/ops/kernels.py).
//
// Semantics are tiny-cuda-nn grid.h, as in nerf_hugs_tpu/ops/hashgrid.py:
// grid coordinate x * scale_l + 0.5, multilinear weights from its fraction,
// dense levels indexed with strides N_l^d and wrapped by one conditional
// subtract, hashed levels combined with xor (tcnn) or add, masked to 2^log2.
// Features per level F = 2, so a table row is one 8-byte float2. Both
// kernels are instantiated for d = 3 (the nerfacto fields, 8 corners) and
// d = 2 (the HA-NeRF implicit mask on pixel coordinates, 4 corners); the
// C entry points dispatch on num_dims and refuse any other value.
//
// The table is one flat float32 array, levels concatenated in tcnn order;
// each level starts at a row offset that is a multiple of 8 rows, so with a
// table that starts on 16 bytes (the wrappers check it) an even row starts
// an aligned 16-byte pair. Per-level constants live in a small device table
// of 8 int32 per level (see LevelRow), read through the read-only cache:
// the threads of a warp read one or a few rows of it.
//
// hashgrid_fwd replaces the XLA gather encode `_encode_impl`
// (nerf_hugs_tpu/ops/hashgrid.py:448-537; it has no Pallas source). It is
// bound by its random row gathers: 2^d per (sample, level), 268M at
// kubric_nerfacto_base's field, each a 32-byte sector for 8 bytes used,
// and the tables (182.6 MiB at the field) do not fit the 50 MB L2. A thread
// takes one (sample, level), sample-major, so neighbouring ray samples
// share an SM's L1 and a warp's stores are one contiguous run of features.
// The 2^d gathers are issued before any is used, and where a cell's two
// x-corners share an aligned 16-byte row pair (dense and additive levels
// with an even row, xor levels with an even x) one float4 load takes both.
// The launch bounds keep a full SM of threads (32 registers). Level-major
// launches, and groups of levels whose tables fit the L2, won on uniform
// positions but not on the main path's ray-ordered ones (PERF.md,
// section 6), so the forward keeps the sample-major order.
//
// hashgrid_bwd replaces the Pallas segment-sum `_kernel` with its driver
// `block_segment_sum` (nerf_hugs_tpu/ops/hashgrid_bwd.py:48-239) and the
// custom VJP backward `_encode_custom_bwd` (hashgrid.py:579-647). The TPU
// sorts the corner entries by row and segment-sums them with one-hot
// matmuls because it has no fast scatter; here each thread recomputes its
// sample's corner rows and weights from the positions (no saved residuals:
// they would be 2^d * 8 bytes per sample and level, about 2.1 GB for the
// field) and adds w * dL/dfeature into the fp32 table gradient with vector
// atomics in the L2. What bounds it is the number of atomics and their
// serialisation on shared rows, not bytes: ray-ordered samples put whole
// runs of a warp's lanes in one coarse cell, and samples outside the box
// all land in the origin's cell. The design:
//   - level-major: blockIdx.y is the level, samples run along x in the
//     caller's order, so the blocks in flight share one level and its
//     gradient (at most 16 MiB) stays in the L2;
//   - a (sample, level) whose dL/dfeature is exactly zero adds only +-0 to
//     a zero-initialised gradient, which changes no bit; it issues nothing
//     (the model collapses out-of-box samples to the origin and masks
//     their density, so their gradient is exactly zero);
//   - the lanes of a warp in one cell (equal integer corner, found with
//     __match_any_sync) sum their 2^d payloads with shuffles when they
//     form runs, and one lane issues the atomics (the mask's pixel patches
//     put whole warps in one cell at its coarse levels);
//   - where two x-corners share an aligned row pair, one float4 atomic adds
//     both (sm_90 has vector atomics in global memory).
// d = 2 (hashgrid_bwd2d_kernel; the HA-NeRF mask, 16 levels of which 0-11
// are dense, 256 to 315848 rows): at 2^20 uniform positions the d = 3
// design lost to one index_add_ (1.932 ms alone against 1.421, NVIDIA H100
// 80GB HBM3, 700.00 W): every block of a coarse level added into the same
// few hundred rows, about 16,000 atomics per row at level 0, and uniform
// lanes rarely share a cell, so the warp combine seldom fired. Now a block
// takes a span of up to 32 samples a thread at one level; a dense level of
// at most kSharedRows rows (levels 0-5) is summed in the block's shared
// memory, each warp first summing its same-cell lanes for groups of any
// shape (reduce_peers: match_any, then a shuffle tree over the group), and
// the block then adds each nonzero aligned row pair with one float4 atomic.
// Float atomics on shared memory compile to a compare-and-swap loop on
// sm_90a (ATOMS.CAST.SPIN in the SASS), so the group sum before them
// matters on pixel patches, whose warps share one cell at the coarse
// levels. The other levels keep the per-sample path of scatter_level<2>,
// over the same span: the group sum there too neither won nor lost beyond
// the noise on pixel centres and 2^20 uniform positions (a one-off
// variant timed with tools/bench_hashgrid.py kernels --baseline, NVIDIA
// H100 80GB HBM3, 700.00 W). The mask's gradient now takes 0.0112 ms
// alone at its 16384 pixel centres (0.0195 before) and 0.744 ms at 2^20
// uniform positions (1.928), against index_add_'s 1.403 ms
// (bench_hashgrid.py kernels, same card). The d = 3 kernel is
// unchanged.
// Only the order of the fp32 additions changes. The payload stays fp32, the
// JAX package's bwd_dtype='float32' mode. Positions get no gradient.
// Summing the coarse levels of the 3-D grids in shared memory first lost
// on their main-path inputs, so at d = 3 the gradient goes to the L2
// directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// One row of the per-level device table, 8 int32:
//   [0] scale (float bits)  [1..3] per-dim multiplier: N_l^d on dense
//   levels, the tcnn primes on hashed ones (column 3 is 0 at d = 2)
//   [4] level rows
//   [5] row offset of the level  [6] 1 if dense  [7] unused
struct LevelRow {
  float scale;
  uint32_t mult[3];
  uint32_t size;
  uint32_t offset;
  uint32_t dense;
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
  return r;
}

// The cell of a sample at one level: integer lower corner and fractions.
// The rounding follows the plain version op for op: no fused multiply-adds.
template <int D>
__device__ __forceinline__ void locate(const float* p, const LevelRow& lv,
                                       uint32_t* x0, float* frac) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = __fadd_rn(__fmul_rn(p[d], lv.scale), 0.5f);
    const float xf = floorf(x);
    frac[d] = __fsub_rn(x, xf);
    x0[d] = (uint32_t)xf;
  }
}

// Level-local corner rows and multilinear weights of one cell, in the
// corner order of HashGridSpec.corner_offsets (dim 0 most significant).
template <int D>
__device__ __forceinline__ void corners(const uint32_t* x0, const float* frac,
                                        const LevelRow& lv,
                                        uint32_t hash_mask, bool hash_add,
                                        uint32_t* row, float* w) {
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
    row[c] = idx;
    w[c] = wc;
  }
}

// One sample's features at one level: the 2^D gathers first, then the
// weighted sum in corner order.
template <int D>
__device__ __forceinline__ float2 encode_level(
    const float2* __restrict__ table, const float* p, const LevelRow& lv,
    uint32_t hash_mask, bool hash_add) {
  uint32_t x0[D], row[1 << D];
  float frac[D], w[1 << D];
  locate<D>(p, lv, x0, frac);
  corners<D>(x0, frac, lv, hash_mask, hash_add, row, w);
  const float2* t = table + lv.offset;
  constexpr int H = 1 << (D - 1);  // corner c + H is c's x + 1 neighbour
  float2 v[1 << D];
#pragma unroll
  for (int c = 0; c < H; ++c) {
    // Level offsets are multiples of 8 rows, so an even row starts an
    // aligned 16-byte pair.
    const float4 q =
        __ldg(reinterpret_cast<const float4*>(t + (row[c] & ~1u)));
    const bool odd = row[c] & 1u;
    v[c] = odd ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
    if ((row[c] ^ row[c + H]) == 1u) {
      v[c + H] = odd ? make_float2(q.x, q.y) : make_float2(q.z, q.w);
    } else {
      v[c + H] = __ldg(t + row[c + H]);
    }
  }
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], v[c].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], v[c].y));
  }
  return acc;
}

// grid ceil(n * L / kThreads): thread i takes sample i / L at level i % L,
// so a warp's stores are one contiguous run of features. The launch bounds
// hold it to 32 registers, a full SM of threads.
template <int D>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
hashgrid_fwd_kernel(const float2* __restrict__ table,
                    const float* __restrict__ pos, float2* __restrict__ out,
                    int64_t n, int num_levels, uint32_t hash_mask,
                    int hash_add, const int4* __restrict__ levels) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t count = n * num_levels;
  if (i >= count) return;
  int64_t s;
  if (count <= 0xffffffffll) {  // 32-bit division where it suffices
    s = (uint32_t)i / (uint32_t)num_levels;
  } else {
    s = i / num_levels;
  }
  const int l = (int)(i - s * num_levels);
  float p[D];
#pragma unroll
  for (int d = 0; d < D; ++d) p[d] = __ldg(pos + s * D + d);
  out[i] = encode_level<D>(table, p, load_level(levels, l), hash_mask,
                           hash_add != 0);
}

// Adds the corner payloads w_c * g of one (sample, level) into `grad`, the
// level's first row, with vector atomics. Called by every lane of a full
// warp, all at the same level; lanes past the last sample come with
// valid = false.
// Lanes in one cell (all D integer corner coordinates equal) have the same
// 2^D rows: when each such group is a run of adjacent lanes, as
// ray-ordered samples give, the run sums its payloads with shuffles and its
// lowest lane adds them; any other grouping adds lane by lane.
template <int D>
__device__ __forceinline__ void scatter_level(const float* __restrict__ pos,
                                              int64_t s, bool valid,
                                              float2 g, const LevelRow& lv,
                                              uint32_t hash_mask,
                                              bool hash_add, float2* grad) {
  constexpr int C = 1 << D;
  const unsigned lane = threadIdx.x & 31u;
  const bool nz = valid && (g.x != 0.0f || g.y != 0.0f);
  const unsigned nz_lanes = __ballot_sync(kFull, nz);
  if (nz_lanes == 0) return;  // the whole warp adds only zeros
  uint32_t x0[D], row[C];
  float frac[D], w[C];
  if (valid) {
    float p[D];
#pragma unroll
    for (int d = 0; d < D; ++d) p[d] = __ldg(pos + s * D + d);
    locate<D>(p, lv, x0, frac);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x0[d] = ~0u;
      frac[d] = 0.0f;
    }
  }
  corners<D>(x0, frac, lv, hash_mask, hash_add, row, w);
  float2 v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y));
  }
  unsigned m = __match_any_sync(
      kFull, ((unsigned long long)x0[D > 1 ? 1 : 0] << 32) | x0[0]);
  if (D > 2) m &= __match_any_sync(kFull, x0[D - 1]);
  const unsigned run = m >> (__ffs(m) - 1);
  const bool combine = !__all_sync(kFull, m == (1u << lane)) &&
                       __all_sync(kFull, (run & (run + 1)) == 0);
  if (combine) {
    // Segmented tree sum over runs: after the step of offset o a lane holds
    // the sum of its run's lanes in [lane, lane + 2o).
    const int longest = (int)__reduce_max_sync(kFull, (unsigned)__popc(m));
    for (int o = 1; o < longest; o <<= 1) {
      const bool take = lane + o < 32 && ((m >> (lane + o)) & 1u);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float x = __shfl_down_sync(kFull, v[c].x, o);
        const float y = __shfl_down_sync(kFull, v[c].y, o);
        if (take) {
          v[c].x = __fadd_rn(v[c].x, x);
          v[c].y = __fadd_rn(v[c].y, y);
        }
      }
    }
    // The run's lowest lane adds, unless every lane of the run was zero.
    if ((m & ((1u << lane) - 1u)) != 0 || (nz_lanes & m) == 0) return;
  } else if (!nz) {
    return;
  }
  constexpr int H = C / 2;  // corner c + H is c's x + 1 neighbour
#pragma unroll
  for (int c = 0; c < H; ++c) {
    if ((row[c] ^ row[c + H]) == 1u) {
      const bool odd = row[c] & 1u;
      const float2 lo = odd ? v[c + H] : v[c], hi = odd ? v[c] : v[c + H];
      atomicAdd(reinterpret_cast<float4*>(grad + (row[c] & ~1u)),
                make_float4(lo.x, lo.y, hi.x, hi.y));
      continue;
    }
    atomicAdd(grad + row[c], v[c]);
    atomicAdd(grad + row[c + H], v[c + H]);
  }
}

// grid (ceil(n / kThreads), L): one sample per thread at level blockIdx.y;
// vector atomics into the L2.
template <int D>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_kernel(const float* __restrict__ pos,
                    const float2* __restrict__ grad_out,
                    float2* __restrict__ grad_table, int64_t n,
                    int num_levels, uint32_t hash_mask, int hash_add,
                    const int4* __restrict__ levels) {
  const int l = blockIdx.y;
  const LevelRow lv = load_level(levels, l);
  const int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool valid = s < n;
  const float2 g = valid ? __ldg(grad_out + s * num_levels + l)
                         : make_float2(0.0f, 0.0f);
  scatter_level<D>(pos, s, valid, g, lv, hash_mask, hash_add != 0,
                   grad_table + lv.offset);
}

// --- d = 2: spans of samples, coarse levels summed in shared memory -------

// Dense levels of at most kSharedRows rows (52 KB of float2: the mask's
// levels 0-5, 256 to 6568 rows) are summed in the block's shared memory;
// 4 blocks of 256 threads still fit an SM.
constexpr int kSharedRows = 6656;
constexpr int kSpanMax = 32;  // samples per thread of one block, at most
constexpr int kMaxDevices = 64;

// Sums v over each group of lanes in `peers` (the lanes of one cell) into
// the group's lowest lane, for groups of any shape: a tree over the group's
// members in lane order, ceil(log2(size)) shuffle rounds, none where every
// lane is alone. Called by every lane of a full warp.
__device__ __forceinline__ void reduce_peers(unsigned peers, float2 (&v)[4]) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rel = __popc(peers & ((1u << lane) - 1u));  // rank in the group
  unsigned above = peers & ~((2u << lane) - 1u);       // members above
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);  // the next member still summing, or 0
    const int src = next ? next - 1 : (int)lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = __shfl_sync(kFull, v[c].x, src);
      const float y = __shfl_sync(kFull, v[c].y, src);
      if (next) {
        v[c].x = __fadd_rn(v[c].x, x);
        v[c].y = __fadd_rn(v[c].y, y);
      }
    }
    // Odd ranks were taken by the member below: they leave the tree.
    above &= ~__ballot_sync(kFull, rel & 1u);
    rel >>= 1;
  }
}

// grid (ceil(n / (span * kThreads)), L), kSharedRows float2 of dynamic
// shared memory: block x takes samples [x * span * kThreads, ...) at level
// blockIdx.y, kThreads at a time (coalesced). A level that fits
// kSharedRows and is dense sums into the block's copy of its gradient:
// each warp first sums the payloads of its lanes in one cell
// (reduce_peers), the group's lowest lane adds its 4 corners with shared
// float atomics, and after the span each nonzero aligned row pair goes to
// the gradient with one float4 atomic: one atomic per (block, row pair)
// instead of one per (sample, corner). Every other level takes the path of
// scatter_level<2> for each sample.
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd2d_kernel(const float* __restrict__ pos,
                      const float2* __restrict__ grad_out,
                      float2* __restrict__ grad_table, int64_t n,
                      int num_levels, uint32_t hash_mask, int hash_add,
                      const int4* __restrict__ levels, int span) {
  extern __shared__ __align__(16) float2 acc[];
  const int l = blockIdx.y;
  const LevelRow lv = load_level(levels, l);
  const int64_t first = (int64_t)blockIdx.x * span * kThreads;
  float2* grad = grad_table + lv.offset;
  if (!lv.dense || lv.size > (uint32_t)kSharedRows) {
    for (int i = 0; i < span; ++i) {
      const int64_t base = first + (int64_t)i * kThreads;
      if (base >= n) break;  // block-uniform
      const int64_t s = base + threadIdx.x;
      const bool valid = s < n;
      const float2 g = valid ? __ldg(grad_out + s * num_levels + l)
                             : make_float2(0.0f, 0.0f);
      scatter_level<2>(pos, s, valid, g, lv, hash_mask, hash_add != 0, grad);
    }
    return;
  }
  for (uint32_t r = threadIdx.x; r < lv.size; r += kThreads) {
    acc[r] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  for (int i = 0; i < span; ++i) {
    const int64_t base = first + (int64_t)i * kThreads;
    if (base >= n) break;  // block-uniform
    const int64_t s = base + threadIdx.x;
    const bool valid = s < n;
    const float2 g = valid ? __ldg(grad_out + s * num_levels + l)
                           : make_float2(0.0f, 0.0f);
    const bool nz = valid && (g.x != 0.0f || g.y != 0.0f);
    const unsigned nz_lanes = __ballot_sync(kFull, nz);
    if (nz_lanes == 0u) continue;  // the warp adds only zeros
    uint32_t x0[2], row[4];
    float frac[2], w[4];
    if (valid) {
      const float p[2] = {__ldg(pos + 2 * s), __ldg(pos + 2 * s + 1)};
      locate<2>(p, lv, x0, frac);
    } else {
      x0[0] = x0[1] = ~0u;
      frac[0] = frac[1] = 0.0f;
    }
    corners<2>(x0, frac, lv, hash_mask, hash_add != 0, row, w);
    float2 v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y));
    }
    const unsigned peers =
        __match_any_sync(kFull, ((unsigned long long)x0[1] << 32) | x0[0]);
    reduce_peers(peers, v);
    // The group's lowest lane adds, unless every lane of it was zero.
    if ((peers & ((1u << lane) - 1u)) != 0u || (nz_lanes & peers) == 0u) {
      continue;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicAdd(&acc[row[c]].x, v[c].x);
      atomicAdd(&acc[row[c]].y, v[c].y);
    }
  }
  __syncthreads();
  // Levels hold a multiple of 8 rows and start on a multiple of 8, so the
  // pairs are whole and 16-byte aligned in both copies.
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  float4* grad4 = reinterpret_cast<float4*>(grad);
  for (uint32_t r = threadIdx.x; r < lv.size / 2; r += kThreads) {
    const float4 q = acc4[r];
    if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f) {
      atomicAdd(grad4 + r, q);
    }
  }
}

unsigned int blocks_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <int D>
void launch_fwd(const float* table, const float* pos, float* out, int64_t n,
                int num_levels, uint32_t hash_mask, int hash_add,
                const int32_t* levels, cudaStream_t stream) {
  hashgrid_fwd_kernel<D><<<blocks_for(n * num_levels), kThreads, 0,
                           stream>>>(
      (const float2*)table, pos, (float2*)out, n, num_levels, hash_mask,
      hash_add, (const int4*)levels);
}

template <int D>
void launch_bwd(const float* pos, const float* grad_out, float* grad_table,
                int64_t n, int num_levels, uint32_t hash_mask, int hash_add,
                const int32_t* levels, cudaStream_t stream) {
  const dim3 grid(blocks_for(n), num_levels);
  hashgrid_bwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      pos, (const float2*)grad_out, (float2*)grad_table, n, num_levels,
      hash_mask, hash_add, (const int4*)levels);
}

// Samples per thread: about 16 blocks per level at the mask's 16384
// positions (4 each), up to kSpanMax at 2^19 positions and more.
cudaError_t launch_bwd2d(const float* pos, const float* grad_out,
                         float* grad_table, int64_t n, int num_levels,
                         uint32_t hash_mask, int hash_add,
                         const int32_t* levels, cudaStream_t stream) {
  const int64_t per_block = (int64_t)kThreads * 16;
  const int64_t want = (n + per_block - 1) / per_block;
  const int span = (int)(want < kSpanMax ? want : kSpanMax);
  const int64_t step = (int64_t)span * kThreads;
  const int smem = kSharedRows * (int)sizeof(float2);
  // Once per device (a launch is a few microseconds of host time, and the
  // mask's is host-bound).
  static bool attribute_set[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !attribute_set[device]) {
    err = cudaFuncSetAttribute(hashgrid_bwd2d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) attribute_set[device] = true;
  }
  const dim3 grid((unsigned int)((n + step - 1) / step), num_levels);
  hashgrid_bwd2d_kernel<<<grid, kThreads, smem, stream>>>(
      pos, (const float2*)grad_out, (float2*)grad_table, n, num_levels,
      hash_mask, hash_add, (const int4*)levels, span);
  return cudaSuccess;
}

}  // namespace

// table: [rows, 2] fp32, 16-byte aligned; pos: [n, num_dims] fp32; out:
// [n, num_levels, 2] fp32; levels: [num_levels, 8] int32 device table.
// num_dims is 3 (the nerfacto fields) or 2 (the HA-NeRF implicit mask);
// any other value returns cudaErrorInvalidValue. Returns a cudaError_t.
extern "C" int hashgrid_fwd(const float* table, const float* pos, float* out,
                            int64_t n, int num_levels, int num_dims,
                            uint32_t hash_mask, int hash_add,
                            const int32_t* levels, void* stream) {
  if (num_dims != 2 && num_dims != 3) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_dims == 3) {
    launch_fwd<3>(table, pos, out, n, num_levels, hash_mask, hash_add,
                  levels, s);
  } else {
    launch_fwd<2>(table, pos, out, n, num_levels, hash_mask, hash_add,
                  levels, s);
  }
  return (int)cudaGetLastError();
}

// pos: [n, num_dims] fp32; grad_out: [n, num_levels, 2] fp32; grad_table:
// [rows, 2] fp32, 16-byte aligned and zeroed by the caller; levels:
// [num_levels, 8] int32 device table. num_dims is 3 or 2, as for
// hashgrid_fwd. Returns a cudaError_t.
extern "C" int hashgrid_bwd(const float* pos, const float* grad_out,
                            float* grad_table, int64_t n, int num_levels,
                            int num_dims, uint32_t hash_mask, int hash_add,
                            const int32_t* levels, void* stream) {
  if (num_dims != 2 && num_dims != 3) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_dims == 3) {
    launch_bwd<3>(pos, grad_out, grad_table, n, num_levels, hash_mask,
                  hash_add, levels, s);
  } else {
    const cudaError_t err = launch_bwd2d(pos, grad_out, grad_table, n,
                                         num_levels, hash_mask, hash_add,
                                         levels, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
