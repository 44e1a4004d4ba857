// Fused bias-free ReLU MLP forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (nerf_hugs_torch/ops/kernels.py).
//
// Replaces the Pallas kernel `_fused_forward_kernel` with its driver
// `_forward_pallas` (nerf_hugs_tpu/ops/fused_mlp.py:39-74): for one tile of
// rows, x -> relu(x W0) -> ... -> x W_{L-1} (the last layer linear, no
// biases), accumulated in fp32 and rounded to the input dtype after every
// layer, with the hidden activations kept on chip. The backward stays in
// PyTorch matmuls (ops/fused_mlp.py::_FusedMLP), as the JAX package leaves
// it to XLA.
//
// The nerfacto layers are narrow: inputs 14, 32 or 80 wide, hidden 64 or
// 256, outputs 1, 3 or 65, over 2-4 million rows. A row costs a few hundred
// bytes of input and output and up to ~90 kFLOP, so the work is bound by
// the matrix units and by how close to them the operands stay, not by
// device memory. The design:
//   * A block owns a tile of rows and runs every layer over it; the tile's
//     activations ping-pong between two shared-memory buffers, rounded to
//     the input dtype, so only the input and the last layer's output touch
//     device memory.
//   * Weights stream through shared memory in fixed 64-column slices (64 K
//     rows in bf16, 32 in fp32; a 256x256 fp32 layer is 256 KiB, more than
//     a block may hold). The wrapper hands them over zero-padded to whole
//     slices, so a slice is 512 16-byte cp.async copies with no bounds
//     checks, and the copies of the next kStages - 1 slices (across chunk
//     and layer boundaries: the weights depend on nothing computed)
//     overlap the products on the current one. The input tile, a
//     contiguous span of x, arrives by cp.async as well.
//   * bf16 (enable_amp): mma.sync m16n8k16 bf16 -> fp32 on the tensor
//     cores, one warp per 16 rows of the tile, widths padded to 16 with
//     zeros inside shared memory. Products of bf16 values are exact in
//     fp32, so the result differs from the plain version only by the order
//     of the fp32 sums, which can flip an isolated bf16 rounding.
//   * fp32: plain FMAs on 4x4 register tiles fed by float4 shared loads
//     (the tensor cores' fp32 input is TF32, which would drop bits the
//     plain version keeps).
// Nothing is read or written past a row of x or out, or past a column of
// out. No TMA and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kChunk = 64;  // output columns per pass over K

struct Mlp {
  // Layer l, zero-padded by the caller: bf16 W^T as [round_up(d_out, 64)]
  // [round_up(d_in, 64)], fp32 W as [round_up(d_in, 32)][round_up(d_out,
  // 64)], both row-major.
  const void* w[kMaxLayers];
  int dims[kMaxLayers + 1];
  int num_layers;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `kPending` of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Weight slices in the shared-memory ring: the one being multiplied and
// kStages - 1 in flight behind it.
constexpr int kStages = 4;

// Starts copying the block's rows of x, a contiguous span of rows * d_in
// elements, into `stage`: 16-byte cp.async copies when the span is 16-byte
// aligned (the caller commits them), plain loads otherwise and for the
// ragged tail.
template <typename T>
__device__ __forceinline__ void stage_input(const T* __restrict__ x,
                                            int64_t row0, int64_t n,
                                            int rows_per_block, int d_in,
                                            T* stage, int threads) {
  const int64_t rows = n - row0 < rows_per_block ? n - row0 : rows_per_block;
  const int count = (int)(rows * d_in);
  const T* src = x + row0 * d_in;
  constexpr int kPerCopy = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count / kPerCopy * kPerCopy;
    for (int i = threadIdx.x * kPerCopy; i < done; i += threads * kPerCopy) {
      cp_async16(stage + i, src + i);
    }
  }
  for (int i = done + threadIdx.x; i < count; i += threads) stage[i] = src[i];
}

// Walks a block's weight slices in order: layer l, output chunk n0, K
// slice k0; k_pad/n_pad are the extents the products cover.
template <int kSlice, int kPadK>
struct SliceCursor {
  int l = 0, n0 = 0, k0 = 0;
  __device__ __forceinline__ bool valid(const Mlp& m) const {
    return l < m.num_layers;
  }
  __device__ __forceinline__ int k_pad(const Mlp& m) const {
    return round_up(m.dims[l], kPadK);
  }
  __device__ __forceinline__ int n_pad(const Mlp& m) const {
    return round_up(m.dims[l + 1], kPadK);
  }
  __device__ __forceinline__ void advance(const Mlp& m) {
    k0 += kSlice;
    if (k0 < k_pad(m)) return;
    k0 = 0;
    n0 += kChunk;
    if (n0 < n_pad(m)) return;
    n0 = 0;
    ++l;
  }
};

// --- bf16: tensor cores --------------------------------------------------

constexpr int kWarpsBf16 = 4;
constexpr int kThreadsBf16 = 32 * kWarpsBf16;
constexpr int kRowsBf16 = 16 * kWarpsBf16;
constexpr int kSliceBf16 = 64;
// Transposed weight slice [kChunk][kSliceBf16 + 8]: the 8-element pad keeps
// rows 16-byte aligned and 9 16-byte units apart, so the ldmatrix row reads
// of the B fragments are free of bank conflicts.
constexpr int kWStrideBf16 = kSliceBf16 + 8;
constexpr int kWBufBf16 = kChunk * kWStrideBf16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives its fragment of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r,
                                            const __nv_bfloat16* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Copies the [64 n][64 k] slice at (n0, k0) of layer l's padded W^T.
__device__ __forceinline__ void issue_slice_bf16(
    const Mlp& m, const SliceCursor<kSliceBf16, 16>& c, __nv_bfloat16* dst) {
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(m.w[c.l]);
  const int ld = round_up(m.dims[c.l], 64);
#pragma unroll
  for (int i = 0; i < kChunk * kSliceBf16 / 8 / kThreadsBf16; ++i) {
    const int v = threadIdx.x + i * kThreadsBf16;
    const int row = v >> 3, col = (v & 7) * 8;
    cp_async16(dst + row * kWStrideBf16 + col,
               w + (int64_t)(c.n0 + row) * ld + c.k0 + col);
  }
}

// act_stride (elements) is the widest padded input width plus 8, so every
// activation row starts 16-byte aligned and an odd number of 16-byte units
// apart, which keeps the ldmatrix row reads free of bank conflicts.
__global__ void __launch_bounds__(kThreadsBf16)
fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ out, int64_t n, Mlp mlp,
                      int act_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act[2];
  act[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  act[1] = act[0] + kRowsBf16 * act_stride;
  __nv_bfloat16* wbuf = act[1] + kRowsBf16 * act_stride;  // kStages slices
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const int64_t row0 = (int64_t)blockIdx.x * kRowsBf16;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  // ldmatrix rows of this lane: the A tile's row lane % 16 at k offset
  // 8 * (lane / 16); for B, n-tile 2p + (lane / 16) row lane % 8 at k offset
  // 8 * ((lane / 8) % 2).
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_k = ((lane >> 3) & 1) * 8;

  // The first kStages - 1 weight slices and the input tile (staged in
  // act[1], which the first layer only writes to) go out together.
  SliceCursor<kSliceBf16, 16> cur, next;
  const int d_in = mlp.dims[0];
  stage_input(x, row0, n, kRowsBf16, d_in, act[1], kThreadsBf16);
  for (int i = 0; i < kStages - 1; ++i) {
    if (next.valid(mlp)) {
      issue_slice_bf16(mlp, next, wbuf + i * kWBufBf16);
      next.advance(mlp);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // the first group: slice 0 and the tile
  __syncthreads();
  // The input tile, zero past row n and past d_in up to a multiple of 16.
  const int k_pad_in = round_up(d_in, 16);
  for (int i = tid; i < kRowsBf16 * k_pad_in; i += kThreadsBf16) {
    const int r = i / k_pad_in, c = i - r * k_pad_in;
    act[0][r * act_stride + c] =
        (row0 + r < n && c < d_in) ? act[1][r * d_in + c] : zero;
  }

  float acc[kChunk / 8][4];
  for (int step = 0; cur.valid(mlp); ++step) {
    // Everyone is done with the buffer the next copy overwrites (and the
    // input tile / the last epilogue is written).
    __syncthreads();
    if (next.valid(mlp)) {
      issue_slice_bf16(mlp, next,
                       wbuf + ((step + kStages - 1) % kStages) * kWBufBf16);
      next.advance(mlp);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this step's slice has landed
    __syncthreads();

    const int l = cur.l;
    const int n_dim = mlp.dims[l + 1];
    const int k_len = min(kSliceBf16, cur.k_pad(mlp) - cur.k0);
    const int n_tiles = min(kChunk, cur.n_pad(mlp) - cur.n0) / 8;
    if (cur.k0 == 0) {
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      }
    }
    // Each warp reads and writes only its own 16 rows of the tile.
    const __nv_bfloat16* a_src =
        act[l & 1] + (warp * 16 + a_row) * act_stride + cur.k0 + a_k;
    const __nv_bfloat16* b_src =
        wbuf + (step % kStages) * kWBufBf16 + b_row * kWStrideBf16 + b_k;
#pragma unroll
    for (int ks = 0; ks < kSliceBf16 / 16; ++ks) {
      if (ks < k_len / 16) {
        uint32_t a[4];
        ldmatrix_x4(a, a_src + ks * 16);
#pragma unroll
        for (int p = 0; p < kChunk / 16; ++p) {
          if (2 * p < n_tiles) {  // n_tiles is even: n_pad is 16-aligned
            uint32_t b[4];
            ldmatrix_x4(b, b_src + p * 16 * kWStrideBf16 + ks * 16);
            mma_bf16(acc[2 * p], a, b[0], b[1]);
            mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
          }
        }
      }
    }

    if (cur.k0 + kSliceBf16 >= cur.k_pad(mlp)) {
      // The chunk is complete. Accumulator (j, h): rows warp*16 + g + 8h,
      // columns col, col + 1.
      const bool last = l == mlp.num_layers - 1;
      __nv_bfloat16* a_out = act[(l + 1) & 1];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        if (j >= n_tiles) continue;
        const int col = cur.n0 + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
          if (!last) {  // ReLU that keeps a NaN, as torch.relu does
            v0 = v0 < 0.0f ? 0.0f : v0;
            v1 = v1 < 0.0f ? 0.0f : v1;
          }
          const __nv_bfloat16 b0 = __float2bfloat16_rn(v0);
          const __nv_bfloat16 b1 = __float2bfloat16_rn(v1);
          if (last) {
            const int64_t row = row0 + r;
            if (row < n) {
              if (col < n_dim) out[row * n_dim + col] = b0;
              if (col + 1 < n_dim) out[row * n_dim + col + 1] = b1;
            }
          } else {
            __nv_bfloat162 pair;
            pair.x = b0;
            pair.y = b1;
            *reinterpret_cast<__nv_bfloat162*>(a_out + r * act_stride + col) =
                pair;
          }
        }
      }
    }
    cur.advance(mlp);
  }
}

// --- fp32: FMAs ---------------------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kRowsF32 = 64;
constexpr int kSliceF32 = 32;
constexpr int kWBufF32 = kSliceF32 * kChunk;

// Copies the [32 k][64 n] slice at (k0, n0) of layer l's padded W.
__device__ __forceinline__ void issue_slice_f32(
    const Mlp& m, const SliceCursor<kSliceF32, 1>& c, float* dst) {
  const float* w = static_cast<const float*>(m.w[c.l]);
  const int ld = round_up(m.dims[c.l + 1], 64);
#pragma unroll
  for (int i = 0; i < kSliceF32 * kChunk / 4 / kThreadsF32; ++i) {
    const int v = threadIdx.x + i * kThreadsF32;
    const int row = v >> 4, col = (v & 15) * 4;
    cp_async16(dst + row * kChunk + col,
               w + (int64_t)(c.k0 + row) * ld + c.n0 + col);
  }
}

// Activations are stored transposed, [k][kActStrideF32] (k-major, the 64
// rows of the tile contiguous), so thread (ty, tx) = (tid / 16, tid % 16),
// which owns rows 4 ty .. 4 ty + 3 and columns n0 + 4 tx .. n0 + 4 tx + 3,
// reads its four activations and its four weights of each k as one float4
// each: two shared loads per 16 FMAs. A warp's activation reads are two
// broadcasts.
constexpr int kActStrideF32 = kRowsF32 + 4;

__global__ void __launch_bounds__(kThreadsF32)
fused_mlp_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t n, Mlp mlp, int max_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wbuf = reinterpret_cast<float*>(smem);  // kStages slices
  float* act[2];
  act[0] = wbuf + kStages * kWBufF32;
  act[1] = act[0] + max_in * kActStrideF32;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)blockIdx.x * kRowsF32;

  SliceCursor<kSliceF32, 1> cur, next;
  const int d_in = mlp.dims[0];
  stage_input(x, row0, n, kRowsF32, d_in, act[1], kThreadsF32);
  for (int i = 0; i < kStages - 1; ++i) {
    if (next.valid(mlp)) {
      issue_slice_f32(mlp, next, wbuf + i * kWBufF32);
      next.advance(mlp);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  for (int i = tid; i < kRowsF32 * d_in; i += kThreadsF32) {
    const int r = i / d_in, c = i - r * d_in;
    act[0][c * kActStrideF32 + r] = row0 + r < n ? act[1][i] : 0.0f;
  }

  float acc[4][4];
  for (int step = 0; cur.valid(mlp); ++step) {
    __syncthreads();
    if (next.valid(mlp)) {
      issue_slice_f32(mlp, next,
                      wbuf + ((step + kStages - 1) % kStages) * kWBufF32);
      next.advance(mlp);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const int l = cur.l;
    const int k_dim = mlp.dims[l], n_dim = mlp.dims[l + 1];
    const int k_len = min(kSliceF32, k_dim - cur.k0);
    if (cur.k0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      }
    }
    const float* a_in = act[l & 1] + cur.k0 * kActStrideF32 + 4 * ty;
    const float* ws = wbuf + (step % kStages) * kWBufF32 + 4 * tx;
#pragma unroll 8
    for (int kk = 0; kk < k_len; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(
          a_in + kk * kActStrideF32);
      const float4 b = *reinterpret_cast<const float4*>(ws + kk * kChunk);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    if (cur.k0 + kSliceF32 >= k_dim) {
      const bool last = l == mlp.num_layers - 1;
      float* a_out = act[(l + 1) & 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cur.n0 + 4 * tx + j;
        if (col >= n_dim) continue;
        if (last) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int64_t row = row0 + 4 * ty + i;
            if (row < n) out[row * n_dim + col] = acc[i][j];
          }
        } else {
          float4 v;
          v.x = acc[0][j] < 0.0f ? 0.0f : acc[0][j];
          v.y = acc[1][j] < 0.0f ? 0.0f : acc[1][j];
          v.z = acc[2][j] < 0.0f ? 0.0f : acc[2][j];
          v.w = acc[3][j] < 0.0f ? 0.0f : acc[3][j];
          *reinterpret_cast<float4*>(a_out + col * kActStrideF32 + 4 * ty) =
              v;
        }
      }
    }
    cur.advance(mlp);
  }
}

}  // namespace

// x: [n, dims[0]]; weights: host array of num_layers device pointers to
// the zero-padded layouts of Mlp::w; dims: host array of num_layers + 1
// widths, each in 1..256; out: [n, dims[num_layers]]. All device arrays
// contiguous, of one dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t.
extern "C" int fused_mlp_fwd(const void* x, const void* const* weights,
                             const int32_t* dims, int num_layers, int64_t n,
                             void* out, int dtype, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers) {
    return (int)cudaErrorInvalidValue;
  }
  Mlp mlp;
  mlp.num_layers = num_layers;
  int max_in = 0;
  for (int l = 0; l <= num_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return (int)cudaErrorInvalidValue;
    mlp.dims[l] = dims[l];
    if (l < num_layers) {
      mlp.w[l] = weights[l];
      max_in = max_in > dims[l] ? max_in : dims[l];
    }
  }
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 1) {
    const int act_stride = round_up(max_in, 16) + 8;
    const size_t bytes =
        (2 * (size_t)kRowsBf16 * act_stride + kStages * (size_t)kWBufBf16) *
        sizeof(__nv_bfloat16);
    err = cudaFuncSetAttribute(fused_mlp_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned int blocks = (unsigned int)((n + kRowsBf16 - 1) / kRowsBf16);
    fused_mlp_bf16_kernel<<<blocks, kThreadsBf16, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        n, mlp, act_stride);
  } else if (dtype == 0) {
    const size_t bytes =
        (kStages * (size_t)kWBufF32 + 2 * (size_t)max_in * kActStrideF32) *
        sizeof(float);
    err = cudaFuncSetAttribute(fused_mlp_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const unsigned int blocks = (unsigned int)((n + kRowsF32 - 1) / kRowsF32);
    fused_mlp_f32_kernel<<<blocks, kThreadsF32, bytes, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, mlp,
        max_in);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
