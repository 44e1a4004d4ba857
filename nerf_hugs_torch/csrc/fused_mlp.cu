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
// The nerfacto layers are narrow: inputs 10-128 wide, hidden 64 or 256,
// outputs 1, 3 or 65, over 2-4 million rows. A row costs a few hundred
// bytes of input and output and up to ~90 kFLOP. At the field's head
// (80 -> 256 -> 256 -> 3) the bf16 tensor-core peak bounds the card
// (0.37 ms for 2^21 rows against 0.11 ms of bytes); the field's base and
// the proposal's are bound by device memory. Two designs:
//
// bf16, resident weights (fused_mlp_resident_kernel; every shipped shape):
//   * Persistent blocks, one per SM, each of 2 (fragment arrays 256 wide)
//     or 4 (64 wide) consumer warpgroups and no producer warp. A block
//     copies the whole MLP into shared memory once, zero-padded and
//     transposed into the K-major core-matrix layout wgmma reads, from the
//     weights as the caller holds them ([d_in, d_out] row-major: no host
//     repack). Weights then cross L2 once per block, not once per 64 rows
//     (the head's 172 KB: 23 MB a pass instead of 7.5 GB).
//   * A warpgroup owns 64-row tiles, strided over the grid. Each layer is a
//     chain of wgmma.m64nNk16 per 64-column chunk (the last chunk 8, 16 or
//     32 wide), A from registers, B (the weights) from shared memory, the
//     sums in fp32 registers, waited for before the chunk's epilogue; the
//     other warpgroups' chains fill the wait. The ReLU'd sums are rounded
//     to bf16 and packed straight into the next layer's A fragments (two
//     adjacent n8 accumulator groups are one k16 A fragment), so hidden
//     activations never leave registers: at width 256, 64 + 64 fragment
//     registers and 32 sums a thread (246-250 registers with addressing,
//     no spills), within the 255 a thread may have at 2 warpgroups a
//     block, so setmaxnreg has nothing to move.
//   * Where the output is at most 72 wide and every earlier input at most
//     64 (both nerfacto bases: 14 -> 64 -> 1, 32 -> 256 -> 65), the last
//     hidden layer feeds the output layer chunk by chunk: each rounded
//     64-column chunk is the A fragments of 4 of the output layer's k
//     steps, issued into output sums that stay in registers and run under
//     the next chunk's chain. No 256-wide fragment array is then needed,
//     and 4 warpgroups fit (128 registers; the 65-wide output spills a few
//     bytes). The head (80 -> 256 -> 256 -> 3) keeps the plain order: fed
//     that way it needs 250+ registers and ptxas serialises its wgmma
//     chains (warning C7511), which made it a third slower on the card.
//   * Input tiles arrive by cp.async in a ring of up to 8 stages per
//     warpgroup: the 16-byte blocks covering the tile's contiguous span of
//     x (any alignment, ragged last tile), read into the first layer's
//     fragments, after which the slot refills with a later tile while the
//     layers run.
//   * Outputs are staged in shared memory as the [rows, d_out] span and
//     written out with 16-byte stores (a tile's span starts 16-byte
//     aligned) and a masked 2-byte tail.
//   Widths whose weights and one input tile do not fit 227 KB (more than
//   ~200 KB of weights, e.g. 8 layers of 256) take the streamed design.
//
// bf16 streamed weights (fused_mlp_bf16_kernel) and fp32:
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
//   * bf16: mma.sync m16n8k16 bf16 -> fp32 on the tensor cores, one warp
//     per 16 rows of the tile, widths padded to 16 with zeros inside
//     shared memory.
//   * fp32: plain FMAs on 4x4 register tiles fed by float4 shared loads
//     (the tensor cores' fp32 input is TF32, which would drop bits the
//     plain version keeps).
// Products of bf16 values are exact in fp32, so a bf16 result differs from
// the plain version only by the order of the fp32 sums, which can flip an
// isolated bf16 rounding. Nothing is written past a row of out or past a
// column of out; the resident kernel reads x only within the 16-byte
// blocks that hold its rows.

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

// --- bf16, resident weights: wgmma ---------------------------------------

constexpr int kTileRows = 64;        // rows of a wgmma tile (M)
constexpr int kSmemBudget = 232448;  // shared memory a block may have
constexpr int kMaxStages = 8;        // input tiles in flight per warpgroup
constexpr int kChunkN = 64;          // output columns per wgmma chain

// Columns a layer's products cover: 64-column chunks, the last one 8, 16,
// 32 or 64 wide. A hidden width pads to 16 first (it is the next layer's
// K), the output width to 8; the padding columns hold zero weights.
__host__ __device__ __forceinline__ int cover_width(int d, bool last) {
  const int n_pad = round_up(d, last ? 8 : 16);
  const int full = n_pad / 64 * 64, r = n_pad - full;
  return full + (r == 0 ? 0 : r <= 8 ? 8 : r <= 16 ? 16 : r <= 32 ? 32 : 64);
}

struct ResidentPlan {
  const __nv_bfloat16* w[kMaxLayers];  // as the caller holds them
  int dims[kMaxLayers + 1];
  int k_pad[kMaxLayers];   // round_up(d_in, 16)
  int n_cov[kMaxLayers];   // cover_width(d_out, last)
  int w_off[kMaxLayers];   // byte offset of layer l in shared memory
  int num_layers;
  int full_layers;         // layers whose whole output is kept
  int weight_bytes;
  int wgs;                 // consumer warpgroups per block
  int stages;              // input tiles in flight per warpgroup
  int tile_in_bytes;       // one input slot: 64 rows of x, plus 16 bytes
  int out_bytes;           // the output staging tile of a warpgroup
  int max_k;               // 64 or 256: the width of the fragment arrays
  int out_regs;            // output sums a thread holds: 4 or 36 where the
                           // last hidden layer feeds the output layer
                           // chunk by chunk (see the kernel), else 0
  int smem_bytes;
};

// Consumer warpgroups of a block by fragment width: as many as the
// registers allow (255 a thread at 2, 128 at 4).
__host__ __device__ constexpr int default_wgs(int max_k) {
  return max_k == 256 ? 2 : 4;
}

// The routing rule, by widths alone: true (and the plan) where the padded
// weights, each warpgroup's output tile and at least one input slot per
// warpgroup fit kSmemBudget, with default_wgs warpgroups or fewer.
// Mirrored by ops/fused_mlp.py::resident_plan.
bool make_resident_plan(const int32_t* dims, int num_layers,
                        ResidentPlan* p) {
  int off = 0;
  for (int l = 0; l < num_layers; ++l) {
    p->dims[l] = dims[l];
    p->k_pad[l] = round_up(dims[l], 16);
    p->n_cov[l] = cover_width(dims[l + 1], l == num_layers - 1);
    p->w_off[l] = off;
    off += p->k_pad[l] * p->n_cov[l] * 2;
  }
  p->dims[num_layers] = dims[num_layers];
  p->num_layers = num_layers;
  // The last hidden layer feeds the output layer chunk by chunk where the
  // output's sums fit a thread (72 columns) and every other layer's input
  // fits 64-wide fragment arrays; then 4 warpgroups share an SM.
  int k_all = 0, k_fused = 0;
  for (int l = 0; l < num_layers; ++l) {
    k_all = k_all > p->k_pad[l] ? k_all : p->k_pad[l];
    if (l < num_layers - 1) k_fused = k_all;
  }
  const int n_out = p->n_cov[num_layers - 1];
  const bool fused = num_layers >= 2 && n_out <= 72 && k_fused <= 64;
  p->full_layers = num_layers - 1 - fused;
  p->out_regs = !fused ? 0 : n_out > 8 ? 36 : 4;
  p->max_k = (fused ? k_fused : k_all) <= 64 ? 64 : 256;
  p->weight_bytes = off;
  p->tile_in_bytes = 128 * dims[0] + 16;
  p->out_bytes = 128 * dims[num_layers];
  for (int wgs = default_wgs(p->max_k); wgs >= 1; --wgs) {
    const int avail = kSmemBudget - off - wgs * p->out_bytes;
    int stages = avail < 0 ? 0 : avail / (wgs * p->tile_in_bytes);
    stages = stages < kMaxStages ? stages : kMaxStages;
    if (stages >= 1) {
      p->wgs = wgs;
      p->stages = stages;
      p->smem_bytes =
          off + wgs * (stages * p->tile_in_bytes + p->out_bytes);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the fence, issue and wait.
template <int kN>
__device__ __forceinline__ void reg_fence(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// B operand descriptor, K-major without swizzle: core matrices of 8 rows
// (n) x 16 bytes (8 k) stored as 128 contiguous bytes; `lbo` steps to the
// next core matrix along K, `sbo` to the next 8 rows along N.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D[64 x N] (+)= A[64 x 16] (registers) B[16 x N] (shared memory); D is
// zeroed first where scale_d is 0.
template <int kN>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
};

// One chunk of a layer: kSteps k16 steps, each advancing B by its two core
// matrices along K (256 bytes, 16 descriptor units).
template <int kN, int kSteps>
__device__ __forceinline__ void mma_chain(float* acc, const uint32_t* a,
                                          uint64_t desc) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    Wgmma<kN>::run(acc, a + 4 * s, desc + 16 * s, s > 0 ? 1 : 0);
  }
}

// The chain for a runtime step count in 1..kSteps, as straight-line code.
template <int kN, int kSteps>
__device__ __forceinline__ void mma_steps(int steps, float* acc,
                                          const uint32_t* a, uint64_t desc) {
  if (steps == kSteps) {
    mma_chain<kN, kSteps>(acc, a, desc);
    return;
  }
  if constexpr (kSteps > 1) mma_steps<kN, kSteps - 1>(steps, acc, a, desc);
}

// One chunk of `width` (8, 16, 32 or kChunkN) output columns.
template <int kMaxSteps>
__device__ __forceinline__ void mma_chunk(int width, int steps, float* acc,
                                          const uint32_t* a, uint64_t desc) {
  if (width == 64) {
    mma_steps<64, kMaxSteps>(steps, acc, a, desc);
  } else if (width == 32) {
    mma_steps<32, kMaxSteps>(steps, acc, a, desc);
  } else if (width == 16) {
    mma_steps<16, kMaxSteps>(steps, acc, a, desc);
  } else {
    mma_steps<8, kMaxSteps>(steps, acc, a, desc);
  }
}

// The output layer's products for one chunk of the last hidden layer:
// `steps` (1, 2 or 4) k16 steps from the fragments `f` into the sums
// `acc` (columns 0 .. w1 - 1, w1 = 8, 16, 32 or 64) and, with `tail`,
// acc + 32 (columns 64 .. 71, 8 rows of W^T further on).
template <int kOutRegs>
__device__ __forceinline__ void mma_out(int w1, bool tail, int steps,
                                        float* acc, const uint32_t* f,
                                        uint64_t desc, uint32_t sbo) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < steps) {
      const uint64_t d = desc + 16 * s;
      if constexpr (kOutRegs == 4) {
        Wgmma<8>::run(acc, f + 4 * s, d, 1);
      } else {
        if (w1 == 64) {
          Wgmma<64>::run(acc, f + 4 * s, d, 1);
        } else if (w1 == 32) {
          Wgmma<32>::run(acc, f + 4 * s, d, 1);
        } else if (w1 == 16) {
          Wgmma<16>::run(acc, f + 4 * s, d, 1);
        } else {
          Wgmma<8>::run(acc, f + 4 * s, d, 1);
        }
        if (tail) Wgmma<8>::run(acc + 32, f + 4 * s, d + ((8 * sbo) >> 4), 1);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// ReLU that keeps a NaN (as torch.relu does), rounded to bf16, as one A
// fragment register: `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t relu_pack(float lo, float hi) {
  lo = lo < 0.0f ? 0.0f : lo;
  hi = hi < 0.0f ? 0.0f : hi;
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Fragment layouts of wgmma m64nNk16 for warp w of the warpgroup, lane
// (g, t) = (lane / 4, lane % 4): A register j of k step s holds row
// 16w + g + 8 (j & 1), columns 16s + 8 (j >> 1) + 2t and + 1; accumulator
// 4i + 2h (+ 1) holds row 16w + g + 8h, column 8i + 2t (+ 1).
template <int kMaxK, int kOutRegs>
__global__ void __launch_bounds__(128 * default_wgs(kMaxK), 1)
fused_mlp_resident_kernel(const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ out, int64_t n,
                          const __grid_constant__ ResidentPlan p) {
  constexpr int kSteps = kMaxK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // The weights, once per block: element (k, c) of layer l's W goes to row
  // c, column k of its zero-padded W^T in core matrices (8 x 8 blocks of
  // 128 bytes, K-major). A warp reads one row k of W, coalesced along c.
  for (int l = 0; l < p.num_layers; ++l) {
    const int d_in = p.dims[l], d_out = p.dims[l + 1];
    const int k_pad = p.k_pad[l], n_cov = p.n_cov[l], kg = k_pad / 8;
    const __nv_bfloat16* w = p.w[l];
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + p.w_off[l]);
    for (int k = tid >> 5; k < k_pad; k += blockDim.x >> 5) {
      for (int c = tid & 31; c < n_cov; c += 32) {
        const __nv_bfloat16 v =
            (k < d_in && c < d_out) ? w[(int64_t)k * d_out + c] : zero;
        dst[((c >> 3) * kg + (k >> 3)) * 64 + (c & 7) * 8 + (k & 7)] = v;
      }
    }
  }
  // wgmma reads shared memory through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bar_id = 1 + wg;
  unsigned char* region = smem + p.weight_bytes +
                          wg * (p.stages * p.tile_in_bytes + p.out_bytes);
  __nv_bfloat16* stage_out =
      reinterpret_cast<__nv_bfloat16*>(region + p.stages * p.tile_in_bytes);
  const int d_in = p.dims[0], d_out = p.dims[p.num_layers];
  const int tiles = (int)((n + kTileRows - 1) / kTileRows);
  const int stride = gridDim.x * p.wgs;
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem);

  // Copies the 16-byte blocks that hold tile `tile`'s rows of x into
  // `slot` and commits them as one group (an empty one past the end).
  auto issue = [&](int tile, unsigned char* slot) {
    if (tile < tiles) {
      const int64_t row0 = (int64_t)tile * kTileRows;
      const int rows = (int)(n - row0 < kTileRows ? n - row0 : kTileRows);
      const uintptr_t src = reinterpret_cast<uintptr_t>(x + row0 * d_in);
      const uintptr_t lo = src & ~(uintptr_t)15;
      const int blocks = (int)((src + rows * d_in * 2 + 15 - lo) >> 4);
      for (int b = wtid; b < blocks; b += 128) {
        cp_async16(slot + 16 * b, reinterpret_cast<const void*>(lo + 16 * b));
      }
    }
    cp_async_commit();
  };
  const int first = blockIdx.x * p.wgs + wg;
  for (int s = 0; s < p.stages; ++s) {
    issue(first + s * stride, region + s * p.tile_in_bytes);
  }

  // f and acc_o (one element where kOutRegs is 0, and unused) serve the
  // last hidden layer's chunk-by-chunk feed of the output layer.
  uint32_t a[4 * kSteps], b[4 * kSteps], f[kChunkN / 4];
  float acc[kChunkN / 2], acc_o[kOutRegs > 0 ? kOutRegs : 1];
  int slot_i = 0;
  for (int tile = first; tile < tiles; tile += stride) {
    unsigned char* slot = region + slot_i * p.tile_in_bytes;
    slot_i = slot_i + 1 == p.stages ? 0 : slot_i + 1;
    const int64_t row0 = (int64_t)tile * kTileRows;
    const int rows = (int)(n - row0 < kTileRows ? n - row0 : kTileRows);
    cp_async_wait_upto(p.stages - 1);  // this tile's group has landed
    wg_barrier(bar_id);
    {
      // The first layer's fragments, zero past row `rows` and column d_in.
      const __nv_bfloat16* in =
          reinterpret_cast<const __nv_bfloat16*>(slot) +
          ((reinterpret_cast<uintptr_t>(x + row0 * d_in) & 15) >> 1);
      const int steps = p.k_pad[0] / 16;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (s < steps) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = warp * 16 + g + 8 * (j & 1);
            const int k = 16 * s + 8 * (j >> 1) + 2 * t;
            const bool row_ok = r < rows;
            const __nv_bfloat16 v0 =
                row_ok && k < d_in ? in[r * d_in + k] : zero;
            const __nv_bfloat16 v1 =
                row_ok && k + 1 < d_in ? in[r * d_in + k + 1] : zero;
            a[4 * s + j] = pack_bf16(v0, v1);
          }
        }
      }
    }
    wg_barrier(bar_id);  // every thread is done with the slot: refill it
    issue(tile + p.stages * stride, slot);

    // Every layer but the output layer where the last hidden one feeds it
    // chunk by chunk (kOutRegs > 0): one chunk loop, one wgmma site.
    const int l_out = p.num_layers - 1;
    const int l_end = kOutRegs > 0 ? l_out : p.num_layers;
#pragma unroll
    for (int j = 0; j < kOutRegs; ++j) acc_o[j] = 0.0f;
    for (int l = 0; l < l_end; ++l) {
      const int steps = p.k_pad[l] / 16, n_cov = p.n_cov[l];
      const uint32_t sbo = 16u * p.k_pad[l];  // 8 rows of W^T
      const uint32_t w_addr = smem_base + p.w_off[l];
      for (int c = 0; c * kChunkN < n_cov; ++c) {
        const int width =
            n_cov - kChunkN * c < kChunkN ? n_cov - kChunkN * c : kChunkN;
        const uint64_t desc =
            b_desc(w_addr + (kChunkN / 8) * c * sbo, 128, sbo);
        __syncwarp();
        reg_fence(acc);
        reg_fence(a);
        wgmma_fence();
        mma_chunk<kSteps>(width, steps, acc, a, desc);
        wgmma_commit();
        // (With kOutRegs > 0 this also retires the previous chunk's output
        // products, which read f.)
        wgmma_wait_all();
        reg_fence(acc);
        if (l < p.full_layers) {
          // Columns kChunkN c + 16q .. + 15 become k step (kChunkN / 16)
          // c + q of the next layer (hidden widths pad to 16).
#pragma unroll
          for (int cc = 0; cc < kMaxK / kChunkN; ++cc) {
            if (cc != c) continue;
#pragma unroll
            for (int q = 0; q < kChunkN / 16; ++q) {
              if (16 * q < width) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  b[4 * (kChunkN / 16 * cc + q) + j] =
                      relu_pack(acc[8 * q + 2 * j], acc[8 * q + 2 * j + 1]);
                }
              }
            }
          }
        } else if constexpr (kOutRegs > 0) {
          // The last hidden layer: the chunk, rounded, is the fragments f
          // of the output layer's k steps (kChunkN / 16) c .., whose
          // products run under the next chunk's. Only the output layer's
          // own k steps: columns past them (zero-weight padding) are
          // exact zeros.
#pragma unroll
          for (int q = 0; q < kChunkN / 16; ++q) {
            if (16 * q < width) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                f[4 * q + j] =
                    relu_pack(acc[8 * q + 2 * j], acc[8 * q + 2 * j + 1]);
              }
            }
          }
          const int n_out = p.n_cov[l_out];
          const int k_left = p.k_pad[l_out] - kChunkN * c;
          const uint32_t sbo_o = 16u * p.k_pad[l_out];
          __syncwarp();
          reg_fence(f);
          reg_fence(acc_o);
          wgmma_fence();
          mma_out<kOutRegs>(
              n_out < 64 ? n_out : 64, n_out > 64,
              (width < k_left ? width : k_left) / 16, acc_o, f,
              b_desc(smem_base + p.w_off[l_out] + (kChunkN / 16) * c * 256,
                     128, sbo_o),
              sbo_o);
          wgmma_commit();
        } else {
          // The output layer, into the staging tile.
#pragma unroll
          for (int j = 0; j < kChunkN / 8; ++j) {
            if (8 * j < width) {
              const int col = kChunkN * c + 8 * j + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                __nv_bfloat16* o = stage_out + (warp * 16 + g + 8 * h) * d_out;
                if (col < d_out) o[col] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
                if (col + 1 < d_out) {
                  o[col + 1] = __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
                }
              }
            }
          }
        }
      }
      if (l < p.full_layers) {
#pragma unroll
        for (int j = 0; j < 4 * kSteps; ++j) a[j] = b[j];
      }
    }
    if constexpr (kOutRegs > 0) {
      // The output layer's sums: columns 8j + 2t (+ 1) of the first 64,
      // then 64 + 2t (+ 1).
      wgmma_wait_all();
      reg_fence(acc_o);
#pragma unroll
      for (int j = 0; j < kOutRegs / 4; ++j) {
        const int col = (j < 8 ? 8 * j : 64) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16* o = stage_out + (warp * 16 + g + 8 * h) * d_out;
          if (col < d_out) o[col] = __float2bfloat16_rn(acc_o[4 * j + 2 * h]);
          if (col + 1 < d_out) {
            o[col + 1] = __float2bfloat16_rn(acc_o[4 * j + 2 * h + 1]);
          }
        }
      }
    }

    // The tile's output span, [rows, d_out] contiguous in out, starts
    // 16-byte aligned (64 rows are 128 d_out bytes; out is aligned).
    wg_barrier(bar_id);
    const int count = rows * d_out;
    __nv_bfloat16* dst = out + row0 * d_out;
    const int vecs = count / 8;
    for (int v = wtid; v < vecs; v += 128) {
      reinterpret_cast<uint4*>(dst)[v] =
          reinterpret_cast<const uint4*>(stage_out)[v];
    }
    for (int e = vecs * 8 + wtid; e < count; e += 128) dst[e] = stage_out[e];
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

template <int kMaxK, int kOutRegs>
cudaError_t launch_resident(const __nv_bfloat16* x, __nv_bfloat16* out,
                            int64_t n, const ResidentPlan& plan,
                            cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_resident_kernel<kMaxK, kOutRegs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int64_t wanted = (tiles + plan.wgs - 1) / plan.wgs;
  const unsigned int blocks =
      (unsigned int)(wanted < sms ? wanted : (int64_t)sms);
  fused_mlp_resident_kernel<kMaxK, kOutRegs>
      <<<blocks, 128 * plan.wgs, plan.smem_bytes, st>>>(x, out, n, plan);
  return cudaSuccess;
}

}  // namespace

// x: [n, dims[0]]; weights: host array of num_layers device pointers;
// dims: host array of num_layers + 1 widths, each in 1..256; out: [n,
// dims[num_layers]], 16-byte aligned. All device arrays contiguous, of one
// dtype: 0 = float32, 1 = bfloat16. bf16 widths that make_resident_plan
// accepts run on the resident kernel and take each weight as the caller
// holds it, [d_in, d_out] row-major; every other call takes the
// zero-padded layouts of Mlp::w. Returns a cudaError_t.
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
  ResidentPlan plan;
  if (dtype == 1 && make_resident_plan(dims, num_layers, &plan)) {
    if ((reinterpret_cast<uintptr_t>(out) & 15) != 0) {
      return (int)cudaErrorInvalidValue;
    }
    for (int l = 0; l < num_layers; ++l) {
      plan.w[l] = static_cast<const __nv_bfloat16*>(weights[l]);
    }
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
    err = plan.max_k == 256 ? launch_resident<256, 0>(xb, ob, n, plan, st)
          : plan.out_regs == 4  ? launch_resident<64, 4>(xb, ob, n, plan, st)
          : plan.out_regs == 36 ? launch_resident<64, 36>(xb, ob, n, plan, st)
                                : launch_resident<64, 0>(xb, ob, n, plan, st);
    if (err != cudaSuccess) return (int)err;
  } else if (dtype == 1) {
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
