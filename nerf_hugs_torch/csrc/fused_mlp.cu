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
// bf16 streamed weights (fused_mlp_bf16_kernel):
//   * A block owns a tile of rows and runs every layer over it; the tile's
//     activations ping-pong between two shared-memory buffers, rounded to
//     bf16, so only the input and the last layer's output touch device
//     memory.
//   * Weights stream through shared memory in fixed 64 x 64 slices. The
//     wrapper hands them over zero-padded to whole slices (W^T), so a
//     slice is 512 16-byte cp.async copies with no bounds checks, and the
//     copies of the next kStages - 1 slices (across chunk and layer
//     boundaries: the weights depend on nothing computed) overlap the
//     products on the current one. The input tile, a contiguous span of
//     x, arrives by cp.async as well.
//   * mma.sync m16n8k16 bf16 -> fp32 on the tensor cores, one warp per 16
//     rows of the tile, widths padded to 16 with zeros inside shared
//     memory.
//
// fp32 (fused_mlp_f32_kernel; enable_amp off): exact fp32 FMAs, as the
// plain version and JAX's HIGHEST precision compute them (the tensor
// cores' fp32 input is TF32, which would drop bits). What bounds it on
// this card is the FMA rate, 67 TFLOP/s: the field's head is 366 GFLOP
// over 2^21 rows, 5.43 ms, against 0.1 ms of bytes. The first design
// (4 x 4 register tiles, two ping-pong activation buffers of 172 KB at
// width 256, every layer padded to 64 columns and streamed from padded
// copies for every 64-row tile) took 22.1 ms there, slower than the cuBLAS
// fp32 chain (12.5 ms; NVIDIA H100 80GB HBM3, 700.00 W). Now:
//   * A thread holds an 8 x 8 tile of sums (64 registers): per 4 k, 8
//     float4 loads of activations (one address for a warp's lanes) and 8
//     of weights for 256 FMAs. A block holds a whole layer's output for a
//     tile of rows (rows x width <= 64 x threads), so the activations live
//     in one shared buffer, [rows][width + 4], updated in place: the sums
//     stay in registers until every thread has read the layer's input,
//     then overwrite it (64 KB at width 256, 64 rows).
//   * A thread's 8 columns are two runs of 4, c0 and n_cov / 2 + c0, so
//     a warp's weight loads and epilogue stores are contiguous.
//   * Layers are covered to a multiple of 8 columns, not 64 (3 -> 8, 65
//     -> 72, 1 -> 8). Where a layer's tiles leave threads idle (the narrow
//     output layers), S = 2..32 consecutive lanes share a tile, each
//     taking every S-th group of 4 k, and their sums meet by shuffles.
//   * The weights are read as the caller holds them ([d_in, d_out]
//     row-major, no host copy): `make_f32_plan` keeps every layer that
//     fits in shared memory for the whole launch (persistent blocks; two
//     of 256 threads an SM where everything fits 113 KB, as at the
//     proposal's base and NeRF-W's transient head, else one, as at the
//     field's base) and streams the rest in 32-row slices through a
//     two-stage cp.async ring, one barrier a slice, once per tile (the
//     heads' 256 x 256 layers and inputs). Streaming blocks have 512
//     threads and 128-row tiles, so each slice serves twice the rows.
//   * The input tile arrives by 4-byte cp.async copies with zero fill
//     past the rows and the width.
//   The head now takes 11.73 ms alone (the first design 21.23), below the
//   cuBLAS fp32 chain's 12.60, at 46% of its bound; the field's base 4.83
//   (9.10), the proposal's 0.80 (1.90) (tools/bench_fused_mlp.py --dtype
//   float32, one call, NVIDIA H100 80GB HBM3, 700.00 W). Tried on the card
//   and not kept, for no gain or a loss: prefetching the next 4 k of
//   activations into registers, the 8 x 8 products in the other loop
//   order, two 256-thread blocks an SM streaming 16-row slices at the
//   heads. The likeliest limits, unverified (no hardware counters on
//   that machine): the FMA loop's shared-memory loads (16 float4 a thread
//   per 256 FMAs), and in the bases the per-tile input copy and barriers.
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
  // Layer l of the streamed bf16 kernel, zero-padded by the caller: W^T
  // as [round_up(d_out, 64)][round_up(d_in, 64)] row-major.
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

// --- fp32: FMAs on 8x8 register tiles -----------------------------------

constexpr int kSliceF32 = 32;  // weight rows of a streamed slice
constexpr int kMaxSlices = kMaxLayers * kMaxWidth / kSliceF32;
// A block holds 64 sums a thread, so a tile of rows x n_cov outputs needs
// rows * n_cov <= 64 * threads. 256 threads where the weights stay
// resident, 512 (one block an SM, 128 registers a thread either way)
// where some stream: a tile twice as tall then takes each streamed slice.
constexpr int kMaxRowsF32 = 256;
// Shared memory of one of two blocks on an SM (228 KB less 1 KB a block).
constexpr int kHalfSmem = 115712;

struct F32Plan {
  const float* w[kMaxLayers];  // as the caller holds them, [d_in, d_out]
  int dims[kMaxLayers + 1];
  int k_pad[kMaxLayers];        // round_up(d_in, 4)
  int n_cov[kMaxLayers];        // round_up(d_out, 8): the columns computed
  int w_off[kMaxLayers];        // byte offset of a resident layer, else -1
  int slice_first[kMaxLayers];  // a streamed layer's first slice
  int num_layers;
  int threads;                  // 256 or 512
  int rows;                     // M: rows of a tile, a multiple of 8
  int astride;                  // floats per activation row
  int act_off;                  // the activations: rows x astride floats
  int ring_off, ring_stage;     // two stages of streamed weight slices
  int smem_bytes;
  int blocks_per_sm;            // 2 within kHalfSmem, else 1
  int slices;                   // streamed slices per tile
  uint8_t slice_layer[kMaxSlices];
  uint8_t slice_k4[kMaxSlices];  // first weight row / 4
};

// The fp32 rule, by widths alone; mirrored by ops/fused_mlp.py::f32_plan.
// A tile is at most as tall as a block's sums allow at the widest layer
// (64 x threads / n_cov rows, at most 256). Every layer stays resident
// where a block and tile height fit (below); else the layers that fit
// stay resident in order and the rest stream through the ring, in blocks
// of 512 threads at the tallest tile that fits beside the ring. (Choosing
// among 256- and 512-thread blocks by how many threads each layer keeps
// busy was slower at the field's base in a one-off comparison on the card
// (NVIDIA H100 80GB HBM3, 700.00 W): its 512-thread tile of 112 rows
// splits the output layer's sums four ways.)
bool make_f32_plan(const int32_t* dims, int num_layers, F32Plan* p) {
  int max_d = dims[0], max_cov = 0, weights = 0;
  for (int l = 0; l < num_layers; ++l) {
    p->dims[l] = dims[l];
    p->k_pad[l] = round_up(dims[l], 4);
    p->n_cov[l] = round_up(dims[l + 1], 8);
    p->w_off[l] = -1;
    p->slice_first[l] = 0;
    weights += p->k_pad[l] * p->n_cov[l] * 4;
    max_cov = max_cov > p->n_cov[l] ? max_cov : p->n_cov[l];
    max_d = max_d > dims[l + 1] ? max_d : dims[l + 1];
  }
  p->dims[num_layers] = dims[num_layers];
  p->num_layers = num_layers;
  p->astride = round_up(max_d, 4) + 4;
  const int row_bytes = p->astride * 4;
  auto top_rows = [&](int threads) {
    const int m = 64 * threads / max_cov / 8 * 8;
    return m < kMaxRowsF32 ? m : kMaxRowsF32;
  };
  // Every layer resident: in blocks of 256 threads, two an SM with the
  // tile down to half of the tallest, else one an SM at any height.
  auto resident_all = [&](int rows, int bps) {
    int off = 0;
    for (int l = 0; l < num_layers; ++l) {
      p->w_off[l] = off;
      off += p->k_pad[l] * p->n_cov[l] * 4;
    }
    p->threads = 256;
    p->rows = rows;
    p->act_off = off;
    p->ring_off = off + rows * row_bytes;
    p->ring_stage = 0;
    p->smem_bytes = p->ring_off;
    p->blocks_per_sm = bps;
    p->slices = 0;
    return true;
  };
  const int top = top_rows(256);
  for (int m = top; m >= 8 && 2 * m >= top; m = m / 2 / 8 * 8) {
    if (weights + m * row_bytes <= kHalfSmem) return resident_all(m, 2);
  }
  for (int m = top; m >= 8; m = m / 2 / 8 * 8) {
    if (weights + m * row_bytes <= kSmemBudget) return resident_all(m, 1);
  }
  const int ring = 2 * kSliceF32 * max_cov * 4;
  int m = top_rows(512);
  while (m > 8 && m * row_bytes + ring > kSmemBudget) m = m / 2 / 8 * 8;
  if (m * row_bytes + ring > kSmemBudget) return false;
  int off = 0, stream_cov = 0;
  for (int l = 0; l < num_layers; ++l) {
    const int bytes = p->k_pad[l] * p->n_cov[l] * 4;
    if (off + bytes + m * row_bytes + ring <= kSmemBudget) {
      p->w_off[l] = off;
      off += bytes;
    } else {
      stream_cov = stream_cov > p->n_cov[l] ? stream_cov : p->n_cov[l];
    }
  }
  p->threads = 512;
  p->rows = m;
  p->act_off = off;
  p->ring_off = off + m * row_bytes;
  p->ring_stage = kSliceF32 * stream_cov * 4;
  p->smem_bytes = p->ring_off + 2 * p->ring_stage;
  p->blocks_per_sm = 1;
  int q = 0;
  for (int l = 0; l < num_layers; ++l) {
    if (p->w_off[l] >= 0) continue;
    p->slice_first[l] = q;
    for (int k0 = 0; k0 < p->k_pad[l]; k0 += kSliceF32) {
      p->slice_layer[q] = (uint8_t)l;
      p->slice_k4[q] = (uint8_t)(k0 / 4);
      ++q;
    }
  }
  p->slices = q;
  return true;
}

__device__ __forceinline__ void cp_async_zfill4(void* smem, const void* gmem,
                                                bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_zfill16(void* smem,
                                                 const void* gmem,
                                                 bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Starts copying rows k0 .. k0 + len - 1 of layer l's W into `dst` as
// [len][n_cov], zero past d_in and past d_out (the caller commits): 16-byte
// copies where every row of W starts on 16 bytes, 4-byte ones otherwise.
// A thread keeps one column of copies and steps over rows.
__device__ __forceinline__ void copy_weight_rows(const F32Plan& p, int l,
                                                 int k0, int len,
                                                 float* dst) {
  const float* w = p.w[l];
  const int d_in = p.dims[l], d_out = p.dims[l + 1], ldw = p.n_cov[l];
  const bool vec =
      (d_out & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int width = vec ? 4 : 1;         // floats a copy
  const int per_row = ldw / width;       // at most 256: one pass of threads
  const int step = blockDim.x / per_row;  // rows a pass
  const int r0 = threadIdx.x / per_row;
  const int c = width * ((int)threadIdx.x - r0 * per_row);
  if (r0 >= step) return;
  for (int r = r0; r < len; r += step) {
    const bool ok = k0 + r < d_in && c < d_out;
    const float* src = ok ? w + (int64_t)(k0 + r) * d_out + c : w;
    if (vec) {
      cp_async_zfill16(dst + r * ldw + c, src, ok);
    } else {
      cp_async_zfill4(dst + r * ldw + c, src, ok);
    }
  }
}

// acc[i][j] += sum over k of a[i][k] w[k][col j], k4 = k / 4 from k4_begin
// to k4_end in steps of k4_step; `a` is row m0 of the activations, `w`
// the weight row k_base of the layer. Columns c0 .. c0 + 3 and half + c0 ..
// half + c0 + 3: each 4-wide run of a warp's lanes is contiguous, so the
// weight reads and the epilogue's writes are free of bank conflicts.
__device__ __forceinline__ void fma_tile(float (&acc)[8][8], const float* a,
                                         int astride, const float* w,
                                         int k_base, int ldw, int c0,
                                         int half, int k4_begin, int k4_end,
                                         int k4_step) {
#pragma unroll 1
  for (int k4 = k4_begin; k4 < k4_end; k4 += k4_step) {
    const int k = 4 * k4;
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + i * astride + k);
    }
    const float* wk = w + (k - k_base) * ldw;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 =
          *reinterpret_cast<const float4*>(wk + kk * ldw + c0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(wk + kk * ldw + half + c0);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ak = kk == 0 ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ak, bv[j], acc[i][j]);
      }
    }
  }
}

// Persistent blocks walk tiles of p.rows rows. A tile's activations live in
// one shared buffer, [rows][astride] row-major, updated in place: a layer's
// sums stay in registers until every thread is done reading its input,
// then overwrite it. Layer l's outputs are covered by (rows / 8) x (n_cov
// / 8) thread tiles of 8 rows x 8 columns; where that leaves threads idle
// (narrow layers), S threads share a tile, each taking every S-th group of
// 4 k, and their sums meet by shuffles (S consecutive lanes).
template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_mlp_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int64_t n, const __grid_constant__ F32Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* act = reinterpret_cast<float*>(smem + p.act_off);
  float* ring = reinterpret_cast<float*>(smem + p.ring_off);
  const int tid = threadIdx.x;
  const int rows_tile = p.rows, as = p.astride;
  const int d_in = p.dims[0], k_in = p.k_pad[0];
  const int d_out = p.dims[p.num_layers];

  for (int l = 0; l < p.num_layers; ++l) {
    if (p.w_off[l] >= 0) {
      copy_weight_rows(p, l, 0, p.k_pad[l],
                       reinterpret_cast<float*>(smem + p.w_off[l]));
    }
  }
  cp_async_commit();
  auto issue = [&](int pos, int stage) {
    const int l = p.slice_layer[pos], k0 = 4 * p.slice_k4[pos];
    const int len = min(kSliceF32, p.k_pad[l] - k0);
    copy_weight_rows(p, l, k0, len, ring + stage * (p.ring_stage / 4));
    cp_async_commit();
  };
  if (p.slices > 0) issue(0, 0);
  cp_async_wait_upto(p.slices > 0 ? 1 : 0);  // the resident weights
  __syncthreads();

  const int64_t tiles = (n + rows_tile - 1) / rows_tile;
  int q = 0;  // slices consumed by this block
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows_tile;
    const int rows = (int)(n - row0 < rows_tile ? n - row0 : rows_tile);
    __syncthreads();  // the previous tile's last layer has read act
    // The tile's rows of x by 4-byte copies, zero past row `rows` and
    // column d_in (k_in <= 256 <= threads: one column a thread).
    {
      const float* xs = x + row0 * d_in;
      const int step = kThreads / k_in, r0 = tid / k_in;
      const int c = tid - r0 * k_in;
      if (r0 < step) {
        for (int r = r0; r < rows_tile; r += step) {
          const bool ok = r < rows && c < d_in;
          cp_async_zfill4(act + r * as + c, ok ? xs + r * d_in + c : x, ok);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int l = 0; l < p.num_layers; ++l) {
      const int n_cov = p.n_cov[l], cgs = n_cov / 8, half = n_cov / 2;
      const int d_next = p.dims[l + 1];
      const int tiles_l = rows_tile / 8 * cgs;
      int split = 1;
      while (split < 32 && 2 * split * tiles_l <= kThreads) split *= 2;
      const int t = tid / split, part = tid - t * split;
      const bool active = t < tiles_l;
      const int rg = active ? t / cgs : 0;
      const int m0 = 8 * rg, c0 = 4 * (active ? t - rg * cgs : 0);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      const float* a = act + m0 * as;
      const int k4s = p.k_pad[l] / 4;
      if (p.w_off[l] >= 0) {
        if (active) {
          fma_tile(acc, a, as,
                   reinterpret_cast<const float*>(smem + p.w_off[l]), 0,
                   n_cov, c0, half, part, k4s, split);
        }
      } else {
        for (int pos = p.slice_first[l]; pos < p.slices &&
                                         p.slice_layer[pos] == l;
             ++pos) {
          cp_async_wait<0>();  // slice q has landed (this thread's part)
          // Every thread's part has, and every thread is done with slice
          // q - 1: its stage takes the next slice while q is multiplied.
          __syncthreads();
          issue((pos + 1) % p.slices, (q + 1) & 1);
          const int k4_0 = p.slice_k4[pos];
          const int k4_1 = min(k4_0 + kSliceF32 / 4, k4s);
          if (active) {
            fma_tile(acc, a, as, ring + (q & 1) * (p.ring_stage / 4),
                     4 * k4_0, n_cov, c0, half, k4_0 + part, k4_1, split);
          }
          ++q;
        }
      }
      // The sums of a shared tile meet in its part-0 lane; only columns
      // some lane of the tile keeps are summed.
      for (int o = split / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((j < 4 ? j : half + j - 4) < d_next) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
            }
          }
        }
      }
      const bool writer = active && part == 0;
      if (l < p.num_layers - 1) {
        __syncthreads();  // every thread has read this layer's input
        if (writer) {
          // ReLU that keeps a NaN, as torch.relu does; columns past the
          // layer's width are written as zeros (the next layer's padding).
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = j < 4 ? c0 + j : half + c0 + j - 4;
              v[j] = col >= d_next ? 0.0f
                     : acc[i][j] < 0.0f ? 0.0f
                                        : acc[i][j];
            }
            float* dst = act + (m0 + i) * as;
            *reinterpret_cast<float4*>(dst + c0) =
                make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(dst + half + c0) =
                make_float4(v[4], v[5], v[6], v[7]);
          }
        }
        __syncthreads();
      } else if (writer) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (m0 + i < rows) {
            float* dst = out + (row0 + m0 + i) * d_out;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = j < 4 ? c0 + j : half + c0 + j - 4;
              if (col < d_out) dst[col] = acc[i][j];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // slices issued past the block's last tile
}

template <int kThreads, int kMinBlocks>
cudaError_t launch_f32(const float* x, float* out, int64_t n,
                       const F32Plan& plan, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_f32_kernel<kThreads, kMinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + plan.rows - 1) / plan.rows;
  const int64_t most = (int64_t)sms * plan.blocks_per_sm;
  const unsigned int blocks = (unsigned int)(tiles < most ? tiles : most);
  fused_mlp_f32_kernel<kThreads, kMinBlocks>
      <<<blocks, kThreads, plan.smem_bytes, st>>>(x, out, n, plan);
  return cudaSuccess;
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
// dtype: 0 = float32, 1 = bfloat16. fp32 runs on fused_mlp_f32_kernel and
// bf16 widths that make_resident_plan accepts on the resident kernel, both
// taking each weight as the caller holds it, [d_in, d_out] row-major; the
// other bf16 widths take the zero-padded layout of Mlp::w. Returns a
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
    F32Plan plan;
    if (!make_f32_plan(dims, num_layers, &plan)) {
      return (int)cudaErrorInvalidValue;
    }
    for (int l = 0; l < num_layers; ++l) {
      plan.w[l] = static_cast<const float*>(weights[l]);
    }
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    err = plan.threads == 512    ? launch_f32<512, 1>(xf, of, n, plan, st)
          : plan.blocks_per_sm == 2 ? launch_f32<256, 2>(xf, of, n, plan, st)
                                    : launch_f32<256, 1>(xf, of, n, plan, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
