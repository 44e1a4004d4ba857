// Integrated positional encoding of Mip-NeRF 360's MLPs for Hopper (sm_90a),
// forward and gradient, with a plain C interface loaded through ctypes
// (nerf_hugs_torch/ops/kernels.py).
//
// It replaces no TPU kernel: the JAX package writes the encoding as plain
// jnp (nerf_hugs_tpu/core/coord.py:81-100), which XLA fuses into one pass on
// the TPU. Eager PyTorch runs the same composition (core/coord.py::
// integrated_pos_enc with core/math.py::safe_sin) as some twenty passes over
// [samples, 2 L d] fp32 intermediates, and the MLP's first layer then casts
// the result to the compute dtype in one more. This kernel writes each
// feature once, in the output dtype.
//
// For a row of lifted means and variances [d] and frequencies
// s_l = 2^(min_deg + l), l < L, the row's 2 L d features are, l-major inside
// each half (the eager layout),
//   out[h L d + l d + j] = exp(-0.5 var_j s_l^2) * sin(R(mean_j s_l + h pi/2))
// for h = 0 (sines) and 1 (cosines), with R the range reduction of
// core/math.py::_range_reduce: x where |x| < 100 pi, else fmod(x, 100 pi)
// plus 100 pi where negative, 0 where not finite. Each operation is the
// eager pass's, in its order and in fp32: products and sums are rounded on
// their own (__fmul_rn / __fadd_rn, so nvcc fuses no multiply-add), sinf,
// expf and fmodf are the accurate library functions (never __sinf or
// __expf), the scalars are the floats that torch casts 100 pi and pi / 2 to,
// and the product is rounded once to the output dtype (round to nearest
// even). So the features are the eager composition's bits.
//
// What bounds it: the bytes (each row reads 8 d bytes and writes 2 L d
// features: 1.18 KB a row at d = 21, L = 12 in bf16) and the accurate sinf
// and expf of every feature, some tens of instructions each. A thread takes
// 16 bytes of output, 8 bf16 or 4 fp32 features in a row of the flat
// [n, 2 L d] array, finds their (row, half, l, j) with one division and
// steps through them, and writes them with one 16-byte store; a warp's
// stores are one contiguous run, and its reads of the means and variances
// stay in L1. Any d, L and n are taken: a chunk may run over a row's end,
// and the array's last, partial chunk is stored element by element.
//
// The gradient (ipe_bwd) takes the output's gradient g and sums, per (row,
// j), over l and both halves the closed form
//   d/dmean = g damp cos(R(x)) s,   d/dvar = g (-0.5 s^2) damp sin(R(x))
// (R's slope is 1 where x is finite, 0 elsewhere), one thread per (row, j).
// No shipped config reaches it: their sample intervals carry no gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The floats torch casts the Python scalars 100 * math.pi and 0.5 * math.pi
// to (core/math.py::_TRIG_PERIOD_CAP, core/coord.py::integrated_pos_enc).
constexpr float kCap = (float)(100.0 * 3.14159265358979323846);
constexpr float kHalfPi = (float)(0.5 * 3.14159265358979323846);

// 2^e, exactly, for -126 <= e <= 127 (the wrapper checks the range).
__device__ __forceinline__ float exp2_int(int e) {
  return __int_as_float((e + 127) << 23);
}

// core/math.py::_range_reduce.
__device__ __forceinline__ float wrap_arg(float x) {
  float r = fmodf(x, kCap);
  if (r < 0.0f) r = __fadd_rn(r, kCap);
  if (!isfinite(r)) r = 0.0f;
  return fabsf(x) < kCap ? x : r;
}

__device__ __forceinline__ float ipe_feature(float mean, float var, float s,
                                             int half) {
  const float sm = __fmul_rn(mean, s);
  const float damp = expf(__fmul_rn(__fmul_rn(var, __fmul_rn(s, s)), -0.5f));
  return __fmul_rn(damp, sinf(wrap_arg(half ? __fadd_rn(sm, kHalfPi) : sm)));
}

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kWidth = 4;  // features in 16 bytes
  static __device__ __forceinline__ void store(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float one(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  static __device__ __forceinline__ void store(__nv_bfloat16* dst,
                                               const float* v) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(dst) = u;
  }
  static __device__ __forceinline__ __nv_bfloat16 one(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ipe_fwd_kernel(const float* __restrict__ mean,
                   const float* __restrict__ var, T* __restrict__ out,
                   int64_t total, int d, int num_deg, int min_deg) {
  constexpr int V = Pack<T>::kWidth;
  const int64_t e0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e0 >= total) return;
  const int ld = num_deg * d;
  const int feats = 2 * ld;
  int64_t row;
  int k;
  if (total <= (int64_t)UINT32_MAX) {
    const uint32_t q = (uint32_t)e0 / (uint32_t)feats;
    row = q;
    k = (int)((uint32_t)e0 - q * (uint32_t)feats);
  } else {
    row = e0 / feats;
    k = (int)(e0 - row * feats);
  }
  int half = k >= ld;
  const int m = k - half * ld;
  int l = m / d;
  int j = m - l * d;
  const int n_here = total - e0 < V ? (int)(total - e0) : V;
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = 0.0f;
    if (i < n_here) {
      const int64_t at = row * d + j;
      v[i] = ipe_feature(__ldg(mean + at), __ldg(var + at),
                         exp2_int(min_deg + l), half);
    }
    if (++j == d) {
      j = 0;
      if (++l == num_deg) {
        l = 0;
        half ^= 1;
        row += half ^ 1;
      }
    }
  }
  if (n_here == V) {
    Pack<T>::store(out + e0, v);
  } else {
    for (int i = 0; i < n_here; ++i) out[e0 + i] = Pack<T>::one(v[i]);
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ipe_bwd_kernel(const float* __restrict__ mean,
                   const float* __restrict__ var, const T* __restrict__ g,
                   float* __restrict__ grad_mean,
                   float* __restrict__ grad_var, int64_t nd, int d,
                   int num_deg, int min_deg) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nd) return;
  const int64_t row = i / d;
  const int j = (int)(i - row * d);
  const int ld = num_deg * d;
  const T* gr = g + row * 2 * ld + j;
  const float mu = mean[i], va = var[i];
  float gm = 0.0f, gv = 0.0f;
  for (int l = 0; l < num_deg; ++l) {
    const float s = exp2_int(min_deg + l);
    const float x0 = __fmul_rn(mu, s);
    const float x1 = __fadd_rn(x0, kHalfPi);
    const float damp =
        expf(__fmul_rn(__fmul_rn(va, __fmul_rn(s, s)), -0.5f));
    float s0, c0, s1, c1;
    sincosf(wrap_arg(x0), &s0, &c0);
    sincosf(wrap_arg(x1), &s1, &c1);
    if (!isfinite(x0)) c0 = 0.0f;
    if (!isfinite(x1)) c1 = 0.0f;
    const float g0 = __fmul_rn(to_float(gr[l * d]), damp);
    const float g1 = __fmul_rn(to_float(gr[ld + l * d]), damp);
    gm = __fadd_rn(gm, __fmul_rn(__fadd_rn(__fmul_rn(g0, c0),
                                           __fmul_rn(g1, c1)), s));
    gv = __fadd_rn(gv, __fmul_rn(__fadd_rn(__fmul_rn(g0, s0),
                                           __fmul_rn(g1, s1)),
                                 __fmul_rn(__fmul_rn(s, s), -0.5f)));
  }
  grad_mean[i] = gm;
  grad_var[i] = gv;
}

template <typename T>
int launch_fwd(const float* mean, const float* var, void* out, int64_t n,
               int d, int num_deg, int min_deg, cudaStream_t stream) {
  const int64_t total = n * 2 * num_deg * d;
  const int64_t chunks = (total + Pack<T>::kWidth - 1) / Pack<T>::kWidth;
  const int64_t blocks = (chunks + kThreads - 1) / kThreads;
  ipe_fwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      mean, var, static_cast<T*>(out), total, d, num_deg, min_deg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const float* mean, const float* var, const void* g,
               float* grad_mean, float* grad_var, int64_t n, int d,
               int num_deg, int min_deg, cudaStream_t stream) {
  const int64_t nd = n * d;
  const int64_t blocks = (nd + kThreads - 1) / kThreads;
  ipe_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      mean, var, static_cast<const T*>(g), grad_mean, grad_var, nd, d,
      num_deg, min_deg);
  return (int)cudaGetLastError();
}

}  // namespace

// mean, var: [n, d] fp32, contiguous; out: [n, 2 num_deg d], contiguous and
// starting on 16 bytes, fp32 (dtype 0) or bf16 (dtype 1). Frequencies
// 2^[min_deg, min_deg + num_deg). Returns the launch's cudaError_t.
extern "C" int ipe_fwd(const void* mean, const void* var, void* out,
                       int64_t n, int d, int num_deg, int min_deg, int dtype,
                       void* stream) {
  if (d <= 0 || num_deg <= 0 || min_deg < -126 || min_deg + num_deg > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  return dtype == 0
             ? launch_fwd<float>(m, v, out, n, d, num_deg, min_deg, s)
             : launch_fwd<__nv_bfloat16>(m, v, out, n, d, num_deg, min_deg,
                                         s);
}

// mean, var: [n, d] fp32; g: [n, 2 num_deg d] fp32 (dtype 0) or bf16
// (dtype 1); grad_mean, grad_var: [n, d] fp32, written whole. All
// contiguous. Returns the launch's cudaError_t.
extern "C" int ipe_bwd(const void* mean, const void* var, const void* g,
                       void* grad_mean, void* grad_var, int64_t n, int d,
                       int num_deg, int min_deg, int dtype, void* stream) {
  if (d <= 0 || num_deg <= 0 || min_deg < -126 || min_deg + num_deg > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  float* gm = static_cast<float*>(grad_mean);
  float* gv = static_cast<float*>(grad_var);
  return dtype == 0 ? launch_bwd<float>(m, v, g, gm, gv, n, d, num_deg,
                                        min_deg, s)
                    : launch_bwd<__nv_bfloat16>(m, v, g, gm, gv, n, d,
                                                num_deg, min_deg, s);
}
