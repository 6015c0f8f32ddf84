// Grouped-expert FFN for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py::
// grouped_expert_ffn_pallas (_gemm_kernel).  The MoE capacity buffers are
// G groups of C padded rows; group g uses expert e = g / gpe (gpe = G/E)
// and keeps its first valid[g] rows:
//
//   h        [G, C, D]        (f32 or bf16)
//   w1, w1g  [E, D, F]        (same type; w1g only for the gated swiglu /
//                              geglu)
//   w2       [E, F, D]
//   valid    [G] int32        rows kept per group (clamped to [0, C])
//   act_ws   [G, C, F] f32    workspace the wrapper allocates
//   out      [G, C, D]        in h's type
//
//   out[g, r] = act(h[g, r] @ w1[e] [, h[g, r] @ w1g[e]]) @ f32(w2[e])
//               for r < valid[g], and exactly 0 for r >= valid[g].
//
// Numerics follow the reference: the first products accumulate bf16 (or
// f32) operands in f32 (a product of two bf16 values is exact in f32);
// the activation is f32 (silu(u) * g, tanh-approximate GELU, relu(u)^2);
// the second product is f32 x f32 with w2 widened to f32 and act never
// rounded to bf16 (no TF32); the output is rounded to h's type once.  Rows
// at or past valid[g] are SELECTED to zero before any product (garbage
// there cannot leak), and those output rows are written as exact zeros.
//
// Bound on this card: at the prefill shape of moonshot-v1-16b-a3b (G = E =
// 64, C = 480, D = 2048, F = 1408, swiglu, bf16, at most T*K = 24576 kept
// rows) the first products are 283 GFLOP of bf16 (0.29 ms at 989
// TFLOP/s), the second 142 GFLOP of f32 (2.12 ms at 67 TFLOP/s outside
// the tensor cores), the weights 1.1 GB (0.33 ms at 3.35 TB/s): the f32
// second product bounds the call, about 2.4 ms.
//
// Design (simple and correct first).  The Pallas kernel loads a whole
// expert's [D, F] weights per grid step into VMEM, which 227 KB of shared
// memory cannot hold, so both products are tiled in D and F, in two
// launches:
//   * launch A over (F tile, row tile, g): the u (and gate) tiles of
//     kRows x kColsA accumulate over D from shared-memory tiles of h
//     (rows past valid[g] staged as zeros) and of w1 / w1g, each thread
//     holding a 4 x 4 block of u and of g in registers; then the
//     activation in f32, written to the f32 workspace;
//   * launch B over (D tile, row tile, g): act (rows past valid[g] staged
//     as zeros) times f32(w2) over F, each thread a 4 x 8 block; rows past
//     valid[g] are written as zeros;
//   * a row tile that lies wholly past valid[g] does no arithmetic:
//     launch A skips it and launch B writes its zeros;
//   * every edge is masked, so any C, D, F >= 1 and valid in [0, C] work.
// The products run on the f32 SIMT units, not the tensor cores.  Later:
// bf16 mma.sync / wgmma for the first product, TMA-fed tiles, a
// persistent walk over only the live row tiles, and A and B fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kRows = 64;            // rows of a tile (both launches)
constexpr int kColsA = 64;           // F columns of a launch-A tile
constexpr int kColsB = 128;          // D columns of a launch-B tile
constexpr int kDepth = 16;           // contraction depth staged per step
constexpr int kPad = 4;              // keeps float4 rows aligned, banks apart

enum Act { kSwiglu = 0, kGeglu = 1, kRelu2 = 2, kGelu = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float gelu_tanh(float u) {
  const float k = 0.7978845608028654f;          // sqrt(2 / pi)
  return 0.5f * u * (1.0f + tanhf(k * (u + 0.044715f * u * u * u)));
}

template <int ACT>
__device__ __forceinline__ float activate(float u, float g) {
  if (ACT == kSwiglu) return u * (1.0f / (1.0f + expf(-u))) * g;
  if (ACT == kGeglu) return gelu_tanh(u) * g;
  if (ACT == kRelu2) {
    const float r = fmaxf(u, 0.0f);
    return r * r;
  }
  return gelu_tanh(u);
}

__device__ __forceinline__ int clamp_valid(const int* valid, int g, int c) {
  return max(0, min(valid[g], c));
}

// ---------------------------------------------------------------------------
// Launch A: act[g, r, f] = act(h[g, r] @ w1[e][:, f] [, h @ w1g])
// ---------------------------------------------------------------------------

template <typename T, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads)
ffn_up_kernel(const T* __restrict__ h, const T* __restrict__ w1,
              const T* __restrict__ w1g, const int* __restrict__ valid,
              float* __restrict__ act, int c, int d, int f, int gpe) {
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kColsA;
  const int v = clamp_valid(valid, g, c);
  if (row0 >= v) return;             // wholly padded: launch B zeroes it
  const int e = g / gpe;

  __shared__ __align__(16) float hs[kDepth][kRows + kPad];   // h^T tile
  __shared__ __align__(16) float us[kDepth][kColsA];
  __shared__ __align__(16) float gs[GATED ? kDepth : 1][kColsA];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* hg = h + (int64_t)g * c * d;
  const T* w1e = w1 + (int64_t)e * d * f;
  const T* wge = GATED ? w1g + (int64_t)e * d * f : nullptr;

  float acc_u[4][4], acc_g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_u[i][j] = acc_g[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    for (int i = tid; i < kRows * kDepth; i += kThreads) {
      const int m = i / kDepth, kk = i % kDepth;
      const int r = row0 + m, k = k0 + kk;
      hs[kk][m] = (r < v && k < d) ? to_f32(hg[(int64_t)r * d + k]) : 0.0f;
    }
    for (int i = tid; i < kDepth * kColsA; i += kThreads) {
      const int kk = i / kColsA, n = i % kColsA;
      const int k = k0 + kk, col = col0 + n;
      const bool in = k < d && col < f;
      const int64_t at = (int64_t)k * f + col;
      us[kk][n] = in ? to_f32(w1e[at]) : 0.0f;
      if (GATED) gs[kk][n] = in ? to_f32(wge[at]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&us[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc_u[i][j] = fmaf(av[i], bv[j], acc_u[i][j]);
      if (GATED) {
        const float4 q = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc_g[i][j] = fmaf(av[i], qv[j], acc_g[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= v) continue;            // launch B never reads these rows
    float* dst = act + ((int64_t)g * c + r) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < f) dst[col] = activate<ACT>(acc_u[i][j], acc_g[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch B: out[g, r, :] = act[g, r] @ f32(w2[e]), zero past valid[g]
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const float* __restrict__ act, const T* __restrict__ w2,
                const int* __restrict__ valid, T* __restrict__ out, int c,
                int d, int f, int gpe) {
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kColsB;
  const int v = clamp_valid(valid, g, c);
  const int tid = threadIdx.x;
  T* og = out + (int64_t)g * c * d;

  if (row0 >= v) {                   // wholly padded: exact zeros, no math
    const T zero = from_f32<T>(0.0f);
    for (int i = tid; i < kRows * kColsB; i += kThreads) {
      const int r = row0 + i / kColsB, col = col0 + i % kColsB;
      if (r < c && col < d) og[(int64_t)r * d + col] = zero;
    }
    return;
  }
  const int e = g / gpe;

  __shared__ __align__(16) float as[kDepth][kRows + kPad];   // act^T tile
  __shared__ __align__(16) float ws[kDepth][kColsB];

  const int tx = tid % 16, ty = tid / 16;
  const float* ag = act + (int64_t)g * c * f;
  const T* w2e = w2 + (int64_t)e * f * d;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < f; k0 += kDepth) {
    for (int i = tid; i < kRows * kDepth; i += kThreads) {
      const int m = i / kDepth, kk = i % kDepth;
      const int r = row0 + m, k = k0 + kk;
      as[kk][m] = (r < v && k < f) ? ag[(int64_t)r * f + k] : 0.0f;
    }
    for (int i = tid; i < kDepth * kColsB; i += kThreads) {
      const int kk = i / kColsB, n = i % kColsB;
      const int k = k0 + kk, col = col0 + n;
      ws[kk][n] = (k < f && col < d) ? to_f32(w2e[(int64_t)k * d + col])
                                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 8]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][tx * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= c) continue;
    T* dst = og + (int64_t)r * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx * 8 + j;
      if (col < d) dst[col] = from_f32<T>(r < v ? acc[i][j] : 0.0f);
    }
  }
}

template <typename T, int ACT, bool GATED>
int launch_up(const void* h, const void* w1, const void* w1g,
              const int* valid, float* act, int g, int c, int d, int f,
              int gpe, cudaStream_t stream) {
  const dim3 grid((f + kColsA - 1) / kColsA, (c + kRows - 1) / kRows, g);
  ffn_up_kernel<T, ACT, GATED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1),
      static_cast<const T*>(w1g), valid, act, c, d, f, gpe);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ffn(int act_code, const void* h, const void* w1, const void* w1g,
               const void* w2, const int* valid, float* act, void* out,
               int g, int c, int d, int f, int gpe, cudaStream_t stream) {
  int err;
  switch (act_code) {
    case kSwiglu:
      err = launch_up<T, kSwiglu, true>(h, w1, w1g, valid, act, g, c, d, f,
                                        gpe, stream);
      break;
    case kGeglu:
      err = launch_up<T, kGeglu, true>(h, w1, w1g, valid, act, g, c, d, f,
                                       gpe, stream);
      break;
    case kRelu2:
      err = launch_up<T, kRelu2, false>(h, w1, w1g, valid, act, g, c, d, f,
                                        gpe, stream);
      break;
    case kGelu:
      err = launch_up<T, kGelu, false>(h, w1, w1g, valid, act, g, c, d, f,
                                       gpe, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const dim3 grid((d + kColsB - 1) / kColsB, (c + kRows - 1) / kRows, g);
  ffn_down_kernel<T><<<grid, kThreads, 0, stream>>>(
      act, static_cast<const T*>(w2), valid, static_cast<T*>(out), c, d, f,
      gpe);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 swiglu, 1 geglu, 2 relu2,
// 3 gelu (w1g is read only for the gated 0 and 1).  Returns a cudaError_t
// (0 = both launches made).
extern "C" int grouped_ffn_launch(int dtype, int act_code, const void* h,
                                  const void* w1, const void* w1g,
                                  const void* w2, const int* valid,
                                  void* act_ws, void* out, int g, int c,
                                  int d, int f, int e, void* stream) {
  if (g < 1 || c < 1 || d < 1 || f < 1 || e < 1 || g % e != 0)
    return (int)cudaErrorInvalidValue;
  if ((act_code == kSwiglu || act_code == kGeglu) && w1g == nullptr)
    return (int)cudaErrorInvalidValue;
  if (g > 65535 || (c + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(act_ws);
  const int gpe = g / e;
  if (dtype == 0)
    return launch_ffn<float>(act_code, h, w1, w1g, w2, valid, ws, out, g, c,
                             d, f, gpe, s);
  if (dtype == 1)
    return launch_ffn<__nv_bfloat16>(act_code, h, w1, w1g, w2, valid, ws,
                                     out, g, c, d, f, gpe, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
