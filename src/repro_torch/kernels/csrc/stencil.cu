// Jacobi 5-point stencil kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the TPU kernels of src/repro/kernels/stencil.py:
//
//   jacobi_step_kernel    <- jacobi_step_pallas (_jacobi_kernel): one sweep
//       u'[r, c] = 0.25 * (((up + down) + left) + right - f[r, c])
//     on columns 1..N-2 of the rows it is given, columns 0 and N-1 copied
//     (Dirichlet).  The row above row 0 and below row M-1 come from the
//     halo rows `lo` / `hi`; where one is null, that edge row is copied
//     through instead (the reference's Dirichlet rows).  Computed in f32
//     in the reference's order, each step rounded (`__f*_rn` are never
//     contracted into FMAs), so f32 agrees with the plain version bit for
//     bit.
//
//   jacobi_ksweep_kernel  <- jacobi_ksweep_pallas (_jacobi_multistep_kernel):
//     k sweeps per device-memory round trip of a k-halo-padded slab
//       padded rows [0, k)        = u_lo   (ghost rows above)
//       padded rows [k, k + m)    = u      (the local block)
//       padded rows [k + m, Mp)   = u_hi   (ghost rows below), Mp = m + 2k
//     and the same for f; writes the m centre rows after k sweeps.  A point
//     is updated iff its padded row p satisfies frozen_top <= p <
//     Mp - frozen_bot, 1 <= p <= Mp - 2, and its column is 1..N-2; the
//     others keep their initial value (frozen ghost rows, Dirichlet
//     columns).  The three parts arrive as separate pointers, so the
//     caller never concatenates a padded copy.
//
// Bound on this card: both are memory-bound.  One sweep of row 4 reads u
// and f and writes u' once: 12 bytes per f32 point against 6 flops, far
// below the f32 SIMT rate.  Row 5 moves the same three arrays (plus the
// apron) once per k sweeps, so its device-memory bound is 1/k of row 4's
// per sweep; its k sweeps inside the tile then read about 20-24 bytes of
// shared memory per point per sweep, which at k = 8 is more than the HBM
// traffic saved relative to shared memory's ~10x higher rate: shared
// memory, not HBM, bounds row 5 at k = 8 (PERF.md).
//
// Design (simple and correct first):
//   * row 4: one thread per column covers a strip of kRows rows, the
//     strip's loads unrolled and independent so that many are in flight;
//     the up / down / left / right neighbours a thread reads again were
//     loaded by itself or its warp (L1 hits), so device memory sees each
//     element about once.  The rows to update are given as two ranges, so
//     one launch does the whole block, the interior, or only the two edge
//     rows (the interleaved schedule's split).
//   * row 5: the Pallas tile spans whole rows (blk_m x N in VMEM), which
//     does not fit in 227 KB of shared memory.  Here a block stages a 2-D
//     tile, (blk_m + 2k) x (blk_n + 2k) in f32: the centre plus a k-wide
//     apron on all four sides (a 2-D trapezoid), with the source term
//     beside it and a second u tile to ping-pong between sweeps, one
//     block of 1024 threads per tile.  A flat 16 x 256 centre keeps the
//     three tiles at 102 KB for k = 8, so two blocks share an SM and one
//     loads while the other sweeps.  Sweep s updates the tile points
//     [s+1, T-1-s) in both directions, so after k sweeps the centre is
//     exact; points outside the array are zeros that no updated point
//     reads.  The frozen depths are runtime arguments
//     applied by global padded row, not by tile.  Ragged edges are masked,
//     so any m, N >= 1 is taken (the TPU kernel's blk_m fallback is a
//     BlockSpec artefact).  The tile sizes come from the caller
//     (kernels/stencil.py::KSWEEP_TILE, which core/cost_model.py prices).
// Later: vectorised 16-byte loads and register blocking in row 4;
// cp.async / TMA tile loads double-buffered against the sweeps in row 5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStepThreads = 128;   // row 4: columns per block
constexpr int kRows = 8;            // row 4: rows per thread strip
constexpr int kSweepTx = 32;        // row 5: block is kSweepTx x kSweepTy,
constexpr int kSweepTy = 32;        // 32 warps to hide shared-memory latency
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

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

// 0.25 * (((up + down) + left) + right - f), each operation rounded to f32
__device__ __forceinline__ float five_point(float up, float down, float left,
                                            float right, float f) {
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(up, down), left), right);
  return __fmul_rn(0.25f, __fsub_rn(s, f));
}

// ---------------------------------------------------------------------------
// Row 4: one sweep
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
jacobi_step_kernel(const T* __restrict__ u, const T* __restrict__ f,
                   const T* __restrict__ lo, const T* __restrict__ hi,
                   T* __restrict__ out, int m, int n, int a0, int a1, int b0,
                   int b1) {
  const int c = blockIdx.x * kStepThreads + threadIdx.x;
  if (c >= n) return;
  const int na = a1 - a0;
  const int nvirt = na + (b1 - b0);
  const int v0 = blockIdx.y * kRows;
  const bool edge_col = (c == 0 || c == n - 1);
  // Unrolled with no loop-carried values: every row's loads are
  // independent, so a thread keeps many in flight; the neighbour rows and
  // columns it reads again come from L1.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int v = v0 + i;
    if (v < nvirt) {
      const int r = v < na ? a0 + v : b0 + (v - na);
      const int64_t at = (int64_t)r * n + c;
      const bool dirichlet_row = (r == 0 && lo == nullptr) ||
                                 (r == m - 1 && hi == nullptr);
      if (edge_col || dirichlet_row) {
        out[at] = u[at];
      } else {
        const float up = r > 0 ? to_f32(u[at - n]) : to_f32(lo[c]);
        const float down = r < m - 1 ? to_f32(u[at + n]) : to_f32(hi[c]);
        out[at] = from_f32<T>(five_point(up, down, to_f32(u[at - 1]),
                                         to_f32(u[at + 1]),
                                         to_f32(f[at])));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Row 5: k sweeps on a 2-D apron tile
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float padded_at(const T* lo, const T* mid,
                                           const T* hi, int k, int m, int n,
                                           int p, int c) {
  if (p < k) return to_f32(lo[(int64_t)p * n + c]);
  if (p < k + m) return to_f32(mid[(int64_t)(p - k) * n + c]);
  return to_f32(hi[(int64_t)(p - k - m) * n + c]);
}

template <typename T>
__global__ void __launch_bounds__(kSweepTx * kSweepTy)
jacobi_ksweep_kernel(const T* __restrict__ u_lo, const T* __restrict__ u,
                     const T* __restrict__ u_hi, const T* __restrict__ f_lo,
                     const T* __restrict__ f, const T* __restrict__ f_hi,
                     T* __restrict__ out, int m, int n, int k, int frozen_top,
                     int frozen_bot, int blk_m, int blk_n) {
  extern __shared__ float smem[];
  const int tm = blk_m + 2 * k;
  const int tn = blk_n + 2 * k;
  float* ta = smem;                 // u, even sweeps read it
  float* tb = ta + tm * tn;         // u, odd sweeps read it
  float* tf = tb + tm * tn;         // f
  const int mp = m + 2 * k;
  const int o0 = blockIdx.y * blk_m;  // first centre row (output row)
  const int c0 = blockIdx.x * blk_n;  // first centre column
  const int tx = threadIdx.x, ty = threadIdx.y;

  // tile row i <-> padded row o0 + i; tile column j <-> column c0 - k + j
  for (int i = ty; i < tm; i += kSweepTy) {
    const int p = o0 + i;
    for (int j = tx; j < tn; j += kSweepTx) {
      const int c = c0 - k + j;
      float uv = 0.f, fv = 0.f;
      if (p < mp && c >= 0 && c < n) {
        uv = padded_at(u_lo, u, u_hi, k, m, n, p, c);
        fv = padded_at(f_lo, f, f_hi, k, m, n, p, c);
      }
      ta[i * tn + j] = uv;
      tb[i * tn + j] = uv;
      tf[i * tn + j] = fv;
    }
  }
  __syncthreads();

  // Sweep s updates the tile points [s+1, T-1-s) in both directions that
  // are updatable globally: padded rows [p_lo, p_hi), columns [1, n-1).
  // The bounds are clipped once per sweep, so the inner loops carry no
  // per-point test.
  const int p_lo = max(frozen_top, 1);
  const int p_hi = min(mp - frozen_bot, mp - 1);
  for (int s = 0; s < k; ++s) {
    const float* src = (s & 1) ? tb : ta;
    float* dst = (s & 1) ? ta : tb;
    const int i_lo = max(s + 1, p_lo - o0);
    const int i_hi = min(tm - 1 - s, p_hi - o0);
    const int j_lo = max(s + 1, 1 - (c0 - k));
    const int j_hi = min(tn - 1 - s, n - 1 - (c0 - k));
    for (int i = i_lo + ty; i < i_hi; i += kSweepTy) {
      for (int j = j_lo + tx; j < j_hi; j += kSweepTx) {
        const int at = i * tn + j;
        dst[at] = five_point(src[at - tn], src[at + tn], src[at - 1],
                             src[at + 1], tf[at]);
      }
    }
    __syncthreads();
  }

  const float* res = (k & 1) ? tb : ta;
  for (int i = k + ty; i < k + blk_m; i += kSweepTy) {
    const int o = o0 + i - k;
    if (o >= m) break;
    for (int j = k + tx; j < k + blk_n; j += kSweepTx) {
      const int c = c0 + j - k;
      if (c >= n) break;
      out[(int64_t)o * n + c] = from_f32<T>(res[i * tn + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_step(const void* u, const void* f, const void* lo, const void* hi,
                void* out, int m, int n, int a0, int a1, int b0, int b1,
                cudaStream_t stream) {
  const int nvirt = (a1 - a0) + (b1 - b0);
  if (nvirt <= 0) return 0;
  // column tiles fastest: the blocks in flight cover whole row bands,
  // so device memory sees long runs of consecutive addresses
  const dim3 grid((n + kStepThreads - 1) / kStepThreads,
                  (nvirt + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_step_kernel<T><<<grid, kStepThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(f),
      static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<T*>(out), m, n, a0, a1, b0, b1);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ksweep(const void* u_lo, const void* u, const void* u_hi,
                  const void* f_lo, const void* f, const void* f_hi,
                  void* out, int m, int n, int k, int frozen_top,
                  int frozen_bot, int blk_m, int blk_n,
                  cudaStream_t stream) {
  static int smem_opted_in = 0;       // bytes already granted above 48 KB
  const size_t smem =
      3 * sizeof(float) * (size_t)(blk_m + 2 * k) * (size_t)(blk_n + 2 * k);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && (int)smem > smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_ksweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted_in = (int)smem;
  }
  const dim3 grid((n + blk_n - 1) / blk_n, (m + blk_m - 1) / blk_m);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_ksweep_kernel<T><<<grid, dim3(kSweepTx, kSweepTy), smem, stream>>>(
      static_cast<const T*>(u_lo), static_cast<const T*>(u),
      static_cast<const T*>(u_hi), static_cast<const T*>(f_lo),
      static_cast<const T*>(f), static_cast<const T*>(f_hi),
      static_cast<T*>(out), m, n, k, frozen_top, frozen_bot, blk_m, blk_n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns a cudaError_t (0 =
// launched).  Rows [a0, a1) and [b0, b1) of `out` are written; lo / hi may
// be null (the edge row is then a Dirichlet row).
extern "C" int jacobi_step_launch(int dtype, const void* u, const void* f,
                                  const void* lo, const void* hi, void* out,
                                  int m, int n, int a0, int a1, int b0,
                                  int b1, void* stream) {
  if (m <= 0 || n <= 0 || a0 < 0 || a1 > m || b0 < 0 || b1 > m)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float>(u, f, lo, hi, out, m, n, a0, a1, b0, b1, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(u, f, lo, hi, out, m, n, a0, a1, b0,
                                      b1, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int jacobi_ksweep_launch(int dtype, const void* u_lo,
                                    const void* u, const void* u_hi,
                                    const void* f_lo, const void* f,
                                    const void* f_hi, void* out, int m,
                                    int n, int k, int frozen_top,
                                    int frozen_bot, int blk_m, int blk_n,
                                    void* stream) {
  if (m <= 0 || n <= 0 || k < 1 || blk_m < 1 || blk_n < 1 ||
      frozen_top < 0 || frozen_bot < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ksweep<float>(u_lo, u, u_hi, f_lo, f, f_hi, out, m, n, k,
                                frozen_top, frozen_bot, blk_m, blk_n, s);
  if (dtype == 1)
    return launch_ksweep<__nv_bfloat16>(u_lo, u, u_hi, f_lo, f, f_hi, out, m,
                                        n, k, frozen_top, frozen_bot, blk_m,
                                        blk_n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* stencil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
