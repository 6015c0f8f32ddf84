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
// ghost rows) once per k sweeps, so its device-memory bound is 1/k of row
// 4's per sweep; at k = 8 its 2.1e9 updates, at about 18 issued
// instructions each (5 of them the update's f32 operations), take longer
// than that bound: instruction issue, not HBM, bounds it there, so the
// design keeps every update in registers and overlaps the loads with the
// sweeps (PERF.md).
//
// Design:
//   * row 4: one thread per column covers a strip of kRows rows, the
//     strip's loads unrolled and independent so that many are in flight;
//     the up / down / left / right neighbours a thread reads again were
//     loaded by itself or its warp (L1 hits), so device memory sees each
//     element about once.  The rows to update are given as two ranges, so
//     one launch does the whole block, the interior, or only the two edge
//     rows (the interleaved schedule's split).
//   * row 5: a pipeline streamed down a strip of rows (temporal blocking).
//     A CTA owns a band of kBand = 192 x kCols loaded columns (kCentre =
//     kBand - 2k written, a k-column apron each side) and a strip of
//     `strip` output rows, and walks down the strip's m_s + 2k padded rows
//     one row per step.  The k sweeps are k stages: at the step that loads
//     padded row p, sweep s produces row p - s from sweep s - 1's rows
//     p - s - 1 .. p - s + 1, so only a three-row window per stage lives on
//     chip.  Each thread owns kCols consecutive columns and keeps its
//     windows in registers (stage s's row of step t in slot t % 3; the
//     step loop is unrolled by 3 so no window is copied); neighbours inside
//     a thread come free, across lanes by one __shfl_up / __shfl_down of a
//     stage's middle row, across warps through a small edge buffer in
//     shared memory written one step earlier.  Sweep 1 reads u from the
//     ring, the last sweep's row is staged in shared memory and written
//     coalesced one step later.  Rows of u and f arrive kKsAhead steps
//     ahead through 4-byte cp.async copies into a ring in shared memory (f
//     kept k + 1 rows longer for the stages in flight).  One barrier per
//     step serves all stages: the ring, the edge buffer and the staged row
//     are read one step after they are written.  Rows a stage computes
//     above its strip's valid trapezoid (its first s rows) and the
//     apron's outer columns are redundant: 2k rows per strip and 2k
//     columns per band.  Frozen depths are runtime arguments applied by
//     global padded row; points outside the array load as zeros that no
//     updated point reads; any m, N >= 1 is taken.  The f32 arithmetic is
//     row 4's, so both agree with the plain versions bit for bit.
//     TMA is not used: a 16386-column f32 row is 65,544 bytes, no multiple
//     of 16, and the slab's parts may be views with element-aligned bases;
//     bf16 rows are copied as 4-byte pairs from the row's first aligned
//     column (the slot's shift), the pair that straddles an array edge by
//     plain loads.  The band width, the strip length and the CTA count come
//     from kernels/stencil.py::ksweep_plan, which mirrors the constants
//     below; core/cost_model.py prices the shared memory (kSmem) it holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kStepThreads = 128;   // row 4: columns per block
constexpr int kRows = 8;            // row 4: rows per thread strip
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
// Row 5: k sweeps as a k-stage pipeline streamed down a row strip
// ---------------------------------------------------------------------------

// The geometry (kernels/stencil.py::KSWEEP_* mirror it): threads a CTA,
// columns a thread owns, CTAs the launch bounds keep resident on an SM,
// and rows loaded ahead of sweep 1.  The launch bounds cap the registers
// at 170 a thread, which the k - 1 sweeps' windows of 3 x kKsCols floats
// must fit without a spill.  Timed at 16386^2 f32 on an H100 as edits of
// these four (PERF.md section 6): 256 threads (capped at 128 registers)
// and 224 spilled at k = 8 and were slower, 160 threads slower at k = 4
// and 8, 8 columns or 1 CTA an SM 1.5-1.6x slower at every k, 6 rows
// ahead or 128 threads at 3 CTAs equal at k = 2 and slower at k = 4, 8.
constexpr int kKsThreads = 192;
constexpr int kKsWarps = kKsThreads / 32;
constexpr int kKsCols = 4;
constexpr int kKsCtas = 2;
constexpr int kKsAhead = 4;
constexpr int kKsMaxK = 8;                   // one instantiation per k

template <typename T, int K>
struct KsGeom {
  static constexpr int kCols = kKsCols;
  static constexpr int kBand = kKsThreads * kCols;      // loaded columns
  static constexpr int kCentre = kBand - 2 * K;          // written columns
  static constexpr int kRingU = kKsAhead + 3;   // rows p - 2 .. p + ahead
  static constexpr int kRingF = kKsAhead + K + 1;  // rows p - k .. p + ahead
  static constexpr int kSlot = kBand * (int)sizeof(T) + 16;  // bytes a row
  static constexpr int kEdgeRow = (kKsWarps + 2) * 2;   // floats
  static constexpr int kEdges = 2 * (K - 1) * kEdgeRow;
  static constexpr int kSmem =
      (kRingU + kRingF) * kSlot + 2 * kBand * 4 + kEdges * 4;
  static_assert(kCols % 4 == 0 && kCentre > 0, "band");
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy; with ok == false the destination is
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Padded row q of the slab [lo; mid; hi] (k + m + k rows of n)
template <typename T>
__device__ __forceinline__ const T* slab_row(const T* lo, const T* mid,
                                             const T* hi, int k, int m,
                                             int n, int q) {
  if (q < k) return lo + (int64_t)q * n;
  if (q < k + m) return mid + (int64_t)(q - k) * n;
  return hi + (int64_t)(q - k - m) * n;
}

// Elements a row's ring slot starts before band column 0 (column cb): 0 in
// f32; in bf16 1 where column cb is not 4-byte aligned, so that every
// 4-byte copy of a pair is
template <typename T>
__device__ __forceinline__ int slot_shift(const T* row, int cb) {
  if constexpr (sizeof(T) == 4) {
    return 0;
  } else {
    return (int)((reinterpret_cast<uintptr_t>(row) / sizeof(T) +
                  (uintptr_t)(intptr_t)cb) & 1);
  }
}

// Issue the copies of one row's band (columns cb .. cb + kBand - 1, zeros
// outside [0, n)) into a ring slot: 4-byte cp.async where the unit lies in
// the row, zero-filled (f32) or a plain store of zeros (bf16) where it
// lies outside, and in bf16 plain loads for the pair that straddles column
// 0 or n - 1
template <typename T, int K>
__device__ __forceinline__ void issue_row(unsigned char* slot, const T* row,
                                          int cb, int n, int tid) {
  using G = KsGeom<T, K>;
  constexpr int kPer = 4 / (int)sizeof(T);           // elements a unit
  constexpr int kUnits = (G::kBand + 2 * (kPer - 1)) / kPer;
  constexpr int kEach = (kUnits + kKsThreads - 1) / kKsThreads;
  const int g0 = cb - slot_shift(row, cb);           // column of unit 0
  uint32_t* units = reinterpret_cast<uint32_t*>(slot);
#pragma unroll
  for (int q = 0; q < kEach; ++q) {
    const int i = tid + q * kKsThreads;
    if (kUnits % kKsThreads != 0 && i >= kUnits) break;
    const int c = g0 + i * kPer;
    if constexpr (kPer == 1) {        // f32: no branch, no straddling pair
      const bool in = c >= 0 && c < n;
      cp_async4(units + i, row + (in ? c : 0), in);
    } else if (c >= 0 && c + kPer <= n) {
      cp_async4(units + i, row + c, true);
    } else if (c + kPer <= 0 || c >= n) {
      units[i] = 0u;
    } else {                                         // bf16 only
      const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
      const uint32_t lo = c >= 0 ? r16[c] : 0u;
      const uint32_t hi = c + 1 < n ? r16[c + 1] : 0u;
      units[i] = lo | (hi << 16);
    }
  }
}

// Band column j of a ring slot, as f32
template <typename T>
__device__ __forceinline__ float slot_at(const unsigned char* slot, int sh,
                                         int j) {
  return to_f32(reinterpret_cast<const T*>(slot)[j + sh]);
}

// The C band columns j0 .. j0 + C - 1 of a ring slot, as f32
template <typename T, int C>
__device__ __forceinline__ void slot_cols(const unsigned char* slot, int sh,
                                          int j0, float (&v)[C]) {
  if constexpr (sizeof(T) == 4) {
    const float4* p = reinterpret_cast<const float4*>(slot) + j0 / 4;
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 x = p[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = slot_at<T>(slot, sh, j0 + j);
  }
}

// What one CTA works on, fixed for its walk down the strip
template <typename T, int K>
struct KsCta {
  using G = KsGeom<T, K>;
  const T *u_lo, *u, *u_hi, *f_lo, *f, *f_hi;
  T* out;
  int m, n;
  int cb;          // band column 0 (the apron's first column)
  int r0;          // first padded row loaded = first output row
  int rows;        // output rows of this strip
  int r_end;       // one past the last padded row loaded
  int p_lo, p_hi;  // updatable padded rows [p_lo, p_hi)
  int tid, lane, warp, j0;
  int dmask;       // bit j: the thread's column j is column 0 or n - 1
  unsigned char* ring_u;
  unsigned char* ring_f;
  float* staged;   // [2][kBand]: the last sweep's row of steps t and t - 1
  float* edges;    // [2][K - 1][kKsWarps + 2][2]: stage rows' warp edges

  __device__ __forceinline__ const T* u_row(int q) const {
    return slab_row(u_lo, u, u_hi, K, m, n, q);
  }
  __device__ __forceinline__ const T* f_row(int q) const {
    return slab_row(f_lo, f, f_hi, K, m, n, q);
  }
  // ring slot i (row q lives in slot q mod the ring's rows)
  __device__ __forceinline__ unsigned char* u_slot(int i) const {
    return ring_u + i * G::kSlot;
  }
  __device__ __forceinline__ unsigned char* f_slot(int i) const {
    return ring_f + i * G::kSlot;
  }
  // a row's slot shift; rows outside the slab (read before they could be
  // loaded, by stages that compute outside the trapezoid) take row 0's
  __device__ __forceinline__ int u_shift(int q) const {
    return slot_shift(u_row(q < 0 || q >= r_end ? 0 : q), cb);
  }
  __device__ __forceinline__ int f_shift(int q) const {
    return slot_shift(f_row(q < 0 || q >= r_end ? 0 : q), cb);
  }

  // start the copies of padded row q into slots iu, i_f (one commit
  // group, empty past the strip)
  __device__ __forceinline__ void issue(int q, int iu, int i_f) const {
    if (q < r_end) {
      issue_row<T, K>(u_slot(iu), u_row(q), cb, n, tid);
      issue_row<T, K>(f_slot(i_f), f_row(q), cb, n, tid);
    }
    cp_async_commit();
  }

  // write the output row the last sweep staged at step t, coalesced
  __device__ __forceinline__ void store(int t) const {
    const int o = r0 + t - 2 * K;
    if (o < r0 || o >= r0 + rows) return;
    const float* src = staged + (t & 1) * G::kBand;
    T* dst = out + (int64_t)o * n;
#pragma unroll
    for (int q = 0; q < G::kCols; ++q) {
      const int j = tid + q * kKsThreads;
      if (j >= K && j < G::kBand - K && cb + j < n) {
        dst[cb + j] = from_f32<T>(src[j]);
      }
    }
  }
};

// i - d wrapped into a ring of r slots (0 <= i < r, 0 <= d < r)
__device__ __forceinline__ int ring_back(int i, int d, int r) {
  return i >= d ? i - d : i - d + r;
}

// One step of the walk: padded row p = r0 + t enters; sweep s produces row
// p - s.  PH = t % 3 names the window slots statically; us / fs are row
// p's ring slots, advanced here for the next step.
template <typename T, int K, int PH>
__device__ __forceinline__ void ks_step(
    const KsCta<T, K>& c,
    float (&w)[K > 1 ? K - 1 : 1][3][KsGeom<T, K>::kCols], int t, int& us,
    int& fs) {
  using G = KsGeom<T, K>;
  constexpr int C = G::kCols;
  const int p = c.r0 + t;
  cp_async_wait<kKsAhead - 1>();   // row p has landed (this thread's part)
  __syncthreads();                 // ... and every thread's; step t - 1 done
  c.store(t - 1);
  c.issue(p + kKsAhead, ring_back(us, G::kRingU - kKsAhead, G::kRingU),
          ring_back(fs, G::kRingF - kKsAhead, G::kRingF));
  const float* e_in = c.edges + ((t & 1) ^ 1) * (K - 1) * G::kEdgeRow;
  float* e_out = c.edges + (t & 1) * (K - 1) * G::kEdgeRow;
#pragma unroll
  for (int s = 1; s <= K; ++s) {
    const int row = p - s;
    const bool row_ok = row >= c.p_lo && row < c.p_hi;
    float up[C], mid[C], down[C], fv[C], l, r;
    if (s == 1) {                    // sweep 0's rows are u's, in the ring
      const int sm = c.u_shift(p - 1);
      const unsigned char* ms = c.u_slot(ring_back(us, 1, G::kRingU));
      slot_cols<T, C>(c.u_slot(ring_back(us, 2, G::kRingU)),
                      c.u_shift(p - 2), c.j0, up);
      slot_cols<T, C>(ms, sm, c.j0, mid);
      slot_cols<T, C>(c.u_slot(us), c.u_shift(p), c.j0, down);
      l = slot_at<T>(ms, sm, c.j0 > 0 ? c.j0 - 1 : 0);
      r = slot_at<T>(ms, sm, c.j0 + C);
    } else {                         // sweep s - 1's window, in registers
#pragma unroll
      for (int j = 0; j < C; ++j) {
        up[j] = w[s - 2][(PH + 1) % 3][j];
        mid[j] = w[s - 2][(PH + 2) % 3][j];
        down[j] = w[s - 2][PH][j];
      }
      l = __shfl_up_sync(0xffffffffu, mid[C - 1], 1);
      r = __shfl_down_sync(0xffffffffu, mid[0], 1);
      const float* e = e_in + (s - 2) * G::kEdgeRow;
      if (c.lane == 0) l = e[c.warp * 2 + 1];          // warp - 1's right
      if (c.lane == 31) r = e[(c.warp + 2) * 2];       // warp + 1's left
    }
    slot_cols<T, C>(c.f_slot(ring_back(fs, s, G::kRingF)), c.f_shift(row),
                    c.j0, fv);
    // the points that keep their value: every one of a row outside
    // [p_lo, p_hi) (uniform across the CTA), else the thread's Dirichlet
    // columns (columns outside the array are computed: no valid point
    // reads them)
    const int keep = row_ok ? c.dmask : (1 << C) - 1;
    float nw[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      nw[j] = five_point(up[j], down[j], j > 0 ? mid[j - 1] : l,
                         j < C - 1 ? mid[j + 1] : r, fv[j]);
      if (keep >> j & 1) nw[j] = mid[j];
    }
    if (s < K) {
#pragma unroll
      for (int j = 0; j < C; ++j) w[s - 1][PH][j] = nw[j];
      float* e = e_out + (s - 1) * G::kEdgeRow + (c.warp + 1) * 2;
      if (c.lane == 0) e[0] = nw[0];
      if (c.lane == 31) e[1] = nw[C - 1];
    } else {
      float4* dst = reinterpret_cast<float4*>(
          c.staged + (t & 1) * G::kBand + c.j0);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        dst[q] = make_float4(nw[4 * q], nw[4 * q + 1], nw[4 * q + 2],
                             nw[4 * q + 3]);
      }
    }
  }
  us = us + 1 == G::kRingU ? 0 : us + 1;
  fs = fs + 1 == G::kRingF ? 0 : fs + 1;
}

template <typename T, int K>
__global__ void __launch_bounds__(kKsThreads, kKsCtas)
jacobi_ksweep_kernel(const T* __restrict__ u_lo, const T* __restrict__ u,
                     const T* __restrict__ u_hi, const T* __restrict__ f_lo,
                     const T* __restrict__ f, const T* __restrict__ f_hi,
                     T* __restrict__ out, int m, int n, int frozen_top,
                     int frozen_bot, int strip) {
  using G = KsGeom<T, K>;
  constexpr int C = G::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  KsCta<T, K> c;
  c.u_lo = u_lo; c.u = u; c.u_hi = u_hi;
  c.f_lo = f_lo; c.f = f; c.f_hi = f_hi;
  c.out = out;
  c.m = m;
  c.n = n;
  c.cb = blockIdx.x * G::kCentre - K;
  c.r0 = blockIdx.y * strip;
  c.rows = min(strip, m - c.r0);
  c.r_end = c.r0 + c.rows + 2 * K;
  const int mp = m + 2 * K;
  c.p_lo = max(frozen_top, 1);
  c.p_hi = min(mp - frozen_bot, mp - 1);
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp = c.tid >> 5;
  c.j0 = c.tid * C;
  c.dmask = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int col = c.cb + c.j0 + j;
    if (col == 0 || col == n - 1) c.dmask |= 1 << j;
  }
  c.ring_u = smem;
  c.ring_f = smem + G::kRingU * G::kSlot;
  c.staged = reinterpret_cast<float*>(c.ring_f + G::kRingF * G::kSlot);
  c.edges = c.staged + 2 * G::kBand;
  // the edge buffer's outer entries (beyond the first and last warp) are
  // read and never written
  for (int i = c.tid; i < G::kEdges; i += kKsThreads) c.edges[i] = 0.f;
  int us = c.r0 % G::kRingU, fs = c.r0 % G::kRingF;   // row r0's slots
#pragma unroll
  for (int d = 0; d < kKsAhead; ++d) {
    c.issue(c.r0 + d, (us + d) % G::kRingU, (fs + d) % G::kRingF);
  }

  float w[K > 1 ? K - 1 : 1][3][C];
#pragma unroll
  for (int s = 0; s < (K > 1 ? K - 1 : 1); ++s)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) w[s][i][j] = 0.f;
  // steps past the strip's last (at most two, to finish a round of three)
  // load nothing and store nothing
  const int steps = c.rows + 2 * K;
  for (int t = 0; t < steps; t += 3) {
    ks_step<T, K, 0>(c, w, t, us, fs);
    ks_step<T, K, 1>(c, w, t + 1, us, fs);
    ks_step<T, K, 2>(c, w, t + 2, us, fs);
  }
  __syncthreads();
  c.store((steps + 2) / 3 * 3 - 1);
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

template <typename T, int K>
int launch_ksweep_k(const void* u_lo, const void* u, const void* u_hi,
                    const void* f_lo, const void* f, const void* f_hi,
                    void* out, int m, int n, int frozen_top, int frozen_bot,
                    int strip, cudaStream_t stream) {
  using G = KsGeom<T, K>;
  static uint32_t opted_in = 0;       // devices granted kSmem
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    e = cudaFuncSetAttribute(jacobi_ksweep_kernel<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) opted_in |= 1u << dev;
  }
  const int bands = (n + G::kCentre - 1) / G::kCentre;
  const int strips = (m + strip - 1) / strip;
  if (strips > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_ksweep_kernel<T, K><<<dim3(bands, strips), kKsThreads, G::kSmem,
                               stream>>>(
      static_cast<const T*>(u_lo), static_cast<const T*>(u),
      static_cast<const T*>(u_hi), static_cast<const T*>(f_lo),
      static_cast<const T*>(f), static_cast<const T*>(f_hi),
      static_cast<T*>(out), m, n, frozen_top, frozen_bot, strip);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, K>) for k = K in 1 .. kKsMaxK, else -1
template <typename F>
int with_k(int k, F fn) {
  switch (k) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 5: return fn(std::integral_constant<int, 5>());
    case 6: return fn(std::integral_constant<int, 6>());
    case 7: return fn(std::integral_constant<int, 7>());
    case 8: return fn(std::integral_constant<int, 8>());
    default: return -1;
  }
}
static_assert(kKsMaxK == 8, "with_k lists k = 1 .. kKsMaxK");

template <typename T>
int launch_ksweep(const void* u_lo, const void* u, const void* u_hi,
                  const void* f_lo, const void* f, const void* f_hi,
                  void* out, int m, int n, int k, int frozen_top,
                  int frozen_bot, int strip, cudaStream_t stream) {
  const int err = with_k(k, [&](auto kc) {
    return launch_ksweep_k<T, decltype(kc)::value>(
        u_lo, u, u_hi, f_lo, f, f_hi, out, m, n, frozen_top, frozen_bot,
        strip, stream);
  });
  return err < 0 ? (int)cudaErrorInvalidValue : err;
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

// k = 1 .. 8 sweeps of the slab [u_lo; u; u_hi] (k + m + k rows of n),
// source [f_lo; f; f_hi]; writes the m centre rows after k sweeps to out.
// `strip` is the output rows one CTA walks (kernels/stencil.py::
// ksweep_plan); any m, n >= 1 and element-aligned bases are taken.
extern "C" int jacobi_ksweep_launch(int dtype, const void* u_lo,
                                    const void* u, const void* u_hi,
                                    const void* f_lo, const void* f,
                                    const void* f_hi, void* out, int m,
                                    int n, int k, int frozen_top,
                                    int frozen_bot, int strip,
                                    void* stream) {
  if (m <= 0 || n <= 0 || k < 1 || k > kKsMaxK || strip < 1 ||
      frozen_top < 0 || frozen_bot < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ksweep<float>(u_lo, u, u_hi, f_lo, f, f_hi, out, m, n, k,
                                frozen_top, frozen_bot, strip, s);
  if (dtype == 1)
    return launch_ksweep<__nv_bfloat16>(u_lo, u, u_hi, f_lo, f, f_hi, out, m,
                                        n, k, frozen_top, frozen_bot, strip,
                                        s);
  return (int)cudaErrorInvalidValue;
}

// The k-sweep kernel's geometry at k sweeps (dtype 0 = f32, 1 = bf16):
// what = 0 loaded columns of a band, 1 shared memory a CTA opts into
// (bytes), 2 CTAs the card keeps resident on one SM (the occupancy API on
// the built kernel; sets the shared-memory attribute first).  -1 for a k
// or dtype the kernel does not take, or a CUDA error.
extern "C" int jacobi_ksweep_geometry(int dtype, int k, int what) {
  if (dtype != 0 && dtype != 1) return -1;
  return with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    auto of = [&](auto one) -> int {
      using T = decltype(one);
      using G = KsGeom<T, K>;
      if (what == 0) return G::kBand;
      if (what == 1) return G::kSmem;
      if (cudaFuncSetAttribute(jacobi_ksweep_kernel<T, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::kSmem) != cudaSuccess)
        return -1;
      int ctas = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &ctas, jacobi_ksweep_kernel<T, K>, kKsThreads, G::kSmem) !=
          cudaSuccess)
        return -1;
      return ctas;
    };
    return dtype == 0 ? of(0.f) : of(__nv_bfloat16());
  });
}

extern "C" const char* stencil_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
