// Grouped-expert FFN for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py::
// grouped_expert_ffn_pallas (_gemm_kernel); its oracle is
// grouped_expert_ffn_jnp.  The MoE capacity buffers are G groups of C
// padded rows; group g uses expert e = g / gpe (gpe = G/E) and keeps its
// first valid[g] rows:
//
//   h        [G, C, D]        (f32 or bf16)
//   w1, w1g  [E, D, F]        (same type; w1g only for the gated swiglu /
//                              geglu)
//   w2       [E, F, D]
//   valid    [G] int32        rows kept per group (clamped to [0, C])
//   out      [G, C, D]        in h's type
//
//   out[g, r] = act(h[g, r] @ w1[e] [, h[g, r] @ w1g[e]]) @ f32(w2[e])
//               for r < valid[g], and exactly 0 for r >= valid[g].
//
// Numerics follow the reference: the first products accumulate bf16 (or
// f32) operands in f32 (a product of two bf16 values is exact in f32);
// the activation is f32 (silu(u) * g, tanh-approximate GELU, relu(u)^2);
// the second product is f32 x f32 with w2 widened to f32 and act never
// rounded to bf16 (no TF32); the output is rounded to h's type once.
//
// Bound on this card, counted as the work whatever runs it: at the
// prefill shape of moonshot-v1-16b-a3b (G = E = 64, C = 480, D = 2048,
// F = 1408, swiglu, bf16, 24576 kept rows) the three products are
// 425 GFLOP, 0.430 ms at the bf16 rate of 989 TFLOP/s; the weights, the
// kept rows of h and the output are 1.33 GB, 0.398 ms at 3.35 TB/s.  (The
// first port's figure, 2.40 ms, charged the second product at the f32
// rate outside the tensor cores, which a tensor-core kernel need not pay.)
//
// Two engines, chosen by the wrapper's plan from shapes alone
// (grouped_matmul.py::grouped_plan), never by catching an error:
//
// * The tensor cores (tc::, bf16 with D and F multiples of 64 and 16-byte
//   aligned bases; moonshot's MoE layers).  Two persistent launches of
//   384-thread CTAs, one per SM: warpgroup 0's one thread issues every
//   TMA load into a ring of 192 KB of stages (full and empty mbarriers),
//   and two consumer warpgroups own 64 rows each of a 128 x 256 tile and
//   run wgmma m64n256k16 from shared memory with 128 f32 accumulators a
//   thread.
//   - Each CTA walks a linear tile index (stride: the grid) over
//     (group, column tile, row tile) and skips a row tile with row0 >=
//     valid[g] after one read of valid; the wrapper never reads valid on
//     the host, so a call can be captured in a CUDA graph.  The walk puts
//     the row tiles of one expert's column block next to each other, so
//     the CTAs that run at once read that block of weights from L2.  Timed
//     at moonshot's prefill call against the walk that puts the column
//     tiles of one row tile together (sharing its rows of h or act
//     instead), in turns: this walk won by 3-7% in two runs and lost by
//     1-2% in a third, inside the spread of one order's own readings
//     (PERF.md), so the other walk was taken out.
//   - Operands come by TMA through 3-D tensor maps over [G, C, D],
//     [E, D, F], [G, C, F] and [E, F, D] in boxes of 64 columns (128-byte
//     swizzled): a box never crosses a group, and rows past C read as
//     zeros.  w1, w1g and w2 lie with their N columns contiguous, so they
//     are MN-major B operands (as V in the flash kernel's P.V).
//   - Launch A (up): a tile is 128 columns of F and the wgmma's 256
//     columns are u (two boxes of w1) beside the gate (two of w1g), so
//     one accumulator holds both (ungated: 256 columns of u); 4 stages of
//     48 KB.  The epilogue applies the activation in f32 and writes act
//     as two bf16 planes, act_hi = bf16(act) and act_lo = bf16(act -
//     act_hi), for rows below valid[g] (the bytes of an f32 workspace).
//   - Launch B (down): out = act_hi w2 + act_lo w2 in one f32 accumulator
//     per 128 x 256 tile, rounded once; 3 stages of 64 KB.  w2 is bf16,
//     so its widening is exact, and act - act_hi - act_lo is at most
//     2^-18 |act|: the two bf16 products give the reference's f32 product
//     to about 1e-5 of its size (the trick of the flash kernels' P.V);
//     act_hi alone is off by about 2e-3.  Rows past valid[g] are written
//     as zeros by a select, and a tile wholly past valid[g] writes its
//     zeros with no load.  Launch B starts under programmatic dependent
//     launch: its CTAs take the SMs that launch A's last tiles free.
//     The f32 readout of the tests (out_f32) is ffn_down_wgmma_kernel<
//     float>, another instantiation of the same template: it proves the
//     template's mainloop keeps the f32 product, not the bf16 binary the
//     models run, so the tests also hold that binary's output to the
//     plain f32 product rounded to bf16: equal on at least 99% of the
//     elements (act_hi alone on about 58%).
//   - Each consumer waits for its own wgmmas at the end of a stage and
//     gives the stage back at once; the other warpgroup's products keep
//     the tensor cores busy meanwhile.  A branch inside the wgmma loop
//     (a release guarded by `kb > 0`) made ptxas serialize the wgmmas
//     (C7518), which was slower.
//   - Row independence replaces masking: garbage, NaN or Inf in h past
//     valid[g] reaches only its own rows of u and act (each row of a
//     product depends on its own row of A only), and those output rows
//     are selected to zero, so h's padded rows are never zeroed.
//   - No split-K and no atomics: each output tile is written by one CTA,
//     so two calls give the same bits.
//   - Not fused: one 128-row tile of act over F = 1408 is 720 KB in f32,
//     against 227 KB of shared memory, and a row tile's [128, 2048] f32
//     output does not fit in registers; the workspace round trip is about
//     277 MB (about 0.08 ms at 3.35 TB/s).
//   - Registers: ptxas holds a 384-thread CTA to 168 a thread; the 128
//     accumulators fit with no spill (cuobjdump -res-usage: no stack, no
//     local memory).  128 x 128 tiles (m64n128) were slower: they load
//     25-33% more bytes from L2 for the same products.
// * SIMT (f32, and bf16 shapes the tensor-core path cannot map: D or F
//   not a multiple of 64).  Two launches tiled in D and F on the f32
//   units: 64-row tiles over (F or D tile, row tile, g), rows past
//   valid[g] staged as zeros before any product, row tiles wholly past
//   valid[g] do no arithmetic, every edge masked.
//
// The backward (grouped_ffn_bwd_launch) replaces no TPU kernel: the
// reference's custom VJP differentiates grouped_expert_ffn_jnp with
// jax.vjp (src/repro/kernels/grouped_matmul.py:196-216).  From dy it
// gives dh (rows past valid[g] exactly 0) and dw1, dw1g, dw2 (sums over
// the kept rows of each expert's groups only; an expert with none gets
// zeros), in three steps:
//   1. per live row tile of group g: u [and the gate] again, dact = dy
//      w2[e]^T, then act, dU = dact act'_u [and dG = dact act'_g] in f32;
//   2. dh = dU w1[e]^T [+ dG w1g[e]^T] per row tile, zeros past valid;
//   3. per expert: dw1 = sum h^T dU, dw1g = sum h^T dG, dw2 = sum act^T dy
//      over the kept rows (the contraction).
// Numerics as the reference's vjp: every product in f32, each result
// rounded once to its operand's type.  On the tensor cores (bf16, tc::)
// step 1's operands are bf16, so its products are exact, and act, dU and
// dG are stored as bf16 hi/lo planes (as the forward's act), so steps 2
// and 3 keep their f32 operand to about 1e-5 of its size: dU_hi w1 +
// dU_lo w1, h dU_hi + h dU_lo, act_hi dy + act_lo dy, each gradient's
// products in one f32 accumulator, rounded once.  Five persistent
// launches of wgmma fed by TMA, one CTA an SM (geometry: the constexpr
// below and grouped_matmul.py::grouped_bwd_plan), in stream order:
//   - step 1 in two launches, each the forward's launch A (a producer
//     warpgroup, 48 KB stages, 128 rows of a tile, an m64n256
//     accumulator a warpgroup): 1a dact = dy w2^T over 256 F columns
//     (w2[e] is [F, D]: a 256-row K-major box) into an f32 workspace; 1b
//     u beside the gate (two boxes of w1 beside two of w1g) over 128 F
//     columns, then with dact act, dU [and dG] as hi/lo planes.  One CTA
//     holding u, the gate and dact (192 accumulators, so 256 threads and
//     no producer warpgroup) timed slower than the two, which add the
//     workspace's round trip: the forward's launch A moves its tiles
//     through L2 half again as fast (PERF.md);
//   - step 2, the forward's launch B with the dU planes against w1's rows
//     and then the dG planes against w1g's (a 256-row K-major box), all
//     four products in one accumulator; rows past valid[g] by a select;
//   - in steps 1 and 2 both warpgroups of a live tile take every stage
//     (rows past valid[g] are computed and never stored), so the CTAs on
//     the two row tiles of one weight block keep pace and find it in L2;
//   - step 3, two launches, [dw1 | dw1g] (A = h, B = the dU box beside
//     the dG box, hi planes then lo planes: two wgmmas a k-step) and dw2
//     (A = act's hi and lo planes, B = dy), 128 x 256 tiles of each
//     expert walked M fastest, 32 kept rows a stage with both operands
//     MN-major (the wgmma's transpose flags).  TMA loads whole 32-row
//     boxes; the rows of a group's last stage past valid[g] (garbage in h
//     and dy, planes never written) are zeroed in shared memory by the
//     consumers, fenced to the async proxy, before that stage's products,
//     so no row past valid reaches a weight gradient (NaN x 0 would).  The
//     epilogue writes bf16 into a 64 KB staging buffer and stores it by
//     TMA (cp.async.bulk.tensor) while the producer loads the next tile;
//     an expert with no kept row stores a zero tile the same way.
// No split-K and no atomics (two calls give the same bits); valid is read
// on the card only.  ptxas: 168 registers a thread in every launch (384
// threads), no stack or local memory.
// Bound on this card at moonshot-v1-16b-a3b's training call (G = E = 64,
// C = 240, D 2048, F 1408, swiglu, bf16, ~12,288 kept rows): eight
// products of ~71 GFLOP, 0.57 ms at 989 TFLOP/s, against the weights read
// and their gradients written, 2.2 GB, 0.66 ms at 3.35 TB/s: bytes bound
// it.  The hi/lo halves double the products of steps 2 and 3 (13 bf16
// products in all), and the SIMT engine (f32) runs the same three steps on
// f32 FMA tiles with an f32 workspace.  Measured there (NVIDIA H100 80GB
// HBM3, 700.00 W; scripts/grouped_bwd_turns.py, in turns with the
// mma.sync kernels this design replaced): 2.34 ms a call (step 1 0.19 +
// 0.63-0.64, step 2 0.50, step 3 0.52-0.53 + 0.25; the mma.sync kernels
// 5.89-5.98), the all-empty call 0.40 ms against 0.35 to write its zeros.
// Step 1b takes 0.63 ms where the forward's launch A, the same tiles and
// loads, takes 0.37-0.42: its epilogue (dact read, six planes stored) and
// the products of warpgroups past valid[g], which the forward skips
// (PERF.md).
//
// Measured (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00 W): at
// moonshot's prefill call the tensor-core engine takes 1.12-1.24 ms over
// every reading of three runs, drifting within a run (35-38% of the
// bound; the first port's SIMT kernel 18.24 ms, the plain version
// 13.3 ms, three cuBLAS bf16 bmm on the padded buffers 0.87 ms; PERF.md).

#include <cuda.h>
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


// ---------------------------------------------------------------------------
// The bf16 engine on the tensor cores (TMA, wgmma, warp specialisation,
// persistent over live tiles); see the note at the head of the file
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kRows = 128;           // rows of a tile, 64 per consumer
constexpr int kDepth = 64;           // contraction depth of a stage
constexpr int kABox = kRows * 128;   // 16 KB: 128 rows x 64 bf16 columns
constexpr int kBBox = kDepth * 128;  // 8 KB: 64 rows x 64 bf16 columns
constexpr int kBoxes = 4;            // 64-column boxes of B in a tile
constexpr int kN = 64 * kBoxes;      // the wgmma's N, 256
constexpr int kAcc = kN / 2;         // f32 accumulators a thread
constexpr int kUpStage = kABox + kBoxes * kBBox;       // h | w1 [| w1g]
constexpr int kDownStage = 2 * kABox + kBoxes * kBBox;  // hi | lo | w2
constexpr int kRingBytes = 192 * 1024;   // of the 227 KB a CTA may have
constexpr int kUpStages = kRingBytes / kUpStage;
constexpr int kDownStages = kRingBytes / kDownStage;
constexpr int kEmptyArrivals = 8;    // one lane of each consumer warp

// Dynamic shared memory of a kernel with `stages` stages of `stage` bytes:
// the stages (1024-aligned for the 128-byte swizzle), then a full and an
// empty mbarrier per stage, and room to align the base.
constexpr int smem_bytes(int stage, int stages) {
  return stage * stages + 16 * stages + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A pipeline that has waited some 10 s is wedged: trap, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// One box of a 3-D tensor map at coordinates (x innermost, y, z); parts
// of the box outside the tensor read as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-column boxes), stride byte offset (between 8-row groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define GM_D8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B, m64n256k16 in bf16 with f32 accumulators, A and B from shared
// memory: TA / TB = 0 K-major, 1 MN-major (its M or N columns contiguous,
// as w1, w1g and w2 lie in memory for the forward, and both operands of
// the backward's weight gradients).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : GM_D8(0), GM_D8(8), GM_D8(16), GM_D8(24), GM_D8(32), GM_D8(40),
        GM_D8(48), GM_D8(56), GM_D8(64), GM_D8(72), GM_D8(80), GM_D8(88),
        GM_D8(96), GM_D8(104), GM_D8(112), GM_D8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef GM_D8

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The linear tile index t -> (group, column tile, row tile): the row tiles
// of one expert's column block are adjacent (all groups of the expert),
// so the CTAs that run at once share that block of weights in L2.
struct Walk {
  int n_row, n_col, n_group, gpe;
  __device__ __forceinline__ int tiles() const {
    return n_row * n_col * n_group;
  }
  __device__ __forceinline__ void tile(int t, int* g, int* col,
                                       int* rt) const {
    *rt = t % n_row;
    t /= n_row;
    const int gi = t % gpe;
    t /= gpe;
    *col = t % n_col;
    *g = (t / n_col) * gpe + gi;
  }
};

// The ring of stages, counted by a running index `it`: the producer
// acquires a stage once the consumers gave it back and announces its
// bytes; the consumers wait for its loads and, after their products have
// completed, give it back.
struct Ring {
  uint32_t full, empty;   // barrier of stage 0; stage s at + 8 s
  int stages;
  __device__ __forceinline__ void wait_full(int it) const {
    mbar_wait(full + 8 * (it % stages), (it / stages) & 1);
  }
  __device__ __forceinline__ void release(int it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % stages));
  }
  // the producer: wait until stage `it` is free, then announce its bytes
  __device__ __forceinline__ uint32_t acquire(int it, int bytes) const {
    const int st = it % stages;
    mbar_wait(empty + 8 * st, ((it / stages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * st, bytes);
    return full + 8 * st;
  }
};

// Barriers after the stages; thread 0 initialises them.
__device__ __forceinline__ Ring ring_init(uint32_t base, int stage,
                                          int stages) {
  const Ring r{base + stage * stages, base + stage * stages + 8 * stages,
               stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + 8 * s, 1);
      mbar_init(r.empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// One k-block (64 deep) of a consumer's products from stage `s`:
// acc += A B for each of the NA A boxes (the warpgroup's 64 rows of each
// 128-row box) and B after them, 4 wgmma k-steps each: kBoxes 64-column
// boxes of B MN-major (TB = 1), or one kN-row box of B K-major (TB = 0,
// the backward's w1 and w1g for dh = dU w1^T).
template <int NA, int TB>
__device__ __forceinline__ void stage_mma(float (&acc)[kAcc], uint32_t s,
                                          int c) {
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    const uint32_t b = s + NA * kABox;
    const uint64_t db = TB ? desc(b + kk * 16 * 128, kBBox, 1024)
                           : desc(b + kk * 32, 16, 1024);
#pragma unroll
    for (int x = 0; x < NA; ++x)
      wgmma_n256<0, TB>(
          acc, desc(s + x * kABox + c * 64 * 128 + kk * 32, 16, 1024), db);
  }
}

// The products of one tile over `nk` k-blocks.  A warpgroup with no live
// row (live = false) takes each stage and gives it back untouched.
template <int NA, int TB>
__device__ __forceinline__ void tile_mma(float (&acc)[kAcc], const Ring& ring,
                                         uint32_t base, int stage, int* it,
                                         int nk, int c, int lane, bool live) {
  if (!live) {
    for (int kb = 0; kb < nk; ++kb, ++*it) {
      ring.wait_full(*it);
      ring.release(*it, lane);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // Each warpgroup waits for its own products before it gives a stage
  // back, so only one stage is held while the other warpgroup's products
  // keep the tensor cores busy.  (One batch left in flight behind the
  // next, as GEMMs often do, held a second stage and timed the same.)
  for (int kb = 0; kb < nk; ++kb, ++*it) {
    ring.wait_full(*it);
    pin(acc);
    wgmma_fence();
    stage_mma<NA, TB>(acc, base + (*it % ring.stages) * stage, c);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    ring.release(*it, lane);
  }
}

// The first column of box `b` of a tile that starts at column c0: c0 +
// 64 b, or c0 again where the tensor (n columns) has ended (the epilogue
// drops those columns), so no box lies wholly outside the tensor.
__device__ __forceinline__ int box_col(int c0, int b, int n) {
  return c0 + 64 * b < n ? c0 + 64 * b : c0;
}

// Launch A: act = act(h w1 [, h w1g]) of each live 128-row tile, written
// as bf16 planes act_hi = bf16(act) and act_lo = bf16(act - act_hi) for
// rows below valid[g].  Gated: a tile is kN / 2 columns of F, and the
// wgmma's kN columns are u (w1's boxes) beside the gate (w1g's boxes).
// Ungated: a tile is kN columns of F, every box from w1.
template <int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_w1,
                    const __grid_constant__ CUtensorMap tm_w1g,
                    const int* __restrict__ valid,
                    __nv_bfloat16* __restrict__ act_hi,
                    __nv_bfloat16* __restrict__ act_lo, int c, int d, int f,
                    Walk walk) {
  // the down launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Ring ring = ring_init(base, kUpStage, kUpStages);
  constexpr int kCols = GATED ? kN / 2 : kN;   // F columns of a tile
  constexpr int kUBoxes = kCols / 64;          // boxes of w1 (of u)
  const int n_tiles = walk.tiles();
  const int nk = d / kDepth;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, col, rt;
      walk.tile(t, &g, &col, &rt);
      const int row0 = rt * kRows;
      if (row0 >= clamp_valid(valid, g, c)) continue;
      const int e = g / walk.gpe;
      const int f0 = col * kCols;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const uint32_t full = ring.acquire(it, kUpStage);
        const uint32_t s = base + (it % kUpStages) * kUpStage;
        tma_load(s, &tm_h, full, kb * kDepth, row0, g);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_load(s + kABox + b * kBBox, b < kUBoxes ? &tm_w1 : &tm_w1g,
                   full, box_col(f0, b % kUBoxes, f), kb * kDepth, e);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows row0 + 64 cw .. + 64 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int tq = lane & 3;
  // acc[4 j + 2 r + e]: row 64 cw + 16 warp + lane / 4 + 8 r of the tile,
  // wgmma column 8 j + 2 tq + e (the gate of u's column n is column
  // n + kN / 2)
  const int trow = 64 * cw + 16 * (tw >> 5) + (lane >> 2);
  float acc[kAcc];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int g, col, rt;
    walk.tile(t, &g, &col, &rt);
    const int row0 = rt * kRows;
    const int v = clamp_valid(valid, g, c);
    if (row0 >= v) continue;
    const bool live = row0 + 64 * cw < v;
    tile_mma<1, 1>(acc, ring, base, kUpStage, &it, nk, cw, lane, live);
    if (!live) continue;
    const int f0 = col * kCols;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + trow + 8 * r;
      if (row >= v) continue;   // never read: launch B zeroes its output
      const int64_t at = ((int64_t)g * c + row) * f + f0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        if (j % 8 == 0 && j > 0 && f0 + 8 * j >= f) break;
        const int u = 4 * j + 2 * r, gate = u + kAcc / 2;
        const float x0 = activate<ACT>(acc[u], GATED ? acc[gate] : 0.f);
        const float x1 =
            activate<ACT>(acc[u + 1], GATED ? acc[gate + 1] : 0.f);
        const uint32_t hi = bf16x2(x0, x1);
        *reinterpret_cast<uint32_t*>(act_hi + at + 8 * j) = hi;
        *reinterpret_cast<uint32_t*>(act_lo + at + 8 * j) =
            bf16x2(x0 - __uint_as_float(hi << 16),
                   x1 - __uint_as_float(hi & 0xffff0000u));
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16x2(a, b);
}

// The consumers of a down launch (the forward's launch B, TB = 1, and the
// backward's dh, TB = 0): the products of both A boxes of every stage of a
// 128 x kN tile of out in one f32 accumulator, rounded once to OutT (bf16;
// f32 for the test readout); rows at or past valid[g] are written as exact
// zeros, and a tile that lies wholly past valid[g] writes its zeros
// without a load.
template <typename OutT, int TB>
__device__ __forceinline__ void down_consumers(const Ring& ring,
                                               uint32_t base, int nk,
                                               const int* __restrict__ valid,
                                               OutT* __restrict__ out, int c,
                                               int d, Walk walk) {
  const int n_tiles = walk.tiles();
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int tq = lane & 3;
  const int trow = 64 * cw + 16 * (tw >> 5) + (lane >> 2);
  float acc[kAcc];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int g, col, rt;
    walk.tile(t, &g, &col, &rt);
    const int row0 = rt * kRows;
    const int v = clamp_valid(valid, g, c);
    const int d0 = col * kN;
    const int cols = min(kN, d - d0);
    OutT* og = out + (int64_t)g * c * d + d0;
    if (row0 >= v) {
      // wholly past valid: 16-byte zero stores by both warpgroups
      constexpr int kPer = 16 / sizeof(OutT);
      const int chunks = cols / kPer;
      const int rows = min(kRows, c - row0);
      for (int i = threadIdx.x - 128; i < rows * chunks; i += 256)
        *reinterpret_cast<uint4*>(og + (int64_t)(row0 + i / chunks) * d +
                                  (i % chunks) * kPer) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    // dh (TB = 0): both warpgroups take every stage, so the CTAs on the
    // two row tiles of one weight block keep pace and share it in L2
    // (skipping the dead half timed slower); the forward keeps its skip
    // as it was timed
    tile_mma<2, TB>(acc, ring, base, kDownStage, &it, nk, cw, lane,
                    TB == 0 || row0 + 64 * cw < v);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + trow + 8 * r;
      if (row >= c) continue;
      const bool keep = row < v;   // a select: NaN past valid stays out
      OutT* dst = og + (int64_t)row * d + 2 * tq;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        if (8 * j >= cols) break;
        store2(dst + 8 * j, keep ? acc[4 * j + 2 * r] : 0.f,
               keep ? acc[4 * j + 2 * r + 1] : 0.f);
      }
    }
  }
}

// Launch B: out = act_hi w2 + act_lo w2 (down_consumers).
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap tm_hi,
                      const __grid_constant__ CUtensorMap tm_lo,
                      const __grid_constant__ CUtensorMap tm_w2,
                      const int* __restrict__ valid, OutT* __restrict__ out,
                      int c, int d, int f, Walk walk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Ring ring = ring_init(base, kDownStage, kDownStages);
  // launch A's act planes are complete (and visible) past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_tiles = walk.tiles();
  const int nk = f / kDepth;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, col, rt;
      walk.tile(t, &g, &col, &rt);
      const int row0 = rt * kRows;
      if (row0 >= clamp_valid(valid, g, c)) continue;
      const int e = g / walk.gpe;
      const int d0 = col * kN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const uint32_t full = ring.acquire(it, kDownStage);
        const uint32_t s = base + (it % kDownStages) * kDownStage;
        tma_load(s, &tm_hi, full, kb * kDepth, row0, g);
        tma_load(s + kABox, &tm_lo, full, kb * kDepth, row0, g);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_load(s + 2 * kABox + b * kBBox, &tm_w2, full,
                   box_col(d0, b, d), kb * kDepth, e);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  down_consumers<OutT, 1>(ring, base, nk, valid, out, c, d, walk);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Launchers of the tensor-core engine
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [outer, mid, inner] tensor: boxes of 64 inner
// elements (128 bytes) x `box_mid` rows of one outer index, 128-byte
// swizzled; what lies outside the tensor reads as zeros, so a box never
// crosses into the next group or expert.
bool map3(CUtensorMap* map, const void* ptr, int inner, int mid, int outer,
          int box_mid) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * mid * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_mid, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into its dynamic shared memory (above 48 KB) once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = e == cudaSuccess;
  return e;
}

struct Maps {
  CUtensorMap h, w1, w1g, hi, lo, w2;
};

template <int ACT, bool GATED>
int launch_up_tc(const Maps& m, const int* valid, __nv_bfloat16* hi,
              __nv_bfloat16* lo, int c, int d, int f, tc::Walk walk,
              int ctas, cudaStream_t stream) {
  static bool done = false;
  constexpr int smem = tc::smem_bytes(tc::kUpStage, tc::kUpStages);
  const cudaError_t e =
      allow_smem(tc::ffn_up_wgmma_kernel<ACT, GATED>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  tc::ffn_up_wgmma_kernel<ACT, GATED><<<ctas, tc::kThreads, smem, stream>>>(
      m.h, m.w1, m.w1g, valid, hi, lo, c, d, f, walk);
  return (int)cudaGetLastError();
}

// Launch B under programmatic dependent launch: its CTAs may be scheduled
// while launch A's last CTAs run, and wait for A in griddepcontrol.wait.
template <typename OutT>
int launch_down_tc(const Maps& m, const int* valid, void* out, int c, int d,
                int f, tc::Walk walk, int ctas, cudaStream_t stream) {
  static bool done = false;
  constexpr int smem = tc::smem_bytes(tc::kDownStage, tc::kDownStages);
  cudaError_t e = allow_smem(tc::ffn_down_wgmma_kernel<OutT>, smem, &done);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tc::ffn_down_wgmma_kernel<OutT>, m.hi, m.lo,
                         m.w2, valid, static_cast<OutT*>(out), c, d, f,
                         walk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The tensor-core engine: bf16 operands, D and F multiples of 64, every
// base on a 16-byte boundary (TMA); act_ws holds the two bf16 planes
// [2, G, C, F].
int launch_wgmma(int act_code, const void* h, const void* w1,
                 const void* w1g, const void* w2, const int* valid,
                 void* act_ws, void* out, int g, int c, int d, int f, int e,
                 int ctas, int out_f32, cudaStream_t stream) {
  if (d % tc::kDepth != 0 || f % tc::kDepth != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const bool gated = act_code == kSwiglu || act_code == kGeglu;
  if (((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(gated ? w1g : w1) |
        reinterpret_cast<uintptr_t>(w2) |
        reinterpret_cast<uintptr_t>(act_ws) |
        reinterpret_cast<uintptr_t>(out)) %
       16) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int n_row = (c + tc::kRows - 1) / tc::kRows;
  const int up_width = gated ? tc::kN / 2 : tc::kN;
  const int up_cols = (f + up_width - 1) / up_width;
  const int down_cols = (d + tc::kN - 1) / tc::kN;
  if ((int64_t)n_row * (up_cols > down_cols ? up_cols : down_cols) * g >
      0x7fffffff)
    return (int)cudaErrorInvalidValue;
  auto* hi = static_cast<__nv_bfloat16*>(act_ws);
  auto* lo = hi + (int64_t)g * c * f;
  Maps m;
  if (!map3(&m.h, h, d, c, g, tc::kRows) ||
      !map3(&m.w1, w1, f, d, e, tc::kDepth) ||
      !map3(&m.w1g, gated ? w1g : w1, f, d, e, tc::kDepth) ||
      !map3(&m.hi, hi, f, c, g, tc::kRows) ||
      !map3(&m.lo, lo, f, c, g, tc::kRows) ||
      !map3(&m.w2, w2, d, f, e, tc::kDepth))
    return (int)cudaErrorInvalidValue;
  const int gpe = g / e;
  const tc::Walk up{n_row, up_cols, g, gpe};
  const tc::Walk down{n_row, down_cols, g, gpe};
  // persistent: at most `ctas` CTAs, and none without a tile
  const int ctas_up = ctas < n_row * up_cols * g ? ctas : n_row * up_cols * g;
  const int ctas_down =
      ctas < n_row * down_cols * g ? ctas : n_row * down_cols * g;
  int err;
  switch (act_code) {
    case kSwiglu:
      err = launch_up_tc<kSwiglu, true>(m, valid, hi, lo, c, d, f, up,
                                        ctas_up, stream);
      break;
    case kGeglu:
      err = launch_up_tc<kGeglu, true>(m, valid, hi, lo, c, d, f, up,
                                       ctas_up, stream);
      break;
    case kRelu2:
      err = launch_up_tc<kRelu2, false>(m, valid, hi, lo, c, d, f, up,
                                        ctas_up, stream);
      break;
    case kGelu:
      err = launch_up_tc<kGelu, false>(m, valid, hi, lo, c, d, f, up,
                                       ctas_up, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return out_f32 ? launch_down_tc<float>(m, valid, out, c, d, f, down,
                                         ctas_down, stream)
                 : launch_down_tc<__nv_bfloat16>(m, valid, out, c, d, f,
                                                 down, ctas_down, stream);
}

// ---------------------------------------------------------------------------
// The backward, SIMT engine: dh, dw1, dw1g and dw2 from dy in f32 FMA tiles
// (f32, and bf16 shapes the tensor-core backward does not take); see the
// note at the head of the file
// ---------------------------------------------------------------------------

// act(u, g) and the cotangents of u and g from dact = d out / d act at one
// element: dU = dact d act / du, dG = dact d act / dg (0 when ungated).
// GELU is the tanh approximation, as in the forward.
template <int ACT>
__device__ __forceinline__ void act_grads(float u, float g, float da,
                                          float* act, float* du, float* dg) {
  if (ACT == kSwiglu) {
    const float s = 1.0f / (1.0f + expf(-u));
    const float silu = u * s;
    *act = silu * g;
    *du = da * g * (s * (1.0f + u * (1.0f - s)));
    *dg = da * silu;
    return;
  }
  if (ACT == kRelu2) {
    const float r = fmaxf(u, 0.0f);
    *act = r * r;
    *du = da * (2.0f * r);
    *dg = 0.0f;
    return;
  }
  const float k = 0.7978845608028654f, c3 = 0.044715f;   // sqrt(2 / pi)
  const float t = tanhf(k * (u + c3 * u * u * u));
  const float gelu = 0.5f * u * (1.0f + t);
  const float dgelu = 0.5f * (1.0f + t) +
                      0.5f * u * (1.0f - t * t) * k * (1.0f + 3.0f * c3 * u * u);
  if (ACT == kGeglu) {
    *act = gelu * g;
    *du = da * g * dgelu;
    *dg = da * gelu;
  } else {
    *act = gelu;
    *du = da * dgelu;
    *dg = 0.0f;
  }
}

// Backward step 1: u [, gate] again and dact = dy w2[e]^T over a 64 x 64
// tile of (rows, F), then act, dU [and dG] into f32 workspaces [G, C, F]
// for rows below valid[g].  A tile wholly past valid[g] does nothing: steps
// 2 and 3 never read those rows.
template <typename T, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_act_kernel(const T* __restrict__ h, const T* __restrict__ w1,
                   const T* __restrict__ w1g, const T* __restrict__ w2,
                   const T* __restrict__ dy, const int* __restrict__ valid,
                   float* __restrict__ act, float* __restrict__ du,
                   float* __restrict__ dg, int c, int d, int f, int gpe) {
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kColsA;
  const int v = clamp_valid(valid, g, c);
  if (row0 >= v) return;
  const int e = g / gpe;

  __shared__ __align__(16) float hs[kDepth][kRows + kPad];   // h^T tile
  __shared__ __align__(16) float ys[kDepth][kRows + kPad];   // dy^T tile
  __shared__ __align__(16) float us[kDepth][kColsA];         // w1
  __shared__ __align__(16) float gs[GATED ? kDepth : 1][kColsA];
  __shared__ float vs[kDepth][kColsA + 1];                   // w2^T

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* hg = h + (int64_t)g * c * d;
  const T* yg = dy + (int64_t)g * c * d;
  const T* w1e = w1 + (int64_t)e * d * f;
  const T* wge = GATED ? w1g + (int64_t)e * d * f : nullptr;
  const T* w2e = w2 + (int64_t)e * f * d;

  float acc_u[4][4], acc_g[4][4], acc_a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_u[i][j] = acc_g[i][j] = acc_a[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    for (int i = tid; i < kRows * kDepth; i += kThreads) {
      const int m = i / kDepth, kk = i % kDepth;
      const int r = row0 + m, k = k0 + kk;
      const bool in = r < v && k < d;
      hs[kk][m] = in ? to_f32(hg[(int64_t)r * d + k]) : 0.0f;
      ys[kk][m] = in ? to_f32(yg[(int64_t)r * d + k]) : 0.0f;
    }
    for (int i = tid; i < kDepth * kColsA; i += kThreads) {
      const int kk = i / kColsA, n = i % kColsA;
      const int k = k0 + kk, col = col0 + n;
      const bool in = k < d && col < f;
      const int64_t at = (int64_t)k * f + col;
      us[kk][n] = in ? to_f32(w1e[at]) : 0.0f;
      if (GATED) gs[kk][n] = in ? to_f32(wge[at]) : 0.0f;
      // w2^T: neighbouring threads read neighbouring k of one row of w2
      const int kt = i % kDepth, nt = i / kDepth;
      const bool in2 = k0 + kt < d && col0 + nt < f;
      vs[kt][nt] = in2 ? to_f32(w2e[(int64_t)(col0 + nt) * d + k0 + kt])
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[kk][ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&ys[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&us[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float yv[4] = {y.x, y.y, y.z, y.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = vs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_u[i][j] = fmaf(av[i], bv[j], acc_u[i][j]);
          acc_a[i][j] = fmaf(yv[i], wv[j], acc_a[i][j]);
        }
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
    if (r >= v) continue;
    const int64_t at = ((int64_t)g * c + r) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= f) continue;
      float x, u, q;
      act_grads<ACT>(acc_u[i][j], acc_g[i][j], acc_a[i][j], &x, &u, &q);
      act[at + col] = x;
      du[at + col] = u;
      if (GATED) dg[at + col] = q;
    }
  }
}

// Backward step 2: dh = dU w1[e]^T [+ dG w1g[e]^T] over a 64 x 128 tile of
// (rows, D) in h's type; rows at or past valid[g] are exact zeros, and a
// tile wholly past valid[g] writes its zeros with no arithmetic.
template <typename T, bool GATED>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dh_kernel(const float* __restrict__ du, const float* __restrict__ dg,
                  const T* __restrict__ w1, const T* __restrict__ w1g,
                  const int* __restrict__ valid, T* __restrict__ dh, int c,
                  int d, int f, int gpe) {
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kColsB;
  const int v = clamp_valid(valid, g, c);
  const int tid = threadIdx.x;
  T* og = dh + (int64_t)g * c * d;

  if (row0 >= v) {
    const T zero = from_f32<T>(0.0f);
    for (int i = tid; i < kRows * kColsB; i += kThreads) {
      const int r = row0 + i / kColsB, col = col0 + i % kColsB;
      if (r < c && col < d) og[(int64_t)r * d + col] = zero;
    }
    return;
  }
  const int e = g / gpe;

  __shared__ __align__(16) float as[kDepth][kRows + kPad];          // dU^T
  __shared__ __align__(16) float bs[GATED ? kDepth : 1][kRows + kPad];  // dG^T
  __shared__ float ws[kDepth][kColsB + 1];                          // w1^T
  __shared__ float wgs[GATED ? kDepth : 1][kColsB + 1];             // w1g^T

  const int tx = tid % 16, ty = tid / 16;
  const float* dug = du + (int64_t)g * c * f;
  const float* dgg = GATED ? dg + (int64_t)g * c * f : nullptr;
  const T* w1e = w1 + (int64_t)e * d * f;
  const T* wge = GATED ? w1g + (int64_t)e * d * f : nullptr;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < f; k0 += kDepth) {
    for (int i = tid; i < kRows * kDepth; i += kThreads) {
      const int m = i / kDepth, kk = i % kDepth;
      const int r = row0 + m, k = k0 + kk;
      const bool in = r < v && k < f;
      as[kk][m] = in ? dug[(int64_t)r * f + k] : 0.0f;
      if (GATED) bs[kk][m] = in ? dgg[(int64_t)r * f + k] : 0.0f;
    }
    // w1^T: neighbouring threads read neighbouring k of one row of w1[e]
    for (int i = tid; i < kDepth * kColsB; i += kThreads) {
      const int kk = i % kDepth, n = i / kDepth;
      const int k = k0 + kk, col = col0 + n;
      const bool in = k < f && col < d;
      const int64_t at = (int64_t)col * f + k;
      ws[kk][n] = in ? to_f32(w1e[at]) : 0.0f;
      if (GATED) wgs[kk][n] = in ? to_f32(wge[at]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ws[kk][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (GATED) {
        const float4 q = *reinterpret_cast<const float4*>(&bs[kk][ty * 4]);
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = wgs[kk][tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], bv[j], acc[i][j]);
      }
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

// Backward step 3: one weight gradient of expert e over the rows its gpe
// groups keep, out[e][m][n] = sum over g of e and r < valid[g] of
// a[g, r, m] b[g, r, n] (dw1 = h^T dU, dw1g = h^T dG, dw2 = act^T dy), in
// 64 x 64 tiles of (M, N) that walk the kept rows kDepth at a time; an
// expert with no kept row writes zeros.
template <typename TA, typename TB, typename TO>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dw_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                  const int* __restrict__ valid, TO* __restrict__ out, int c,
                  int m_dim, int n_dim, int gpe) {
  constexpr int kTile = 64;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ __align__(16) float as[kDepth][kTile];
  __shared__ __align__(16) float bs[kDepth][kTile];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int gi = 0; gi < gpe; ++gi) {
    const int g = e * gpe + gi;
    const int v = clamp_valid(valid, g, c);
    const TA* ag = a + (int64_t)g * c * m_dim;
    const TB* bg = b + (int64_t)g * c * n_dim;
    for (int r0 = 0; r0 < v; r0 += kDepth) {
      for (int i = tid; i < kDepth * kTile; i += kThreads) {
        const int kk = i / kTile, x = i % kTile;
        const int r = r0 + kk;
        as[kk][x] = (r < v && m0 + x < m_dim)
                        ? to_f32(ag[(int64_t)r * m_dim + m0 + x]) : 0.0f;
        bs[kk][x] = (r < v && n0 + x < n_dim)
                        ? to_f32(bg[(int64_t)r * n_dim + n0 + x]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 p = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 q = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float pv[4] = {p.x, p.y, p.z, p.w};
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], qv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  TO* oe = out + (int64_t)e * m_dim * n_dim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < n_dim) oe[(int64_t)m * n_dim + n] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename T, int ACT, bool GATED>
int launch_bwd_act(const void* h, const void* w1, const void* w1g,
                   const void* w2, const void* dy, const int* valid,
                   float* act, float* du, float* dg, int g, int c, int d,
                   int f, int gpe, cudaStream_t stream) {
  const dim3 grid((f + kColsA - 1) / kColsA, (c + kRows - 1) / kRows, g);
  ffn_bwd_act_kernel<T, ACT, GATED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w1),
      static_cast<const T*>(w1g), static_cast<const T*>(w2),
      static_cast<const T*>(dy), valid, act, du, dg, c, d, f, gpe);
  return (int)cudaGetLastError();
}

// out [E, M, N] = the sums of a^T b over each expert's kept rows
template <typename TA, typename TB, typename TO>
int launch_bwd_dw(const TA* a, const TB* b, const int* valid, TO* out,
                  int e, int c, int m_dim, int n_dim, int gpe,
                  cudaStream_t stream) {
  const dim3 grid((n_dim + 63) / 64, (m_dim + 63) / 64, e);
  ffn_bwd_dw_kernel<TA, TB, TO><<<grid, kThreads, 0, stream>>>(
      a, b, valid, out, c, m_dim, n_dim, gpe);
  return (int)cudaGetLastError();
}

// The SIMT backward: step 1 into ws = f32 [3, G, C, F] (act, dU, dG), then
// steps 2 and 3.
template <typename T>
int launch_bwd_simt(int act_code, const void* h, const void* w1,
                    const void* w1g, const void* w2, const void* dy,
                    const int* valid, float* ws, void* dh, void* dw1,
                    void* dw1g, void* dw2, int g, int c, int d, int f, int e,
                    cudaStream_t stream) {
  const int gpe = g / e;
  const bool gated = act_code == kSwiglu || act_code == kGeglu;
  float* act = ws;
  float* du = ws + (int64_t)g * c * f;
  float* dg = du + (int64_t)g * c * f;
  int err;
  switch (act_code) {
    case kSwiglu:
      err = launch_bwd_act<T, kSwiglu, true>(h, w1, w1g, w2, dy, valid, act,
                                             du, dg, g, c, d, f, gpe, stream);
      break;
    case kGeglu:
      err = launch_bwd_act<T, kGeglu, true>(h, w1, w1g, w2, dy, valid, act,
                                            du, dg, g, c, d, f, gpe, stream);
      break;
    case kRelu2:
      err = launch_bwd_act<T, kRelu2, false>(h, w1, w1g, w2, dy, valid, act,
                                             du, dg, g, c, d, f, gpe, stream);
      break;
    case kGelu:
      err = launch_bwd_act<T, kGelu, false>(h, w1, w1g, w2, dy, valid, act,
                                            du, dg, g, c, d, f, gpe, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const dim3 grid((d + kColsB - 1) / kColsB, (c + kRows - 1) / kRows, g);
  if (gated)
    ffn_bwd_dh_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        du, dg, static_cast<const T*>(w1), static_cast<const T*>(w1g), valid,
        static_cast<T*>(dh), c, d, f, gpe);
  else
    ffn_bwd_dh_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        du, nullptr, static_cast<const T*>(w1), nullptr, valid,
        static_cast<T*>(dh), c, d, f, gpe);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const T* ht = static_cast<const T*>(h);
  if ((err = launch_bwd_dw<T, float, T>(ht, du, valid, static_cast<T*>(dw1),
                                        e, c, d, f, gpe, stream)) != 0)
    return err;
  if (gated &&
      (err = launch_bwd_dw<T, float, T>(ht, dg, valid, static_cast<T*>(dw1g),
                                        e, c, d, f, gpe, stream)) != 0)
    return err;
  return launch_bwd_dw<float, T, T>(act, static_cast<const T*>(dy), valid,
                                    static_cast<T*>(dw2), e, c, f, d, gpe,
                                    stream);
}

// ---------------------------------------------------------------------------
// The backward on the tensor cores (bf16; TMA, wgmma, persistent CTAs over
// live tiles); see the note at the head of the file
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

// x as bf16 pairs hi = bf16(x), lo = bf16(x - hi), stored at p and p + plane
__device__ __forceinline__ void store_hi_lo(bf16* p, int64_t plane, float x0,
                                            float x1) {
  const uint32_t hi = bf16x2(x0, x1);
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + plane) =
      bf16x2(x0 - __uint_as_float(hi << 16),
             x1 - __uint_as_float(hi & 0xffff0000u));
}

// ---- step 1 ----

// Step 1a: dact = dy w2[e]^T in f32 per live 128-row x kN-F tile (w2[e]
// is [F, D], so a 256-row box of it is a K-major B), into an f32 workspace
// [G, C, F] for rows below valid[g]: the forward's launch A with dy in
// place of h and w2's rows in place of w1's columns.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_dact_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy,
                          const __grid_constant__ CUtensorMap tm_w2,
                          const int* __restrict__ valid,
                          OutT* __restrict__ dact, int c, int d, int f,
                          Walk walk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Ring ring = ring_init(base, kUpStage, kUpStages);
  const int n_tiles = walk.tiles();
  const int nk = d / kDepth;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, col, rt;
      walk.tile(t, &g, &col, &rt);
      const int row0 = rt * kRows;
      if (row0 >= clamp_valid(valid, g, c)) continue;
      const int e = g / walk.gpe;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const uint32_t full = ring.acquire(it, kUpStage);
        const uint32_t s = base + (it % kUpStages) * kUpStage;
        tma_load(s, &tm_dy, full, kb * kDepth, row0, g);
        tma_load(s + kABox, &tm_w2, full, kb * kDepth, col * kN, e);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int tq = lane & 3;
  const int trow = 64 * cw + 16 * (tw >> 5) + (lane >> 2);
  float acc[kAcc];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int g, col, rt;
    walk.tile(t, &g, &col, &rt);
    const int row0 = rt * kRows;
    const int v = clamp_valid(valid, g, c);
    if (row0 >= v) continue;
    // both warpgroups take every stage, as in step 2
    tile_mma<1, 0>(acc, ring, base, kUpStage, &it, nk, cw, lane, true);
    const int f0 = col * kN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + trow + 8 * r;
      if (row >= v) continue;   // never read: step 1b stores no such row
      OutT* dst = dact + ((int64_t)g * c + row) * f + f0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        if (j % 8 == 0 && j > 0 && f0 + 8 * j >= f) break;
        store2(dst + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// Step 1b: per live 128-row tile of kN / 2 F columns (kN ungated), u [|
// gate] = h w1 [| w1g] as the forward's launch A computes them (one
// m64n256 accumulator, u beside the gate), then with step 1a's dact act,
// dU [and dG] as bf16 hi/lo planes (planes 0-1 act, 2-3 dU, 4-5 dG, each
// [G, C, F]) for rows below valid[g].
template <int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_act_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                         const __grid_constant__ CUtensorMap tm_w1,
                         const __grid_constant__ CUtensorMap tm_w1g,
                         const int* __restrict__ valid,
                         const float* __restrict__ dact,
                         bf16* __restrict__ planes, int n_g, int c, int d,
                         int f, Walk walk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Ring ring = ring_init(base, kUpStage, kUpStages);
  constexpr int kCols = GATED ? kN / 2 : kN;   // F columns of a tile
  constexpr int kUBoxes = kCols / 64;          // boxes of w1 (of u)
  const int n_tiles = walk.tiles();
  const int nk = d / kDepth;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, col, rt;
      walk.tile(t, &g, &col, &rt);
      const int row0 = rt * kRows;
      if (row0 >= clamp_valid(valid, g, c)) continue;
      const int e = g / walk.gpe;
      const int f0 = col * kCols;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const uint32_t full = ring.acquire(it, kUpStage);
        const uint32_t s = base + (it % kUpStages) * kUpStage;
        tma_load(s, &tm_h, full, kb * kDepth, row0, g);
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
          tma_load(s + kABox + b * kBBox, b < kUBoxes ? &tm_w1 : &tm_w1g,
                   full, box_col(f0, b % kUBoxes, f), kb * kDepth, e);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int tq = lane & 3;
  // acc[4 j + 2 r + e]: row 64 cw + 16 warp + lane / 4 + 8 r of the tile,
  // column 8 j + 2 tq + e (the gate of u's column n is column n + kN / 2)
  const int trow = 64 * cw + 16 * (tw >> 5) + (lane >> 2);
  float acc[kAcc];
  int it = 0;
  const int64_t plane = (int64_t)n_g * c * f;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int g, col, rt;
    walk.tile(t, &g, &col, &rt);
    const int row0 = rt * kRows;
    const int v = clamp_valid(valid, g, c);
    if (row0 >= v) continue;
    // both warpgroups take every stage, as in step 2
    tile_mma<1, 1>(acc, ring, base, kUpStage, &it, nk, cw, lane, true);
    const int f0 = col * kCols;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + trow + 8 * r;
      if (row >= v) continue;   // never read: steps 2 and 3 mask them
      const int64_t at = ((int64_t)g * c + row) * f + f0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        if (j % 8 == 0 && j > 0 && f0 + 8 * j >= f) break;
        const int i = 4 * j + 2 * r;
        const float2 da = *reinterpret_cast<const float2*>(dact + at + 8 * j);
        float x[2], u[2], q[2];
        act_grads<ACT>(acc[i], GATED ? acc[i + kAcc / 2] : 0.f, da.x, &x[0],
                       &u[0], &q[0]);
        act_grads<ACT>(acc[i + 1], GATED ? acc[i + 1 + kAcc / 2] : 0.f,
                       da.y, &x[1], &u[1], &q[1]);
        bf16* p = planes + at + 8 * j;
        store_hi_lo(p, plane, x[0], x[1]);
        store_hi_lo(p + 2 * plane, plane, u[0], u[1]);
        if (GATED) store_hi_lo(p + 4 * plane, plane, q[0], q[1]);
      }
    }
  }
}

// ---- step 2 ----

// Step 2: dh = dU w1[e]^T [+ dG w1g[e]^T] per live 128 x kN tile of (rows,
// D): the dU planes with w1's rows, then the dG planes with w1g's, each
// stage the hi and lo boxes of one plane pair and a kN-row box of the
// weight (K-major: w1[e] is [D, F], its contraction axis F contiguous), all
// into one f32 accumulator, rounded once (down_consumers).
template <bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_dh_wgmma_kernel(const __grid_constant__ CUtensorMap tm_planes,
                        const __grid_constant__ CUtensorMap tm_w1,
                        const __grid_constant__ CUtensorMap tm_w1g,
                        const int* __restrict__ valid, bf16* __restrict__ dh,
                        int n_g, int c, int d, int f, Walk walk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const Ring ring = ring_init(base, kDownStage, kDownStages);
  const int n_tiles = walk.tiles();
  const int nkf = f / kDepth;
  const int nk = (GATED ? 2 : 1) * nkf;

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int g, col, rt;
      walk.tile(t, &g, &col, &rt);
      const int row0 = rt * kRows;
      if (row0 >= clamp_valid(valid, g, c)) continue;
      const int e = g / walk.gpe;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int half = kb / nkf, k0 = (kb - half * nkf) * kDepth;
        const uint32_t full = ring.acquire(it, kDownStage);
        const uint32_t s = base + (it % kDownStages) * kDownStage;
        tma_load(s, &tm_planes, full, k0, row0, (2 + 2 * half) * n_g + g);
        tma_load(s + kABox, &tm_planes, full, k0, row0,
                 (3 + 2 * half) * n_g + g);
        tma_load(s + 2 * kABox, half ? &tm_w1g : &tm_w1, full, k0, col * kN,
                 e);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  down_consumers<bf16, 0>(ring, base, nk, valid, dh, c, d, walk);
}

// ---- step 3 ----

constexpr int kDwRows = 32;               // kept rows a stage
constexpr int kDwBox = kDwRows * 128;     // 4 KB: 32 rows x 64 bf16 columns
constexpr int kOutBox = 64 * 128;         // 8 KB: 64 rows x 64 bf16 columns
constexpr int kDwRing = 160 * 1024;       // the stages; the output staging
                                          // takes 64 KB more

// KIND 0: [dw1 | dw1g] = h^T [dU | dG] (A = h, B = the hi and lo planes of
// dU [and dG]); KIND 1: dw2 = act^T dy (A = act's hi and lo planes, B =
// dy).  A stage holds, for kDwRows kept rows of one group, each A plane's
// two 64-column boxes (one per warpgroup) and each B plane's kBoxes.
template <int KIND>
struct DwGeom {
  static constexpr int kNA = KIND == 0 ? 1 : 2;
  static constexpr int kNB = KIND == 0 ? 2 : 1;
  static constexpr int kStage = (2 * kNA + kBoxes * kNB) * kDwBox;
  static constexpr int kStages = kDwRing / kStage;
  static constexpr int kOut = 2 * kBoxes * kOutBox;
  static constexpr int kSmem = kOut + smem_bytes(kStage, kStages);
};

// Step 3's walk: the linear tile index t -> (expert, M tile, N tile), M
// fastest, so the CTAs that run at once share one expert's rows in L2.
struct DwWalk {
  int n_m, n_n, n_e;
  __device__ __forceinline__ int tiles() const { return n_m * n_n * n_e; }
  __device__ __forceinline__ void tile(int t, int* e, int* mt,
                                       int* nt) const {
    *mt = t % n_m;
    t /= n_m;
    *nt = t % n_n;
    *e = t / n_n;
  }
};

// One box of an output tile from shared memory (128-byte swizzled, as the
// epilogue writes it) at (x, y, z) of a 3-D tensor map; parts outside the
// tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// Step 3: a weight gradient of expert e per 128 x 256 tile of (M, N) of
// the wgmma, the sum over its groups g and rows r < valid[g] of A[g, r]^T
// B[g, r] with both operands MN-major (the kept rows are the contraction),
// every product of an A plane with a B plane in one f32 accumulator,
// rounded once to bf16.  The rows of a group's last stage past valid[g]
// are garbage (h and dy past valid, planes never written), so the
// consumers zero them in shared memory before that stage's products.  An
// expert with no kept row has no stage and stores zeros.  The epilogue
// writes bf16 into a staging buffer of each warpgroup and stores it with
// TMA while the producer loads the next tile.  KIND 0 gated: the N columns
// are 128 of dw1 (tm_o) beside the same 128 of dw1g (tm_og).
template <int KIND, bool GATED>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_b,
                        const __grid_constant__ CUtensorMap tm_o,
                        const __grid_constant__ CUtensorMap tm_og,
                        const int* __restrict__ valid, int n_g, int c,
                        int m_dim, int n_dim, int gpe, DwWalk walk) {
  using L = DwGeom<KIND>;
  // output boxes a tile of one tensor: gated dw1 and dw1g 2 each, else 4
  constexpr int kOutBoxes = KIND == 0 && GATED ? kBoxes / 2 : kBoxes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const basep = smem_raw + (base - raw);
  const uint32_t stages = base + L::kOut;
  const Ring ring = ring_init(stages, L::kStage, L::kStages);
  const int n_tiles = walk.tiles();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int e, mt, nt;
      walk.tile(t, &e, &mt, &nt);
      const int m0 = mt * kRows, n0 = nt * kOutBoxes * 64;
      for (int gi = 0; gi < gpe; ++gi) {
        const int g = e * gpe + gi;
        const int v = clamp_valid(valid, g, c);
        for (int r0 = 0; r0 < v; r0 += kDwRows, ++it) {
          const uint32_t full = ring.acquire(it, L::kStage);
          const uint32_t s = stages + (it % L::kStages) * L::kStage;
#pragma unroll
          for (int p = 0; p < L::kNA; ++p)
#pragma unroll
            for (int w = 0; w < 2; ++w)
              tma_load(s + (2 * p + w) * kDwBox, &tm_a, full,
                       box_col(m0, w, m_dim), r0,
                       KIND == 0 ? g : p * n_g + g);
#pragma unroll
          for (int q = 0; q < L::kNB; ++q)
#pragma unroll
            for (int b = 0; b < kBoxes; ++b)
              tma_load(s + (2 * L::kNA + kBoxes * q + b) * kDwBox, &tm_b,
                       full, box_col(n0, b % kOutBoxes, n_dim), r0,
                       KIND == 0 ? (2 + 2 * (b / kOutBoxes) + q) * n_g + g
                                 : g);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int tq = lane & 3;
  const int gq = lane >> 2;
  // acc[4 j + 2 r + e]: M row 64 cw + wrow + 8 r of the tile, N column
  // 8 j + 2 tq + e
  const int wrow = 16 * (tw >> 5) + gq;
  const uint32_t out_s = base + cw * kBoxes * kOutBox;
  uint8_t* const out_p = basep + cw * kBoxes * kOutBox;
  float acc[kAcc];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int e, mt, nt;
    walk.tile(t, &e, &mt, &nt);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int gi = 0; gi < gpe; ++gi) {
      const int v = clamp_valid(valid, e * gpe + gi, c);
      for (int r0 = 0; r0 < v; r0 += kDwRows, ++it) {
        ring.wait_full(it);
        const uint32_t s = stages + (it % L::kStages) * L::kStage;
        const int rows = v - r0;
        if (rows < kDwRows) {
          // rows [rows, kDwRows) of every box: bytes [rows * 128, kDwBox)
          // (a swizzle moves 16-byte chunks within a 128-byte row only)
          constexpr int kBoxesAll = 2 * L::kNA + kBoxes * L::kNB;
          const int chunks = (kDwRows - rows) * 8;
          uint8_t* const sp = basep + (s - base) + rows * 128;
          for (int i = threadIdx.x - 128; i < kBoxesAll * chunks; i += 256)
            *reinterpret_cast<uint4*>(sp + (i / chunks) * kDwBox +
                                      (i % chunks) * 16) =
                make_uint4(0, 0, 0, 0);
          // the zeros reach wgmma (the async proxy) before either
          // warpgroup's products read the stage
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDwRows / 16; ++kk)
#pragma unroll
          for (int p = 0; p < L::kNA; ++p) {
            const uint64_t da =
                desc(s + (2 * p + cw) * kDwBox + kk * 16 * 128, kDwBox, 1024);
#pragma unroll
            for (int q = 0; q < L::kNB; ++q)
              wgmma_n256<1, 1>(
                  acc, da,
                  desc(s + (2 * L::kNA + kBoxes * q) * kDwBox + kk * 16 * 128,
                       kDwBox, 1024));
          }
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        ring.release(it, lane);
      }
    }

    // the epilogue: once the last tile's stores have read the staging,
    // bf16 pairs into it in TMA's 128-byte swizzle (row m, column chunk k
    // at m * 128 + ((k ^ (m % 8)) * 16); m % 8 = gq), then one store a box
    if (tw == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            out_p + (j / 8) * kOutBox + (wrow + 8 * r) * 128 +
            (((j % 8) ^ gq) << 4) + 4 * tq) =
            bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    const int m = mt * kRows + 64 * cw;
    if (tw == 0 && m < m_dim) {
      const int n0 = nt * kOutBoxes * 64;
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
        const int n = n0 + 64 * (b % kOutBoxes);
        if (n < n_dim)
          tma_store(b < kOutBoxes ? &tm_o : &tm_og, out_s + b * kOutBox, n,
                    m, e);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the staging is read before the CTA's shared memory goes
  if (tw == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace tc

// Launch a persistent kernel of the backward, opting it into its shared
// memory once.  (Programmatic dependent launch, as the forward's launch B
// takes, timed the same here, and the profiler then counts a launch's
// wait for its predecessor as its own time.)
template <auto Kernel, typename... Args>
int launch_persistent(int ctas, int threads, int smem, cudaStream_t stream,
                      Args... args) {
  static bool done = false;
  const cudaError_t e = allow_smem(Kernel, smem, &done);
  if (e != cudaSuccess) return (int)e;
  Kernel<<<ctas, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The tensor maps of the backward's five launches.
struct BwdMaps {
  CUtensorMap dy, w2, h, w1, w1g;     // step 1 (1a: dy, w2; 1b: h, w1, w1g)
  CUtensorMap planes, w1k, w1gk;      // step 2
  CUtensorMap h32, dy32, planes32;    // step 3's operands
  CUtensorMap dw1, dw1g, dw2;         // step 3's outputs
};

template <int ACT, bool GATED>
int launch_bwd_act_tc(const BwdMaps& m, const int* valid, const float* dact,
                      __nv_bfloat16* planes, int g, int c, int d, int f,
                      tc::Walk walk, int ctas, cudaStream_t stream) {
  return launch_persistent<tc::ffn_bwd_act_wgmma_kernel<ACT, GATED>>(
      ctas, tc::kThreads, tc::smem_bytes(tc::kUpStage, tc::kUpStages),
      stream, m.h, m.w1, m.w1g, valid, dact, planes, g, c, d, f, walk);
}

// Persistent CTAs of a walk of `tiles` tiles: at most `ctas`, none idle.
int grid_of(int64_t tiles, int ctas) {
  return (int)(tiles < ctas ? (tiles > 0 ? tiles : 1) : ctas);
}

// The tensor-core backward: bf16, D and F multiples of 64, every base on a
// 16-byte boundary (TMA); step 1 into ws = bf16 [8, G, C, F] (act, dU and
// dG as hi/lo planes, then the bytes of planes 6-7 as step 1a's f32 dact
// [G, C, F]; [6, G, C, F] ungated, dact in planes 4-5), then steps 2 and
// 3, each launch persistent over at most `ctas` CTAs.
int launch_bwd_wgmma(int act_code, const void* h, const void* w1,
                     const void* w1g, const void* w2, const void* dy,
                     const int* valid, void* ws, void* dh, void* dw1,
                     void* dw1g, void* dw2, int g, int c, int d, int f, int e,
                     int ctas, cudaStream_t stream) {
  const bool gated = act_code == kSwiglu || act_code == kGeglu;
  if (d % tc::kDepth != 0 || f % tc::kDepth != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w1) |
        reinterpret_cast<uintptr_t>(gated ? w1g : w1) |
        reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(dh) |
        reinterpret_cast<uintptr_t>(dw1) |
        reinterpret_cast<uintptr_t>(gated ? dw1g : dw1) |
        reinterpret_cast<uintptr_t>(dw2)) %
       16) != 0)
    return (int)cudaErrorMisalignedAddress;
  const int gpe = g / e;
  const int n_planes = gated ? 6 : 4;
  const int n_row = (c + tc::kRows - 1) / tc::kRows;
  const int dw1_cols = gated ? tc::kN / 2 : tc::kN;
  const int act_cols = gated ? tc::kN / 2 : tc::kN;
  const tc::Walk dactw{n_row, (f + tc::kN - 1) / tc::kN, g, gpe};
  const tc::Walk act{n_row, (f + act_cols - 1) / act_cols, g, gpe};
  const tc::Walk dhw{n_row, (d + tc::kN - 1) / tc::kN, g, gpe};
  const tc::DwWalk dw1w{(d + tc::kRows - 1) / tc::kRows,
                        (f + dw1_cols - 1) / dw1_cols, e};
  const tc::DwWalk dw2w{(f + tc::kRows - 1) / tc::kRows,
                        (d + tc::kN - 1) / tc::kN, e};
  // every walk's tile index fits an int (D and F tiles at most d / 64
  // and f / 64 each)
  if ((int64_t)n_row * (d / 64 + f / 64) * g > 0x7fffffff ||
      (int64_t)(d / 64) * (f / 64) * e > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  auto* planes = static_cast<__nv_bfloat16*>(ws);
  auto* dact =
      reinterpret_cast<float*>(planes + (int64_t)n_planes * g * c * f);
  BwdMaps m;
  const void* gate_w = gated ? w1g : w1;
  if (!map3(&m.dy, dy, d, c, g, tc::kRows) ||
      !map3(&m.w2, w2, d, f, e, tc::kN) ||
      !map3(&m.h, h, d, c, g, tc::kRows) ||
      !map3(&m.w1, w1, f, d, e, tc::kDepth) ||
      !map3(&m.w1g, gate_w, f, d, e, tc::kDepth) ||
      !map3(&m.planes, planes, f, c, n_planes * g, tc::kRows) ||
      !map3(&m.w1k, w1, f, d, e, tc::kN) ||
      !map3(&m.w1gk, gate_w, f, d, e, tc::kN) ||
      !map3(&m.h32, h, d, c, g, tc::kDwRows) ||
      !map3(&m.dy32, dy, d, c, g, tc::kDwRows) ||
      !map3(&m.planes32, planes, f, c, n_planes * g, tc::kDwRows) ||
      !map3(&m.dw1, dw1, f, d, e, 64) ||
      !map3(&m.dw1g, gated ? dw1g : dw1, f, d, e, 64) ||
      !map3(&m.dw2, dw2, d, f, e, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int up_smem = tc::smem_bytes(tc::kUpStage, tc::kUpStages);
  int err = launch_persistent<tc::ffn_bwd_dact_wgmma_kernel<float>>(
      grid_of((int64_t)dactw.n_row * dactw.n_col * g, ctas), tc::kThreads,
      up_smem, stream, m.dy, m.w2, valid, dact, c, d, f, dactw);
  if (err != 0) return err;
  const int ctas_act = grid_of((int64_t)act.n_row * act.n_col * g, ctas);
  switch (act_code) {
    case kSwiglu:
      err = launch_bwd_act_tc<kSwiglu, true>(m, valid, dact, planes, g, c, d,
                                             f, act, ctas_act, stream);
      break;
    case kGeglu:
      err = launch_bwd_act_tc<kGeglu, true>(m, valid, dact, planes, g, c, d,
                                            f, act, ctas_act, stream);
      break;
    case kRelu2:
      err = launch_bwd_act_tc<kRelu2, false>(m, valid, dact, planes, g, c, d,
                                             f, act, ctas_act, stream);
      break;
    case kGelu:
      err = launch_bwd_act_tc<kGelu, false>(m, valid, dact, planes, g, c, d,
                                            f, act, ctas_act, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  constexpr int dh_smem = tc::smem_bytes(tc::kDownStage, tc::kDownStages);
  const int ctas_dh = grid_of((int64_t)dhw.n_row * dhw.n_col * g, ctas);
  auto* dhb = static_cast<__nv_bfloat16*>(dh);
  err = gated ? launch_persistent<tc::ffn_bwd_dh_wgmma_kernel<true>>(
                    ctas_dh, tc::kThreads, dh_smem, stream, m.planes,
                    m.w1k, m.w1gk, valid, dhb, g, c, d, f, dhw)
              : launch_persistent<tc::ffn_bwd_dh_wgmma_kernel<false>>(
                    ctas_dh, tc::kThreads, dh_smem, stream, m.planes,
                    m.w1k, m.w1gk, valid, dhb, g, c, d, f, dhw);
  if (err != 0) return err;
  const int ctas_dw1 = grid_of((int64_t)dw1w.n_m * dw1w.n_n * e, ctas);
  constexpr int dw1_smem = tc::DwGeom<0>::kSmem;
  err = gated ? launch_persistent<tc::ffn_bwd_dw_wgmma_kernel<0, true>>(
                    ctas_dw1, tc::kThreads, dw1_smem, stream, m.h32,
                    m.planes32, m.dw1, m.dw1g, valid, g, c, d, f, gpe, dw1w)
              : launch_persistent<tc::ffn_bwd_dw_wgmma_kernel<0, false>>(
                    ctas_dw1, tc::kThreads, dw1_smem, stream, m.h32,
                    m.planes32, m.dw1, m.dw1g, valid, g, c, d, f, gpe, dw1w);
  if (err != 0) return err;
  const int ctas_dw2 = grid_of((int64_t)dw2w.n_m * dw2w.n_n * e, ctas);
  return launch_persistent<tc::ffn_bwd_dw_wgmma_kernel<1, false>>(
      ctas_dw2, tc::kThreads, tc::DwGeom<1>::kSmem, stream, m.planes32,
      m.dy32, m.dw2, m.dw2, valid, g, c, f, d, gpe, dw2w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; engine: 0 = SIMT (either type, any
// shape; act_ws is f32 [G, C, F]), 1 = the tensor cores (bf16, D and F
// multiples of 64, 16-byte aligned bases; act_ws is bf16 [2, G, C, F];
// at most `ctas` persistent CTAs a launch; out_f32 = 1 writes the f32
// result before rounding into an f32 out, for tests).  act: 0 swiglu, 1 geglu, 2 relu2, 3 gelu (w1g is read only for
// the gated 0 and 1).  Returns a cudaError_t (0 = both launches made).
extern "C" int grouped_ffn_launch(int dtype, int engine, int act_code,
                                  const void* h, const void* w1,
                                  const void* w1g, const void* w2,
                                  const int* valid, void* act_ws, void* out,
                                  int g, int c, int d, int f, int e,
                                  int ctas, int out_f32, void* stream) {
  if (g < 1 || c < 1 || d < 1 || f < 1 || e < 1 || g % e != 0)
    return (int)cudaErrorInvalidValue;
  if ((act_code == kSwiglu || act_code == kGeglu) && w1g == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma(act_code, h, w1, w1g, w2, valid, act_ws, out, g, c,
                        d, f, e, ctas, out_f32, s);
  }
  if (engine != 0 || out_f32) return (int)cudaErrorInvalidValue;
  if (g > 65535 || (c + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidConfiguration;
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

// The backward of grouped_ffn_launch: from dy [G, C, D] (h's type), dh
// [G, C, D] in h's type (rows past valid[g] exactly 0) and dw1, dw1g
// [E, D, F] and dw2 [E, F, D] in the weights' type (dw1g and w1g only for
// the gated 0 and 1; an expert with no kept row gets zeros), by steps 1-3
// on one stream.  engine: 0 = SIMT (either type, any shape; ws f32
// [3, G, C, F]: act, dU, dG), 1 = the tensor cores (bf16, D and F
// multiples of 64, 16-byte aligned bases; ws bf16 [6, G, C, F]: act, dU
// and dG as hi/lo planes, [4, G, C, F] ungated; at most `ctas` persistent
// CTAs a launch).  Returns a cudaError_t (0 = every launch made).
extern "C" int grouped_ffn_bwd_launch(int dtype, int engine, int act_code,
                                      const void* h, const void* w1,
                                      const void* w1g, const void* w2,
                                      const void* dy, const int* valid,
                                      void* ws, void* dh, void* dw1,
                                      void* dw1g, void* dw2, int g, int c,
                                      int d, int f, int e, int ctas,
                                      void* stream) {
  if (g < 1 || c < 1 || d < 1 || f < 1 || e < 1 || g % e != 0)
    return (int)cudaErrorInvalidValue;
  const bool gated = act_code == kSwiglu || act_code == kGeglu;
  if (gated && (w1g == nullptr || dw1g == nullptr))
    return (int)cudaErrorInvalidValue;
  if (g > 65535 || e > 65535 || (c + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_bwd_wgmma(act_code, h, w1, w1g, w2, dy, valid, ws, dh,
                            dw1, dw1g, dw2, g, c, d, f, e, ctas, s);
  }
  if (engine != 0) return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_bwd_simt<float>(act_code, h, w1, w1g, w2, dy, valid, wsf,
                                  dh, dw1, dw1g, dw2, g, c, d, f, e, s);
  if (dtype == 1)
    return launch_bwd_simt<__nv_bfloat16>(act_code, h, w1, w1g, w2, dy, valid,
                                          wsf, dh, dw1, dw1g, dw2, g, c, d, f,
                                          e, s);
  return (int)cudaErrorInvalidValue;
}

// The tile of each launch of an engine (0 SIMT, 1 the tensor cores) for
// a gated (swiglu, geglu) or ungated activation: rows, F columns of the
// up launch, D columns of the down launch.  Returns 0, or
// cudaErrorInvalidValue for an unknown engine.
extern "C" int grouped_tile_shape(int engine, int gated, int* rows,
                                  int* up_cols, int* down_cols) {
  if (engine == 0) {
    *rows = kRows;
    *up_cols = kColsA;
    *down_cols = kColsB;
  } else if (engine == 1) {
    *rows = tc::kRows;
    *up_cols = gated ? tc::kN / 2 : tc::kN;
    *down_cols = tc::kN;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// CTAs of `kernel` an SM keeps resident at `smem` bytes of dynamic shared
// memory (the occupancy API; needs a card), or -1.
template <typename Kernel>
int resident(Kernel kernel, int threads, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// The tensor-core backward's geometry, read by the tests against the
// Python plan (grouped_matmul.py::grouped_bwd_plan): launch 0 step 1a
// (dact), 1 step 1b (act, dU, dG), 2 step 2 (dh), 3 step 3's dw1 [and
// dw1g], 4 its dw2; gated 1 for swiglu and geglu; what = 0 threads a CTA,
// 1 rows of an output tile, 2 its columns (of one output tensor), 3 the
// contraction depth of a stage, 4 stages, 5 dynamic shared memory bytes,
// 6 CTAs an SM keeps resident (the occupancy API on the compiled kernel;
// needs a card).  Returns -1 for another argument or a failed query.
extern "C" int grouped_bwd_geometry(int launch, int gated, int what) {
  if (launch < 0 || launch > 4 || what < 0 || what > 6) return -1;
  switch (launch) {
    case 0:
    case 1: {
      const int up = tc::smem_bytes(tc::kUpStage, tc::kUpStages);
      const int v[6] = {tc::kThreads, tc::kRows,
                        launch == 1 && gated ? tc::kN / 2 : tc::kN,
                        tc::kDepth, tc::kUpStages, up};
      if (what < 6) return v[what];
      if (launch == 0)
        return resident(tc::ffn_bwd_dact_wgmma_kernel<float>, v[0], v[5]);
      return gated ? resident(tc::ffn_bwd_act_wgmma_kernel<kSwiglu, true>,
                              v[0], v[5])
                   : resident(tc::ffn_bwd_act_wgmma_kernel<kRelu2, false>,
                              v[0], v[5]);
    }
    case 2: {
      const int v[6] = {tc::kThreads, tc::kRows, tc::kN, tc::kDepth,
                        tc::kDownStages,
                        tc::smem_bytes(tc::kDownStage, tc::kDownStages)};
      if (what == 6)
        return gated ? resident(tc::ffn_bwd_dh_wgmma_kernel<true>, v[0], v[5])
                     : resident(tc::ffn_bwd_dh_wgmma_kernel<false>, v[0],
                                v[5]);
      return v[what];
    }
    default: {
      using L0 = tc::DwGeom<0>;
      using L1 = tc::DwGeom<1>;
      const bool dw1 = launch == 3;
      const int v[6] = {tc::kThreads, tc::kRows,
                        dw1 && gated ? tc::kN / 2 : tc::kN, tc::kDwRows,
                        dw1 ? L0::kStages : L1::kStages,
                        dw1 ? L0::kSmem : L1::kSmem};
      if (what == 6)
        return !dw1 ? resident(tc::ffn_bwd_dw_wgmma_kernel<1, false>, v[0],
                               v[5])
               : gated ? resident(tc::ffn_bwd_dw_wgmma_kernel<0, true>, v[0],
                                  v[5])
                       : resident(tc::ffn_bwd_dw_wgmma_kernel<0, false>, v[0],
                                  v[5]);
      return v[what];
    }
  }
}

extern "C" const char* grouped_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
