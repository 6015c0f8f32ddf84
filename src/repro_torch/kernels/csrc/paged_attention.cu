// Paged decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention_pallas (_paged_kernel).  One query token per slot
// attends its KV chain through a page table:
//
//   q        [B, H, hd]                 (f32 or bf16)
//   k_pages  [n_pages, page, KV, hd]    (same type as q)
//   v_pages  [n_pages, page, KV, hd]
//   table    [B, pmax] int32 pool page ids (entries past ceil(lens/page)
//            may hold anything and are never read)
//   lens     [B] int32 valid positions (0 = nothing: the output is zeros)
//   out      [B, H, hd] in q's type
//
// or, for a pool sharded over ranks, the flash partials of this rank's
// pages in place of out (paged_attention.py::paged_attention_partials):
// m (natural-log units) and l [B, H] and the unnormalised acc [B, H, hd],
// all f32, which the caller LSE-merges across ranks.  The table then
// holds GLOBAL page ids; id - pool_offset indexes the local pool, and an
// entry outside it (another rank's page) contributes nothing, as in the
// plain version.  A row with nothing to attend gets m = NEG_INF, l = 0 and
// acc = 0.  Both engines write partials: the f32 path's kernel its own
// (m, l, acc), the bf16 fast path its splits' partials through the merge
// kernel, which folds them without normalising.
//
// Query head h reads kv head h / G (G = H / KV).  A sliding window keeps
// positions lens-window <= kpos < lens.  As in the reference, only the
// pmax * page positions the table can name are attended, and a position
// whose page id lies outside the pool contributes nothing (the plain
// version's rule for pages another shard owns); neither is ever loaded.
// Logits are q.k in f32 times 1/sqrt(hd); P stays f32 in P.V (the TPU
// kernel's preferred_element_type=f32 on f32 operands).  NEG_INF is the
// finite -1e30 and l is clamped at 1e-30, so a lens == 0 slot writes exact
// zeros (the serving engine relies on that for inactive slots).
//
// What bounds it on this card.  A call must read the K and V rows it
// attends once: sum_b needed_b * KV * hd * 2 * sizeof(T) bytes over 3.35
// TB/s.  It does 4 flops per (query head, position, hd), about G flop per
// byte of K/V in bf16.  Bytes bound it at G <= 8 (phi4-mini G=4, grok G=6,
// moonshot G=1).  On the SIMT units the arithmetic would bound it at G=48
// (granite's MQA: 96 flop/byte against the 20 that 67 TFLOP/s f32 over
// 3.35 TB/s allow), so the fast path computes on the tensor cores, where
// the bytes bound it again.  At the serving shapes a call moves a few MB
// and is bound by latency instead: the chain lens -> page ids -> K/V ->
// partials -> merge, each a dependent trip to memory.
//
// Design of the bf16 fast path (hd 32, 64, 128, 192):
//   * Split-KV (flash-decoding).  The grid is (CTA of a kv head, split,
//     slot).  A split is a run of whole table columns; the wrapper's
//     split_plan picks the pages per split from pmax, page, B, KV, the
//     row tiles per kv head and the SM count, never from lens (the host
//     reads nothing from the card): at least one CTA per SM, and long
//     chains cut further (towards 16 per SM, splits of >= 512 positions)
//     so slots of unequal length share the SMs.  A CTA attends the
//     positions of its split in [max(0, lens - window), min(lens, pmax *
//     page)); a split wholly outside writes an empty partial (m = NEG_INF,
//     l = 0) at once.  With one split the CTA writes the output itself;
//     with more it writes f32 partials (m, l, acc) to a workspace the
//     wrapper allocates with torch.empty, and paged_merge_kernel folds them
//     in split order 0, 1, ... with the combinator of kernels/
//     flash_attention.py::merge_partials (in base 2: m is kept in log2
//     units throughout), so two calls give the same bits.  A split whose l
//     is 0 is skipped: its acc is never read.  The merge is launched with
//     programmatic dependent launch: its CTAs start while the split CTAs
//     run and wait in griddepcontrol.wait for their results.
//   * Loads.  q is copied first (off the chain above).  The split's page
//     ids are read once into shared memory (only the columns its positions
//     need).  K and V rows of kTile = 64 positions are copied with 16-byte
//     cp.async.cg into a ring of kStages = 3 stages, kept in bf16 with rows
//     padded by 16 bytes (so the ldmatrix reads are free of bank
//     conflicts); a row that is not attended is zero-filled (src-size 0)
//     and never read from memory.  The next stages stay in flight while
//     the current one is computed; one __syncthreads per tile.
//   * Compute.  4 warps, 16 positions of each tile per warp, each warp
//     with its own online softmax in f32 registers (no shared-memory logit
//     buffer); at the end the 4 warps' (m, l, acc) merge in warp order
//     through shared memory.  paged_mma_kernel serves every G: the query
//     heads of a kv head are the rows of mma.sync.m16n8k16 tiles (G padded
//     to 16; one CTA per 16 heads, so G=48 runs 3 CTAs per kv head, which
//     share its K/V in L2).  S = Q K^T from ldmatrix fragments; P stays in
//     registers as the A operand of P.V, which runs as P_hi.V + P_lo.V
//     (bf16 pairs, as in the flash kernels), so P is f32 in effect.
//     A second, SIMT engine for G <= 8 (hd / 8 lanes per position, q in
//     registers, dots reduced by shuffles) was built and timed against
//     this one on an NVIDIA H100 80GB HBM3 at 700 W while the kernel was
//     designed: the tensor cores won from G = 4, and SIMT only at G = 1,
//     by about a tenth of the call's latency.  One engine for every G
//     was worth more than that, so the SIMT engine was taken out.
//
// The f32 path (and bf16 at a head dim the fast path is not built for)
// keeps the first port's kernel, paged_simt_kernel: one CTA per (kv head,
// slot) walking the slot's positions kTile at a time with f32 tiles in
// shared memory.  It serves the f32 parity runs and card tests at atol
// 1e-4, which tensor cores in TF32 would not hold.
//
// Left for later: a TMA / wgmma tile (mma.sync is far from its limit at
// these G, so this matters only for wider groups); the merge as the last
// CTA of each slot (one launch, at the price of counters kept between
// calls); and, above all, the CUDA graph of the serving decode step, whose
// host time (phi4-mini on an H100 80GB HBM3 at 700 W: 53-77 ms against
// 8.4 ms of device time) hides the kernel's gain from tokens/s and TPOT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;    // the reference's finite NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The f32 path: one CTA per (kv head, slot), f32 tiles in shared memory
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // cache positions staged per iteration

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_simt_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
            const T* __restrict__ v_pages, const int* __restrict__ table,
            const int* __restrict__ lens, T* __restrict__ out,
            float* __restrict__ out_m, float* __restrict__ out_l,
            float* __restrict__ out_acc, int n_heads, int n_kv, int hd,
            int page, int pmax, int n_pages, int pool_offset, int window,
            float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                     // [G, hd]   q * scale
  float* acc = qs + groups * hd;        // [G, hd]   unnormalised output
  float* ks = acc + groups * hd;        // [kTile, hd]
  float* vs = ks + kTile * hd;          // [kTile, hd]
  float* ps = vs + kTile * hd;          // [G, kTile] logits, then probs
  float* m_s = ps + groups * kTile;     // [G] running max
  float* l_s = m_s + groups;            // [G] running sum
  float* alpha_s = l_s + groups;        // [G] rescale of this tile
  __shared__ int page_s[kTile];         // [kTile] pool page per row, -1 = none

  const int h0 = kvh * groups;
  const T* qb = q + ((int64_t)b * n_heads + h0) * hd;
  for (int i = tid; i < groups * hd; i += kThreads) {
    qs[i] = to_f32(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < groups; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len_b = lens[b];
  const int len = min(len_b, pmax * page);
  const int lo = window > 0 ? max(0, len_b - window) : 0;
  const int* trow = table + (int64_t)b * pmax;
  const int64_t row_stride = (int64_t)n_kv * hd;
  const int64_t page_stride = (int64_t)page * row_stride;
  __syncthreads();

  for (int t0 = lo; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);

    for (int r = tid; r < kTile; r += kThreads) {
      int pid = -1;
      if (r < n) {
        pid = trow[(t0 + r) / page] - pool_offset;
        if (pid < 0 || pid >= n_pages) pid = -1;
      }
      page_s[r] = pid;
    }
    __syncthreads();

    // stage the tile's K/V rows (neighbouring threads, neighbouring d)
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      float kv = 0.f, vv = 0.f;
      if (page_s[r] >= 0) {
        const int64_t off = (int64_t)page_s[r] * page_stride +
                            (int64_t)((t0 + r) % page) * row_stride +
                            (int64_t)kvh * hd + d;
        kv = to_f32(k_pages[off]);
        vv = to_f32(v_pages[off]);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    // logits: one warp per (query head, position) pair
    for (int pr = warp; pr < groups * kTile; pr += kWarps) {
      const int g = pr / kTile;
      const int r = pr - g * kTile;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += qs[g * hd + d] * ks[r * hd + d];
      s = warp_sum(s);
      if (lane == 0) ps[pr] = (page_s[r] >= 0) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < groups; g += kWarps) {
      float* p = ps + g * kTile;
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, p[r]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float e = (page_s[r] >= 0) ? expf(p[r] - m_new) : 0.f;
        p[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha_s[g] = a;
        l_s[g] = a * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    for (int i = tid; i < groups * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* p = ps + g * kTile;
      float a = acc[i] * alpha_s[g];
      for (int r = 0; r < n; ++r) a += p[r] * vs[r * hd + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  const int64_t row0 = (int64_t)b * n_heads + h0;
  if (out_acc != nullptr) {          // this pool's partials, unnormalised
    for (int i = tid; i < groups * hd; i += kThreads)
      out_acc[row0 * hd + i] = acc[i];
    for (int g = tid; g < groups; g += kThreads) {
      out_m[row0 + g] = m_s[g];
      out_l[row0 + g] = l_s[g];
    }
    return;
  }
  T* ob = out + row0 * hd;
  for (int i = tid; i < groups * hd; i += kThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* out, float* out_m,
           float* out_l, float* out_acc, int batch, int n_heads, int n_kv,
           int hd, int page, int pmax, int n_pages, int pool_offset,
           int window, float scale, cudaStream_t stream) {
  static int smem_opted_in = 0;       // bytes already granted above 48 KB
  const size_t groups = n_heads / n_kv;
  const size_t smem = sizeof(float) *
      (2 * groups * hd + 2 * (size_t)kTile * hd + groups * kTile +
       3 * groups);
  if (smem > 48 * 1024 && (int)smem > smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted_in = (int)smem;
  }
  const dim3 grid(n_kv, batch);
  paged_simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out), out_m, out_l,
      out_acc, n_heads, n_kv, hd, page, pmax, n_pages, pool_offset, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The bf16 fast path: split-KV, cp.async stages, mma.sync compute
// ---------------------------------------------------------------------------

namespace split {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // positions per stage, 16 per warp
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kMaxSplitPages = 512;    // page ids of a split in smem
constexpr int kRowTile = 16;           // query heads per mma CTA

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* lens;
  bf16* out;
  float* ws_acc;     // [n_splits, B * H, hd] (unused when direct)
  float* ws_ml;      // [n_splits, B * H, 2]: (m in log2 units, l)
  float* out_m;      // the partials out, [B * H] and [B * H, hd], or null
  float* out_l;
  float* out_acc;
  int batch, n_heads, n_kv, page, pmax, n_pages, pool_offset, window;
  int pages_per_split, n_splits, row_tiles;
  float scale_log2;  // 1/sqrt(hd) * log2(e)
};

template <int HD>
struct Dims {
  static constexpr int kRow = HD + 8;          // padded smem row, elements
  static constexpr int kChunks = HD / 8;       // 16-byte chunks per row
  static constexpr int kStageElems = 2 * kTile * kRow;   // K then V
  static constexpr int kLoadsPerThread = kTile * kChunks / kThreads;
  static_assert(kTile * kChunks % kThreads == 0, "chunks per thread");
};

// One split that writes the output itself: no workspace, no merge.
__host__ __device__ __forceinline__ bool direct(const Params& p) {
  return p.n_splits == 1 && p.out_acc == nullptr;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with ok == false the destination is
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: the merge kernel may start (and wait in
// griddepcontrol.wait for this grid's completion and its memory) once
// every CTA of the split kernel has started.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The CTA's share of the chain: positions [begin, end) of its split.
struct Span {
  int begin, end;    // attended positions of this split
  int c0;            // first table column of the split's page ids
};

__device__ __forceinline__ Span span_of(const Params& p, int b, int split) {
  const int len_b = p.lens[b];
  const int len = min(len_b, p.pmax * p.page);
  const int lo = p.window > 0 ? max(0, len_b - p.window) : 0;
  const int s0 = split * p.pages_per_split * p.page;
  const int s1 = min(s0 + p.pages_per_split * p.page, p.pmax * p.page);
  Span s;
  s.begin = max(lo, s0);
  s.end = min(len, s1);
  s.c0 = s.begin / p.page;
  return s;
}

// Page ids of the columns the span needs, -1 for one outside the pool.
__device__ __forceinline__ void load_page_ids(const Params& p, int b,
                                              const Span& s, int* pages_s) {
  const int* trow = p.table + (int64_t)b * p.pmax;
  const int nc = (s.end - 1) / p.page + 1 - s.c0;
  for (int i = threadIdx.x; i < nc; i += kThreads) {
    const int pid = trow[s.c0 + i] - p.pool_offset;
    pages_s[i] = (pid >= 0 && pid < p.n_pages) ? pid : -1;
  }
}

// Issue the cp.async copies of tile t (positions s.begin + t * kTile ...)
// into one stage, and mark which of its rows are attended.
template <int HD>
__device__ __forceinline__ void load_tile(const Params& p, const Span& s,
                                          const int* pages_s, int kvh, int t,
                                          bf16* stage, uint8_t* valid) {
  using D = Dims<HD>;
  const int t0 = s.begin + t * kTile;
  const int64_t row_stride = (int64_t)p.n_kv * HD;
  bf16* ks = stage;
  bf16* vs = stage + kTile * D::kRow;
#pragma unroll
  for (int k = 0; k < D::kLoadsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / D::kChunks;
    const int c = i - r * D::kChunks;
    const int pos = t0 + r;
    int pid = -1, prow = 0;
    if (pos < s.end) {
      const int col = pos / p.page;
      pid = pages_s[col - s.c0];
      prow = pos - col * p.page;
    }
    const bool ok = pid >= 0;
    const int64_t off =
        ok ? ((int64_t)pid * p.page + prow) * row_stride + kvh * HD + c * 8
           : 0;
    cp_async16(ks + r * D::kRow + c * 8, p.k + off, ok);
    cp_async16(vs + r * D::kRow + c * 8, p.v + off, ok);
    if (c == 0) valid[r] = ok;
  }
}

// The empty partial of a split with nothing to attend (or zeros, where
// the CTA writes the output itself).
__device__ __forceinline__ void write_empty(const Params& p, int b, int split,
                                            int h0, int rows, int hd) {
  if (direct(p)) {
    bf16* ob = p.out + ((int64_t)b * p.n_heads + h0) * hd;
    for (int i = threadIdx.x; i < rows * hd; i += kThreads)
      ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int64_t row0 = ((int64_t)split * p.batch + b) * p.n_heads + h0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    p.ws_ml[(row0 + r) * 2] = kNegInf;
    p.ws_ml[(row0 + r) * 2 + 1] = 0.f;
  }
}

// Merge the warps' (m, l, acc) in warp order and write the output (one
// split) or the split's partial.  ml_s: [kWarps][kRowTile][2];
// acc_s: [kWarps][kRowTile][HD] f32.
template <int HD>
__device__ __forceinline__ void finish(const Params& p, int b, int split,
                                       int h0, int rows, const float* ml_s,
                                       const float* acc_s) {
  const int64_t row0 = ((int64_t)split * p.batch + b) * p.n_heads + h0;
  for (int i = threadIdx.x; i < rows * (HD / 2); i += kThreads) {
    const int r = i / (HD / 2);
    const int d = (i - r * (HD / 2)) * 2;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, ml_s[(w * kRowTile + r) * 2]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = ml_s + (w * kRowTile + r) * 2;
      const float wt = exp2f(ml[0] - mx);
      l += wt * ml[1];
      const float2 a = *reinterpret_cast<const float2*>(
          acc_s + (w * kRowTile + r) * HD + d);
      a0 += wt * a.x;
      a1 += wt * a.y;
    }
    if (direct(p)) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(
          p.out + ((int64_t)b * p.n_heads + h0 + r) * HD + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(p.ws_acc + (row0 + r) * HD + d) =
          make_float2(a0, a1);
      if (d == 0) {
        p.ws_ml[(row0 + r) * 2] = mx;
        p.ws_ml[(row0 + r) * 2 + 1] = l;
      }
    }
  }
}

// --- mma.sync helpers -------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi): x = hi + lo to about 16 bits
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// One CTA per (16 query heads of a kv head, split, slot).  Warp w takes
// positions [16 w, 16 w + 16) of every tile.  Thread layout of the m16n8
// fragments: rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4) + {0, 1}.
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const Params p) {
  using D = Dims<HD>;
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int kvh = blockIdx.x / p.row_tiles;
  const int rt = blockIdx.x - kvh * p.row_tiles;
  const int groups = p.n_heads / p.n_kv;
  const int h0 = kvh * groups + rt * kRowTile;
  const int rows = min(kRowTile, groups - rt * kRowTile);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);          // kStages x K,V
  bf16* qs = stages + kStages * D::kStageElems;              // [16][kRow]
  __shared__ int pages_s[kMaxSplitPages];
  __shared__ uint8_t valid_s[kStages][kTile];
  __shared__ float ml_s[kWarps * kRowTile * 2];

  // q rows of this CTA (rows past the group are zeros), copied before
  // lens is read: they land with tile 0, off the lens -> table -> K/V chain
  const bf16* qb = p.q + ((int64_t)b * p.n_heads + h0) * HD;
  for (int i = tid; i < kRowTile * D::kChunks; i += kThreads) {
    const int r = i / D::kChunks;
    const int c = i - r * D::kChunks;
    cp_async16(qs + r * D::kRow + c * 8, qb + (r < rows ? r * HD + c * 8 : 0),
               r < rows);
  }
  const Span s = span_of(p, b, split);
  if (s.begin >= s.end) {
    cp_async_wait<0>();
    write_empty(p, b, split, h0, rows, HD);
    return;
  }
  load_page_ids(p, b, s, pages_s);
  __syncthreads();

  const int n_tiles = (s.end - s.begin + kTile - 1) / kTile;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile<HD>(p, s, pages_s, kvh, t, stages + t * D::kStageElems,
                    valid_s[t]);
    cp_async_commit();
  }

  uint32_t qa[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int qd = lane & 3;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles)
        load_tile<HD>(p, s, pages_s, kvh, tn,
                      stages + (tn % kStages) * D::kStageElems,
                      valid_s[tn % kStages]);
      cp_async_commit();
    }
    const int st = t % kStages;
    const bf16* ks = stages + st * D::kStageElems + warp * 16 * D::kRow;
    const bf16* vs = ks + kTile * D::kRow;
    const uint8_t* valid = valid_s[st] + warp * 16;
    if (t == 0) {                       // q arrived with tile 0
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk * 16 + (lane >> 4) * 8;
        ldsm_x4(qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                qs + r * D::kRow + c);
      }
    }

    // S = Q K^T over this warp's 16 positions (two n8 tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b0, b1, b2, b3;
      const int r = (lane & 7) + (lane >> 4) * 8;
      const int c = kk * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(b0, b1, b2, b3, ks + r * D::kRow + c);
      mma16816(sc[0], qa[kk], b0, b1);
      mma16816(sc[1], qa[kk], b2, b3);
    }

    // online softmax in base 2; masked positions give p = 0
    bool ok[2][2];
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[j][e] = valid[j * 8 + qd * 2 + e] != 0;
        sc[j][e] = ok[j][e] ? sc[j][e] * p.scale_log2 : kNegInf;
        sc[j][2 + e] = ok[j][e] ? sc[j][2 + e] * p.scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = ok[j][e] ? exp2f(sc[j][e] - mn0) : 0.f;
        sc[j][2 + e] = ok[j][e] ? exp2f(sc[j][2 + e] - mn1) : 0.f;
        ps0 += sc[j][e];
        ps1 += sc[j][2 + e];
      }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // P as the A operand (k = the 16 positions), split into bf16 hi + lo
    uint32_t ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);

    // acc += P_hi V + P_lo V, 16 hd columns per ldmatrix
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t b0, b1, b2, b3;
      const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = n * 16 + (lane >> 4) * 8;
      ldsm_x4_t(b0, b1, b2, b3, vs + r * D::kRow + c);
      mma16816(acc[2 * n], ph, b0, b1);
      mma16816(acc[2 * n], pl, b0, b1);
      mma16816(acc[2 * n + 1], ph, b2, b3);
      mma16816(acc[2 * n + 1], pl, b2, b3);
    }
  }
  cp_async_wait<0>();

  // the warps' partials through shared memory (the stages are free now)
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw);
  const int r0 = lane >> 2;
  if (qd == 0) {
    ml_s[(warp * kRowTile + r0) * 2] = m0;
    ml_s[(warp * kRowTile + r0) * 2 + 1] = l0;
    ml_s[(warp * kRowTile + r0 + 8) * 2] = m1;
    ml_s[(warp * kRowTile + r0 + 8) * 2 + 1] = l1;
  }
  float* aw = acc_s + warp * kRowTile * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + qd * 2;
    *reinterpret_cast<float2*>(aw + r0 * HD + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(aw + (r0 + 8) * HD + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  finish<HD>(p, b, split, h0, rows, ml_s, acc_s);
}

// Fold the splits' partials in split order: one warp per (slot, head).
// With out_acc, write the folded partial unnormalised (m in natural-log
// units; m = NEG_INF, l = 0, acc = 0 where no split attended anything) in
// place of the output.
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws_acc,
             const float* __restrict__ ws_ml, bf16* __restrict__ out,
             float* __restrict__ out_m, float* __restrict__ out_l,
             float* __restrict__ out_acc, int rows, int hd, int n_splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, ws_ml[((int64_t)s * rows + row) * 2]);
  for (int d = lane * 4; d < hd; d += 128) {
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_splits; ++s) {
      const int64_t r = (int64_t)s * rows + row;
      const float ls = ws_ml[r * 2 + 1];
      if (ls == 0.f) continue;           // an empty split: acc unwritten
      const float w = exp2f(ws_ml[r * 2] - mx);
      l += w * ls;
      const float4 v = *reinterpret_cast<const float4*>(ws_acc + r * hd + d);
      a.x += w * v.x;
      a.y += w * v.y;
      a.z += w * v.z;
      a.w += w * v.w;
    }
    if (out_acc != nullptr) {
      *reinterpret_cast<float4*>(out_acc + (int64_t)row * hd + d) = a;
      if (d == 0) {
        out_m[row] = l > 0.f ? mx * (1.0f / kLog2e) : kNegInf;
        out_l[row] = l;
      }
      continue;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out + (int64_t)row * hd + d);
    o[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
    o[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int* granted, size_t smem) {
  if (smem > 48 * 1024 && (int)smem > *granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *granted = (int)smem;
  }
  return 0;
}

template <int HD>
int launch_mma(const Params& p, cudaStream_t stream) {
  static int granted = 0;
  const size_t smem = sizeof(bf16) *
      ((size_t)kStages * Dims<HD>::kStageElems + kRowTile * Dims<HD>::kRow);
  if (int e = set_smem(paged_mma_kernel<HD>, &granted, smem)) return e;
  const dim3 grid(p.n_kv * p.row_tiles, p.n_splits, p.batch);
  paged_mma_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(const Params& p, int hd, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  if (hd == 32) err = launch_mma<32>(p, stream);
  else if (hd == 64) err = launch_mma<64>(p, stream);
  else if (hd == 128) err = launch_mma<128>(p, stream);
  else if (hd == 192) err = launch_mma<192>(p, stream);
  if (err != 0 || direct(p)) return err;
  const int rows = p.batch * p.n_heads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_merge_kernel, (const float*)p.ws_acc, (const float*)p.ws_ml,
      p.out, p.out_m, p.out_l, p.out_acc, rows, hd, p.n_splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace split

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  engine: 0 = the f32 path's kernel
// (paged_simt_kernel, either type, any hd), 1 = the bf16 split-KV mma.sync
// kernel (hd 32, 64, 128, 192), which takes pages_per_split and n_splits
// from the wrapper's split plan (n_splits = ceil(pmax / pages_per_split))
// and, when n_splits > 1 or partials are asked for, f32 workspaces ws_acc
// [n_splits, B, H, hd] and ws_ml [n_splits, B, H, 2] (m in log2 units, l).
// Page id - pool_offset indexes the pool of n_pages.  With out_acc (and
// out_m, out_l) not null the call writes the partials of the header's note
// there and not out.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(
    int dtype, int engine, const void* q, const void* k_pages,
    const void* v_pages, const void* table, const void* lens, void* out,
    void* ws_acc, void* ws_ml, void* out_m, void* out_l, void* out_acc,
    int batch, int n_heads, int n_kv, int hd, int page, int pmax,
    int n_pages, int pool_offset, int window, float scale,
    int pages_per_split, int n_splits, void* stream) {
  if (batch <= 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || hd <= 0 || page <= 0 || pmax <= 0)
    return (int)cudaErrorInvalidValue;
  const bool partials = out_acc != nullptr;
  if (partials ? (out_m == nullptr || out_l == nullptr) : out == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(out_m);
  float* pl = static_cast<float*>(out_l);
  float* pa = static_cast<float*>(out_acc);
  if (engine == 0) {
    if (dtype == 0)
      return simt::launch<float>(q, k_pages, v_pages, table, lens, out, pm,
                                 pl, pa, batch, n_heads, n_kv, hd, page,
                                 pmax, n_pages, pool_offset, window, scale,
                                 s);
    if (dtype == 1)
      return simt::launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens,
                                         out, pm, pl, pa, batch, n_heads,
                                         n_kv, hd, page, pmax, n_pages,
                                         pool_offset, window, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1 || engine != 1 || pages_per_split <= 0 ||
      pages_per_split > split::kMaxSplitPages ||
      n_splits != (pmax + pages_per_split - 1) / pages_per_split ||
      n_splits > 65535 || batch > 65535 ||
      ((n_splits > 1 || partials) && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int groups = n_heads / n_kv;
  split::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k_pages);
  p.v = static_cast<const __nv_bfloat16*>(v_pages);
  p.table = static_cast<const int*>(table);
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.out_m = pm;
  p.out_l = pl;
  p.out_acc = pa;
  p.batch = batch;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.page = page;
  p.pmax = pmax;
  p.n_pages = n_pages;
  p.pool_offset = pool_offset;
  p.window = window;
  p.pages_per_split = pages_per_split;
  p.n_splits = n_splits;
  p.row_tiles = (groups + split::kRowTile - 1) / split::kRowTile;
  p.scale_log2 = scale * kLog2e;
  return split::launch(p, hd, s);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
