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
// Query head h reads kv head h / G (G = H / KV).  A sliding window keeps
// positions lens-window <= kpos < lens.  As in the reference, only the
// pmax * page positions the table can name are attended, and a position
// whose page id lies outside the pool contributes nothing (the plain
// version's rule for pages another shard owns); neither is ever loaded.
//
// Bound on this card: the bytes of K and V the call must read,
// sum_b needed_b * KV * hd * 2 * sizeof(T) (needed_b = lens_b, or
// min(lens_b, window)), over 3.35 TB/s — the arithmetic is 4 * G flops
// per byte-pair read and never the limit at G <= 48.
//
// Design (simple and correct first):
//   * one CTA per (kv head, slot) serves that kv head's G query heads, so
//     each K/V element is read from device memory once per call;
//   * the CTA loops over its own cache positions only, from the window's
//     start to lens, kTile positions per iteration, reading each
//     position's page id from its table row (the TPU grid walks every
//     table column; the positions past lens are never loaded here);
//   * K and V rows of a tile are staged in shared memory as f32; the G x
//     kTile logits go to shared memory; the online softmax keeps m, l
//     and acc[G, hd] in f32 in shared memory, exactly as the reference's
//     (m, l, acc) scratch;
//   * NEG_INF is the finite -1e30 and l is clamped at 1e-30 at finalize,
//     so a lens == 0 slot writes exact zeros (the serving engine relies
//     on that for inactive slots).
// Later: split-KV across CTAs with an LSE merge pass (fills the card at
// small batch and for MQA, where only B CTAs run), and TMA/wgmma tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // cache positions staged per iteration
constexpr float kNegInf = -1e30f;    // the reference's finite NEG_INF

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ table,
                       const int* __restrict__ lens,
                       T* __restrict__ out,
                       int n_heads, int n_kv, int hd, int page, int pmax,
                       int n_pages, int window, float scale) {
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
        pid = trow[(t0 + r) / page];
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

  T* ob = out + ((int64_t)b * n_heads + h0) * hd;
  for (int i = tid; i < groups * hd; i += kThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lens, void* out, int batch,
           int n_heads, int n_kv, int hd, int page, int pmax, int n_pages,
           int window, float scale, cudaStream_t stream) {
  static int smem_opted_in = 0;       // bytes already granted above 48 KB
  const size_t groups = n_heads / n_kv;
  const size_t smem = sizeof(float) *
      (2 * groups * hd + 2 * (size_t)kTile * hd + groups * kTile +
       3 * groups);
  if (smem > 48 * 1024 && (int)smem > smem_opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_opted_in = (int)smem;
  }
  const dim3 grid(n_kv, batch);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out), n_heads, n_kv,
      hd, page, pmax, n_pages, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lens, void* out, int batch,
                                      int n_heads, int n_kv, int hd, int page,
                                      int pmax, int n_pages, int window,
                                      float scale, void* stream) {
  if (batch <= 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv != 0 || hd <= 0 || page <= 0 || pmax <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lens, out, batch,
                         n_heads, n_kv, hd, page, pmax, n_pages, window,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, out,
                                 batch, n_heads, n_kv, hd, page, pmax,
                                 n_pages, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
