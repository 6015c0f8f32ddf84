// Flash attention forward, backward and the ring-attention carry step for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel) and flash_attention_carry_pallas
// (_flash_kernel_carry), and the reference's jnp flash backward
// src/repro/kernels/ops.py::_flash_bwd_blockwise, which the custom VJP at
// ops.py:59-105 wires in.
//
//   q      [B, Sq, H, hd]     (f32 or bf16)
//   k, v   [B, Skv, KV, hd]   (q's type); query head h reads kv head h / G,
//                             G = H / KV
//   out    [B, Sq, H, hd]     (q's type)
//   lse    [B, Sq, H]         f32, m + log(max(l, 1e-30))
//   mask   kpos < Skv, and qpos >= kpos when causal, and
//          qpos - kpos < window when window > 0; qpos = q_offset + i
//
// The forward emits the lse beside the output, so the backward needs no
// second pass over K (the reference recomputes it, ops.py:79-82).  The
// backward recomputes the probabilities from (q, k, lse), as
// ops.py:224-238 does:  p = exp(q.k * scale - lse),  dsum = sum(dout*out),
// dv = p^T dout,  dp = dout v^T,  ds = p (dp - dsum) scale,
// dq = ds k,  dk = ds^T q.
//
// Numerics are the reference's: logits, probabilities and accumulators in
// f32, the finite NEG_INF = -1e30, and l clamped at 1e-30 at finalize, so
// a fully masked row gives zeros, not NaN.
//
// Bound on this card: at the training shape (B=2, S=1024, H=32, KV=8,
// hd=128, causal, bf16) the forward does 17.2 GFLOP of unmasked QK^T and
// PV and moves 42 MB, so it is bound by operations (0.017 ms at the bf16
// tensor-core rate); the backward does about 2.5x the operations.
//
// Design (simple and correct first: SIMT f32 FMAs, no tensor cores):
//   * the Pallas grid's sequential kv dimension (scratch carried across
//     ki) becomes a loop inside the CTA; kv tiles that causality or the
//     window mask entirely are never visited (the Pallas grid runs them
//     for zero); ragged Sq and Skv are masked in the kernel;
//   * every tile product is a 64-row block product in shared memory:
//     256 threads as 16 x 16, each owning 4 rows x (N/16) columns of the
//     result in registers, with float4 reads (A row-major along the
//     reduction, B with the output columns contiguous).  Tiles are staged
//     as f32 (120 to 189 kB: dynamic shared memory above 48 KB);
//   * forward: one CTA per (b, h, 64 query rows); online softmax with
//     (m, l) and the output accumulator in registers, row statistics
//     reduced across the 16 threads of a row with warp shuffles;
//   * backward, deterministic and without atomics: a pre-pass computes
//     dsum; one launch for dK/dV with one CTA per (b, kv head, 64 kv
//     rows) looping over its G query heads and the query tiles that see
//     it; one launch for dQ with one CTA per (b, h, 64 query rows)
//     looping over the kv tiles it sees.
// The bound is far: these are f32 FMAs at best 67 TFLOP/s where the
// tensor cores give 989.  Later: mma/wgmma tiles in bf16 with TMA loads.
//
// The carry step (ring attention, managed.managed_ring_attention) is the
// forward kernel with the online-softmax state carried in and out instead
// of initialised and normalised:
//   m, l   [B, Sq, H]       f32 running max and sum (unnormalised)
//   acc    [B, Sq, H, hd]   f32 running sum of p v
//   mask   as above with qpos = q_offset + i, kpos = k_offset + j; only
//          d = q_offset - k_offset enters it, so the kernel takes d as its
//          q offset against local kv rows.  d < 0 (the block lies after
//          the q rows) gives an empty kv range under causality.
// Each CTA loads its 64 rows of the carry before its kv loop and stores
// them after it, so a CTA that visits no kv tile copies its rows through
// unchanged.  A wholly masked tile leaves the state bit for bit as it was
// (alpha = exp(0) = 1, p = 0), which is why skipping it is exact; a fully
// masked row keeps m = -1e30, l = 0, acc = 0.  The carry may be updated in
// place (in == out): a CTA reads only the rows it writes.  At ring
// attention's prefill call (B=1, S=8192, 32/8 heads, hd 128, causal) the
// step does 5.5e11 flop over the unmasked pairs and moves 0.37 GB (acc in
// and out dominate), so it is bound by operations (0.56 ms at the bf16
// tensor-core rate); this SIMT version is far from that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows of a q or kv tile
constexpr int kLd64 = kTile + 4;      // padded row of a 64-wide tile
constexpr float kNegInf = -1e30f;     // the reference's finite NEG_INF

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

// Sum / max over the 16 threads of one row (lanes that share lane / 16).
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Output column of register c of thread column tx: N = 64 uses c in
// [0, 4), N = 128 uses c in [0, 8) as two 64-wide halves.
__device__ __forceinline__ int col_of(int c, int tx) {
  return (c >> 2) * 64 + 4 * tx + (c & 3);
}

// acc[r][c] += sum_k A[4 ty + r][k] * B[k][col_of(c, tx)] for k in [0, K).
// A is row-major with leading dimension lda (a multiple of 4), B has
// leading dimension ldb; NC = N / 16 registers per row.
template <int NC>
__device__ __forceinline__ void block_mma(const float* __restrict__ A,
                                          int lda,
                                          const float* __restrict__ B,
                                          int ldb, int K, int ty, int tx,
                                          float (&acc)[4][NC]) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 t =
          *reinterpret_cast<const float4*>(A + (4 * ty + r) * lda + k);
      a[r][0] = t.x;
      a[r][1] = t.y;
      a[r][2] = t.z;
      a[r][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[NC];
#pragma unroll
      for (int hh = 0; hh < NC / 4; ++hh) {
        const float4 t = *reinterpret_cast<const float4*>(
            B + (k + kk) * ldb + hh * 64 + 4 * tx);
        b[4 * hh + 0] = t.x;
        b[4 * hh + 1] = t.y;
        b[4 * hh + 2] = t.z;
        b[4 * hh + 3] = t.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += a[r][kk] * b[c];
    }
  }
}

// Stage rows [row0, row0 + 64) of a [rows, heads, HD] slab (row stride
// heads * HD, head `head`) into shared memory as f32; rows past `rows` are
// zeros.  Row-major: dst[r * ld + d].  Transposed: dst[d * ld + r].
template <typename T, int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int rows, int heads,
                                          int head) {
  const int64_t stride = (int64_t)heads * HD;
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows) x = to_f32(src[(int64_t)row * stride + head * HD + d]);
    if (kTransposed)
      dst[d * ld + r] = x;
    else
      dst[r * ld + d] = x;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int causal, int window) {
  return kpos < skv && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// kv rows [lo, hi) that query positions [qlo, qhi] may see.
__device__ __forceinline__ void kv_range(int qlo, int qhi, int skv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *lo = window > 0 ? max(0, qlo - window + 1) : 0;
  *hi = causal ? min(skv, qhi + 1) : skv;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The online-softmax state of a carry step: read before the kv loop,
// written after it (null for the self-contained forward).
struct Carry {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// kCarry = false: the forward (state initialised, out and lse written).
// kCarry = true: one carry step (state from `carry`, stored back there).
template <typename T, int HD, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Carry carry, int sq, int skv,
                 int n_heads, int n_kv, int q_offset, int window, int causal,
                 float scale) {
  constexpr int NC = HD / 16;
  constexpr int kLdHd = HD + 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][HD+4]
  float* kt = qs + kTile * kLdHd;               // [HD][64+4]  K transposed
  float* vs = kt + HD * kLd64;                  // [64][HD+4]
  float* ps = vs + kTile * kLdHd;               // [64][64+4]  probabilities

  const T* qb = q + (int64_t)b * sq * n_heads * HD;
  const T* kb = k + (int64_t)b * skv * n_kv * HD;
  const T* vb = v + (int64_t)b * skv * n_kv * HD;
  load_tile<T, HD, false>(qs, kLdHd, qb, q0, sq, n_heads, h);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    const int i = q0 + 4 * ty + r;
    if (kCarry && i < sq) {
      const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
      m[r] = carry.m_in[row];
      l[r] = carry.l_in[row];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[r][c] = carry.acc_in[row * HD + col_of(c, tx)];
    }
  }

  int lo, hi;
  kv_range(q_offset + q0, q_offset + min(q0 + kTile, sq) - 1, skv, causal,
           window, &lo, &hi);
  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
    __syncthreads();  // the previous tile's kt, vs, ps are consumed
    load_tile<T, HD, true>(kt, kLd64, kb, k0, skv, n_kv, kvh);
    load_tile<T, HD, false>(vs, kLdHd, vb, k0, skv, n_kv, kvh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    block_mma<4>(qs, kLdHd, kt, kLd64, HD, ty, tx, s);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + 4 * ty + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ok[c] = visible(qpos, k0 + 4 * tx + c, skv, causal, window);
        s[r][c] = ok[c] ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p[c];
      }
      sum = row_sum(sum);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + r) * kLd64 + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    block_mma<NC>(ps, kLd64, vs, kLdHd, kTile, ty, tx, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= sq) continue;
    if (kCarry) {
      const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        carry.acc_out[row * HD + col_of(c, tx)] = acc[r][c];
      if (tx == 0) {
        carry.m_out[row] = m[r];
        carry.l_out[row] = l[r];
      }
      continue;
    }
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* ob = out + (((int64_t)b * sq + i) * n_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[col_of(c, tx)] = from_f32<T>(acc[r][c] / l_safe);
    if (tx == 0)
      lse[((int64_t)b * sq + i) * n_heads + h] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// dsum[b, i, h] = sum_d dout * out, one warp per row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                  float* __restrict__ dsum, int64_t rows) {
  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = out + row * HD;
  const T* g = dout + row * HD;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s += to_f32(g[d]) * to_f32(o[d]);
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) dsum[row] = s;
}

// Stage 64 per-row statistics (lse or dsum) of query rows [q0, q0 + 64).
__device__ __forceinline__ void load_stats(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int q0, int sq, int n_heads,
                                           int h) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = (q0 + r < sq) ? src[(int64_t)(q0 + r) * n_heads + h] : 0.f;
}

// p[r][c] and ds[r][c] of query rows 4 ty + r of tile q0 against kv
// columns 4 tx + c of tile k0, from S = Q K^T (unscaled) and dP = dO V^T.
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[4][4], float (&dp)[4][4], const float* __restrict__ lse_s,
    const float* __restrict__ dsum_s, int q0, int k0, int sq, int skv,
    int q_offset, int window, int causal, float scale, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    const int qpos = q_offset + q0 + i;
    const bool row_ok = q0 + i < sq;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok =
          row_ok && visible(qpos, k0 + 4 * tx + c, skv, causal, window);
      const float p = ok ? expf(s[r][c] * scale - lse_s[i]) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dsum_s[i]) * scale;
    }
  }
}

// dK, dV of kv rows [k0, k0 + 64) of kv head kvh: loop over the G query
// heads of the group and the query tiles that see these rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int skv, int n_heads,
                      int n_kv, int q_offset, int window, int causal,
                      float scale) {
  constexpr int NC = HD / 16;
  constexpr int kLdHd = HD + 4;
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [HD][64+4]  K transposed
  float* vt = kt + HD * kLd64;                  // [HD][64+4]  V transposed
  float* qs = vt + HD * kLd64;                  // [64][HD+4]
  float* dos = qs + kTile * kLdHd;              // [64][HD+4]
  float* pt = dos + kTile * kLdHd;              // [64][64+4]  P^T
  float* dst = pt + kTile * kLd64;              // [64][64+4]  dS^T
  float* lse_s = dst + kTile * kLd64;           // [64]
  float* dsum_s = lse_s + kTile;                // [64]

  const T* qb = q + (int64_t)b * sq * n_heads * HD;
  const T* gb = dout + (int64_t)b * sq * n_heads * HD;
  const float* lb = lse + (int64_t)b * sq * n_heads;
  const float* sb = dsum + (int64_t)b * sq * n_heads;
  load_tile<T, HD, true>(kt, kLd64, k + (int64_t)b * skv * n_kv * HD, k0,
                         skv, n_kv, kvh);
  load_tile<T, HD, true>(vt, kLd64, v + (int64_t)b * skv * n_kv * HD, k0,
                         skv, n_kv, kvh);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // query rows that see kv rows [k0, kmax]
  const int kmax = min(k0 + kTile, skv) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(sq, kmax + window - q_offset) : sq;

  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    for (int q0 = (i_lo / kTile) * kTile; q0 < i_hi; q0 += kTile) {
      __syncthreads();  // the previous tile's qs, dos, pt, dst are consumed
      load_tile<T, HD, false>(qs, kLdHd, qb, q0, sq, n_heads, h);
      load_tile<T, HD, false>(dos, kLdHd, gb, q0, sq, n_heads, h);
      load_stats(lse_s, lb, q0, sq, n_heads, h);
      load_stats(dsum_s, sb, q0, sq, n_heads, h);
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
      block_mma<4>(qs, kLdHd, kt, kLd64, HD, ty, tx, s);    // S = Q K^T
      block_mma<4>(dos, kLdHd, vt, kLd64, HD, ty, tx, dp);  // dP = dO V^T
      probs_and_dscores(s, dp, lse_s, dsum_s, q0, k0, sq, skv, q_offset,
                        window, causal, scale, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pt[(4 * tx + c) * kLd64 + 4 * ty + r] = s[r][c];
          dst[(4 * tx + c) * kLd64 + 4 * ty + r] = dp[r][c];
        }
      __syncthreads();
      block_mma<NC>(pt, kLd64, dos, kLdHd, kTile, ty, tx, dv_acc);  // P^T dO
      block_mma<NC>(dst, kLd64, qs, kLdHd, kTile, ty, tx, dk_acc);  // dS^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * ty + r;
    if (j >= skv) continue;
    const int64_t off = (((int64_t)b * skv + j) * n_kv + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + col_of(c, tx)] = from_f32<T>(dk_acc[r][c]);
      dv[off + col_of(c, tx)] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// dQ of query rows [q0, q0 + 64) of head h: loop over the kv tiles they see.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq,
                    int sq, int skv, int n_heads, int n_kv, int q_offset,
                    int window, int causal, float scale) {
  constexpr int NC = HD / 16;
  constexpr int kLdHd = HD + 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][HD+4]
  float* dos = qs + kTile * kLdHd;              // [64][HD+4]
  float* ks = dos + kTile * kLdHd;              // [64][HD+4]
  float* kt = ks + kTile * kLdHd;               // [HD][64+4]  K transposed
  float* vt = kt + HD * kLd64;                  // [HD][64+4]  V transposed
  float* dss = vt + HD * kLd64;                 // [64][64+4]  dS
  float* lse_s = dss + kTile * kLd64;           // [64]
  float* dsum_s = lse_s + kTile;                // [64]

  const T* kb = k + (int64_t)b * skv * n_kv * HD;
  const T* vb = v + (int64_t)b * skv * n_kv * HD;
  load_tile<T, HD, false>(qs, kLdHd, q + (int64_t)b * sq * n_heads * HD, q0,
                          sq, n_heads, h);
  load_tile<T, HD, false>(dos, kLdHd, dout + (int64_t)b * sq * n_heads * HD,
                          q0, sq, n_heads, h);
  load_stats(lse_s, lse + (int64_t)b * sq * n_heads, q0, sq, n_heads, h);
  load_stats(dsum_s, dsum + (int64_t)b * sq * n_heads, q0, sq, n_heads, h);

  float dq_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[r][c] = 0.f;

  int lo, hi;
  kv_range(q_offset + q0, q_offset + min(q0 + kTile, sq) - 1, skv, causal,
           window, &lo, &hi);
  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
    __syncthreads();  // the previous tile's ks, kt, vt, dss are consumed
    load_tile<T, HD, false>(ks, kLdHd, kb, k0, skv, n_kv, kvh);
    load_tile<T, HD, true>(kt, kLd64, kb, k0, skv, n_kv, kvh);
    load_tile<T, HD, true>(vt, kLd64, vb, k0, skv, n_kv, kvh);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    block_mma<4>(qs, kLdHd, kt, kLd64, HD, ty, tx, s);
    block_mma<4>(dos, kLdHd, vt, kLd64, HD, ty, tx, dp);
    probs_and_dscores(s, dp, lse_s, dsum_s, q0, k0, sq, skv, q_offset,
                      window, causal, scale, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(dss + (4 * ty + r) * kLd64 + 4 * tx) =
          make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]);
    __syncthreads();
    block_mma<NC>(dss, kLd64, ks, kLdHd, kTile, ty, tx, dq_acc);  // dS K
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= sq) continue;
    T* ob = dq + (((int64_t)b * sq + i) * n_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[col_of(c, tx)] = from_f32<T>(dq_acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Opt a kernel into `bytes` of dynamic shared memory once (above 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024 || (int)bytes <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *granted = (int)bytes;
  return e;
}

struct Shape {
  int batch, sq, skv, n_heads, n_kv, q_offset, window, causal;
  float scale;
};

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * (HD + 4) + HD * kLd64 + kTile * kLd64);
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (2 * HD * kLd64 + 2 * kTile * (HD + 4) + 2 * kTile * kLd64 +
          2 * kTile);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (3 * kTile * (HD + 4) + 2 * HD * kLd64 +
                          kTile * kLd64 + 2 * kTile);
}

template <typename T, int HD, bool kCarry>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Carry& carry, const Shape& s, cudaStream_t stream) {
  static int granted = 0;
  const size_t smem = fwd_smem<HD>();
  cudaError_t e =
      allow_smem(flash_fwd_kernel<T, HD, kCarry>, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s.sq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_fwd_kernel<T, HD, kCarry><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), carry, s.sq, s.skv, s.n_heads, s.n_kv,
      s.q_offset, s.window, s.causal, s.scale);
  return (int)cudaGetLastError();
}

template <bool kCarry>
int fwd_dispatch(int dtype, int hd, const void* q, const void* k,
                 const void* v, void* out, void* lse, const Carry& carry,
                 const Shape& s, cudaStream_t st) {
  if (dtype == 0)
    return hd == 128
               ? fwd<float, 128, kCarry>(q, k, v, out, lse, carry, s, st)
               : fwd<float, 64, kCarry>(q, k, v, out, lse, carry, s, st);
  if (dtype == 1)
    return hd == 128 ? fwd<__nv_bfloat16, 128, kCarry>(q, k, v, out, lse,
                                                        carry, s, st)
                     : fwd<__nv_bfloat16, 64, kCarry>(q, k, v, out, lse,
                                                       carry, s, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* dsum, void* dq, void* dk,
        void* dv, const Shape& s, cudaStream_t stream) {
  static int granted_dkdv = 0, granted_dq = 0;
  cudaError_t e =
      allow_smem(flash_bwd_dkdv_kernel<T, HD>, dkdv_smem<HD>(), &granted_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_kernel<T, HD>, dq_smem<HD>(), &granted_dq);
  if (e != cudaSuccess) return (int)e;

  const int64_t rows = (int64_t)s.batch * s.sq * s.n_heads;
  const int64_t per_block = kThreads / 32;
  flash_dsum_kernel<T, HD>
      <<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                   static_cast<float*>(dsum), rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((s.skv + kTile - 1) / kTile, s.n_kv, s.batch);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, kThreads, dkdv_smem<HD>(),
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), s.sq, s.skv, s.n_heads,
      s.n_kv, s.q_offset, s.window, s.causal, s.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((s.sq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, dq_smem<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), s.sq, s.skv, s.n_heads, s.n_kv, s.q_offset,
      s.window, s.causal, s.scale);
  return (int)cudaGetLastError();
}

bool valid(const Shape& s, int hd) {
  return s.batch >= 0 && s.sq >= 0 && s.skv >= 0 && s.n_kv > 0 &&
         s.n_heads % s.n_kv == 0 && (hd == 64 || hd == 128) &&
         s.n_heads <= 65535 && s.batch <= 65535 && s.n_kv <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          void* out, void* lse, int batch,
                                          int sq, int skv, int n_heads,
                                          int n_kv, int hd, int q_offset,
                                          int window, int causal,
                                          float scale, void* stream) {
  const Shape s{batch, sq, skv, n_heads, n_kv, q_offset, window, causal,
                scale};
  if (!valid(s, hd)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  return fwd_dispatch<false>(dtype, hd, q, k, v, out, lse, Carry{}, s,
                             static_cast<cudaStream_t>(stream));
}

// One ring-attention carry step: fold k, v [B, Skv, KV, hd] into (m, l,
// acc) for q [B, Sq, H, hd].  q_offset and k_offset are the global
// positions of q[0] and k[0].  The *_out pointers may equal the *_in ones.
extern "C" int flash_attention_carry_launch(
    int dtype, const void* q, const void* k, const void* v, const void* m_in,
    const void* l_in, const void* acc_in, void* m_out, void* l_out,
    void* acc_out, int batch, int sq, int skv, int n_heads, int n_kv,
    int hd, int q_offset, int k_offset, int window, int causal, float scale,
    void* stream) {
  const Shape s{batch, sq,           skv,    n_heads, n_kv,
                q_offset - k_offset, window, causal,  scale};
  if (!valid(s, hd)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || n_heads == 0) return 0;
  const Carry carry{static_cast<const float*>(m_in),
                    static_cast<const float*>(l_in),
                    static_cast<const float*>(acc_in),
                    static_cast<float*>(m_out),
                    static_cast<float*>(l_out),
                    static_cast<float*>(acc_out)};
  return fwd_dispatch<true>(dtype, hd, q, k, v, nullptr, nullptr, carry, s,
                            static_cast<cudaStream_t>(stream));
}

// dsum is f32 scratch [B, Sq, H].  Three launches (dsum, dK/dV, dQ).
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int n_heads, int n_kv, int hd,
    int q_offset, int window, int causal, float scale, void* stream) {
  const Shape s{batch, sq, skv, n_heads, n_kv, q_offset, window, causal,
                scale};
  if (!valid(s, hd)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || skv == 0 || n_heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hd == 128
               ? bwd<float, 128>(q, k, v, out, dout, lse, dsum, dq, dk, dv, s,
                                 st)
               : bwd<float, 64>(q, k, v, out, dout, lse, dsum, dq, dk, dv, s,
                                st);
  if (dtype == 1)
    return hd == 128 ? bwd<__nv_bfloat16, 128>(q, k, v, out, dout, lse, dsum,
                                               dq, dk, dv, s, st)
                     : bwd<__nv_bfloat16, 64>(q, k, v, out, dout, lse, dsum,
                                              dq, dk, dv, s, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
