// Flash attention forward, backward and the ring-attention carry step for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel) and flash_attention_carry_pallas
// (_flash_kernel_carry), and the reference's jnp flash backward
// src/repro/kernels/ops.py::_flash_bwd_blockwise, which the custom VJP at
// ops.py:59-105 wires in, and its twin for ring attention,
// ops.py::flash_attention_bwd_block (the backward of one carry step: the
// caller's dsum, q and k at global offsets, f32 outputs).
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
// The carry step (ring attention, managed.managed_ring_attention) is the
// forward with the online-softmax state carried in and out instead of
// initialised and normalised:
//   m, l   [B, Sq, H]       f32 running max (natural log) and sum
//   acc    [B, Sq, H, hd]   f32 running sum of p v
//   mask   as above with qpos = q_offset + i, kpos = k_offset + j; only
//          d = q_offset - k_offset enters it, so the kernel takes d as its
//          q offset against local kv rows.  d < 0 (the block lies after
//          the q rows) gives an empty kv range under causality.
// A CTA loads its rows of the carry before its kv loop and stores them
// after it, so a CTA that visits no kv tile copies its rows through
// unchanged.  A wholly masked tile leaves the state bit for bit (alpha =
// exp(0) = 1, p = 0), which is why skipping it is exact; a fully masked
// row keeps m = -1e30, l = 0, acc = 0.  The carry may be updated in place
// (in == out): a CTA reads only the rows it writes.
//
// The bf16 forward and carry step: one kernel on the tensor cores
// (flash_fwd_wgmma_kernel<HD, kCarry>, FlashAttention-3's shape).  Bound on
// this card, by operations: the forward at the training shape (B=2,
// S=1024, H=32, KV=8, hd=128, causal) does 17.2 GFLOP of unmasked QK^T and
// PV and moves 42 MB (0.017 ms at 989 TFLOP/s); the carry step at ring
// attention's prefill call (B=1, S=8192, same heads, causal) does 5.5e11
// flop and moves 0.37 GB, the f32 carry in and out (0.56 ms).
//   * one CTA of 384 threads per (b, h, 128 query rows), heaviest query
//     tiles first under causality; warpgroup 0 is the producer (one
//     thread issues every load, setmaxnreg lowers its registers), and
//     consumer warpgroups 1 and 2 own 64 query rows each;
//   * loads by TMA from 4-D tensor maps over [B, S, heads, hd], built on
//     the host at each launch (cuTensorMapEncodeTiled through the runtime,
//     no -lcuda): boxes of 128 rows x 64 hd columns, 128-byte swizzled,
//     rows past S read as zeros (and are masked).  Q is loaded once; K and
//     V go through a ring of 2 stages with full and empty mbarriers.  At
//     hd 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB of shared memory.
//     TMA needs 16-byte aligned bases: the launcher refuses others;
//   * S = Q K^T by wgmma m64n128k16, both operands in shared memory
//     (K-major, the descriptors' 128-byte swizzle matching TMA's);
//     acc += P V by wgmma with P in registers (the f32 accumulator layout
//     of S is the register A layout of P) and V MN-major in shared memory;
//   * P V runs as two bf16 products, acc += P_hi V + P_lo V, P_hi = bf16(p),
//     P_lo = bf16(p - P_hi).  The reference computes P V in f32
//     (src/repro/kernels/flash_attention.py:64, :88-90).  Modelled on one
//     causal carry step (bf16 q, k, v, hd 128): p rounded to bf16 puts acc
//     off by 1.6e-3 of its largest magnitude, 16x the carry's tolerance
//     (1e-4); the split puts it off by 2.5e-6.  It costs 1.5x the tensor
//     work of the algorithm; the bounds count the algorithm's;
//   * the online softmax in registers, row statistics over the 4 threads
//     of a row (shuffles), exp2 of log2e-scaled logits with m kept in
//     natural-log units; the mask runs only on tiles that reach Skv or
//     cross the diagonal or the window's edge, and tiles that causality
//     or the window masks entirely are never visited;
//   * the two consumers take turns on the tensor cores (named barriers):
//     a turn is P V of the previous tile, then S of this one, and one
//     consumer's softmax overlaps the other's turn.  ptxas holds every
//     thread of a 384-thread CTA to 168 registers, so P V completes
//     before S starts: acc (64) with S (64) or with P (64) fits, all three
//     would spill;
//   * the forward's epilogue divides, acc / max(l, 1e-30), and writes
//     lse = m + log(l): at an empty carry the carry step, finalized in
//     torch (finalize_partials), gives the forward's output bit for bit,
//     which makes the one-rank ring prefill equal the megatron one;
//   * at hd 192 the kernel of its own below.
//
// At hd 192 (nemotron-4-340b: 96/8 heads) the bf16 forward and carry step
// are flash_fwd_wgmma_skip_kernel<192, kCarry>: the kernel above at 64 kv
// rows a stage (kSkN; 128 rows of K and V beside Q would take 240 KB,
// over the 227 KB a CTA may have, so S = Q K^T is m64n64k16 and P V
// m64n192k16 over three 64-column boxes of V), Q 48 KB + 2 x (K 24 KB + V
// 24 KB), a consumer holding acc (96 registers) with S (32) or P's hi and
// lo (32) within the 168 ptxas gives a thread of 384.  Bound on this card,
// by operations: 0.6255 ms at nemotron's call (1 x 4096, causal); the
// hi/lo P V makes its tensor work 9.57e11 flop, 0.967 ms at 989 TFLOP/s.
// Where a kv tile's time went in that kernel (scripts/flash192_fwd_phases.py,
// cycles a warp-tile): P V 920 and S 493 against 768 and 384 at the rated
// rate, the softmax 990 hidden behind the other consumer's turn (turn
// waits 240): the tensor cores are busy ~97% of the loop at ~81% of their
// rate, the two products paced by their shared-memory operand reads; and
// 12% of a CTA before its first S (6,100 cycles) and in its forward
// epilogue (8,100: 96 IEEE divisions a thread and scattered stores).  Two
// changes pay:
//   * the rescale of a row's acc is skipped where that row's alpha is
//     exactly 1 in every lane of the warp (online_softmax_skip: a warp
//     vote on the computed alpha; x * 1.0f == x, so no bit changes); 40%
//     of the warp-tiles at nemotron's call keep every alpha at 1;
//   * the forward's epilogue: each quotient acc / l correctly rounded from
//     one reciprocal a row (y = RN(1 / l), q = RN(acc y), then RN(q + (acc
//     - l q) y) = RN(acc / l), Markstein's correction, exact away from
//     underflow, so the forward still equals the finalized empty carry bit
//     for bit), staged in the warpgroup's rows of the Q tile (free once its
//     last S has completed) in the load's 128-byte swizzle and stored by
//     three TMA stores.
// Built, measured and dropped (slower in turns against this kernel's
// parent; PERF.md §6): 256 threads with no producer warpgroup and the next
// tile's S issued behind this tile's softmax (a wgmma's issue waits for the
// tensor cores, so the softmax overlapped little, and the lane that issued
// the loads held its warpgroup ~800 cycles a tile); Q in registers (S from
// registers: 168 registers at 384 threads spill it, and at 256 the
// register-A m64n64 products ran slower); persistent CTAs over the units
// with the next unit's Q loaded into a second buffer.
//
// The bf16 backward and block backward: one kernel on the tensor cores
// (flash_bwd_wgmma_kernel<HD, kBlock>).  Bound on this card, by
// operations: at the training shape the backward does 10 flop per
// unmasked (pair, hd), 43 GFLOP (0.0435 ms at 989 TFLOP/s).
//   * one CTA of 256 threads per (b, h, 128 kv rows), lowest kv tile (the
//     most query rows under causality) first; warpgroup c owns kv rows
//     64 c.. and loops over the 64-row query tiles that see the CTA's kv
//     rows.  No producer warp: ptxas held the first version's 288
//     threads to 168 registers, as it holds 384 (9 warps put 3 on one
//     quarter of the SM's register file: 65,536 / 4 / 3 / 32 = 170), and
//     it spilled 2.4 KB; at 8 warps a thread may have 255, which dK and
//     dV (128 registers at hd 128) beside S^T and dP^T (64) need;
//   * thread 0 issues every TMA load: K and V once; then, through 2
//     stages of full and empty mbarriers, Q and dO of each query tile and
//     that tile's lse (times log2 e) and dsum by 1-D bulk copies from a
//     [B, H, 2, Sq padded to 64] f32 statistics array that a short pass
//     (flash_bwd_stats_kernel) writes first, computing dsum = sum(dout *
//     out) for the flash backward and taking the caller's for the block
//     backward (read from [B, Sq, H] in the loop, the statistics cost
//     more than the tensor cores' S^T and dP^T);
//   * S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 from shared memory
//     (exact in f32: bf16 products); P = exp(S scale - lse) and dS = P (dP
//     - dsum) scale in f32 registers, masked pairs exactly 0 (tiles that
//     reach Sq or Skv, cross the diagonal or the window's edge only);
//   * dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T as the
//     register A operand (the accumulator layout of S^T is the A layout),
//     dO and Q MN-major; dQ += dS K by wgmma from dS written to shared
//     memory in the swizzled K-major layout, K MN-major: at hd 128
//     warpgroup c takes hd columns 64 c.. over both warpgroups' dS (a
//     barrier of both), at hd 64 each its own kv rows;
//   * the reference multiplies P and dS in f32, so every product with
//     one of them as an operand runs as two bf16 products, x_hi = bf16(x)
//     and x_lo = bf16(x - x_hi) (x to about 2^-17; one rounding would put
//     the outputs some 1e-3 of their magnitude off): 16 tensor flop per
//     (pair, hd) against the algorithm's 10; the bounds count the
//     algorithm's;
//   * dQ is added into an f32 workspace, dK and dV too when G > 1 (G CTAs
//     share a kv head), each staged in shared memory (rows padded to keep
//     the stores free of bank conflicts) and added by 1-D bulk reduce-adds
//     (cp.reduce.async.bulk .add.f32), one per row, which timed faster on
//     the card than float2 or float4 atomics from registers.  At G = 1 dK
//     and dV are written directly.  The flash backward then turns the
//     workspaces into bf16 (to_bf16_kernel); the block backward's outputs
//     are the f32 workspaces.  The reduce-adds sum in an order that
//     changes from run to run, so the backward is not bit for bit
//     repeatable.
//
// At hd 192 the backward is flash_bwd_wgmma_pair_kernel<192, kBlock>.  A
// CTA holds 64 kv rows (dK and dV of 128 rows, 192 registers a thread,
// would not fit beside S^T and dP^T).  Bound on this card, by operations:
// at nemotron-4-340b's call (1 x 4096, 96/8 heads, causal) 1.56 ms (10
// flop per unmasked pair and hd at 989 TFLOP/s; the hi/lo products make
// the tensor work 16, 2.5 ms).  Measured (scripts/flash192_bwd_turns.py,
// H100 80GB HBM3): the first hd-192 kernel's time a head was flat from 12
// to 48 heads and rose 35% at 96, where its launch order (heads fastest)
// spread the resident CTAs over every head's Q, dO and dQ (~600 MB against
// the 50 MB L2); the rest was its serial CTA.  The design:
//   * clusters of two CTAs (__cluster_dims__) on adjacent 64-row kv tiles
//     of one (b, h): each query tile's Q and lse (CTA 0) and dO and dsum
//     (CTA 1) are multicast into both CTAs, so one load serves 128 kv
//     rows; 2 stages, a stage's empty barrier counting the warps of both
//     CTAs.  Both CTAs step through the union of their query tiles and
//     compute only on their own: under causality the upper CTA skips the
//     first, with a window the lower one the last, and a pair whose upper
//     tile lies past Skv has an upper CTA with no rows that only loads;
//   * 5-D tensor maps ({column block, row, block, head, batch}) move a
//     whole 24 KB tile in one TMA instruction; lane 0 of warp 3 of
//     warpgroup 0 issues the tile, that of warpgroup 1 the statistics and
//     the stage's expected bytes, as soon as both CTAs free the stage
//     (try_wait; blocking only for the tile the CTA needs next);
//   * both warpgroups busy: each computes S^T and dP^T for 32 of the 64
//     query columns (m64n32k16, 12 k-steps, both operands in shared
//     memory), forms its own P and dS, and writes P^T and dS^T (hi, lo)
//     into 128-byte-swizzled [64 kv][64 q] tiles; then warpgroup 0 runs
//     dK += dS^T Q and warpgroup 1 dV += P^T dO (m64n192k16, A from those
//     tiles K-major), releasing the stage once they have read it
//     (wgmma_wait<1>), and each dQ += dS K over 96 hd columns as one
//     m64n96k16 a k-step (A = the dS^T tile read MN-major, B = K
//     MN-major: K is loaded in 32-column blocks with the 64-byte swizzle,
//     so column 96 starts a block and A is read once a k-step).  Two CTA
//     barriers a tile;
//   * each warpgroup stages its dQ partial as three swizzled 32-column
//     f32 blocks and adds it to the f32 dq with one tensor-map
//     reduce-add; dK and dV (G > 1) leave the same way, one reduce-add a
//     warpgroup.  Not the pair's partials summed in one CTA first: over
//     distributed shared memory that put ~5,500 cycles of cross-CTA
//     waiting on every tile; nor f32 vector atomics from registers (1.2x
//     slower);
//   * the launch order keeps the resident clusters' Q, dO and dQ in L2:
//     (b, h) units in chunks of at most kL2Chunk (32 MB) of Q + dO + dQ
//     (at 1 x 4096, 5 heads; a small call is one chunk), chunks one after
//     another with h slowest, and within a chunk the kv pairs lowest
//     (heaviest under causality) first over the chunk's units, so the
//     tail stays short;
//   * shared memory: K and V 2 x 24 KB, Q and dO 2 stages x 2 x 24 KB,
//     P^T and dS^T 32 KB, the statistics 1 KB, the dQ staging 48 KB:
//     231,464 B with the barriers and the alignment.  dK or dV (96
//     registers) beside the dQ partial (48): 226 registers, no spill.
//   What bounds it: ~7,400 cycles a tile (before the m64n96 dQ), 78% in
//   the three product phases, whose pace follows their shared-memory
//   operand reads (~350 KB a tile).  Slower when measured: the next
//   tile's S^T and dP^T issued behind this tile's products (1.1-1.3x),
//   S^T and dP^T as m64n64 on one warpgroup each with halves traded
//   through shared memory (spills, 1.2x).
//
// The f32 forward and carry step and the f32 backward are SIMT kernels
// (simple and correct first; f32 FMAs, no tensor cores: TF32 would round
// the reference's f32 products).  They are kept as the f32 oracle path of
// the parity runs:
//   * the Pallas grid's sequential kv dimension (scratch carried across
//     ki) becomes a loop inside the CTA; fully masked kv tiles are never
//     visited; ragged Sq and Skv are masked in the kernel;
//   * every tile product is a 64-row block product in shared memory:
//     256 threads as 16 x 16, each owning 4 rows x (N/16) columns of the
//     result in registers, with float4 reads (A row-major along the
//     reduction, B with the output columns contiguous).  Tiles are staged
//     as f32 (120 to 189 kB: dynamic shared memory above 48 KB);
//   * forward: one CTA per (b, h, 64 query rows); online softmax with
//     (m, l) and the output accumulator in registers, row statistics
//     reduced across the 16 threads of a row with warp shuffles;
//   * backward, deterministic and without atomics: a pre-pass computes
//     dsum (the block backward takes the caller's); one launch for dK/dV
//     with one CTA per (b, kv head, 64 kv rows) looping over its G query
//     heads and the query tiles that see it; one launch for dQ with one
//     CTA per (b, h, 64 query rows) looping over the kv tiles it sees.
//
// At hd 192 the SIMT backward's tiles would take 240,128 B (dK/dV) and
// 272,896 B (dQ) of shared memory, over the 232,448 a CTA may have: there
// P^T and dS^T take turns in one buffer, and so do K^T and V^T (for S and
// dP) and K (for dS K), 222,720 B each (the tiles stay 64 rows; a tile
// takes one or two more barriers).  At hd 16, 64 and 128, which fit, each
// has its own buffer, as before hd 192 was built (`dkdv_p_turns`,
// `dq_k_turns`).
//
// Head dims: the tensor-core kernels take hd 64, 128 and 192 (their TMA
// boxes are 64 hd columns wide); the SIMT kernels take 16, 64, 128 and
// 192.  Every dispatch on the head dim names the ones it was built for
// and refuses any other with cudaErrorInvalidValue.  At hd 16 (the
// reduced configs) both types run the SIMT kernels: bf16 inputs are
// staged as f32 and the outputs rounded once, as the tensor-core path
// rounds its f32 accumulators.  A product whose output columns span hd
// runs over a 64-column tile (HP = max(hd, 64)): the row-major tiles are
// zero-padded to 64 columns and columns past hd are never stored; the
// products over hd (Q K^T, dO V^T) read hd columns only.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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
  return __float2bfloat16_rn(x);
}

// Width of a tile whose output columns span hd: 64-column tiles at hd 16.
template <int HD>
__host__ __device__ constexpr int padded_hd() { return HD < 64 ? 64 : HD; }

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
// heads * HD, head `head`) into shared memory as f32; rows past `rows`
// and columns [HD, W) are zeros.  Row-major: dst[r * ld + d].
// Transposed: dst[d * ld + r].
template <typename T, int HD, bool kTransposed, int W = HD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int rows, int heads,
                                          int head) {
  const int64_t stride = (int64_t)heads * HD;
  for (int i = threadIdx.x; i < kTile * W; i += kThreads) {
    const int r = i / W;
    const int d = i - r * W;
    const int row = row0 + r;
    float x = 0.f;
    if (row < rows && d < HD)
      x = to_f32(src[(int64_t)row * stride + head * HD + d]);
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
// Forward and carry step: the online-softmax state, and the f32 (SIMT)
// kernel
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
  constexpr int HP = padded_hd<HD>();
  constexpr int NC = HP / 16;
  constexpr int kLdHd = HP + 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [64][HP+4]
  float* kt = qs + kTile * kLdHd;               // [HD][64+4]  K transposed
  float* vs = kt + HD * kLd64;                  // [64][HP+4]
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
        if (HP == HD || col_of(c, tx) < HD)
          acc[r][c] = carry.acc_in[row * HD + col_of(c, tx)];
    }
  }

  int lo, hi;
  kv_range(q_offset + q0, q_offset + min(q0 + kTile, sq) - 1, skv, causal,
           window, &lo, &hi);
  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
    __syncthreads();  // the previous tile's kt, vs, ps are consumed
    load_tile<T, HD, true>(kt, kLd64, kb, k0, skv, n_kv, kvh);
    load_tile<T, HD, false, HP>(vs, kLdHd, vb, k0, skv, n_kv, kvh);
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
        if (HP == HD || col_of(c, tx) < HD)
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
      if (HP == HD || col_of(c, tx) < HD)
        ob[col_of(c, tx)] = from_f32<T>(acc[r][c] / l_safe);
    if (tx == 0)
      lse[((int64_t)b * sq + i) * n_heads + h] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Forward and carry step in bf16 on the tensor cores (TMA, wgmma, warp
// specialisation); see the note at the head of the file
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kM = 128;               // query rows of a CTA, 64 per consumer
constexpr int kStages = 2;
constexpr int kBox = 128 * 128;       // bytes of one TMA box: 128 rows x 64
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kMinusInfBits = 0xff800000u;   // -inf in f32
constexpr int kEmptyArrivals = 8;     // one lane of each consumer warp

// kv rows of a stage (at hd 192 flash_fwd_wgmma_skip_kernel stages kSkN)
constexpr int kFwdN = 128;

// Byte offsets in the 1024-aligned dynamic shared memory.
template <int HD>
struct Smem {
  static constexpr int kN = kFwdN;
  static constexpr int kKvBox = kN * 128;             // a K or V box
  static constexpr int kQTile = HD / 64 * kBox;       // the Q tile
  static constexpr int kKvTile = HD / 64 * kKvBox;    // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBar = kV + kStages * kKvTile;
  // q_full, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the opt-in shared memory");
};

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

// Named barriers 1 and 2 order the two consumers' turns on the tensor
// cores: one consumer waits on its own (bar.sync), the other arrives.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One box of a [B, S, heads, hd] tensor map: hd columns [c0, c0 + 64) of
// rows [row, row + 128) of head `head` of batch `b`; rows past S read 0.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(head),
      "r"(row), "r"(b)
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
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B, m64n128k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d = A B, m64n128k16 (d written, not read), operands as wgmma_ss_n128.
__device__ __forceinline__ void wgmma_ss_n128_init(float (&d)[64], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A B, m64n128k16, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#define FA_D8(C, i)                                                        \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define FA_RW(x) "+f"(x)
#define FA_WO(x) "=f"(x)

// d += A B, m64n192k16, A from registers, B from shared memory MN-major
// (three 64-column boxes, the leading byte offset apart).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : FA_D8(FA_RW, 0), FA_D8(FA_RW, 8), FA_D8(FA_RW, 16),
        FA_D8(FA_RW, 24), FA_D8(FA_RW, 32), FA_D8(FA_RW, 40),
        FA_D8(FA_RW, 48), FA_D8(FA_RW, 56), FA_D8(FA_RW, 64),
        FA_D8(FA_RW, 72), FA_D8(FA_RW, 80), FA_D8(FA_RW, 88)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

#define FA_N64_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}, "

// d (+)= A B, m64n64k16, A K-major and B K-major (TB = 0) or MN-major
// (TB = 1), both from shared memory.  kInit writes d without reading it.
template <int TB, bool kInit>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (kInit)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_N64_REGS
        "%32, %33, p, 1, 1, 0, %34;\n}\n"
        : FA_D8(FA_WO, 0), FA_D8(FA_WO, 8), FA_D8(FA_WO, 16),
          FA_D8(FA_WO, 24)
        : "l"(da), "l"(db), "n"(TB), "r"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %35, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_N64_REGS
        "%32, %33, p, 1, 1, 0, %34;\n}\n"
        : FA_D8(FA_RW, 0), FA_D8(FA_RW, 8), FA_D8(FA_RW, 16),
          FA_D8(FA_RW, 24)
        : "l"(da), "l"(db), "n"(TB), "r"(1));
}

#undef FA_N64_REGS
#undef FA_WO
#undef FA_RW
#undef FA_D8


// acc += A B over the k-steps of 16 rows of B: A in the register
// fragments `a` (4 per k-step), B MN-major at `b` (row r of a box at b +
// 128 r; hd columns 64.. one box, `box` bytes, further on), N = HD.  The
// forward's P V (B = a V tile) and the backward's P^T dO and dS^T Q (B =
// a dO or Q tile).
template <int HD, int kSteps>
__device__ __forceinline__ void rs_mma(float (&acc)[HD / 2],
                                       const uint32_t (&a)[4 * kSteps],
                                       uint32_t b, int box) {
  static_assert(HD == 64 || HD == 128 || HD == 192,
                "the tensor-core kernels take hd 64, 128 and 192");
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const uint64_t d = desc(b + kk * 16 * 128, box, 1024);
    if constexpr (HD == 192)
      wgmma_rs_n192(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                    a[4 * kk + 3], d);
    else if constexpr (HD == 128)
      wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                    a[4 * kk + 3], d);
    else
      wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                   a[4 * kk + 3], d);
  }
}

// The online-softmax update of one consumer thread's two rows (qpos and
// qpos + 8) over a tile of N scores s in the m64nN accumulator layout:
// s[4 j + 2 r + e] is row r, kv column kpos + 8 j + e.  Masked scores
// become -inf, so their p is exactly 0 and they never raise the max; m
// stays in natural-log units; lp is this thread's share of l (its N / 4
// columns), summed over the quad only at the end.  p leaves as the A
// fragments of P V, P = P_hi + P_lo in bf16 (p to about 2^-17): the
// accumulator layout of S is the register A layout of P, so the pair
// (s[2 x], s[2 x + 1]) becomes p_hi[x], p_lo[x].  acc is rescaled by
// exp(m_old - m_new).  Row by row, so S and P of a row hold registers
// together, never of the whole tile.
template <bool kMask, int HD, int N>
__device__ __forceinline__ void online_softmax(
    const float (&s)[N / 2], float (&m)[2], float (&lp)[2],
    float (&acc)[HD / 2], uint32_t (&p_hi)[N / 4], uint32_t (&p_lo)[N / 4],
    int qpos, int kpos, int skv, int causal, int window, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[N / 4];
    float mx = __uint_as_float(kMinusInfBits);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[2 * j + e] = s[4 * j + 2 * r + e];
        if (kMask && !visible(qpos + 8 * r, kpos + 8 * j + e, skv, causal,
                              window))
          x[2 * j + e] = __uint_as_float(kMinusInfBits);
        mx = fmaxf(mx, x[2 * j + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // max(s) * scale == max(s * scale): rounding is monotonic, scale > 0
    const float m_new = fmaxf(m[r], mx * scale);
    const float alpha = exp2_approx((m[r] - m_new) * kLog2e);
    const float ms = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float p0 = exp2_approx(fmaf(x[2 * j], sl, -ms));
      const float p1 = exp2_approx(fmaf(x[2 * j + 1], sl, -ms));
      sum += p0 + p1;
      const uint32_t hi = bf16x2(p0, p1);
      p_hi[2 * j + r] = hi;
      p_lo[2 * j + r] = bf16x2(p0 - __uint_as_float(hi << 16),
                               p1 - __uint_as_float(hi & 0xffff0000u));
    }
    lp[r] = alpha * lp[r] + sum;
    m[r] = m_new;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j + 2 * r] *= alpha;
      acc[4 * j + 2 * r + 1] *= alpha;
    }
  }
}

// kCarry = false: the forward (state initialised, out and lse written).
// kCarry = true: one carry step (state from `carry`, stored back there).
// One CTA per (b, h, 128 query rows), heaviest first under causality.
template <int HD, bool kCarry>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, Carry carry, int batch,
                       int sq, int skv, int n_heads, int n_kv, int q_offset,
                       int window, int causal, float scale) {
  using L = Smem<HD>;
  constexpr int kN = L::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128B swizzle atoms
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;             // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_qt = (sq + kM - 1) / kM;
  int idx = blockIdx.x;
  const int h = idx % n_heads;
  idx /= n_heads;
  const int b = idx % batch;
  idx /= batch;
  const int q0 = (causal ? n_qt - 1 - idx : idx) * kM;
  const int kvh = h / (n_heads / n_kv);

  int lo, hi;
  kv_range(q_offset + q0, q_offset + min(q0 + kM, sq) - 1, skv, causal,
           window, &lo, &hi);
  const int t0 = lo / kN;
  const int n_tiles = hi > lo ? (hi + kN - 1) / kN - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kEmptyArrivals);
      mbar_init(v_empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0 || n_tiles == 0) return;
    mbar_expect_tx(q_full, L::kQTile);
#pragma unroll
    for (int x = 0; x < HD / 64; ++x)
      tma_load(base + L::kQ + x * kBox, &tm_q, q_full, 64 * x, h, q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int par = (i / kStages) & 1;
      const int row = (t0 + i) * kN;
      mbar_wait(k_empty + 8 * st, par ^ 1);
      mbar_expect_tx(k_full + 8 * st, L::kKvTile);
#pragma unroll
      for (int x = 0; x < HD / 64; ++x)
        tma_load(base + L::kK + st * L::kKvTile + x * L::kKvBox, &tm_k,
                 k_full + 8 * st, 64 * x, kvh, row, b);
      mbar_wait(v_empty + 8 * st, par ^ 1);
      mbar_expect_tx(v_full + 8 * st, L::kKvTile);
#pragma unroll
      for (int x = 0; x < HD / 64; ++x)
        tma_load(base + L::kV + st * L::kKvTile + x * L::kKvBox, &tm_v,
                 v_full + 8 * st, 64 * x, kvh, row, b);
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = q0 + 64 * c + 16 * (tw >> 5) + g;   // and row0 + 8
  const bool elected = lane == 0;

  // acc[4 j + 2 r + e]: row row0 + 8 r, hd column 8 j + 2 tq + e
  float m[2] = {kNegInf, kNegInf}, lp[2] = {0.f, 0.f}, acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  if (kCarry) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= sq) continue;
      const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
      m[r] = carry.m_in[row];
      lp[r] = tq == 0 ? carry.l_in[row] : 0.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(
            carry.acc_in + row * HD + 8 * j + 2 * tq);
        acc[4 * j + 2 * r] = a.x;
        acc[4 * j + 2 * r + 1] = a.y;
      }
    }
  }

  if (n_tiles > 0) {
    // A consumer's turn on the tensor cores is P V of the previous tile,
    // then S = Q K^T of this one; its softmax then overlaps the other
    // consumer's turn.  P V completes before S starts, so P and S never
    // hold registers together: acc + S or acc + P fit the 168 registers
    // a thread of a 384-thread CTA may have.
    const int mine = 1 + c, other = 2 - c;
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;
    const uint32_t k_tiles = base + L::kK, v_tiles = base + L::kV;
    float s[kN / 2];
    uint32_t p_hi[kN / 4], p_lo[kN / 4];
    const int qpos = q_offset + row0;
    // a tile needs the mask where it reaches Skv, crosses the diagonal or
    // the window's edge for any of the CTA's 128 rows
    const int qmin = q_offset + q0, qmax = q_offset + q0 + kM - 1;
    mbar_wait(q_full, 0);
    if (c == 1) turn_pass(1);            // consumer 0 takes the first turn
    for (int i = 0; i <= n_tiles; ++i) {
      const int st = i % kStages;
      const int pst = (i + kStages - 1) % kStages;
      if (i < n_tiles) mbar_wait(k_full + 8 * st, (i / kStages) & 1);
      turn_wait(mine);
      if (i > 0) {                       // acc += P V of the previous tile
        mbar_wait(v_full + 8 * pst, ((i - 1) / kStages) & 1);
        pin(acc);
        pin(p_hi);
        pin(p_lo);
        wgmma_fence();
        const uint32_t vt = v_tiles + pst * L::kKvTile;
        rs_mma<HD, kN / 16>(acc, p_hi, vt, L::kKvBox);
        rs_mma<HD, kN / 16>(acc, p_lo, vt, L::kKvBox);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        __syncwarp();
        if (elected) mbar_arrive(v_empty + 8 * pst);
      }
      if (i == n_tiles) {                // the last turn: no S to compute
        if (c == 0) turn_pass(other);
        break;
      }
      wgmma_fence();                     // S = Q K^T of this tile
      const uint32_t kt = k_tiles + st * L::kKvTile;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da =
            desc(q_rows + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            desc(kt + (kk / 4) * L::kKvBox + (kk % 4) * 32, 16, 1024);
        if constexpr (kN == 128) {
          if (kk == 0)
            wgmma_ss_n128_init(s, da, db);
          else
            wgmma_ss_n128(s, da, db);
        } else {
          if (kk == 0)
            wgmma_ss_n64<0, true>(s, da, db);
          else
            wgmma_ss_n64<0, false>(s, da, db);
        }
      }
      wgmma_commit();
      turn_pass(other);
      wgmma_wait<0>();
      pin(s);
      __syncwarp();
      if (elected) mbar_arrive(k_empty + 8 * st);

      const int k0 = (t0 + i) * kN;
      if (k0 + kN > skv || (causal && k0 + kN - 1 > qmin) ||
          (window > 0 && qmax - k0 >= window))
        online_softmax<true, HD, kN>(s, m, lp, acc, p_hi, p_lo, qpos,
                                 k0 + 2 * tq, skv, causal, window, scale);
      else
        online_softmax<false, HD, kN>(s, m, lp, acc, p_hi, p_lo, qpos,
                                  k0 + 2 * tq, skv, causal, window, scale);
    }
  }

  // ---- epilogue: l over the quad, then the rows below Sq ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lp[r] + __shfl_xor_sync(0xffffffffu, lp[r], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int i = row0 + 8 * r;
    if (i >= sq) continue;
    const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
    if (kCarry) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(carry.acc_out + row * HD + 8 * j +
                                   2 * tq) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (tq == 0) {
        carry.m_out[row] = m[r];
        carry.l_out[row] = l;
      }
      continue;
    }
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + row * HD + 8 * j + 2 * tq) =
          bf16x2(acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
    if (tq == 0) lse[row] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Backward in bf16 on the tensor cores; see the note at the head of the file
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;      // 2 warpgroups, no producer warp
constexpr int kBN = 128;              // kv rows of a CTA, 64 per warpgroup
constexpr int kBM = 64;               // query rows of a streamed tile
constexpr int kQBox = kBM * 128;      // bytes of one 64-row TMA box
constexpr int kBwdStages = 2;         // Q and dO tiles in flight
constexpr int kDqRow = 288;           // bytes of a staged dQ row: 256 + 32
constexpr int kBwdEmptyArrivals = 8;  // one lane of each warp

template <int HD>
struct BwdSmem {
  static constexpr int kKV = HD / 64 * kBox;    // a K or V tile (128 rows)
  static constexpr int kQT = HD / 64 * kQBox;   // a Q or dO tile (64 rows)
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;
  static constexpr int kDO = kQ + kBwdStages * kQT;
  // dS of each warpgroup, hi then lo: [64 q][64 kv] bf16, K-major, swizzled
  static constexpr int kDS = kDO + kBwdStages * kQT;
  // lse (times log2 e) then dsum of each stage's 64 rows, f32
  static constexpr int kStat = kDS + 4 * kQBox;
  // dQ of each warpgroup, 64 rows x 64 hd columns f32 (rows kDqRow apart)
  static constexpr int kDQ = kStat + kBwdStages * 2 * kBM * 4;
  static constexpr int kBar = kDQ + 2 * kBM * kDqRow;
  // kv_full, then full and empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
};

// 1-D bulk copies (TMA without a tensor map): a load that completes on an
// mbarrier, and a reduce-add of f32 from shared into global memory that
// completes in the issuing thread's bulk group.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The bulk group's reads of shared memory (read = true) or all of it done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Named barrier of both warpgroups (id 3).
__device__ __forceinline__ void cta_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Named barrier of one warpgroup (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// P^T and dS^T of one thread from S^T = K Q^T and dP^T = V dO^T
// in the m64n64 accumulator layout: x[4 j + 2 r + e] is kv row kv_row +
// 8 r, query column 8 j + 2 tq + e of the tile at q0.  P = exp(S scale -
// lse), masked pairs exactly 0; dS = P (dP - dsum) scale.  Both leave as
// bf16 hi/lo pairs (x to about 2^-17) in the register A layout of the
// next products: pair (x[2 n], x[2 n + 1]) becomes hi[n], lo[n].
template <bool kMask>
__device__ __forceinline__ void bwd_probs(
    float (&s)[32], float (&dp)[32], const float (&lse_r)[16],
    const float (&dsum_r)[16], uint32_t (&p_hi)[16], uint32_t (&p_lo)[16],
    uint32_t (&ds_hi)[16], uint32_t (&ds_lo)[16], int q0, int kv_row, int tq,
    int sq, int skv, int q_offset, int window, int causal, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * j + 2 * r + e;
        const float l = lse_r[2 * j + e];   // already times log2(e)
        const float dd = dsum_r[2 * j + e];
        float p = exp2_approx(fmaf(s[n], sl, -l));
        if (kMask) {
          const int qi = q0 + 8 * j + 2 * tq + e;
          if (qi >= sq ||
              !visible(q_offset + qi, kv_row + 8 * r, skv, causal, window))
            p = 0.f;
        }
        s[n] = p;
        dp[n] = p * (dp[n] - dd) * scale;
      }
  }
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    uint32_t hi = bf16x2(s[2 * n], s[2 * n + 1]);
    p_hi[n] = hi;
    p_lo[n] = bf16x2(s[2 * n] - __uint_as_float(hi << 16),
                     s[2 * n + 1] - __uint_as_float(hi & 0xffff0000u));
    hi = bf16x2(dp[2 * n], dp[2 * n + 1]);
    ds_hi[n] = hi;
    ds_lo[n] = bf16x2(dp[2 * n] - __uint_as_float(hi << 16),
                      dp[2 * n + 1] - __uint_as_float(hi & 0xffff0000u));
  }
}

// acc += A B over a 64-row q tile (4 k-steps), A = the register fragments
// `a`, B MN-major at `bt` (a Q or dO tile: row r of a box at bt + 128 r,
// hd columns 64.. one 64-row box further on).
template <int HD>
__device__ __forceinline__ void bwd_rs(float (&acc)[HD / 2],
                                       const uint32_t (&a)[16], uint32_t bt) {
  rs_mma<HD, kBM / 16>(acc, a, bt, kQBox);
}

// x = A B^T over hd (HD / 16 k-steps), A = 64 rows of a K or V tile at
// `a` (boxes `a_box` bytes apart: 128-row boxes, or 64-row ones at hd
// 192), B = a Q or dO tile at `bt` (64-row boxes), both K-major: S^T = K
// Q^T and dP^T = V dO^T.
template <int HD>
__device__ __forceinline__ void bwd_ss_t(float (&x)[32], uint32_t a,
                                         uint32_t bt, int a_box = kBox) {
  wgmma_ss_n64<0, true>(x, desc(a, 16, 1024), desc(bt, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    wgmma_ss_n64<0, false>(
        x, desc(a + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
        desc(bt + (kk / 4) * kQBox + (kk % 4) * 32, 16, 1024));
}

// Write one warpgroup's dS (its 64 kv columns of the tile, hi or lo) into
// shared memory as the K-major A operand [64 q][64 kv] of dQ = dS K, in
// TMA's 128-byte swizzle: element (i, jj) at i * 128 + ((jj / 8) ^ (i %
// 8)) * 16 + (jj % 8) * 2.  x holds dS^T (kv row 16 w + g + 8 r, q column
// 8 j + 2 tq + e) as bf16 pairs over e.
__device__ __forceinline__ void store_ds(uint8_t* dst,
                                         const uint32_t (&x)[16], int w,
                                         int g, int tq) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int j = n / 2, r = n % 2;
    const int jj = 16 * w + g + 8 * r;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 8 * j + 2 * tq + e;
      const uint16_t v = e ? static_cast<uint16_t>(x[n] >> 16)
                           : static_cast<uint16_t>(x[n] & 0xffffu);
      *reinterpret_cast<uint16_t*>(dst + i * 128 +
                                   (((jj >> 3) ^ (i & 7)) << 4) +
                                   ((jj & 7) << 1)) = v;
    }
  }
}

// kBlock = false: the flash backward (dK, dV at G = 1 written in bf16).
// kBlock = true: ring attention's block backward (every output f32).
// dq is an f32 workspace that the CTAs add into; dk and dv are added into
// as f32 workspaces when G > 1, and written directly at G = 1.  stats is
// the statistics pass's [B, H, 2, sq_pad].  One CTA per (b, h, 128 kv
// rows), heaviest (lowest kv) first under causality.
template <int HD, bool kBlock>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ stats, int sq_pad,
                       float* __restrict__ dq, void* __restrict__ dk,
                       void* __restrict__ dv, int batch, int sq, int skv,
                       int n_heads, int n_kv, int q_offset, int window,
                       int causal, float scale) {
  static_assert(HD == 64 || HD == 128, "hd 192: the pair kernel");
  using L = BwdSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128B swizzle atoms
  uint8_t* const basep = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;              // + 8 * stage
  const uint32_t empty = full + 8 * kBwdStages;

  int idx = blockIdx.x;
  const int h = idx % n_heads;
  idx /= n_heads;
  const int b = idx % batch;
  idx /= batch;
  const int k0 = idx * kBN;
  const int groups = n_heads / n_kv;
  const int kvh = h / groups;

  // query rows that see kv rows [k0, kmax]
  const int kmax = min(k0 + kBN, skv) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(sq, kmax + window - q_offset) : sq;
  const int t0 = i_lo / kBM;
  const int n_qt = i_hi > i_lo ? (i_hi + kBM - 1) / kBM - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues every TMA load: K and V once, then the Q and dO tile
  // and the lse and dsum rows of query tile i into stage i % kBwdStages
  // once both warpgroups have released the tile that used the stage.
  const float* stat_bh = stats + ((int64_t)b * n_heads + h) * 2 * sq_pad;
  auto issue = [&](int i) {
    const int st = i % kBwdStages;
    mbar_wait(empty + 8 * st, ((i / kBwdStages) & 1) ^ 1);
    mbar_expect_tx(full + 8 * st, 2 * L::kQT + 2 * kBM * 4);
    const int q0 = (t0 + i) * kBM;
    const uint32_t stat = base + L::kStat + st * 2 * kBM * 4;
    bulk_load(stat, stat_bh + q0, kBM * 4, full + 8 * st);
    bulk_load(stat + kBM * 4, stat_bh + sq_pad + q0, kBM * 4, full + 8 * st);
#pragma unroll
    for (int x = 0; x < HD / 64; ++x) {
      tma_load(base + L::kQ + st * L::kQT + x * kQBox, &tm_q, full + 8 * st,
               64 * x, h, q0, b);
      tma_load(base + L::kDO + st * L::kQT + x * kQBox, &tm_do,
               full + 8 * st, 64 * x, h, q0, b);
    }
  };
  if (threadIdx.x == 0 && n_qt > 0) {
    mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
    for (int x = 0; x < HD / 64; ++x) {
      tma_load(base + L::kK + x * kBox, &tm_k, kv_full, 64 * x, kvh, k0, b);
      tma_load(base + L::kV + x * kBox, &tm_v, kv_full, 64 * x, kvh, k0, b);
    }
    for (int i = 0; i < min(n_qt, kBwdStages - 1); ++i) issue(i);
  }

  // ---- warpgroup c owns kv rows [k0 + 64 c, k0 + 64 c + 64) ----
  constexpr bool kShare = HD == 128;
  const int c = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int w = tw >> 5;
  const int lane = tw & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kc0 = k0 + 64 * c;
  const int kv_row = kc0 + 16 * w + g;              // and kv_row + 8
  const bool elected = lane == 0;

  // acc[4 j + 2 r + e]: kv row kv_row + 8 r, hd column 8 j + 2 tq + e
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_qt > 0) {
    const uint32_t k_rows = base + L::kK + c * 64 * 128;
    const uint32_t v_rows = base + L::kV + c * 64 * 128;
    const uint32_t ds_hi = base + L::kDS + c * 2 * kQBox;
    const uint32_t ds_lo = ds_hi + kQBox;
    uint8_t* const ds_hi_p = basep + L::kDS + c * 2 * kQBox;
    uint8_t* const ds_lo_p = ds_hi_p + kQBox;
    const uint32_t dq_st = base + L::kDQ + c * kBM * kDqRow;
    uint8_t* const dq_st_p = basep + L::kDQ + c * kBM * kDqRow;
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int st = i % kBwdStages;
      const int q0 = (t0 + i) * kBM;
      const uint32_t qt = base + L::kQ + st * L::kQT;
      const uint32_t dot = base + L::kDO + st * L::kQT;
      if (threadIdx.x == 0 && i + kBwdStages - 1 < n_qt)
        issue(i + kBwdStages - 1);
      __syncwarp();
      mbar_wait(full + 8 * st, (i / kBwdStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, exact in f32 (bf16 products)
      float s[32], dp[32];
      wgmma_fence();
      bwd_ss_t<HD>(s, k_rows, qt);
      bwd_ss_t<HD>(dp, v_rows, dot);
      wgmma_commit();
      // this thread's query columns' lse (times log2 e) and dsum
      float lse_r[16], dsum_r[16];
      const float* stat = reinterpret_cast<const float*>(
          basep + L::kStat + st * 2 * kBM * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(stat + 8 * j + 2 * tq);
        const float2 d2 =
            *reinterpret_cast<const float2*>(stat + kBM + 8 * j + 2 * tq);
        lse_r[2 * j] = l2.x;
        lse_r[2 * j + 1] = l2.y;
        dsum_r[2 * j] = d2.x;
        dsum_r[2 * j + 1] = d2.y;
      }
      wgmma_wait<0>();
      pin(s);
      pin(dp);

      uint32_t p_hi[16], p_lo[16], d_hi[16], d_lo[16];
      if (q0 + kBM > sq || kc0 + 64 > skv ||
          (causal && q_offset + q0 < kc0 + 63) ||
          (window > 0 && q_offset + q0 + kBM - 1 - kc0 >= window))
        bwd_probs<true>(s, dp, lse_r, dsum_r, p_hi, p_lo, d_hi, d_lo, q0,
                        kv_row, tq, sq, skv, q_offset, window, causal, scale);
      else
        bwd_probs<false>(s, dp, lse_r, dsum_r, p_hi, p_lo, d_hi, d_lo, q0,
                         kv_row, tq, sq, skv, q_offset, window, causal,
                         scale);

      // dS into shared memory for dQ, once the last tile's dQ has read it
      // (at hd 128 both warpgroups read both halves)
      kShare ? cta_sync() : wg_sync(1 + c);
      store_ds(ds_hi_p, d_hi, w, g, tq);
      store_ds(ds_lo_p, d_lo, w, g, tq);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      kShare ? cta_sync() : wg_sync(1 + c);

      // dV += P^T dO and dK += dS^T Q, each as hi + lo
      pin(dk_acc);
      pin(dv_acc);
      pin(p_hi);
      pin(p_lo);
      pin(d_hi);
      pin(d_lo);
      wgmma_fence();
      bwd_rs<HD>(dv_acc, p_hi, dot);
      bwd_rs<HD>(dv_acc, p_lo, dot);
      bwd_rs<HD>(dk_acc, d_hi, qt);
      bwd_rs<HD>(dk_acc, d_lo, qt);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dk_acc);
      pin(dv_acc);
      __syncwarp();
      if (elected) mbar_arrive(empty + 8 * st);

      // dQ += dS K, 64 hd columns at a time: A = dS (K-major), B = K
      // (MN-major).  At hd 128 warpgroup c takes hd columns 64 c.. over
      // all 128 kv rows; at hd 64 each takes its own 64 kv rows.
      for (int n = kShare ? c : 0; n < (kShare ? c + 1 : HD / 64); ++n) {
        float x[32];
        wgmma_fence();
        if constexpr (kShare) {
          const uint32_t kb = base + L::kK + n * kBox;
          const uint32_t ds = base + L::kDS;      // box i: kv rows 64 i..
          wgmma_ss_n64<1, true>(x, desc(ds, 16, 1024), desc(kb, kBox, 1024));
#pragma unroll
          for (int kk = 1; kk < 16; ++kk) {
            const int t = kk % 8;                  // k-step; kk / 8: lo
            const uint32_t a =
                ds + (t / 4) * 2 * kQBox + (kk / 8) * kQBox + (t % 4) * 32;
            wgmma_ss_n64<1, false>(x, desc(a, 16, 1024),
                                   desc(kb + t * 16 * 128, kBox, 1024));
          }
        } else {
          const uint32_t kb = k_rows + n * kBox;
          wgmma_ss_n64<1, true>(x, desc(ds_hi, 16, 1024),
                                desc(kb, kBox, 1024));
#pragma unroll
          for (int kk = 1; kk < 4; ++kk)
            wgmma_ss_n64<1, false>(x, desc(ds_hi + kk * 32, 16, 1024),
                                   desc(kb + kk * 16 * 128, kBox, 1024));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64<1, false>(x, desc(ds_lo + kk * 32, 16, 1024),
                                   desc(kb + kk * 16 * 128, kBox, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(x);
        // x[4 j + 2 r + e]: q row 16 w + g + 8 r of the tile, hd column
        // 64 n + 8 j + 2 tq + e.  Staged in shared memory once the last
        // bulk reduce has read it, then one bulk reduce-add per row.
        if (tw < kBM) bulk_wait<true>();
        wg_sync(1 + c);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<float2*>(dq_st_p +
                                       (16 * w + g + 8 * r) * kDqRow +
                                       (8 * j + 2 * tq) * 4) =
                make_float2(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(1 + c);
        if (tw < kBM && q0 + tw < sq) {
          bulk_reduce_add(
              dq + (((int64_t)b * sq + q0 + tw) * n_heads + h) * HD + 64 * n,
              dq_st + tw * kDqRow, 64 * 4);
          bulk_commit();
        }
      }
    }
  }

  // ---- epilogue: this warpgroup's kv rows of dK and dV ----
  if (tw < kBM) bulk_wait<false>();
  if (groups > 1) {
    // G CTAs share the kv head: stage dK and dV in the shared memory the
    // loop is done with (below the barriers, rows kKvRow bytes apart),
    // then one bulk reduce-add per row of each
    if (n_qt == 0) return;
    constexpr int kKvRow = HD * 4 + 32;
    static_assert(4 * kBM * kKvRow <= L::kBar, "dK, dV staging too large");
    cta_sync();
    uint8_t* const st_k = basep + c * 2 * kBM * kKvRow;
    uint8_t* const st_v = st_k + kBM * kKvRow;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int at = (16 * w + g + 8 * r) * kKvRow + (8 * j + 2 * tq) * 4;
        *reinterpret_cast<float2*>(st_k + at) =
            make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(st_v + at) =
            make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + c);
    if (tw < kBM && kc0 + tw < skv) {
      const int64_t off = (((int64_t)b * skv + kc0 + tw) * n_kv + kvh) * HD;
      const uint32_t src = base + c * 2 * kBM * kKvRow + tw * kKvRow;
      bulk_reduce_add(static_cast<float*>(dk) + off, src, HD * 4);
      bulk_reduce_add(static_cast<float*>(dv) + off, src + kBM * kKvRow,
                      HD * 4);
      bulk_commit();
      bulk_wait<false>();
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv_row + 8 * r;
    if (row >= skv) continue;
    const int64_t off = (((int64_t)b * skv + row) * n_kv + kvh) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float k_0 = dk_acc[4 * j + 2 * r], k_1 = dk_acc[4 * j + 2 * r + 1];
      const float v_0 = dv_acc[4 * j + 2 * r], v_1 = dv_acc[4 * j + 2 * r + 1];
      if (kBlock) {
        *reinterpret_cast<float2*>(static_cast<float*>(dk) + off + 8 * j) =
            make_float2(k_0, k_1);
        *reinterpret_cast<float2*>(static_cast<float*>(dv) + off + 8 * j) =
            make_float2(v_0, v_1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dk) + off +
                                     8 * j) = bf16x2(k_0, k_1);
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dv) + off +
                                     8 * j) = bf16x2(v_0, v_1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward and block backward at hd 192 (see the note at the head
// of the file): clusters of two CTAs on adjacent 64-row kv tiles that share
// every Q, dO and statistics tile and one dQ reduce-add a row
// ---------------------------------------------------------------------------

constexpr int kPairN = 64;            // kv rows of a CTA
constexpr int kPair = 2;              // CTAs of a cluster
constexpr int kHalf = 96;             // hd columns of dQ a warpgroup holds
constexpr int kDqBox = 32;            // f32 columns of a reduce block (128 B)
// K's 32-column blocks (64-byte swizzle, so dQ's 96 columns start on one)
constexpr int kK64Block = kPairN * 64;
constexpr int kPairEmptyArrivals = 16;  // one lane of each warp of both CTAs
// Q and dO (bf16) and dQ (f32) of the (batch row, head) units a chunk of
// the launch order interleaves: chunks of heads come one after another, so
// what the resident clusters re-read stays in the card's 50 MB L2
constexpr int64_t kL2Chunk = 32ll << 20;

template <int HD>
struct PairSmem {
  static_assert(HD == 192, "the pair kernel is built for hd 192");
  static constexpr int kT = HD / 64 * kQBox;    // a 64-row K, V, Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kT;
  static constexpr int kQ = kV + kT;
  static constexpr int kDO = kQ + kBwdStages * kT;
  // P^T then dS^T, each hi and lo: [64 kv][64 q] bf16, K-major, swizzled
  static constexpr int kPT = kDO + kBwdStages * kT;
  static constexpr int kDST = kPT + 2 * kQBox;
  // lse (times log2 e) then dsum of each stage's 64 rows, f32
  static constexpr int kStat = kDST + 2 * kQBox;
  // each warpgroup's dQ partial as 3 boxes [64 q][32] f32, swizzled
  // (128 B) as its tensor-map reduce-adds read them
  static constexpr int kDQ = kStat + kBwdStages * 2 * kBM * 4;
  static constexpr int kBar = kDQ + 2 * (kHalf / kDqBox) * kBM * 128;
  // kv_full, then full and empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kBwdStages) + 1024;
  static_assert(kBytes <= 232448, "over the opt-in shared memory");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of `addr` (this CTA's) in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Every thread of both CTAs.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_peer(uint32_t cluster_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_bar)
      : "memory");
}

// Shared-memory matrix descriptor of a 64-byte-swizzled operand (as desc,
// 32-element rows of 64 bytes; 8-row groups 512 bytes apart).
__device__ __forceinline__ uint64_t desc64(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 | static_cast<uint64_t>(2) << 62;
}

// The pair kernel's tensor maps are 5-D, {swizzle-wide column block, row,
// block, head, batch}, so one instruction moves a whole tile of 64 rows,
// laid out block after block in shared memory: at hd 192 three 64-column
// blocks of bf16 (Q, dO, V; 128-byte swizzle), six 32-column ones (K;
// 64-byte swizzle), or three 32-column blocks of f32 (96 dQ columns).

// A tile into this CTA (K or V).
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %3, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(head), "r"(b)
      : "memory");
}

// A tile (Q or dO), or 1-D bytes (lse or dsum), into both CTAs of the
// cluster: the same offsets in each, completing on each CTA's barrier at
// `bar`'s offset.
__device__ __forceinline__ void tma_load5_pair(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int row,
                                               int head, int b) {
  const uint16_t both = 3;
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %3, %5, %6}], [%2], "
      "%7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row),
      "r"(head), "r"(b), "h"(both)
      : "memory");
}
__device__ __forceinline__ void bulk_load_pair(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  const uint16_t both = 3;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "h"(both)
      : "memory");
}

// A tile of f32 (blocks from `block`) added from shared memory into
// global memory, completing in the bulk group.
__device__ __forceinline__ void tma_reduce5(const CUtensorMap* map,
                                            uint32_t src, int row, int block,
                                            int head, int b) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.5d.global.shared::cta.add.tile.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(row), "r"(block), "r"(head), "r"(b)
      : "memory");
}

#define FP_D8(C, i)                                                        \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define FP_RW(x) "+f"(x)
#define FP_WO(x) "=f"(x)
#define FP_N32_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}, "
#define FP_N192_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "   \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "   \
  "%93, %94, %95}, "

// d (+)= A B, m64nNk16, both from shared memory: A K-major (TA = 0) or
// MN-major (TA = 1), B likewise (TB).  kInit writes d without reading it.
template <int TA, int TB, bool kInit>
__device__ __forceinline__ void ss_n32(float (&d)[16], uint64_t da,
                                       uint64_t db) {
  if constexpr (kInit)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FP_N32_REGS
        "%16, %17, p, 1, 1, %18, %19;\n}\n"
        : FP_D8(FP_WO, 0), FP_D8(FP_WO, 8)
        : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FP_N32_REGS
        "%16, %17, p, 1, 1, %18, %19;\n}\n"
        : FP_D8(FP_RW, 0), FP_D8(FP_RW, 8)
        : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}
#define FP_N96_REGS                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47}, "
// d (+)= A B, m64n96k16, A and B MN-major from shared memory (dQ = dS K).
template <bool kInit>
__device__ __forceinline__ void ss_n96(float (&d)[48], uint64_t da,
                                       uint64_t db) {
  if constexpr (kInit)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " FP_N96_REGS
        "%48, %49, p, 1, 1, 1, 1;\n}\n"
        : FP_D8(FP_WO, 0), FP_D8(FP_WO, 8), FP_D8(FP_WO, 16),
          FP_D8(FP_WO, 24), FP_D8(FP_WO, 32), FP_D8(FP_WO, 40)
        : "l"(da), "l"(db), "r"(0));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " FP_N96_REGS
        "%48, %49, p, 1, 1, 1, 1;\n}\n"
        : FP_D8(FP_RW, 0), FP_D8(FP_RW, 8), FP_D8(FP_RW, 16),
          FP_D8(FP_RW, 24), FP_D8(FP_RW, 32), FP_D8(FP_RW, 40)
        : "l"(da), "l"(db), "r"(1));
}
#undef FP_N96_REGS

// d += A B, m64n192k16, A K-major and B MN-major, both from shared memory.
__device__ __forceinline__ void ss_n192(float (&d)[96], uint64_t da,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " FP_N192_REGS
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : FP_D8(FP_RW, 0), FP_D8(FP_RW, 8), FP_D8(FP_RW, 16),
        FP_D8(FP_RW, 24), FP_D8(FP_RW, 32), FP_D8(FP_RW, 40),
        FP_D8(FP_RW, 48), FP_D8(FP_RW, 56), FP_D8(FP_RW, 64),
        FP_D8(FP_RW, 72), FP_D8(FP_RW, 80), FP_D8(FP_RW, 88)
      : "l"(da), "l"(db), "r"(1));
}

#undef FP_N192_REGS
#undef FP_N32_REGS
#undef FP_WO
#undef FP_RW
#undef FP_D8

// Query tiles [*t0, *t1) of 64 rows that see kv rows [k0, k0 + 64) (none
// when k0 >= skv): from the first query that causality lets see k0 to the
// last that the window lets see the tile's last row.  Every such tile
// holds at least one unmasked pair (bwd192_plan in flash_attention.py is
// this function in Python).
__device__ __forceinline__ void pair_q_tiles(int k0, int sq, int skv,
                                             int q_offset, int window,
                                             int causal, int* t0, int* t1) {
  *t0 = *t1 = 0;
  if (k0 >= skv) return;
  const int kmax = min(k0 + kPairN, skv) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(sq, kmax + window - q_offset) : sq;
  if (i_hi <= i_lo) return;
  *t0 = i_lo / kBM;
  *t1 = (i_hi + kBM - 1) / kBM;
}

// P^T and dS^T of one thread's 8 x 2 pairs, from S^T = K Q^T and dP^T =
// V dO^T over its warpgroup's 32 query columns (m64n32 accumulator
// layout: x[4 j + 2 r + e] is kv row kv_row + 8 r, query column qc + 8 j
// + 2 tq + e).  P = exp(S scale - lse), masked pairs exactly 0; dS = P
// (dP - dsum) scale.  Pair (x[2 m], x[2 m + 1]) leaves as bf16 hi/lo
// (x to about 2^-17) in p_hi[m], p_lo[m] and d_hi[m], d_lo[m].
template <bool kMask>
__device__ __forceinline__ void pair_probs(
    float (&s)[16], float (&dp)[16], const float (&lse_r)[8],
    const float (&dsum_r)[8], uint32_t (&p_hi)[8], uint32_t (&p_lo)[8],
    uint32_t (&d_hi)[8], uint32_t (&d_lo)[8], int qc, int kv_row, int tq,
    int sq, int skv, int q_offset, int window, int causal, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 4 * j + 2 * r + e;
        float p = exp2_approx(fmaf(s[n], sl, -lse_r[2 * j + e]));
        if (kMask) {
          const int qi = qc + 8 * j + 2 * tq + e;
          if (qi >= sq ||
              !visible(q_offset + qi, kv_row + 8 * r, skv, causal, window))
            p = 0.f;
        }
        s[n] = p;
        dp[n] = p * (dp[n] - dsum_r[2 * j + e]) * scale;
      }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    uint32_t hi = bf16x2(s[2 * m], s[2 * m + 1]);
    p_hi[m] = hi;
    p_lo[m] = bf16x2(s[2 * m] - __uint_as_float(hi << 16),
                     s[2 * m + 1] - __uint_as_float(hi & 0xffff0000u));
    hi = bf16x2(dp[2 * m], dp[2 * m + 1]);
    d_hi[m] = hi;
    d_lo[m] = bf16x2(dp[2 * m] - __uint_as_float(hi << 16),
                     dp[2 * m + 1] - __uint_as_float(hi & 0xffff0000u));
  }
}

// One CTA of a pair: kv rows [k0, k0 + 64) of head h, k0 = 128 pt + 64 r
// for cluster rank r.  Per query tile both warpgroups take 32 query
// columns each of S^T and dP^T (m64n32), form their P and dS, and write
// P^T and dS^T (hi, lo) into swizzled shared memory; then warpgroup 0 runs
// dK += dS^T Q and warpgroup 1 dV += P^T dO (m64n192, A from shared
// memory), and each dQ += dS K over 96 hd columns (A = dS^T read
// MN-major), staged as three swizzled 32-column blocks and added to the
// f32 dq by one tensor-map reduce-add.  Each CTA issues half of every
// tile's loads (CTA 0 Q and lse, CTA 1 dO and dsum) into both CTAs; both
// CTAs step through the union of their query tiles, and a CTA computes
// only on its own.  kBlock = false: the flash backward (dK, dV at
// G = 1 written in bf16); kBlock = true: the block backward (every output
// f32).  `chunk` (units of (batch row, head) a chunk of the launch order
// holds) comes from kL2Chunk and the shapes.
template <int HD, bool kBlock>
__global__ void __cluster_dims__(kPair, 1, 1)
    __launch_bounds__(kBwdThreads, 1)
    flash_bwd_wgmma_pair_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_dq,
                                const __grid_constant__ CUtensorMap tm_dk,
                                const __grid_constant__ CUtensorMap tm_dv,
                                const float* __restrict__ stats, int sq_pad,
                                void* __restrict__ dk, void* __restrict__ dv,
                                int batch, int sq, int skv, int n_heads,
                                int n_kv, int q_offset, int window,
                                int causal, float scale, int chunk) {
  using L = PairSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128B swizzle atoms
  uint8_t* const basep = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;              // + 8 * stage
  const uint32_t empty = full + 8 * kBwdStages;

  // The launch order: chunks of `chunk` units (h slowest, then b), one
  // after another; within a chunk the kv pairs, lowest (the most query
  // rows under causality) first, each over the chunk's units.
  const uint32_t r = cluster_rank();
  const uint32_t pr = r ^ 1u;
  const int n_pt = (skv + kPair * kPairN - 1) / (kPair * kPairN);
  const int n_units = batch * n_heads;
  int idx = blockIdx.x / kPair;
  const int c = idx / (chunk * n_pt);
  idx -= c * chunk * n_pt;
  const int cu = min(chunk, n_units - c * chunk);
  const int pt = idx / cu;
  const int unit = c * chunk + idx % cu;
  const int h = unit / batch;
  const int b = unit % batch;
  const int groups = n_heads / n_kv;
  const int kvh = h / groups;
  const int k0 = (kPair * pt + (int)r) * kPairN;

  // own and the other CTA's query tiles, and their union, which both step
  int t0m, t1m, t0p, t1p;
  pair_q_tiles(k0, sq, skv, q_offset, window, causal, &t0m, &t1m);
  pair_q_tiles((kPair * pt + (int)pr) * kPairN, sq, skv, q_offset, window,
               causal, &t0p, &t1p);
  const int own_n = t1m - t0m;
  const int T0 = own_n == 0 ? t0p : (t1p == t0p ? t0m : min(t0m, t0p));
  const int n_u = max(t1m, t1p) - T0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kPairEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // both CTAs' barriers live before any remote access

  // Lane 0 of warp 3 of each warpgroup issues this CTA's half of union
  // tile v into stage v % 2 of both CTAs, once both have released the
  // tile that used the stage: warpgroup 0 the Q (CTA 0) or dO (CTA 1)
  // tile, warpgroup 1 the lse (CTA 0) or dsum (CTA 1) and the stage's
  // expected bytes (an issue stalls its warp, so warp 0 of each warpgroup
  // issues the dQ reduce-add instead).
  const int wp = (threadIdx.x >> 5) & 3;
  const bool producer = wp == 3 && (threadIdx.x & 31) == 0;
  const float* stat_bh = stats + ((int64_t)b * n_heads + h) * 2 * sq_pad;
  int issued = 0;
  auto issue_upto = [&](int limit, bool block) {
    for (limit = min(limit, n_u); issued < limit; ++issued) {
      const int st = issued % kBwdStages;
      const int par = ((issued / kBwdStages) & 1) ^ 1;
      // (the other CTA's arrivals release at cluster scope; this wait
      // acquires at CTA scope, as CUTLASS's multicast pipelines do)
      if (block)
        mbar_wait(empty + 8 * st, par);
      else if (!mbar_try_wait(empty + 8 * st, par))
        return;
      const int q0 = (T0 + issued) * kBM;
      if (threadIdx.x >= 128) {
        mbar_expect_tx(full + 8 * st, 2 * L::kT + 2 * kBM * 4);
        const uint32_t stat = base + L::kStat + st * 2 * kBM * 4 + r * kBM * 4;
        bulk_load_pair(stat, stat_bh + r * sq_pad + q0, kBM * 4,
                       full + 8 * st);
      } else {
        tma_load5_pair(base + (r == 0 ? L::kQ : L::kDO) + st * L::kT,
                       r == 0 ? &tm_q : &tm_do, full + 8 * st, q0, h, b);
      }
    }
  };
  if (producer) issue_upto(kBwdStages, true);
  if (threadIdx.x == 0) {
    if (own_n > 0) {
      mbar_expect_tx(kv_full, 2 * L::kT);
      tma_load5(base + L::kK, &tm_k, kv_full, k0, kvh, b);
      tma_load5(base + L::kV, &tm_v, kv_full, k0, kvh, b);
    }
  }

  // ---- warpgroup 0: dK; warpgroup 1: dV; each 96 hd columns of dQ ----
  const int w = threadIdx.x >> 7;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kv_row = k0 + 16 * wp + g;              // and kv_row + 8

  // acc[4 j + 2 r + e]: kv row kv_row + 8 r, hd column 8 j + 2 tq + e
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // dQ: y64 over K's box b64 and y32 over 32 columns at b32: warpgroup 0
  // hd columns 0..63 and 64..95, warpgroup 1 128..191 and 96..127; their
  // columns within the warpgroup's 96, staged as 3 blocks of 32 at dq_st
  const uint32_t kq = base + L::kK + 3 * w * kK64Block;
  const uint32_t dq_st = base + L::kDQ + w * (kHalf / kDqBox) * kBM * 128;
  uint8_t* const dq_st_p = basep + (dq_st - base);
  if (own_n > 0) mbar_wait(kv_full, 0);
  for (int u = 0; u < n_u; ++u) {
    const int st = u % kBwdStages;
    const int t = T0 + u;
    const int q0 = t * kBM;
    const bool mine = t >= t0m && t < t1m;
    if (producer) {
      issue_upto(u + 1, true);
      issue_upto(u + 2, false);
    }
    __syncwarp();
    mbar_wait(full + 8 * st, (u / kBwdStages) & 1);

    // this CTA is done with the stage's Q and dO: release it in both CTAs
    auto release = [&] {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty + 8 * st);
        mbar_arrive_peer(peer_addr(empty + 8 * st, pr));
      }
      if (producer) issue_upto(u + kBwdStages + 1, false);
    };
    uint32_t p_hi[8], p_lo[8], d_hi[8], d_lo[8];
    if (mine) {
      // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 32 query
      // columns, exact in f32 (bf16 products)
      const uint32_t qt = base + L::kQ + st * L::kT + 32 * w * 128;
      const uint32_t dot = base + L::kDO + st * L::kT + 32 * w * 128;
      const uint32_t ka = base + L::kK, va = base + L::kV;
      float s[16], dp[16];
      wgmma_fence();
      ss_n32<0, 0, true>(s, desc64(ka, 16), desc(qt, 16, 1024));
      ss_n32<0, 0, true>(dp, desc(va, 16, 1024), desc(dot, 16, 1024));
#pragma unroll
      for (int kk = 1; kk < HD / 16; ++kk) {
        const uint32_t o = (kk / 4) * kQBox + (kk % 4) * 32;
        ss_n32<0, 0, false>(
            s, desc64(ka + (kk / 2) * kK64Block + (kk % 2) * 32, 16),
            desc(qt + o, 16, 1024));
        ss_n32<0, 0, false>(dp, desc(va + o, 16, 1024),
                            desc(dot + o, 16, 1024));
      }
      wgmma_commit();
      float lse_r[8], dsum_r[8];
      const float* stat = reinterpret_cast<const float*>(
          basep + L::kStat + st * 2 * kBM * 4) + 32 * w;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(stat + 8 * j + 2 * tq);
        const float2 d2 =
            *reinterpret_cast<const float2*>(stat + kBM + 8 * j + 2 * tq);
        lse_r[2 * j] = l2.x;
        lse_r[2 * j + 1] = l2.y;
        dsum_r[2 * j] = d2.x;
        dsum_r[2 * j + 1] = d2.y;
      }
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const int qc = q0 + 32 * w;
      if (q0 + kBM > sq || k0 + kPairN > skv ||
          (causal && q_offset + q0 < k0 + kPairN - 1) ||
          (window > 0 && q_offset + q0 + kBM - 1 - k0 >= window))
        pair_probs<true>(s, dp, lse_r, dsum_r, p_hi, p_lo, d_hi, d_lo, qc,
                         kv_row, tq, sq, skv, q_offset, window, causal,
                         scale);
      else
        pair_probs<false>(s, dp, lse_r, dsum_r, p_hi, p_lo, d_hi, d_lo, qc,
                          kv_row, tq, sq, skv, q_offset, window, causal,
                          scale);
    }
    // the last tile's dQ reduce-adds have read their staging (ordered
    // before this tile's staging writes by the CTA barriers below)
    if (lane == 0 && wp == 0) bulk_wait<true>();
    cta_sync();        // the last tile's products have read P^T and dS^T
    if (mine) {
      // (kv row m, query column k) at m * 128 + ((k / 8) ^ (m % 8)) * 16 +
      // (k % 8) * 2, TMA's 128-byte swizzle; m % 8 = g
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int row = 16 * wp + g + 8 * (m & 1);
        const int at = row * 128 + (((4 * w + (m >> 1)) ^ g) << 4) + 4 * tq;
        *reinterpret_cast<uint32_t*>(basep + L::kPT + at) = p_hi[m];
        *reinterpret_cast<uint32_t*>(basep + L::kPT + kQBox + at) = p_lo[m];
        *reinterpret_cast<uint32_t*>(basep + L::kDST + at) = d_hi[m];
        *reinterpret_cast<uint32_t*>(basep + L::kDST + kQBox + at) = d_lo[m];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    cta_sync();        // P^T and dS^T of both warpgroups in place

    float y[48];
    if (mine) {
      // dK += dS^T Q (warpgroup 0) or dV += P^T dO (1), each as hi + lo;
      // A K-major from shared memory, B MN-major
      const uint32_t a = base + (w == 0 ? L::kDST : L::kPT);
      const uint32_t bt = base + (w == 0 ? L::kQ : L::kDO) + st * L::kT;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ss_n192(acc, desc(a + x * kQBox + kk * 32, 16, 1024),
                  desc(bt + kk * 16 * 128, kQBox, 1024));
      wgmma_commit();
      // dQ += dS K over this warpgroup's 96 columns: A = dS^T read
      // MN-major (transposed), B = K MN-major in 64-byte-swizzled blocks
      const uint32_t ds = base + L::kDST;
      ss_n96<true>(y, desc(ds, kQBox, 1024), desc64(kq, kK64Block));
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = x == 0 ? 1 : 0; kk < 4; ++kk)
          ss_n96<false>(y, desc(ds + x * kQBox + kk * 16 * 128, kQBox, 1024),
                        desc64(kq + kk * 16 * 64, kK64Block));
      wgmma_commit();
      wgmma_wait<1>();
      pin(acc);
      release();
      wgmma_wait<0>();
      pin(y);
    } else {
      release();
    }

    if (mine) {
      // y[4 j + 2 r + e]: query row 16 wp + g + 8 r of the tile, column
      // 8 j + 2 tq + e of the warpgroup's 96.  Column c of row m at block
      // c / 32, m * 128 + (((c % 32) / 4) ^ (m % 8)) * 16 + (c % 4) * 4:
      // the tensor map's 128-byte swizzle; m % 8 = g, and the float2
      // stores of a warp fill each bank twice
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = 16 * wp + g + 8 * rr;
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(
              dq_st_p + (col / kDqBox) * kBM * 128 + m * 128 +
              ((((col % kDqBox) >> 2) ^ g) << 4) + (col & 3) * 4) =
              make_float2(y[4 * j + 2 * rr], y[4 * j + 2 * rr + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + w);
      if (lane == 0 && wp == 0) {
        tma_reduce5(&tm_dq, dq_st, q0, kHalf / kDqBox * w, h, b);
        bulk_commit();
      }
    }
  }

  // ---- epilogue: dK (warpgroup 0) or dV (1) of the CTA's kv rows ----
  // (a CTA may leave once its reduce-adds have read shared memory: the
  // adds themselves complete before the launch does)
  if (lane == 0 && wp == 0) bulk_wait<true>();
  void* const dst = w == 0 ? dk : dv;
  if (groups > 1) {
    // G CTAs share the kv head: stage the rows as six swizzled 32-column
    // blocks in the shared memory the loop is done with, then one
    // tensor-map reduce-add a warpgroup
    constexpr int kKvTile = HD / kDqBox * kBM * 128;
    static_assert(2 * kKvTile <= L::kStat, "dK, dV staging too large");
    cta_sync();
    if (own_n > 0) {
      uint8_t* const st_p = basep + w * kKvTile;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = 16 * wp + g + 8 * rr;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          *reinterpret_cast<float2*>(
              st_p + (col / kDqBox) * kBM * 128 + m * 128 +
              ((((col % kDqBox) >> 2) ^ g) << 4) + (col & 3) * 4) =
              make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + w);
      if (lane == 0 && wp == 0) {
        tma_reduce5(w == 0 ? &tm_dk : &tm_dv, base + w * kKvTile, k0, 0, kvh,
                    b);
        bulk_commit();
        bulk_wait<true>();
      }
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = kv_row + 8 * rr;
      if (row >= skv) continue;
      const int64_t off =
          (((int64_t)b * skv + row) * n_kv + kvh) * HD + 2 * tq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float a0 = acc[4 * j + 2 * rr], a1 = acc[4 * j + 2 * rr + 1];
        if (kBlock)
          *reinterpret_cast<float2*>(static_cast<float*>(dst) + off + 8 * j) =
              make_float2(a0, a1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst) +
                                       off + 8 * j) = bf16x2(a0, a1);
      }
    }
  }
  cluster_sync();   // neither CTA leaves while the other may reach it
}

// ---------------------------------------------------------------------------
// The bf16 forward and carry step at hd 192; see the note at the head of
// the file
// ---------------------------------------------------------------------------

constexpr int kSkN = 64;              // kv rows of a stage
constexpr int kSkStages = 2;          // K and V tiles in flight

template <int HD>
struct SkSmem {
  static_assert(HD == 192, "the hd-192 forward kernel");
  static constexpr int kN = kSkN;
  static constexpr int kKvBox = kN * 128;             // a K or V box
  static constexpr int kQTile = HD / 64 * kBox;       // the Q tile
  static constexpr int kKvTile = HD / 64 * kKvBox;    // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kSkStages * kKvTile;
  static constexpr int kBar = kV + kSkStages * kKvTile;
  // q_full, then k_full, v_full, k_empty, v_empty of each stage
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kSkStages) + 1024;
  static_assert(kBytes <= 232448, "over the opt-in shared memory");
};

// One box of the output from shared memory, 128-byte swizzled as a TMA
// load leaves it: hd columns [c0, c0 + 64) of 64 rows from `row` of head
// `head` of batch `b`; rows past S are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int head,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(head), "r"(row), "r"(b)
      : "memory");
}

// online_softmax, with the rescale of a row's acc skipped where the alpha
// of that row is exactly 1 in every lane of the warp (a warp vote on the
// computed alpha; x * 1.0f == x, so the skip changes no bit).  A copy, so
// that the hd-64 and hd-128 kernels stay as they were timed.
template <bool kMask, int HD, int N>
__device__ __forceinline__ void online_softmax_skip(
    const float (&s)[N / 2], float (&m)[2], float (&lp)[2],
    float (&acc)[HD / 2], uint32_t (&p_hi)[N / 4], uint32_t (&p_lo)[N / 4],
    int qpos, int kpos, int skv, int causal, int window, float scale) {
  const float sl = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[N / 4];
    float mx = __uint_as_float(kMinusInfBits);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[2 * j + e] = s[4 * j + 2 * r + e];
        if (kMask && !visible(qpos + 8 * r, kpos + 8 * j + e, skv, causal,
                              window))
          x[2 * j + e] = __uint_as_float(kMinusInfBits);
        mx = fmaxf(mx, x[2 * j + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // max(s) * scale == max(s * scale): rounding is monotonic, scale > 0
    const float m_new = fmaxf(m[r], mx * scale);
    const float alpha = exp2_approx((m[r] - m_new) * kLog2e);
    const float ms = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float p0 = exp2_approx(fmaf(x[2 * j], sl, -ms));
      const float p1 = exp2_approx(fmaf(x[2 * j + 1], sl, -ms));
      sum += p0 + p1;
      const uint32_t hi = bf16x2(p0, p1);
      p_hi[2 * j + r] = hi;
      p_lo[2 * j + r] = bf16x2(p0 - __uint_as_float(hi << 16),
                               p1 - __uint_as_float(hi & 0xffff0000u));
    }
    lp[r] = alpha * lp[r] + sum;
    m[r] = m_new;
    if (!__all_sync(0xffffffffu, alpha == 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j + 2 * r] *= alpha;
        acc[4 * j + 2 * r + 1] *= alpha;
      }
    }
  }
}

// kCarry = false: the forward (state initialised, out and lse written).
// kCarry = true: one carry step (state from `carry`, stored back there).
// One CTA per (b, h, 128 query rows), heaviest first under causality:
// flash_fwd_wgmma_kernel's turns at kSkN kv rows a stage, with the exact
// rescale skip of online_softmax_skip and the forward's output leaving by
// TMA stores.
template <int HD, bool kCarry>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_skip_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       float* __restrict__ lse, Carry carry, int batch,
                       int sq, int skv, int n_heads, int n_kv, int q_offset,
                       int window, int causal, float scale) {
  using L = SkSmem<HD>;
  constexpr int kN = L::kN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // 128B swizzle atoms
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;             // + 8 * stage
  const uint32_t v_full = k_full + 8 * kSkStages;
  const uint32_t k_empty = v_full + 8 * kSkStages;
  const uint32_t v_empty = k_empty + 8 * kSkStages;

  const int n_qt = (sq + kM - 1) / kM;
  int idx = blockIdx.x;
  const int h = idx % n_heads;
  idx /= n_heads;
  const int b = idx % batch;
  idx /= batch;
  const int q0 = (causal ? n_qt - 1 - idx : idx) * kM;
  const int kvh = h / (n_heads / n_kv);

  int lo, hi;
  kv_range(q_offset + q0, q_offset + min(q0 + kM, sq) - 1, skv, causal,
           window, &lo, &hi);
  const int t0 = lo / kN;
  const int n_tiles = hi > lo ? (hi + kN - 1) / kN - t0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSkStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kEmptyArrivals);
      mbar_init(v_empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0 || n_tiles == 0) return;
    mbar_expect_tx(q_full, L::kQTile);
#pragma unroll
    for (int x = 0; x < HD / 64; ++x)
      tma_load(base + L::kQ + x * kBox, &tm_q, q_full, 64 * x, h, q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kSkStages;
      const int par = (i / kSkStages) & 1;
      const int row = (t0 + i) * kN;
      mbar_wait(k_empty + 8 * st, par ^ 1);
      mbar_expect_tx(k_full + 8 * st, L::kKvTile);
#pragma unroll
      for (int x = 0; x < HD / 64; ++x)
        tma_load(base + L::kK + st * L::kKvTile + x * L::kKvBox, &tm_k,
                 k_full + 8 * st, 64 * x, kvh, row, b);
      mbar_wait(v_empty + 8 * st, par ^ 1);
      mbar_expect_tx(v_full + 8 * st, L::kKvTile);
#pragma unroll
      for (int x = 0; x < HD / 64; ++x)
        tma_load(base + L::kV + st * L::kKvTile + x * L::kKvBox, &tm_v,
                 v_full + 8 * st, 64 * x, kvh, row, b);
    }
    return;
  }

  // ---- consumers: warpgroup c owns query rows [q0 + 64 c, q0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tw = threadIdx.x & 127;
  const int lane = tw & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = q0 + 64 * c + 16 * (tw >> 5) + g;   // and row0 + 8
  const bool elected = lane == 0;

  // acc[4 j + 2 r + e]: row row0 + 8 r, hd column 8 j + 2 tq + e
  float m[2] = {kNegInf, kNegInf}, lp[2] = {0.f, 0.f}, acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  if (kCarry) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= sq) continue;
      const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
      m[r] = carry.m_in[row];
      lp[r] = tq == 0 ? carry.l_in[row] : 0.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(
            carry.acc_in + row * HD + 8 * j + 2 * tq);
        acc[4 * j + 2 * r] = a.x;
        acc[4 * j + 2 * r + 1] = a.y;
      }
    }
  }

  if (n_tiles > 0) {
    // A consumer's turn on the tensor cores is P V of the previous tile,
    // then S = Q K^T of this one; its softmax then overlaps the other
    // consumer's turn.  P V completes before S starts, so P and S never
    // hold registers together: acc + S or acc + P fit the 168 registers
    // a thread of a 384-thread CTA may have.
    const int mine = 1 + c, other = 2 - c;
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;
    const uint32_t k_tiles = base + L::kK, v_tiles = base + L::kV;
    float s[kN / 2];
    uint32_t p_hi[kN / 4], p_lo[kN / 4];
    const int qpos = q_offset + row0;
    // a tile needs the mask where it reaches Skv, crosses the diagonal or
    // the window's edge for any of the CTA's 128 rows
    const int qmin = q_offset + q0, qmax = q_offset + q0 + kM - 1;
    mbar_wait(q_full, 0);
    if (c == 1) turn_pass(1);            // consumer 0 takes the first turn
    for (int i = 0; i <= n_tiles; ++i) {
      const int st = i % kSkStages;
      const int pst = (i + kSkStages - 1) % kSkStages;
      if (i < n_tiles) mbar_wait(k_full + 8 * st, (i / kSkStages) & 1);
      turn_wait(mine);
      if (i > 0) {                       // acc += P V of the previous tile
        mbar_wait(v_full + 8 * pst, ((i - 1) / kSkStages) & 1);
        pin(acc);
        pin(p_hi);
        pin(p_lo);
        wgmma_fence();
        const uint32_t vt = v_tiles + pst * L::kKvTile;
        rs_mma<HD, kN / 16>(acc, p_hi, vt, L::kKvBox);
        rs_mma<HD, kN / 16>(acc, p_lo, vt, L::kKvBox);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        __syncwarp();
        if (elected) mbar_arrive(v_empty + 8 * pst);
      }
      if (i == n_tiles) {                // the last turn: no S to compute
        if (c == 0) turn_pass(other);
        break;
      }
      wgmma_fence();                     // S = Q K^T of this tile
      const uint32_t kt = k_tiles + st * L::kKvTile;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da =
            desc(q_rows + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        const uint64_t db =
            desc(kt + (kk / 4) * L::kKvBox + (kk % 4) * 32, 16, 1024);
        if constexpr (kN == 128) {
          if (kk == 0)
            wgmma_ss_n128_init(s, da, db);
          else
            wgmma_ss_n128(s, da, db);
        } else {
          if (kk == 0)
            wgmma_ss_n64<0, true>(s, da, db);
          else
            wgmma_ss_n64<0, false>(s, da, db);
        }
      }
      wgmma_commit();
      turn_pass(other);
      wgmma_wait<0>();
      pin(s);
      __syncwarp();
      if (elected) mbar_arrive(k_empty + 8 * st);

      const int k0 = (t0 + i) * kN;
      if (k0 + kN > skv || (causal && k0 + kN - 1 > qmin) ||
          (window > 0 && qmax - k0 >= window))
        online_softmax_skip<true, HD, kN>(s, m, lp, acc, p_hi, p_lo,
                                      qpos, k0 + 2 * tq, skv, causal,
                                      window, scale);
      else
        online_softmax_skip<false, HD, kN>(s, m, lp, acc, p_hi, p_lo,
                                       qpos, k0 + 2 * tq, skv, causal,
                                       window, scale);
    }
  }

  // ---- epilogue: l over the quad, then the rows below Sq ----
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = lp[r] + __shfl_xor_sync(0xffffffffu, lp[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (kCarry) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= sq) continue;
      const int64_t row = ((int64_t)b * sq + i) * n_heads + h;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(carry.acc_out + row * HD + 8 * j +
                                   2 * tq) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (tq == 0) {
        carry.m_out[row] = m[r];
        carry.l_out[row] = l[r];
      }
    }
    return;
  }
  // out = acc / l, each quotient correctly rounded (Markstein: y = RN(1 /
  // l), q = RN(acc y), then RN(q + (acc - l q) y) is RN(acc / l) away
  // from underflow), staged in the warpgroup's 64 rows of the Q tile (its
  // last S has completed) in the load's 128-byte swizzle and stored by TMA
  uint8_t* const basep = smem_raw + (base - raw);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(l[r], 1e-30f);
    const float y = __frcp_rn(l_safe);
    const int mrow = 16 * (tw >> 5) + g + 8 * r;
    auto quot = [&](float a) {
      const float q = a * y;
      return fmaf(fmaf(-l_safe, q, a), y, q);
    };
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(
          basep + L::kQ + (j / 8) * kBox + (64 * c + mrow) * 128 +
          (((j % 8) ^ g) << 4) + 4 * tq) =
          bf16x2(quot(acc[4 * j + 2 * r]), quot(acc[4 * j + 2 * r + 1]));
    const int i = row0 + 8 * r;
    if (tq == 0 && i < sq)
      lse[((int64_t)b * sq + i) * n_heads + h] = m[r] + logf(l_safe);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
  if (tw == 0) {
#pragma unroll
    for (int x = 0; x < HD / 64; ++x)
      tma_store(&tm_o, base + L::kQ + x * kBox + c * 64 * 128, 64 * x, h,
                q0 + 64 * c, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// The finishing pass: an f32 workspace into bf16, four values a thread
// (n4 = n / 4: every workspace holds rows of hd 64, 128 or 192).
__global__ void to_bf16_kernel(const float* __restrict__ src,
                               __nv_bfloat16* __restrict__ dst, int64_t n4) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    reinterpret_cast<uint2*>(dst)[i] =
        make_uint2(bf16x2(x.x, x.y), bf16x2(x.z, x.w));
  }
}

}  // namespace tc

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

// The bf16 backward's per-row statistics in the layout its bulk loads
// read, [B, H, 2, sq_pad] f32: lse times log2(e), then dsum, zeros past
// Sq.  dsum = sum_d dout * out where out is given (the flash backward),
// else the caller's (the block backward).  A row is one warp (kDsum, each
// lane reading HD / 32 neighbouring values of out and dout) or one thread.
template <int HD, bool kDsum>
__global__ void __launch_bounds__(kThreads)
flash_bwd_stats_kernel(const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       float* __restrict__ stats, int batch, int sq,
                       int sq_pad, int n_heads) {
  constexpr int kPer = kDsum ? 32 : 1;      // threads of a row
  const int64_t row = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kPer;
  if (row >= (int64_t)batch * sq_pad * n_heads) return;
  const int h = (int)(row % n_heads);
  const int i = (int)((row / n_heads) % sq_pad);
  const int b = (int)(row / ((int64_t)n_heads * sq_pad));
  const int lane = threadIdx.x % kPer;
  float l = 0.f, s = 0.f;
  if (i < sq) {
    const int64_t src = ((int64_t)b * sq + i) * n_heads + h;
    if constexpr (kDsum) {
      constexpr int kN = HD / 32;           // 2, 4 or 6 bf16: 4, 8, 12 bytes
      static_assert(kN == 2 || kN == 4 || kN == 6, "hd 64, 128 or 192");
      using Vec = typename std::conditional<
          kN == 2, uint32_t,
          typename std::conditional<kN == 4, uint2, uint3>::type>::type;
      const Vec o = reinterpret_cast<const Vec*>(out + src * HD)[lane];
      const Vec g = reinterpret_cast<const Vec*>(dout + src * HD)[lane];
      const __nv_bfloat16* ob = reinterpret_cast<const __nv_bfloat16*>(&o);
      const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&g);
#pragma unroll
      for (int x = 0; x < kN; ++x) s += to_f32(gb[x]) * to_f32(ob[x]);
      for (int w = 16; w > 0; w >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, w);
    } else {
      s = dsum[src];
    }
    l = lse[src] * tc::kLog2e;
  }
  if (lane == 0) {
    float* o = stats + ((int64_t)b * n_heads + h) * 2 * sq_pad;
    o[i] = l;
    o[sq_pad + i] = s;
  }
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

// Shared memory of the SIMT backward's kernels.  Where a kernel's tiles
// would not fit the opt-in limit (hd 192), two of its buffers take turns:
// P^T and dS^T (dK/dV), K^T + V^T and K (dQ), at the cost of one or two
// more barriers a tile; below the limit each has its own.
constexpr size_t kSmemOptIn = 232448;
template <int HD>
__host__ __device__ constexpr size_t dkdv_bytes(bool p_turns) {
  return sizeof(float) *
         (2 * HD * kLd64 + 2 * kTile * (padded_hd<HD>() + 4) +
          (p_turns ? 1 : 2) * kTile * kLd64 + 2 * kTile);
}
template <int HD>
__host__ __device__ constexpr bool dkdv_p_turns() {
  return dkdv_bytes<HD>(false) > kSmemOptIn;
}
template <int HD>
__host__ __device__ constexpr size_t dkdv_smem() {
  return dkdv_bytes<HD>(dkdv_p_turns<HD>());
}
template <int HD>
__host__ __device__ constexpr size_t dq_k_floats(bool k_turns) {
  constexpr size_t kv = 2 * HD * kLd64, k = kTile * (padded_hd<HD>() + 4);
  return k_turns ? (kv > k ? kv : k) : kv + k;
}
template <int HD>
__host__ __device__ constexpr size_t dq_bytes(bool k_turns) {
  return sizeof(float) * (2 * kTile * (padded_hd<HD>() + 4) +
                          dq_k_floats<HD>(k_turns) + kTile * kLd64 +
                          2 * kTile);
}
template <int HD>
__host__ __device__ constexpr bool dq_k_turns() {
  return dq_bytes<HD>(false) > kSmemOptIn;
}
template <int HD>
__host__ __device__ constexpr size_t dq_smem() {
  return dq_bytes<HD>(dq_k_turns<HD>());
}

// dK, dV of kv rows [k0, k0 + 64) of kv head kvh: loop over the G query
// heads of the group and the query tiles that see these rows.  Inputs T,
// outputs O (T, or f32 for the block backward).
template <typename T, typename O, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, O* __restrict__ dk,
                      O* __restrict__ dv, int sq, int skv, int n_heads,
                      int n_kv, int q_offset, int window, int causal,
                      float scale) {
  constexpr int HP = padded_hd<HD>();
  constexpr int NC = HP / 16;
  constexpr int kLdHd = HP + 4;
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
  float* qs = vt + HD * kLd64;                  // [64][HP+4]
  float* dos = qs + kTile * kLdHd;              // [64][HP+4]
  float* pt = dos + kTile * kLdHd;              // [64][64+4]  P^T
  constexpr bool kTurns = dkdv_p_turns<HD>();
  float* dst = kTurns ? pt : pt + kTile * kLd64;  // [64][64+4]  dS^T
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
      load_tile<T, HD, false, HP>(qs, kLdHd, qb, q0, sq, n_heads, h);
      load_tile<T, HD, false, HP>(dos, kLdHd, gb, q0, sq, n_heads, h);
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
          if constexpr (!kTurns)
            dst[(4 * tx + c) * kLd64 + 4 * ty + r] = dp[r][c];
        }
      __syncthreads();
      block_mma<NC>(pt, kLd64, dos, kLdHd, kTile, ty, tx, dv_acc);  // P^T dO
      if constexpr (kTurns) {  // dS^T into the buffer P^T leaves
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dst[(4 * tx + c) * kLd64 + 4 * ty + r] = dp[r][c];
        __syncthreads();
      }
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
      if (HP != HD && col_of(c, tx) >= HD) continue;
      dk[off + col_of(c, tx)] = from_f32<O>(dk_acc[r][c]);
      dv[off + col_of(c, tx)] = from_f32<O>(dv_acc[r][c]);
    }
  }
}

// dQ of query rows [q0, q0 + 64) of head h: loop over the kv tiles they see.
template <typename T, typename O, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, O* __restrict__ dq,
                    int sq, int skv, int n_heads, int n_kv, int q_offset,
                    int window, int causal, float scale) {
  constexpr int HP = padded_hd<HD>();
  constexpr int NC = HP / 16;
  constexpr int kLdHd = HP + 4;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  extern __shared__ float4 smem4[];
  constexpr bool kTurns = dq_k_turns<HD>();
  float* qs = reinterpret_cast<float*>(smem4);  // [64][HP+4]
  float* dos = qs + kTile * kLdHd;              // [64][HP+4]
  float* ks = dos + kTile * kLdHd;              // [64][HP+4]
  float* kt = kTurns ? ks : ks + kTile * kLdHd;  // [HD][64+4]  K transposed
  float* vt = kt + HD * kLd64;                  // [HD][64+4]  V transposed
  float* dss = ks + dq_k_floats<HD>(kTurns);    // [64][64+4]  dS
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
    if constexpr (!kTurns)
      load_tile<T, HD, false, HP>(ks, kLdHd, kb, k0, skv, n_kv, kvh);
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
    if constexpr (kTurns) {  // K into the buffer K^T and V^T leave
      load_tile<T, HD, false, HP>(ks, kLdHd, kb, k0, skv, n_kv, kvh);
      __syncthreads();
    }
    block_mma<NC>(dss, kLd64, ks, kLdHd, kTile, ty, tx, dq_acc);  // dS K
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= sq) continue;
    O* ob = dq + (((int64_t)b * sq + i) * n_heads + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (HP == HD || col_of(c, tx) < HD)
        ob[col_of(c, tx)] = from_f32<O>(dq_acc[r][c]);
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
  return sizeof(float) * (2 * kTile * (padded_hd<HD>() + 4) + HD * kLd64 +
                          kTile * kLd64);
}
static_assert(fwd_smem<192>() <= kSmemOptIn &&
                  dkdv_smem<192>() <= kSmemOptIn &&
                  dq_smem<192>() <= kSmemOptIn,
              "over the opt-in shared memory");

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

// The tensor map of a bf16 [B, S, heads, hd] tensor: boxes of `box_rows`
// rows x 64 hd columns of one head, 128-byte swizzled, rows past S read
// as 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int rows,
                int heads, int hd, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t row_bytes = (cuuint64_t)heads * hd * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row_bytes,
                                 row_bytes * rows};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The pair kernel's 5-D tensor map of a [B, S, heads, hd] tensor of
// `esize`-byte elements (bf16 2, f32 4): {`swizzle`-byte column block,
// row, block, head, batch}, boxes of `box_rows` rows x `box_blocks`
// blocks of one head, swizzled 128 or 64 bytes; rows past S read as 0
// and are not written.
bool tensor_map5(CUtensorMap* map, const void* ptr, int esize, int batch,
                 int rows, int heads, int hd, int box_rows, int box_blocks,
                 int swizzle = 128) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int inner = swizzle / esize;
  const cuuint64_t dims[5] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)(hd / inner), (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t row_bytes = (cuuint64_t)heads * hd * esize;
  const cuuint64_t strides[4] = {row_bytes, (cuuint64_t)swizzle,
                                 (cuuint64_t)hd * esize, row_bytes * rows};
  const cuuint32_t box[5] = {(cuuint32_t)inner, (cuuint32_t)box_rows,
                             (cuuint32_t)box_blocks, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map,
                esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                5, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 forward and carry step: TMA needs 16-byte aligned bases (the
// strides of contiguous [.., hd] rows are multiples of 128 bytes).  At hd
// 192 its own kernel (64 kv rows a stage, the output by TMA stores).
template <int HD, bool kCarry>
int fwd_wgmma(const void* q, const void* k, const void* v, void* out,
              void* lse, const Carry& carry, const Shape& s,
              cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  constexpr bool k192 = HD == 192;
  // with Skv = 0 no CTA loads k or v: a map over q stands in
  const bool empty = s.skv == 0;
  constexpr int kN = k192 ? tc::kSkN : tc::kFwdN;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, s.batch, s.sq, s.n_heads, HD, tc::kM) ||
      !tensor_map(&tm_k, empty ? q : k, s.batch, empty ? 1 : s.skv,
                  empty ? s.n_heads : s.n_kv, HD, kN) ||
      !tensor_map(&tm_v, empty ? q : v, s.batch, empty ? 1 : s.skv,
                  empty ? s.n_heads : s.n_kv, HD, kN))
    return (int)cudaErrorInvalidValue;
  static int granted = 0;
  const int64_t ctas = (int64_t)((s.sq + tc::kM - 1) / tc::kM) * s.batch *
                       s.n_heads;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if constexpr (k192) {
    // the carry step writes no bf16 output: a map over q stands in
    CUtensorMap tm_o;
    if (!tensor_map(&tm_o, kCarry ? q : out, s.batch, s.sq, s.n_heads, HD,
                    tc::kM / 2))
      return (int)cudaErrorInvalidValue;
    const size_t smem = tc::SkSmem<HD>::kBytes;
    const cudaError_t e = allow_smem(
        tc::flash_fwd_wgmma_skip_kernel<HD, kCarry>, smem, &granted);
    if (e != cudaSuccess) return (int)e;
    tc::flash_fwd_wgmma_skip_kernel<HD, kCarry>
        <<<(unsigned)ctas, tc::kThreads, smem, stream>>>(
            tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), carry,
            s.batch, s.sq, s.skv, s.n_heads, s.n_kv, s.q_offset, s.window,
            s.causal, s.scale);
  } else {
    const size_t smem = tc::Smem<HD>::kBytes;
    const cudaError_t e =
        allow_smem(tc::flash_fwd_wgmma_kernel<HD, kCarry>, smem, &granted);
    if (e != cudaSuccess) return (int)e;
    tc::flash_fwd_wgmma_kernel<HD, kCarry>
        <<<(unsigned)ctas, tc::kThreads, smem, stream>>>(
            tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out),
            static_cast<float*>(lse), carry, s.batch, s.sq, s.skv,
            s.n_heads, s.n_kv, s.q_offset, s.window, s.causal, s.scale);
  }
  return (int)cudaGetLastError();
}

// Every dispatch on the head dim names each one the file is built for and
// refuses any other (valid() checks first; a case left out would fall
// through to the refusal, never into another instantiation).
template <bool kCarry>
int fwd_dispatch(int dtype, int hd, const void* q, const void* k,
                 const void* v, void* out, void* lse, const Carry& carry,
                 const Shape& s, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0) switch (hd) {
      case 16: return fwd<float, 16, kCarry>(q, k, v, out, lse, carry, s, st);
      case 64: return fwd<float, 64, kCarry>(q, k, v, out, lse, carry, s, st);
      case 128:
        return fwd<float, 128, kCarry>(q, k, v, out, lse, carry, s, st);
      case 192:
        return fwd<float, 192, kCarry>(q, k, v, out, lse, carry, s, st);
    }
  if (dtype == 1) switch (hd) {
      case 16: return fwd<bf16, 16, kCarry>(q, k, v, out, lse, carry, s, st);
      case 64: return fwd_wgmma<64, kCarry>(q, k, v, out, lse, carry, s, st);
      case 128:
        return fwd_wgmma<128, kCarry>(q, k, v, out, lse, carry, s, st);
      case 192:
        return fwd_wgmma<192, kCarry>(q, k, v, out, lse, carry, s, st);
    }
  return (int)cudaErrorInvalidValue;
}

// dsum[b, i, h] = sum_d dout * out (the pre-pass of the flash backward).
template <typename T, int HD>
int dsum_pass(const void* out, const void* dout, void* dsum, const Shape& s,
              cudaStream_t stream) {
  const int64_t rows = (int64_t)s.batch * s.sq * s.n_heads;
  const int64_t per_block = kThreads / 32;
  flash_dsum_kernel<T, HD>
      <<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                   static_cast<float*>(dsum), rows);
  return (int)cudaGetLastError();
}

// The SIMT backward (f32, the block backward in f32, and both types at hd
// 16): dK/dV, then dQ, from a dsum already computed; inputs T, outputs O.
template <typename T, typename O, int HD>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* dsum, void* dq, void* dk, void* dv,
        const Shape& s, cudaStream_t stream) {
  static int granted_dkdv = 0, granted_dq = 0;
  cudaError_t e = allow_smem(flash_bwd_dkdv_kernel<T, O, HD>,
                             dkdv_smem<HD>(), &granted_dkdv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_bwd_dq_kernel<T, O, HD>, dq_smem<HD>(), &granted_dq);
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_kv((s.skv + kTile - 1) / kTile, s.n_kv, s.batch);
  flash_bwd_dkdv_kernel<T, O, HD><<<grid_kv, kThreads, dkdv_smem<HD>(),
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<O*>(dk), static_cast<O*>(dv), s.sq, s.skv, s.n_heads,
      s.n_kv, s.q_offset, s.window, s.causal, s.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid_q((s.sq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_bwd_dq_kernel<T, O, HD><<<grid_q, kThreads, dq_smem<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<O*>(dq), s.sq, s.skv, s.n_heads, s.n_kv, s.q_offset,
      s.window, s.causal, s.scale);
  return (int)cudaGetLastError();
}

// The flash backward on the SIMT kernels: the dsum pre-pass into
// `scratch`, then dK/dV and dQ in T.
template <typename T, int HD>
int bwd_simt(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* scratch, void* dq,
             void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const int e = dsum_pass<T, HD>(out, dout, scratch, s, st);
  if (e != 0) return e;
  return bwd<T, T, HD>(q, k, v, dout, lse, scratch, dq, dk, dv, s, st);
}

// Units of (batch row, head) a chunk of the pair kernel's launch order
// interleaves: as many as keep their Q and dO (bf16) and dQ (f32), sq x
// 192 x 8 bytes each, within tc::kL2Chunk; at least 1, at most `units`.
int pair_chunk(int sq, int64_t units) {
  const int64_t unit_bytes = std::max<int64_t>(1, (int64_t)sq * 192 * 8);
  return (int)std::min<int64_t>(std::max<int64_t>(1, tc::kL2Chunk / unit_bytes),
                                std::max<int64_t>(1, units));
}

// The bf16 backward on the tensor cores: dq is a zeroed f32 workspace;
// dk, dv are zeroed f32 workspaces when G > 1, else the outputs (bf16, or
// f32 for the block backward).  TMA needs 16-byte aligned bases.  At hd
// 192 the pair kernel (clusters of two CTAs of 64 kv rows), else the
// kernel of 128 kv rows a CTA.
template <int HD, bool kBlock>
int bwd_wgmma(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, const void* dsum,
              void* stats, void* dq, void* dk, void* dv, const Shape& s,
              cudaStream_t stream) {
  // (the statistics pass reads out with 8-byte loads)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out)) %
          16 !=
      0)
    return (int)cudaErrorMisalignedAddress;
  constexpr bool kIsPair = HD == 192;
  constexpr int kRows = kIsPair ? tc::kPairN : tc::kBN;   // kv rows a CTA
  using Smem =
      std::conditional_t<kIsPair, tc::PairSmem<HD>, tc::BwdSmem<HD>>;
  const auto kernel = [] {
    if constexpr (kIsPair)
      return tc::flash_bwd_wgmma_pair_kernel<HD, kBlock>;
    else
      return tc::flash_bwd_wgmma_kernel<HD, kBlock>;
  }();
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const bool mapped =
      kIsPair
          ? tensor_map5(&tm_q, q, 2, s.batch, s.sq, s.n_heads, HD, tc::kBM,
                        HD / 64) &&
                tensor_map5(&tm_do, dout, 2, s.batch, s.sq, s.n_heads, HD,
                            tc::kBM, HD / 64) &&
                tensor_map5(&tm_k, k, 2, s.batch, s.skv, s.n_kv, HD, kRows,
                            HD / 32, 64) &&
                tensor_map5(&tm_v, v, 2, s.batch, s.skv, s.n_kv, HD, kRows,
                            HD / 64)
          : tensor_map(&tm_q, q, s.batch, s.sq, s.n_heads, HD, tc::kBM) &&
                tensor_map(&tm_do, dout, s.batch, s.sq, s.n_heads, HD,
                           tc::kBM) &&
                tensor_map(&tm_k, k, s.batch, s.skv, s.n_kv, HD, kRows) &&
                tensor_map(&tm_v, v, s.batch, s.skv, s.n_kv, HD, kRows);
  if (!mapped) return (int)cudaErrorInvalidValue;
  static int granted = 0;
  const size_t smem = Smem::kBytes;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return (int)e;
  const int sq_pad = (s.sq + tc::kBM - 1) / tc::kBM * tc::kBM;
  const int64_t rows = (int64_t)s.batch * sq_pad * s.n_heads;
  const auto stats_kernel = out != nullptr ? flash_bwd_stats_kernel<HD, true>
                                           : flash_bwd_stats_kernel<HD, false>;
  const int64_t per_block = out != nullptr ? kThreads / 32 : kThreads;
  stats_kernel<<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0,
                 stream>>>(static_cast<const __nv_bfloat16*>(out),
                           static_cast<const __nv_bfloat16*>(dout),
                           static_cast<const float*>(lse),
                           static_cast<const float*>(dsum),
                           static_cast<float*>(stats), s.batch, s.sq, sq_pad,
                           s.n_heads);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (kIsPair) {
    // dK and dV are added through maps only where they are f32 workspaces
    // (G > 1); at G = 1 the kernel writes them and the maps stand unused
    const bool grouped = s.n_heads > s.n_kv;
    CUtensorMap tm_dq, tm_dk, tm_dv;
    if (!tensor_map5(&tm_dq, dq, 4, s.batch, s.sq, s.n_heads, HD, tc::kBM,
                     tc::kHalf / tc::kDqBox) ||
        !tensor_map5(&tm_dk, grouped ? dk : dq, 4, s.batch,
                     grouped ? s.skv : s.sq, grouped ? s.n_kv : s.n_heads,
                     HD, kRows, HD / tc::kDqBox) ||
        !tensor_map5(&tm_dv, grouped ? dv : dq, 4, s.batch,
                     grouped ? s.skv : s.sq, grouped ? s.n_kv : s.n_heads,
                     HD, kRows, HD / tc::kDqBox))
      return (int)cudaErrorInvalidValue;
    const int64_t units = (int64_t)s.batch * s.n_heads;
    const int64_t pairs = (s.skv + tc::kPair * kRows - 1) / (tc::kPair * kRows);
    const int64_t ctas = tc::kPair * pairs * units;
    if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)ctas, tc::kBwdThreads, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, tm_dq, tm_dk, tm_dv,
        static_cast<const float*>(stats),
        sq_pad, dk, dv, s.batch, s.sq, s.skv, s.n_heads, s.n_kv, s.q_offset,
        s.window, s.causal, s.scale, pair_chunk(s.sq, units));
  } else {
    const int64_t ctas = (int64_t)((s.skv + kRows - 1) / kRows) * s.batch *
                         s.n_heads;
    if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)ctas, tc::kBwdThreads, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(stats), sq_pad,
        static_cast<float*>(dq), dk, dv, s.batch, s.sq, s.skv, s.n_heads,
        s.n_kv, s.q_offset, s.window, s.causal, s.scale);
  }
  return (int)cudaGetLastError();
}

int to_bf16(const void* src, void* dst, int64_t n, cudaStream_t stream) {
  const int64_t n4 = n / 4;
  const int64_t blocks = std::min<int64_t>((n4 + 255) / 256, 132 * 16);
  tc::to_bf16_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), n4);
  return (int)cudaGetLastError();
}

// The bf16 flash backward: the statistics pass (dsum from out and dout),
// the tensor-core kernel into the f32 workspaces, and the finishing pass
// into the bf16 outputs.
template <int HD>
int bwd_bf16(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* stats, void* dq,
             void* dk, void* dv, void* ws_dq, void* ws_dk, void* ws_dv,
             const Shape& s, cudaStream_t st) {
  const bool grouped = s.n_heads > s.n_kv;
  int e = bwd_wgmma<HD, false>(q, k, v, out, dout, lse, nullptr, stats,
                               ws_dq, grouped ? ws_dk : dk,
                               grouped ? ws_dv : dv, s, st);
  if (e != 0) return e;
  e = to_bf16(ws_dq, dq, (int64_t)s.batch * s.sq * s.n_heads * HD, st);
  if (e != 0 || !grouped) return e;
  const int64_t n_kv = (int64_t)s.batch * s.skv * s.n_kv * HD;
  e = to_bf16(ws_dk, dk, n_kv, st);
  if (e != 0) return e;
  return to_bf16(ws_dv, dv, n_kv, st);
}

bool valid(const Shape& s, int hd) {
  return s.batch >= 0 && s.sq >= 0 && s.skv >= 0 && s.n_kv > 0 &&
         s.n_heads % s.n_kv == 0 &&
         (hd == 16 || hd == 64 || hd == 128 || hd == 192) &&
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

// f32, and bf16 at hd 16: three launches (dsum into `scratch`, f32 [B,
// Sq, H]; dK/dV; dQ), the workspaces unused.  bf16 at hd 64 and 128: the
// statistics pass into `scratch`, f32 [B, H, 2, ceil(Sq / 64) * 64], the
// tensor-core kernel and the finishing pass; ws_dq is a zeroed f32 [B, Sq,
// H, hd], ws_dk and ws_dv zeroed f32 [B, Skv, KV, hd] when H > KV (else
// unused).
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, void* ws_dq, void* ws_dk, void* ws_dv, int batch, int sq,
    int skv, int n_heads, int n_kv, int hd, int q_offset, int window,
    int causal, float scale, void* stream) {
  const Shape s{batch, sq, skv, n_heads, n_kv, q_offset, window, causal,
                scale};
  if (!valid(s, hd)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || skv == 0 || n_heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_SIMT(T, HD) \
  bwd_simt<T, HD>(q, k, v, out, dout, lse, scratch, dq, dk, dv, s, st)
#define FA_TC(HD)                                                          \
  bwd_bf16<HD>(q, k, v, out, dout, lse, scratch, dq, dk, dv, ws_dq, ws_dk, \
               ws_dv, s, st)
  if (dtype == 0) switch (hd) {
      case 16: return FA_SIMT(float, 16);
      case 64: return FA_SIMT(float, 64);
      case 128: return FA_SIMT(float, 128);
      case 192: return FA_SIMT(float, 192);
    }
  if (dtype == 1) switch (hd) {
      case 16: return FA_SIMT(__nv_bfloat16, 16);
      case 64: return FA_TC(64);
      case 128: return FA_TC(128);
      case 192: return FA_TC(192);
    }
#undef FA_TC
#undef FA_SIMT
  return (int)cudaErrorInvalidValue;
}

// Ring attention's block backward: the backward of one carry step, with
// dsum from the caller and q, k at global offsets (only their difference
// enters the mask).  dq, dk, dv are f32 [B, Sq, H, hd] / [B, Skv, KV,
// hd].  bf16 at hd 64 and 128 adds into them (the caller zeroes dq, and
// dk, dv when H > KV; at H = KV dk and dv are written), with `scratch` the
// statistics, f32 [B, H, 2, ceil(Sq / 64) * 64]; f32, and bf16 at hd 16,
// write them (SIMT kernels, no scratch).
extern "C" int flash_attention_bwd_block_launch(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* scratch, void* dq, void* dk,
    void* dv, int batch, int sq, int skv, int n_heads, int n_kv, int hd,
    int q_offset, int k_offset, int window, int causal, float scale,
    void* stream) {
  const Shape s{batch, sq,           skv,    n_heads, n_kv,
                q_offset - k_offset, window, causal,  scale};
  if (!valid(s, hd)) return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0 || skv == 0 || n_heads == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_SIMT(T, HD) \
  bwd<T, float, HD>(q, k, v, dout, lse, dsum, dq, dk, dv, s, st)
#define FA_TC(HD)                                                        \
  bwd_wgmma<HD, true>(q, k, v, nullptr, dout, lse, dsum, scratch, dq, dk, \
                      dv, s, st)
  if (dtype == 0) switch (hd) {
      case 16: return FA_SIMT(float, 16);
      case 64: return FA_SIMT(float, 64);
      case 128: return FA_SIMT(float, 128);
      case 192: return FA_SIMT(float, 192);
    }
  if (dtype == 1) switch (hd) {
      case 16: return FA_SIMT(__nv_bfloat16, 16);
      case 64: return FA_TC(64);
      case 128: return FA_TC(128);
      case 192: return FA_TC(192);
    }
#undef FA_TC
#undef FA_SIMT
  return (int)cudaErrorInvalidValue;
}

// The hd-192 backward's geometry, read by the tests against the Python
// plan (flash_attention.py::bwd192_plan): what = 0 kv rows a CTA, 1 CTAs
// a cluster, 2 dynamic shared memory bytes, 3 threads a CTA, 4 the bytes
// a chunk of the launch order may keep in L2, 5 clusters the card keeps
// resident at once (the occupancy API on the compiled kernel; needs a
// card).  Returns -1 for another `what` or a failed query.
extern "C" int flash_bwd192_geometry(int what) {
  using L = tc::PairSmem<192>;
  switch (what) {
    case 0: return tc::kPairN;
    case 1: return tc::kPair;
    case 2: return L::kBytes;
    case 3: return tc::kBwdThreads;
    case 4: return (int)tc::kL2Chunk;
    case 5: {
      const auto kernel = tc::flash_bwd_wgmma_pair_kernel<192, false>;
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes) != cudaSuccess)
        return -1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(tc::kPair * 1024, 1, 1);
      cfg.blockDim = dim3(tc::kBwdThreads, 1, 1);
      cfg.dynamicSmemBytes = L::kBytes;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
          cudaSuccess)
        return -1;
      return clusters;
    }
  }
  return -1;
}

// The hd-192 forward's geometry, read by the tests against the Python
// plan (flash_attention.py::fwd192_plan): what = 0 query rows a CTA, 1 kv
// rows a stage, 2 stages of each ring, 3 threads a CTA, 4 dynamic shared
// memory bytes, 5 CTAs an SM keeps resident (the occupancy API on the
// compiled kernel; needs a card).  Returns -1 for another `what` or a
// failed query.
extern "C" int flash_fwd192_geometry(int what) {
  using L = tc::SkSmem<192>;
  switch (what) {
    case 0: return tc::kM;
    case 1: return tc::kSkN;
    case 2: return tc::kSkStages;
    case 3: return tc::kThreads;
    case 4: return L::kBytes;
    case 5: {
      const auto kernel = tc::flash_fwd_wgmma_skip_kernel<192, false>;
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes) != cudaSuccess)
        return -1;
      int ctas = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &ctas, kernel, tc::kThreads, L::kBytes) != cudaSuccess)
        return -1;
      return ctas;
    }
  }
  return -1;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
