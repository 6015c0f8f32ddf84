"""Flash attention — hand-written CUDA kernels + plain PyTorch versions
(port of ``repro.kernels.flash_attention`` and of the blockwise engines
of ``repro.kernels.ops``, the ring-attention carry step included).

Causal / sliding-window GQA attention with an online softmax that never
materialises the [Sq, Skv] logits.  q: [B, Sq, H, hd]; k, v: [B, Skv, KV,
hd]; query head h reads kv head ``h * KV // H``; ``q_offset`` is the
global position of q[0] relative to k[0].

Two engines with identical math, forward and backward:

  * the CUDA kernels ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``), in
    place of the reference's Pallas TPU kernel ``flash_attention_pallas``
    and its jnp flash backward ``ops._flash_bwd_blockwise``.  The forward
    emits the lse beside the output, so the backward needs no second pass
    (see the source's note);
  * ``flash_attention_torch`` / ``flash_attention_bwd_torch`` — the
    blockwise loops of ``ops._blockwise_fwd`` / ``_flash_bwd_blockwise``
    over kv blocks, with ragged kv zero-padded and masked (``_pad_kv``).

The ring-attention carry step folds one kv block into an unnormalised
online-softmax carry ``(m, l, acc)``, with q and k at global offsets:

  * the CUDA kernel (the forward's tiles with the carry loaded before the
    kv loop and stored after it), in place of the reference's Pallas
    kernel ``flash_attention_carry_pallas``;
  * ``flash_attention_step_torch`` — the reference's ``ops._flash_step_jnp``
    loop over kv blocks.

The ring's block backward (the backward of one carry step, with the
caller's dsum and f32 outputs):

  * the CUDA kernels: in bf16 the flash backward's tensor-core kernel with
    the offset difference q_offset - k_offset, in f32 its SIMT kernels,
    in place of the reference's jnp ``ops.flash_attention_bwd_block``;
  * ``flash_attention_bwd_block_torch`` — that function's loop over kv
    blocks.

``flash_attention_fwd`` / ``flash_attention_bwd`` /
``flash_attention_carry`` / ``flash_attention_bwd_block`` dispatch on the
tensor's device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` /
``CARRY_LAUNCHES`` / ``BWD_BLOCK_LAUNCHES`` count wrapper calls that
launched a kernel, so a run can show that its main path went through
them.

Also here: the online-softmax partials combinators.  Public carry layout
(matches q): m, l: [B, Sq, H] f32; acc: [B, Sq, H, hd] f32.  ``out = acc /
l`` and ``lse = m + log(l)`` only at finalize — every intermediate stays
unnormalised so partials from disjoint KV ranges combine with one LSE
merge.  ``NEG_INF`` is finite, so fully masked rows give zeros, not NaN.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import instrument
from repro_torch.kernels import build

NEG_INF = -1e30

Partials = tuple[torch.Tensor, torch.Tensor, torch.Tensor]

#: forward / backward / carry-step / block-backward wrapper calls that
#: launched their kernels since the counts were last set to 0
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
CARRY_LAUNCHES = 0
BWD_BLOCK_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels are compiled for: the tensor-core kernels (bf16)
#: take ``TC_HEAD_DIMS``; the SIMT kernels take every one, and run bf16 at
#: the others (16: the reduced configs); 192 is nemotron-4-340b's
KERNEL_HEAD_DIMS = (16, 64, 128, 192)
TC_HEAD_DIMS = (64, 128, 192)

#: the bf16 backward's geometry at head_dim 192 (``csrc/flash_attention.cu``,
#: ``flash_bwd_wgmma_pair_kernel``): kv rows a CTA, CTAs a cluster (two
#: adjacent kv tiles share every Q / dO tile), threads a CTA, its dynamic
#: shared memory (``PairSmem<192>::kBytes``), query rows a tile, and the
#: bytes of Q and dO (bf16) and dQ (f32) a chunk of its launch order may
#: keep in L2 (``kL2Chunk``).  A variant is a source edit of both;
#: ``bwd192_built`` reads the library's and the card tests hold them equal
BWD192_KV_ROWS = 64
BWD192_CLUSTER = 2
BWD192_THREADS = 256
BWD192_SMEM = 231464
BWD192_Q_ROWS = 64
BWD192_L2_CHUNK = 32 << 20

#: the bf16 forward and carry step's geometry at head_dim 192
#: (``flash_fwd_wgmma_skip_kernel``): query rows a CTA (64 a consumer
#: warpgroup), kv rows a stage, stages of the K and V rings, threads a CTA
#: (a producer and two consumer warpgroups) and its dynamic shared memory
#: (``SkSmem<192>::kBytes``).  A variant is a source edit of both;
#: ``fwd192_built`` reads the library's and the card tests hold them equal
FWD192_Q_ROWS = 128
FWD192_KV_ROWS = 64
FWD192_STAGES = 2
FWD192_THREADS = 384
FWD192_SMEM = 148552


# ---------------------------------------------------------------------------
# The least work of each kernel entry (the one definition the dry run,
# launch/hlo.py, and the card's roofline bounds read)
# ---------------------------------------------------------------------------


def attended_pairs(sq: int, skv: int, *, causal: bool, window: int = 0,
                   q_offset: int = 0, k_offset: int = 0) -> int:
    """The unmasked (query, key) pairs of one batch row and head: query i
    at position ``q_offset + i`` attends key j at ``k_offset + j`` (j <
    ``skv``) where causal allows (key <= query) and the window does
    (query - key < window), as ``_step_mask``.  Host arithmetic only: it
    runs under the dry run's recorder."""
    if sq <= 0 or skv <= 0:
        return 0
    qpos = np.arange(sq, dtype=np.int64) + int(q_offset)
    hi = np.full(sq, int(k_offset) + skv - 1, dtype=np.int64)
    lo = np.full(sq, int(k_offset), dtype=np.int64)
    if causal:
        hi = np.minimum(hi, qpos)
    if window > 0:
        lo = np.maximum(lo, qpos - int(window) + 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(kind: str, b: int, sq: int, skv: int, h: int, kvh: int,
               hd: int, itemsize: int, *, causal: bool = True,
               window: int = 0, q_offset: int = 0, k_offset: int = 0
               ) -> tuple[int, int]:
    """(flops, bytes) of one call of ``kind`` — "fwd", "bwd", "carry" or
    "bwd_block" — over q [B, Sq, H, hd] and k, v [B, Skv, KV, hd] of
    ``itemsize`` bytes: the function's least work, however a kernel runs
    it.  Flops: QK^T and PV, 2 each per unmasked (pair, hd) (forward and
    carry: 4); the backward's recomputed QK^T, dP, dV, dK and dQ (10).
    Bytes: each input read once and each output written once — forward q,
    k, v in, out and the f32 lse out; backward q, k, v, out, dout and lse
    in, dq, dk, dv out; carry q, k, v in and the f32 (m, l, acc) read and
    written; block backward q, dout, k, v, lse and dsum in and f32 dq, dk,
    dv out."""
    pairs = b * h * attended_pairs(sq, skv, causal=causal, window=window,
                                   q_offset=q_offset, k_offset=k_offset)
    q_bytes = b * sq * h * hd * itemsize
    kv_bytes = 2 * b * skv * kvh * hd * itemsize
    row_f32 = b * sq * h * 4
    if kind == "fwd":
        return 4 * pairs * hd, 2 * q_bytes + kv_bytes + row_f32
    if kind == "bwd":
        return 10 * pairs * hd, 4 * q_bytes + 2 * kv_bytes + row_f32
    if kind == "carry":
        return 4 * pairs * hd, (q_bytes + kv_bytes
                                + 2 * (b * sq * h * hd * 4 + 2 * row_f32))
    if kind == "bwd_block":
        return 10 * pairs * hd, (2 * q_bytes + kv_bytes + 2 * row_f32
                                 + (b * sq * h * hd + 2 * b * skv * kvh * hd)
                                 * 4)
    raise ValueError(f"unknown flash kernel {kind!r}")


class Bwd192Cluster(NamedTuple):
    """One cluster of the hd-192 backward: kv rows [k0, k0 + 128) of head
    ``h`` of batch row ``b``; CTA r of it holds rows k0 + 64 r.. and
    computes on query tiles ``tiles[r]`` = [t0, t1) of 64 rows (empty
    where it has no rows or nothing sees them); both CTAs step through
    ``union``, loading each tile once for both."""
    b: int
    h: int
    k0: int
    tiles: tuple[tuple[int, int], tuple[int, int]]
    union: tuple[int, int]


class Bwd192Plan(NamedTuple):
    """How one hd-192 bf16 backward (or block backward) call runs on the
    card: the kernel's geometry, the launch order of its clusters, the
    units of (batch row, head) a chunk of that order interleaves, and the
    clusters that ``n_sm`` SMs hold at once (one CTA an SM)."""
    kv_rows: int
    cluster: int
    threads: int
    smem: int
    chunk: int
    resident: int
    clusters: tuple[Bwd192Cluster, ...]


def _bwd192_tiles(k0: int, sq: int, skv: int, causal: bool, window: int,
                  q_offset: int) -> tuple[int, int]:
    """Query tiles [t0, t1) that see kv rows [k0, k0 + 64): from the first
    query causality lets see k0 to the last the window lets see the last
    row (the kernel's ``pair_q_tiles``); (0, 0) when none do."""
    if k0 >= skv:
        return 0, 0
    kmax = min(k0 + BWD192_KV_ROWS, skv) - 1
    i_lo = max(0, k0 - q_offset) if causal else 0
    i_hi = min(sq, kmax + window - q_offset) if window > 0 else sq
    if i_hi <= i_lo:
        return 0, 0
    return i_lo // BWD192_Q_ROWS, -(-i_hi // BWD192_Q_ROWS)


def bwd192_plan(b: int, sq: int, skv: int, h: int, kvh: int, causal: bool,
                window: int = 0, q_offset: int = 0, n_sm: int = 132
                ) -> Bwd192Plan:
    """The hd-192 backward's plan for q [b, sq, h, 192] against k, v [b,
    skv, kvh, 192] (``q_offset``: q's position less k's).  Clusters of two
    CTAs on adjacent 64-row kv tiles; the launch order takes the (b, h)
    units, h slowest, in chunks whose Q, dO and dQ (sq x 192 x 8 bytes a
    unit) fit ``BWD192_L2_CHUNK``, one chunk after another, and within a
    chunk the kv pairs lowest first (the most query rows under causality)
    over the chunk's units.  Host arithmetic on the shapes and the SM
    count only."""
    if min(b, sq, skv, h, kvh, n_sm) < 1 or h % kvh:
        raise ValueError("bwd192_plan takes positive sizes and h a "
                         "multiple of kvh")
    units = b * h
    chunk = min(max(1, BWD192_L2_CHUNK // (sq * 192 * 8)), units)
    pair_rows = BWD192_CLUSTER * BWD192_KV_ROWS
    n_pt = -(-skv // pair_rows)
    order = []
    for c0 in range(0, units, chunk):
        for pt in range(n_pt):
            for unit in range(c0, min(c0 + chunk, units)):
                k0 = pt * pair_rows
                tiles = tuple(_bwd192_tiles(k0 + r * BWD192_KV_ROWS, sq, skv,
                                            causal, window, q_offset)
                              for r in range(BWD192_CLUSTER))
                live = [t for t in tiles if t[1] > t[0]]
                union = ((min(t[0] for t in live), max(t[1] for t in live))
                         if live else (0, 0))
                order.append(Bwd192Cluster(unit % b, unit // b, k0, tiles,
                                           union))
    return Bwd192Plan(BWD192_KV_ROWS, BWD192_CLUSTER, BWD192_THREADS,
                      BWD192_SMEM, chunk, n_sm // BWD192_CLUSTER,
                      tuple(order))


class Fwd192Unit(NamedTuple):
    """One CTA of the hd-192 forward or carry step: query rows [q0, q0 +
    128) of head ``h`` of batch row ``b``, over kv tiles [t0, t0 +
    n_tiles) of 64 rows (none: the carry's rows are copied through, the
    forward's written as zeros)."""
    b: int
    h: int
    q0: int
    t0: int
    n_tiles: int


class Fwd192Plan(NamedTuple):
    """How one hd-192 bf16 forward (or carry step) call runs on the card:
    the kernel's geometry, the CTAs ``n_sm`` SMs hold at once (one an SM)
    and the launch order of its CTAs."""
    q_rows: int
    kv_rows: int
    stages: int
    threads: int
    smem: int
    resident: int
    units: tuple[Fwd192Unit, ...]


def fwd192_plan(b: int, sq: int, skv: int, h: int, kvh: int, causal: bool,
                window: int = 0, q_offset: int = 0, n_sm: int = 132
                ) -> Fwd192Plan:
    """The hd-192 forward's plan for q [b, sq, h, 192] against k, v [b,
    skv, kvh, 192] (``q_offset``: q's position less k's): one CTA per (b,
    h, 128 query rows), heads fastest, then batch rows, then query tiles,
    the last (heaviest under causality) first; each over the 64-row kv
    tiles from the first its rows' window lets them see to the last
    causality does (the kernel's ``kv_range``).  Host arithmetic on the
    shapes and the SM count only."""
    if min(b, sq, h, kvh, n_sm) < 1 or skv < 0 or h % kvh:
        raise ValueError("fwd192_plan takes positive sizes and h a "
                         "multiple of kvh")
    n_qt = -(-sq // FWD192_Q_ROWS)
    units = []
    for idx in range(n_qt * b * h):
        hh, rest = idx % h, idx // h
        bb, rest = rest % b, rest // b
        q0 = (n_qt - 1 - rest if causal else rest) * FWD192_Q_ROWS
        qlo = q_offset + q0
        qhi = q_offset + min(q0 + FWD192_Q_ROWS, sq) - 1
        lo = max(0, qlo - window + 1) if window > 0 else 0
        hi = min(skv, qhi + 1) if causal else skv
        t0 = lo // FWD192_KV_ROWS
        n = -(-hi // FWD192_KV_ROWS) - t0 if hi > lo else 0
        units.append(Fwd192Unit(bb, hh, q0, t0, n))
    return Fwd192Plan(FWD192_Q_ROWS, FWD192_KV_ROWS, FWD192_STAGES,
                      FWD192_THREADS, FWD192_SMEM, n_sm, tuple(units))


def _work(kind: str, q: torch.Tensor, k: torch.Tensor, causal: bool,
          window: int, q_offset: int, k_offset: int = 0):
    """A wrapper's launch, as the recorder reads it: ``flash_work`` of
    the call's shapes, evaluated only where a recorder asks."""
    b, sq, h, hd = q.shape
    return lambda: flash_work(kind, b, sq, k.shape[1], h, k.shape[2], hd,
                              q.element_size(), causal=causal,
                              window=window, q_offset=q_offset,
                              k_offset=k_offset)


def init_partials(b: int, sq: int, h: int, hd: int, *,
                  device: torch.device | str) -> Partials:
    """Empty carry: max = -inf (finite sentinel), sum = 0, acc = 0, on
    ``device`` (q's device: a carry on another device than q, k and v is
    refused by the carry step)."""
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=device)
    return m, l, acc


def merge_partials(p1: Partials, p2: Partials) -> Partials:
    """LSE-merge two flash partials over disjoint KV ranges.  Commutative
    and associative up to float rounding; an empty carry (init_partials)
    is the identity."""
    m1, l1, a1 = p1
    m2, l2, a2 = p2
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    l = w1 * l1 + w2 * l2
    acc = w1[..., None] * a1 + w2[..., None] * a2
    return m, l, acc


def finalize_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l, acc) -> (out [B, Sq, H, hd], lse [B, Sq, H])."""
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(out_dtype)
    lse = m + torch.log(l_safe)
    return out, lse


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the blockwise engines of the reference's ops.py)
# ---------------------------------------------------------------------------


def _pad_kv(k: torch.Tensor, v: torch.Tensor, blk: int
            ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Zero-pad ragged kv to a multiple of ``blk``; returns (k, v, skv)."""
    skv = k.shape[1]
    if skv % blk:
        pad = blk - skv % blk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, skv


def _blk_mask(sq: int, blk: int, ki: int, qpos: torch.Tensor,
              skv_valid: int, causal: bool, window: int) -> torch.Tensor:
    kpos = ki * blk + torch.arange(blk, device=qpos.device)
    mask = (kpos < skv_valid)[None, :].expand(sq, blk)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, Sq, H(, hd)] -> [b, kvh, g, sq(, hd)] in f32 (GQA layout)."""
    b, sq, h = x.shape[:3]
    x = x.float().reshape(b, sq, kvh, h // kvh, *x.shape[3:])
    return x.permute(0, 2, 3, 1, 4) if x.dim() == 5 else x.permute(0, 2, 3, 1)


def _ungrouped(x: torch.Tensor) -> torch.Tensor:
    """[b, kvh, g, sq(, hd)] -> [B, Sq, H(, hd)]."""
    b, kvh, g, sq = x.shape[:4]
    if x.dim() == 4:
        return x.permute(0, 3, 1, 2).reshape(b, sq, kvh * g)
    return x.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, x.shape[-1])


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, blk_kv: int = 512
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax forward over kv blocks of ``blk_kv`` (port of
    ``ops._blockwise_fwd``).  Returns (out [B, Sq, H, hd] in q's type,
    lse [B, Sq, H] f32)."""
    b, sq, h, hd = q.shape
    k, v, skv_valid = _pad_kv(k, v, max(1, min(blk_kv, k.shape[1])))
    skv = k.shape[1]
    blk = max(1, min(blk_kv, skv))
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = _grouped(q, kvh) * scale                    # [b,kvh,g,sq,hd]
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full(qf.shape[:4], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for ki in range(skv // blk):
        ks = k[:, ki * blk:(ki + 1) * blk].float()
        vs = v[:, ki * blk:(ki + 1) * blk].float()
        logits = torch.einsum("bkgqd,bskd->bkgqs", qf, ks)
        mask = _blk_mask(sq, blk, ki, qpos, skv_valid, causal, window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                    p, vs)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = _ungrouped(acc / l_safe[..., None]).to(q.dtype)
    lse = _ungrouped(m + torch.log(l_safe))
    return out, lse


def _step_mask(sq: int, blk: int, ki: int, qpos: torch.Tensor, k_offset: int,
               skv_valid: int, causal: bool, window: int) -> torch.Tensor:
    """The mask of kv sub-block ``ki`` when q and k both sit at global
    offsets (the reference's ``ops._step_mask``); ``skv_valid`` masks the
    zero padding of ragged kv."""
    kloc = ki * blk + torch.arange(blk, device=qpos.device)
    kpos = k_offset + kloc
    mask = (kloc < skv_valid)[None, :].expand(sq, blk)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def flash_attention_step_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, m: torch.Tensor,
                               l: torch.Tensor, acc: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               q_offset: int = 0, k_offset: int = 0,
                               blk_kv: int = 512) -> Partials:
    """One carry step in plain torch (port of ``ops._flash_step_jnp``):
    fold k, v [B, Skv, KV, hd] into the carry (m, l [B, Sq, H], acc [B,
    Sq, H, hd], f32) over kv blocks of ``blk_kv``, ragged kv zero-padded
    and masked.  Returns the new carry; the inputs are not modified."""
    b, sq, h, hd = q.shape
    k, v, skv_valid = _pad_kv(k, v, max(1, min(blk_kv, k.shape[1])))
    skv = k.shape[1]
    blk = max(1, min(blk_kv, skv))
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = _grouped(q, kvh) * scale                    # [b,kvh,g,sq,hd]
    qpos = q_offset + torch.arange(sq, device=q.device)
    mc, lc, ac = _grouped(m, kvh), _grouped(l, kvh), _grouped(acc, kvh)
    for ki in range(skv // blk):
        ks = k[:, ki * blk:(ki + 1) * blk].float()
        vs = v[:, ki * blk:(ki + 1) * blk].float()
        logits = torch.einsum("bkgqd,bskd->bkgqs", qf, ks)
        mask = _step_mask(sq, blk, ki, qpos, k_offset, skv_valid, causal,
                          window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(mc, logits.amax(dim=-1))
        alpha = torch.exp(mc - m_new)
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        lc = alpha * lc + p.sum(dim=-1)
        ac = ac * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                  vs)
        mc = m_new
    return _ungrouped(mc), _ungrouped(lc), _ungrouped(ac)


def flash_attention_bwd_torch(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              q_offset: int = 0, blk_kv: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Flash backward: recompute p per kv block from (q, k, lse) (port of
    ``ops._flash_bwd_blockwise``, which is the block backward below with
    k at offset 0 and dsum = sum(dout * out)).  Returns (dq in q's type,
    dk, dv in k's and v's types)."""
    dsum = (dout.float() * out.float()).sum(dim=-1)
    dq, dk, dv = flash_attention_bwd_block_torch(
        q, k, v, dout, lse, dsum, causal=causal, window=window,
        q_offset=q_offset, blk_kv=blk_kv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_block_torch(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, dout: torch.Tensor,
                                    lse: torch.Tensor, dsum: torch.Tensor, *,
                                    causal: bool, window: int = 0,
                                    q_offset: int = 0, k_offset: int = 0,
                                    blk_kv: int = 512
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Backward of one carry step in plain torch (port of the reference's
    ``ops.flash_attention_bwd_block``), recomputing p from (q, k, lse)
    over kv blocks of ``blk_kv``.  q, dout: [B, Sq, H, hd]; k, v: [B, Skv,
    KV, hd]; lse, dsum: [B, Sq, H] (dsum = sum(dout * out, -1), computed
    once by the caller).  Returns f32 (dq contribution, dk, dv)."""
    b, sq, h, hd = q.shape
    k, v, skv_valid = _pad_kv(k, v, max(1, min(blk_kv, k.shape[1])))
    skv = k.shape[1]
    blk = max(1, min(blk_kv, skv))
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = _grouped(q, kvh)                            # [b,kvh,g,sq,hd]
    do = _grouped(dout, kvh)
    lse_g = _grouped(lse, kvh)
    dsum_g = _grouped(dsum, kvh)
    qpos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for ki in range(skv // blk):
        ks = k[:, ki * blk:(ki + 1) * blk].float()
        vs = v[:, ki * blk:(ki + 1) * blk].float()
        logits = torch.einsum("bkgqd,bskd->bkgqs", qf * scale, ks)
        mask = _step_mask(sq, blk, ki, qpos, k_offset, skv_valid, causal,
                          window)
        p = torch.where(mask, torch.exp(logits - lse_g[..., None]), 0.0)
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, do))
        dp = torch.einsum("bkgqd,bskd->bkgqs", do, vs)
        ds = p * (dp - dsum_g[..., None]) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, ks)
        dks.append(torch.einsum("bkgqs,bkgqd->bskd", ds, qf))
    dk = (torch.cat(dks, dim=1) if dks
          else k.new_zeros(k.shape, dtype=torch.float32))
    dv = (torch.cat(dvs, dim=1) if dvs
          else v.new_zeros(v.shape, dtype=torch.float32))
    return _ungrouped(dq), dk[:, :skv_valid], dv[:, :skv_valid]


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_launch.argtypes = [
            i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_bwd_launch.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
            i, i, f, p]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_block_launch.argtypes = [
            i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
            f, p]
        lib.flash_attention_bwd_block_launch.restype = i
        lib.flash_attention_carry_launch.argtypes = [
            i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f,
            p]
        lib.flash_attention_carry_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_bwd192_geometry.argtypes = [i]
        lib.flash_bwd192_geometry.restype = i
        lib.flash_fwd192_geometry.argtypes = [i]
        lib.flash_fwd192_geometry.restype = i
    return lib


def bwd192_built() -> dict[str, int]:
    """The built hd-192 backward's geometry, read from the library: kv
    rows a CTA, CTAs a cluster, dynamic shared memory, threads a CTA, the
    L2 chunk's bytes, and the clusters the card keeps resident at once
    (the occupancy API on the compiled kernel; needs a card)."""
    lib = _lib()
    keys = ("kv_rows", "cluster", "smem", "threads", "l2_chunk", "resident")
    got = {key: lib.flash_bwd192_geometry(what)
           for what, key in enumerate(keys)}
    if min(got.values()) < 0:
        raise RuntimeError(f"flash_bwd192_geometry: {got}")
    return got


def fwd192_built() -> dict[str, int]:
    """The built hd-192 forward's geometry, read from the library: query
    rows a CTA, kv rows a stage, stages, threads a CTA, dynamic shared
    memory, and the CTAs an SM keeps resident (the occupancy API on the
    compiled kernel; needs a card)."""
    lib = _lib()
    keys = ("q_rows", "kv_rows", "stages", "threads", "smem", "resident")
    got = {key: lib.flash_fwd192_geometry(what)
           for what, key in enumerate(keys)}
    if min(got.values()) < 0:
        raise RuntimeError(f"flash_fwd192_geometry: {got}")
    return got


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rest: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be [B, Sq, H, hd] and k, v [B, Skv, KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(k.shape)}")
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    devs = {t.device for t in (q, k, v, *rest)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def _check_kernel_inputs(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"no flash-attention kernel for {q.device}")
    _check_operands(q, *tensors)


def _check_operands(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take — types, head dims, contiguity — checked on
    the card and on abstract (meta) tensors alike, so a dry run refuses
    what the card refuses."""
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise TypeError(f"the kernels take f32 or bf16 q, k, v of one type; "
                        f"got {q.dtype}, "
                        f"{[t.dtype for t in tensors]}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernels are built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}; got {q.shape[3]}")
    if not all(t.is_contiguous() for t in (q, *tensors)):
        raise ValueError("the kernels take contiguous tensors")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _tensor_cores(q: torch.Tensor) -> bool:
    """True where the backward takes the bf16 tensor-core kernel, False
    where it takes the SIMT kernels."""
    return q.dtype == torch.bfloat16 and q.shape[3] in TC_HEAD_DIMS


def _bwd_scratch(q: torch.Tensor) -> torch.Tensor:
    """The backward launchers' f32 scratch: dsum [B, Sq, H] for the SIMT
    kernels; lse and dsum per head, [B, H, 2, Sq padded to 64], for the
    tensor-core kernel's bulk loads."""
    b, sq, h = q.shape[:3]
    shape = (b, h, 2, -(-sq // 64) * 64) if _tensor_cores(q) else (b, sq, h)
    return torch.empty(shape, dtype=torch.float32, device=q.device)


def _raise_on(lib: ctypes.CDLL, err: int, which: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {which} kernel launch failed: "
                           f"{msg}")


def _check_bwd_operands(q, k, v, out, lse, dout) -> None:
    _check_operands(q, k, v, out, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous f32")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, engine: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Sq, H, hd] in q's type, lse [B, Sq, H] f32).

    A CUDA tensor launches the forward kernel; a CPU tensor takes the plain
    version.  ``engine="torch"`` pins the plain version on any device (a
    test-only switch that holds the kernel against it end to end)."""
    global FWD_LAUNCHES
    _check(q, k, v)
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" or q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if instrument.is_meta(q):
        _check_operands(q, k, v)
        return instrument.meta_kernel(
            "flash_attention_fwd", (q, k, v),
            (torch.empty_like(q), q.new_empty(q.shape[:3],
                                              dtype=torch.float32)),
            work=_work("fwd", q, k, causal, window, q_offset))
    _check_kernel_inputs(q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, skv, h, kvh, hd,
            int(q_offset), int(window), int(bool(causal)),
            1.0 / math.sqrt(hd), stream)
    _raise_on(lib, err, "forward")
    FWD_LAUNCHES += 1
    instrument.note_kernel("flash_attention_fwd", (q, k, v), (out, lse),
                           work=_work("fwd", q, k, causal, window, q_offset))
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        engine: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq in q's type, dk, dv in k's type) from the forward's (out, lse)
    and the output gradient ``dout``.  Dispatch as ``flash_attention_fwd``:
    a CUDA tensor launches the backward kernels and counts once (f32, and
    bf16 at head_dim 16: the dsum pre-pass, dK/dV, dQ; bf16 at 64, 128 and
    192: the statistics pass, the tensor-core kernel adding into f32
    workspaces allocated here, the pass into bf16)."""
    global BWD_LAUNCHES
    _check(q, k, v, out, lse, dout)
    if out.shape != q.shape or dout.shape != q.shape \
            or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} "
                         f"and lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" or q.device.type == "cpu":
        return flash_attention_bwd_torch(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
    if instrument.is_meta(q):
        _check_bwd_operands(q, k, v, out, lse, dout)
        return instrument.meta_kernel(
            "flash_attention_bwd", (q, k, v, out, lse, dout),
            (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
            work=_work("bwd", q, k, causal, window, q_offset))
    _check_kernel_inputs(q)
    _check_bwd_operands(q, k, v, out, lse, dout)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = _bwd_scratch(q)
    ws_dq = ws_dk = ws_dv = None
    if _tensor_cores(q):
        ws_dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        if h > kvh:
            ws_dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
            ws_dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _ptr(ws_dq),
            _ptr(ws_dk), _ptr(ws_dv), b, sq, skv, h, kvh, hd, int(q_offset),
            int(window), int(bool(causal)), 1.0 / math.sqrt(hd), stream)
    _raise_on(lib, err, "backward")
    BWD_LAUNCHES += 1
    instrument.note_kernel("flash_attention_bwd", (q, k, v, out, lse, dout),
                           (dq, dk, dv),
                           work=_work("bwd", q, k, causal, window, q_offset))
    return dq, dk, dv


def _check_carry_operands(q, k, v, m, l, acc) -> None:
    _check_operands(q, k, v)
    if not all(t.is_contiguous() for t in (m, l, acc)):
        raise ValueError("the kernels take contiguous tensors")


def flash_attention_carry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          m: torch.Tensor, l: torch.Tensor,
                          acc: torch.Tensor, *, causal: bool = True,
                          window: int = 0, q_offset: int = 0,
                          k_offset: int = 0) -> Partials:
    """One ring-attention step: fold k, v [B, Skv, KV, hd] into the carry
    (m, l [B, Sq, H], acc [B, Sq, H, hd], f32) for q [B, Sq, H, hd].
    ``q_offset`` / ``k_offset`` are the global positions of q[0] and k[0]
    (host integers).  Returns a new carry; the inputs are not modified.

    A CUDA tensor launches the carry kernel (any Sq and Skv, head_dim in
    ``KERNEL_HEAD_DIMS``) or raises; a CPU tensor takes
    ``flash_attention_step_torch``.  The step has no gradient: ring
    attention's autograd Function owns the backward."""
    global CARRY_LAUNCHES
    _check(q, k, v, m, l, acc)
    b, sq, h, hd = q.shape
    if tuple(m.shape) != (b, sq, h) or tuple(l.shape) != (b, sq, h) \
            or tuple(acc.shape) != (b, sq, h, hd):
        raise ValueError(f"carry m {tuple(m.shape)}, l {tuple(l.shape)}, "
                         f"acc {tuple(acc.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError("the carry (m, l, acc) is f32")
    if q.device.type == "cpu":
        return flash_attention_step_torch(
            q, k, v, m, l, acc, causal=causal, window=window,
            q_offset=q_offset, k_offset=k_offset)
    if instrument.is_meta(q):
        _check_carry_operands(q, k, v, m, l, acc)
        return instrument.meta_kernel(
            "flash_attention_carry", (q, k, v, m, l, acc),
            (torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)),
            work=_work("carry", q, k, causal, window, q_offset, k_offset))
    _check_kernel_inputs(q)
    _check_carry_operands(q, k, v, m, l, acc)
    skv, kvh = k.shape[1], k.shape[2]
    m_out, l_out, acc_out = (torch.empty_like(m), torch.empty_like(l),
                             torch.empty_like(acc))
    if acc.numel() == 0:
        return m_out, l_out, acc_out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_carry_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
            l_out.data_ptr(), acc_out.data_ptr(), b, sq, skv, h, kvh, hd,
            int(q_offset), int(k_offset), int(window), int(bool(causal)),
            1.0 / math.sqrt(hd), stream)
    _raise_on(lib, err, "carry")
    CARRY_LAUNCHES += 1
    instrument.note_kernel("flash_attention_carry", (q, k, v, m, l, acc),
                           (m_out, l_out, acc_out),
                           work=_work("carry", q, k, causal, window, q_offset,
                                      k_offset))
    return m_out, l_out, acc_out


def _check_block_operands(q, k, v, dout, lse, dsum) -> None:
    _check_operands(q, k, v, dout)
    if not (lse.is_contiguous() and dsum.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")


def flash_attention_bwd_block(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, dsum: torch.Tensor, *,
                              causal: bool, window: int = 0,
                              q_offset: int = 0, k_offset: int = 0,
                              blk_kv: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Backward of one ring-attention carry step: f32 (dq contribution, dk,
    dv) of q [B, Sq, H, hd] against k, v [B, Skv, KV, hd] at global
    offsets ``q_offset`` / ``k_offset``, from the full forward's lse and
    the caller's dsum (both [B, Sq, H] f32).

    A bf16 CUDA tensor launches the tensor-core backward kernel (head_dim
    in ``TC_HEAD_DIMS``), an f32 one or one at another head_dim in
    ``KERNEL_HEAD_DIMS`` the SIMT backward kernels (any Sq and Skv), or
    raises; a CPU tensor takes
    ``flash_attention_bwd_block_torch`` (kv blocks of ``blk_kv``)."""
    global BWD_BLOCK_LAUNCHES
    _check(q, k, v, dout, lse, dsum)
    b, sq, h, hd = q.shape
    if dout.shape != q.shape or tuple(lse.shape) != (b, sq, h) \
            or tuple(dsum.shape) != (b, sq, h):
        raise ValueError(f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} "
                         f"and dsum {tuple(dsum.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if lse.dtype != torch.float32 or dsum.dtype != torch.float32:
        raise TypeError(f"lse and dsum are f32; got {lse.dtype}, "
                        f"{dsum.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_block_torch(
            q, k, v, dout, lse, dsum, causal=causal, window=window,
            q_offset=q_offset, k_offset=k_offset, blk_kv=blk_kv)
    if instrument.is_meta(q):
        _check_block_operands(q, k, v, dout, lse, dsum)
        return instrument.meta_kernel(
            "flash_attention_bwd_block", (q, k, v, dout, lse, dsum),
            tuple(t.new_empty(t.shape, dtype=torch.float32)
                  for t in (q, k, v)),
            work=_work("bwd_block", q, k, causal, window, q_offset,
                       k_offset))
    _check_kernel_inputs(q)
    _check_block_operands(q, k, v, dout, lse, dsum)
    skv, kvh = k.shape[1], k.shape[2]
    adds = _tensor_cores(q)                # the tensor-core kernel adds
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device) \
        if adds else torch.empty(q.shape, dtype=torch.float32,
                                 device=q.device)
    kv_alloc = torch.zeros if adds and h > kvh else torch.empty
    dk = kv_alloc(k.shape, dtype=torch.float32, device=q.device)
    dv = kv_alloc(v.shape, dtype=torch.float32, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = _bwd_scratch(q) if adds else None
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_block_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), _ptr(scratch),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh,
            hd,
            int(q_offset), int(k_offset), int(window), int(bool(causal)),
            1.0 / math.sqrt(hd), stream)
    _raise_on(lib, err, "block backward")
    BWD_BLOCK_LAUNCHES += 1
    instrument.note_kernel("flash_attention_bwd_block",
                           (q, k, v, dout, lse, dsum), (dq, dk, dv),
                           work=_work("bwd_block", q, k, causal, window,
                                      q_offset, k_offset))
    return dq, dk, dv
