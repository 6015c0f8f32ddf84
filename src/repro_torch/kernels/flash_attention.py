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

import torch

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
#: head dims the kernels are compiled for
KERNEL_HEAD_DIMS = (64, 128)


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
    return lib


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


def _bwd_scratch(q: torch.Tensor) -> torch.Tensor:
    """The backward launchers' f32 scratch: dsum [B, Sq, H] for the f32
    kernels; lse and dsum per head, [B, H, 2, Sq padded to 64], for the
    bf16 kernel's bulk loads."""
    b, sq, h = q.shape[:3]
    shape = (b, sq, h) if q.dtype == torch.float32 else (
        b, h, 2, -(-sq // 64) * 64)
    return torch.empty(shape, dtype=torch.float32, device=q.device)


def _raise_on(lib: ctypes.CDLL, err: int, which: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention {which} kernel launch failed: "
                           f"{msg}")


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
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        engine: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq in q's type, dk, dv in k's type) from the forward's (out, lse)
    and the output gradient ``dout``.  Dispatch as ``flash_attention_fwd``:
    a CUDA tensor launches the backward kernels and counts once (f32: the
    dsum pre-pass, dK/dV, dQ; bf16: the statistics pass, the tensor-core
    kernel adding into f32 workspaces allocated here, the pass into
    bf16)."""
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
    _check_kernel_inputs(q, k, v, out, dout)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("lse must be contiguous f32")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = _bwd_scratch(q)
    ws_dq = ws_dk = ws_dv = None
    if q.dtype == torch.bfloat16:
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
    return dq, dk, dv


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
    _check_kernel_inputs(q, k, v)
    if not all(t.is_contiguous() for t in (m, l, acc)):
        raise ValueError("the kernels take contiguous tensors")
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
    return m_out, l_out, acc_out


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

    A bf16 CUDA tensor launches the tensor-core backward kernel, an f32
    one the SIMT backward kernels (any Sq and Skv, head_dim in
    ``KERNEL_HEAD_DIMS``), or raises; a CPU tensor takes
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
    _check_kernel_inputs(q, k, v, dout)
    if not (lse.is_contiguous() and dsum.is_contiguous()):
        raise ValueError("the kernels take contiguous tensors")
    skv, kvh = k.shape[1], k.shape[2]
    adds = q.dtype == torch.bfloat16       # the tensor-core kernel adds
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
    return dq, dk, dv
