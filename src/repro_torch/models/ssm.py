"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), per rank (port
of ``repro.models.ssm``).

TP: SSD heads are sharded over the ``model`` axis (head count padded to a
TP multiple).  The fused input projection is one all-gather-matmul ring
for ``w_z, w_x, w_bc, w_dt`` (the sequence gathered while the projection
runs); the output projection returns to sequence shards through
matmul-reduce-scatter.  The scan is chunk-parallel within a rank (the
SSD dual form: quadratic-in-chunk attention-like blocks plus an
inter-chunk state recurrence) and moves no byte between ranks.  It has no
TPU kernel in the reference, so it is plain torch here, in f32 op for op
as the reference computes it; the reference's ``lax.scan`` over chunks is
a Python loop.

One deliberate difference: the intra-chunk decay mask is applied BEFORE
the exponent (``exp(where(tri, li, -inf))``).  The reference applies it
after (``where(tri, exp(li), 0)``); above the diagonal ``li`` is a
positive decay sum, which overflows ``exp`` at chunk 256, and the
backward then multiplies a zero cotangent by ``inf``.  The forward is the
same function; the port's gradient stays finite at every chunk size.

Decode: O(1) state update per token (conv ring buffer + SSM state).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.core.overlap import fsdp_gather
from repro_torch.models import layers
from repro_torch.parallel.sharding import MeshCtx


def ssd_dims(cfg: ModelConfig, ctx: MeshCtx) -> dict:
    s = cfg.ssm
    h = cfg.ssm_heads
    h_loc = h // ctx.tp
    p = s.headdim
    return dict(h=h, h_loc=h_loc, p=p, n=s.d_state, conv=s.d_conv,
                chunk=s.chunk, d_inner_loc=h_loc * p)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Chunked SSD scan (per shard-local heads, full sequence)
# ---------------------------------------------------------------------------


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, d_skip: torch.Tensor,
             chunk: int, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked dual form.

    x:     [B, S, H, P]     inputs per head
    dt:    [B, S, H]        softplus-activated step sizes
    a:     [H]              negative decay rates (A = -exp(a_log))
    b_mat: [B, S, N]        input maps (shared across heads, n_groups=1)
    c_mat: [B, S, N]        output maps
    d_skip:[H]              skip connection
    h0:    [B, H, P, N]     initial state
    Returns (y [B, S, H, P] in x's type, final_state [B, H, P, N] f32).

    The sequence splits into ``nc = max(1, S // chunk)`` chunks of
    ``S // nc`` positions, as the reference: a length that is no multiple
    of the chunk runs in fewer, longer chunks, and one that ``nc`` does
    not divide is refused."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = max(1, s // chunk)
    q = s // nc
    if nc * q != s:
        raise ValueError(f"ssd_scan: {s} positions do not split into {nc} "
                         f"chunks of {q}")
    f32 = torch.float32

    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b_mat.reshape(bsz, nc, q, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, n).to(f32)

    da = dtc * a[None, None, None, :]                   # [B,NC,Q,H] (<=0)
    cum = torch.cumsum(da, dim=2)                       # within-chunk cumsum
    seg_end = cum[:, :, -1, :]                          # [B,NC,H]

    # --- intra-chunk (attention-like, lower-triangular decay mask) --------
    # L[i,j] = exp(cum_i - cum_j) for i >= j; masked before the exponent
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,NC,Q,Q,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmask = torch.exp(torch.where(tri[None, None, :, :, None], li,
                                  -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)        # [B,NC,Q,Q]
    w = cb[..., None] * lmask * dtc[:, :, None, :, :]   # [B,NC,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # --- chunk states ------------------------------------------------------
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cum)    # [B,NC,Q,H]
    sc = torch.einsum("bcqn,bcqh,bcqhp->bchpn",
                      bc, decay_to_end * dtc, xc)             # [B,NC,H,P,N]

    # --- inter-chunk recurrence (sequential over chunks) -------------------
    hprev = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    before = []
    for c in range(nc):
        before.append(hprev)
        hprev = (hprev * torch.exp(seg_end[:, c])[:, :, None, None]
                 + sc[:, c])
    h_before = torch.stack(before, dim=1)               # [B,NC,H,P,N]

    # --- inter-chunk contribution ------------------------------------------
    yc_in = torch.einsum("bcqn,bchpn->bcqhp", cc, h_before)
    y_inter = yc_in * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + x.to(f32) * d_skip[None, None, :, None]
    return y.to(x.dtype), hprev


def ssd_decode_step(xt: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bt: torch.Tensor, ct: torch.Tensor, d_skip: torch.Tensor,
                    h_state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  xt: [B,H,P], dt: [B,H], bt/ct: [B,N],
    h_state: [B,H,P,N] f32 -> (y [B,H,P] in xt's type, new state)."""
    f32 = torch.float32
    xt_, dt_, bt_, ct_ = (t.to(f32) for t in (xt, dt, bt, ct))
    da = torch.exp(dt_ * a[None, :])                     # [B,H]
    upd = torch.einsum("bhp,bn->bhpn", xt_ * dt_[..., None], bt_)
    hnew = h_state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", hnew, ct_)
    y = y + xt_ * d_skip[None, :, None]
    return y.to(xt.dtype), hnew


# ---------------------------------------------------------------------------
# Depthwise causal conv over sequence (pre-SSD, on x|B|C channels)
# ---------------------------------------------------------------------------


def causal_conv(u: torch.Tensor, w: torch.Tensor,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """u: [B, S, C]; w: [K, C] depthwise kernel.  Returns (SiLU of the
    conv [B, S, C] in u's type, new conv state [B, K-1, C]: the last K-1
    inputs)."""
    bsz, s, c = u.shape
    k = w.shape[0]
    if state is None:
        state = u.new_zeros((bsz, k - 1, c))
    up = torch.cat([state, u], dim=1)                   # [B, S+K-1, C]
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(k):
        out = out + up[:, i:i + s].float() * w[i][None, None].float()
    return layers._silu(out).to(u.dtype), up[:, s:]


def conv_step(ut: torch.Tensor, w: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token depthwise conv.  ut: [B, C]; state: [B, K-1, C]."""
    window = torch.cat([state, ut[:, None]], dim=1)     # [B, K, C]
    out = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return layers._silu(out).to(ut.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Full Mamba-2 mixer (SP flow and decode flow)
# ---------------------------------------------------------------------------


def _gated_norm(y: torch.Tensor, z: torch.Tensor, params: dict,
                cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """RMSNorm of y * silu(z) over the FULL d_inner (heads sharded over
    'model': only the scalar sum of squares crosses the axis)."""
    return layers.rms_norm_sharded(
        y * layers._silu(z.float()).to(y.dtype), params["norm_w"],
        cfg.norm_eps, "model", ctx)


def mamba_mixer_sp(x: torch.Tensor, params: dict, cfg: ModelConfig,
                   ctx: MeshCtx, *, return_state: bool = False):
    """x: [B, S_loc, D] -> [B, S_loc, D] (and, with ``return_state``, the
    (final SSM state [B, H_loc, P, N] f32, pre-conv tail [B, K-1, di+2N])
    that decode continues from).  Heads sharded over 'model'; the
    in-projection ring gathers the sequence."""
    b = x.shape[0]
    dims = ssd_dims(cfg, ctx)
    h_loc, p, n = dims["h_loc"], dims["p"], dims["n"]

    # w_z/w_x: [D, di] heads sharded over model; w_bc: [D, 2N] replicated
    # over model; w_dt: [D, H] heads sharded.  ONE ring for all four.
    mode = ctx.mdmp_mode
    w_z = fsdp_gather(params["w_z"], "data", ctx, mode=mode)
    w_x = fsdp_gather(params["w_x"], "data", ctx, mode=mode)
    w_bc = fsdp_gather(params["w_bc"], "data", ctx, mode=mode)
    w_dt = fsdp_gather(params["w_dt"], "data", ctx, mode=mode)
    w_out = fsdp_gather(params["w_out"], "data", ctx, axis=1, mode=mode)

    z2, xs2, bc2, dt2 = managed.all_gather_matmul_multi(
        layers.to_ring(x), [w_z, w_x, w_bc, w_dt], "model", ctx, mode=mode)
    z = layers.from_ring(z2, b)                          # [B, S, di]
    xs = layers.from_ring(xs2, b)                        # [B, S, di]
    bc = layers.from_ring(bc2, b)                        # [B, S, 2N]
    dt = layers.from_ring(dt2, b)                        # [B, S, H_loc]
    s_full = z.shape[1]
    di = h_loc * p

    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    xbc, conv_tail = causal_conv(torch.cat([xs, bc], dim=-1), conv_w)
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)

    a = -torch.exp(params["a_log"].float())              # [H_loc]
    dt_act = softplus(dt.float() + params["dt_bias"][None, None])
    y, h_final = ssd_scan(xs.reshape(b, s_full, h_loc, p), dt_act, a,
                          bmat, cmat, params["d_skip"], dims["chunk"])
    y = _gated_norm(y.reshape(b, s_full, di), z, params, cfg, ctx)

    y2 = managed.matmul_reduce_scatter(layers.to_ring(y), w_out, "model",
                                       ctx, mode=mode)
    out = layers.from_ring(y2.to(x.dtype), b)
    if return_state:
        return out, (h_final, conv_tail)
    return out


def mamba_mixer_decode(x: torch.Tensor, state: tuple, params: dict,
                       cfg: ModelConfig, ctx: MeshCtx):
    """One-token mixer.  x: [B, D_loc(data)] (decode flow); state =
    (h_state [B,H_loc,P,N], conv_state [B,K-1,C]).  Weight-stationary:
    the in-projection contracts the FSDP dim with an all-reduce over
    'data', the out-projection over 'model'.  Returns (y, new state)."""
    dims = ssd_dims(cfg, ctx)
    h_loc, p, n = dims["h_loc"], dims["p"], dims["n"]
    di = h_loc * p
    h_state, conv_state = state
    mode = ctx.mdmp_mode

    zxbcdt = managed.managed_all_reduce(
        torch.cat([x @ params["w_z"], x @ params["w_x"], x @ params["w_bc"],
                   x @ params["w_dt"]], dim=-1), "data", ctx, mode=mode)
    z, xs, bmat, cmat, dt = zxbcdt.split([di, di, n, n, h_loc], dim=-1)

    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    xbc, conv_state = conv_step(torch.cat([xs, bmat, cmat], dim=-1), conv_w,
                                conv_state)
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)

    a = -torch.exp(params["a_log"].float())
    dt_act = softplus(dt.float() + params["dt_bias"][None])
    bsz = x.shape[0]
    y, h_state = ssd_decode_step(xs.reshape(bsz, h_loc, p), dt_act, a, bmat,
                                 cmat, params["d_skip"], h_state)
    y = _gated_norm(y.reshape(bsz, di), z, params, cfg, ctx)
    out = managed.managed_all_reduce(y @ params["w_out"], "model", ctx,
                                     mode=mode)
    return out.to(x.dtype), (h_state, conv_state)
