"""Shared layers — norms, MLPs, embeddings, RoPE, the loss (port of
``repro.models.layers``).

SP flow (training / prefill): the residual is [B, S_loc, D] (sequence
sharded over ``model``), ring ops work on the S-major [S_loc * B, D]
layout, and weights are FSDP-gathered on use.  Decode flow ("TP-2D"): the
residual is [B, D_loc(data)], the batch is replicated, and the
feature/vocab contractions close with managed all-reduces over ``data`` /
``model``.  The embedding, the loss and the greedy pick are
vocab-parallel over ``model``.  At axis size 1 every collective and
gather is the identity (core/managed.py, core/overlap.py), so each
function below is the plain one-device computation.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import instrument, managed
from repro_torch.core.overlap import fsdp_gather
from repro_torch.parallel.sharding import MeshCtx

# ---------------------------------------------------------------------------
# Layout shuffles between [B, S_loc, D] and the S-major ring layout
# ---------------------------------------------------------------------------


def to_ring(x: torch.Tensor) -> torch.Tensor:
    """[B, S_loc, D] -> [S_loc*B, D] (S-major)."""
    b, s, d = x.shape
    return x.transpose(0, 1).reshape(s * b, d)


def from_ring(x2: torch.Tensor, batch: int) -> torch.Tensor:
    """[S*B, D] -> [B, S, D]."""
    sb, d = x2.shape
    return x2.reshape(sb // batch, batch, d).transpose(0, 1)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rms_norm_sharded(x: torch.Tensor, scale_loc: torch.Tensor, eps: float,
                     axis_name: str, ctx: MeshCtx) -> torch.Tensor:
    """RMSNorm over a feature dim sharded across ``axis_name`` (decode
    flow): only the scalar sum-of-squares crosses the link."""
    xf = x.float()
    ssq = (xf * xf).sum(dim=-1, keepdim=True)
    d_total = x.shape[-1] * ctx.axis_sizes.get(axis_name, 1)
    var = managed.managed_all_reduce(ssq, axis_name, ctx) / d_total
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale_loc.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def _silu(u: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * sigmoid(x), the sigmoid rounded to x's type."""
    return u * torch.sigmoid(u)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def _rounded_const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s type, a 0-d tensor on its device made
    by a fill: a copy from host memory would stop a CUDA graph capture."""
    return torch.full((), _rounded(value, like.dtype), dtype=like.dtype,
                      device=like.device)


def _gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default (tanh) form op by op in u's type, its
    constants rounded to that type — the reference's rounding in bf16,
    where torch's fused GELU rounds once and differs in about 40% of the
    elements by an ulp."""
    c = _rounded_const(math.sqrt(2.0 / math.pi), u)
    k = _rounded_const(0.044715, u)
    return u * (0.5 * (1.0 + torch.tanh(c * (u + k * u ** 3))))


def activation(name: str, u: torch.Tensor,
               g: torch.Tensor | None) -> torch.Tensor:
    """Gated (u = gate, g = linear) or plain activation, with jax.nn's
    formulas and rounding (GELU is the tanh approximation, jax.nn.gelu's
    default)."""
    if name == "swiglu":
        return _silu(u) * g
    if name == "geglu":
        return _gelu_tanh(u) * g
    if name == "relu2":
        r = F.relu(u)
        return r * r
    if name == "gelu":
        return _gelu_tanh(u)
    raise ValueError(name)


def gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def mlp_block_sp(x: torch.Tensor, params: dict, cfg: ModelConfig,
                 ctx: MeshCtx) -> torch.Tensor:
    """Dense MLP, SP flow: AG-matmul up (+gate in the same ring), local
    activation, matmul-RS down.  x: [B, S_loc, D] -> same."""
    b = x.shape[0]
    w_up = fsdp_gather(params["w_up"], "data", ctx, mode=ctx.mdmp_mode)
    w_down = fsdp_gather(params["w_down"], "data", ctx, axis=1,
                         mode=ctx.mdmp_mode)
    x2 = to_ring(x)
    if gated(cfg.mlp):
        w_gate = fsdp_gather(params["w_gate"], "data", ctx,
                             mode=ctx.mdmp_mode)
        u, g = managed.all_gather_matmul_multi(x2, [w_up, w_gate], "model",
                                               ctx, mode=ctx.mdmp_mode)
        h = activation(cfg.mlp, u, g)
    else:
        u2 = managed.all_gather_matmul(x2, w_up, "model", ctx,
                                       mode=ctx.mdmp_mode)
        h = activation(cfg.mlp, u2, None)
    y2 = managed.matmul_reduce_scatter(h, w_down, "model", ctx,
                                       mode=ctx.mdmp_mode)
    return from_ring(y2.to(x.dtype), b)


def mlp_block_decode(x: torch.Tensor, params: dict, cfg: ModelConfig,
                     ctx: MeshCtx) -> torch.Tensor:
    """Dense MLP, decode flow: x [B, D_loc(data)] -> same.
    Weight-stationary: contract the FSDP dim with psum('data'), come back
    with psum('model')."""
    if gated(cfg.mlp):
        ug = managed.managed_all_reduce(
            torch.cat([x @ params["w_up"], x @ params["w_gate"]], dim=-1),
            "data", ctx, mode=ctx.mdmp_mode)
        uu, g = ug.chunk(2, dim=-1)
        h = activation(cfg.mlp, uu, g)
    else:
        u = managed.managed_all_reduce(x @ params["w_up"], "data", ctx,
                                       mode=ctx.mdmp_mode)
        h = activation(cfg.mlp, u, None)
    y = managed.managed_all_reduce(h @ params["w_down"], "model", ctx,
                                   mode=ctx.mdmp_mode)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / logits / sampling
# ---------------------------------------------------------------------------


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``tokens`` — the reference's one-hot
    contraction without the [..., V] one-hot.  A token outside the table
    (another model rank's vocab block) gives zeros, as its all-zero
    one-hot does (an out-of-range index would be a device-side assert on
    CUDA)."""
    v = table.shape[0]
    tok = tokens.long()
    inside = (tok >= 0) & (tok < v)
    return table[tok.clamp(0, v - 1)] * inside[..., None].to(table.dtype)


def embed_sp(tokens: torch.Tensor, table_loc: torch.Tensor,
             cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """Vocab-parallel lookup fused with the sequence scatter: tokens [B, S]
    (replicated over model) -> x [B, S_loc, D].  Above tp=1 it is the
    reference's one-hot(tokens) @ table, whose contraction (the vocab) is
    sharded over ``model``: a matmul-reduce-scatter.  At tp=1 it is a row
    lookup, whose gradient scatters into the table rows."""
    if table_loc.shape[-1] != cfg.d_model:
        table_loc = fsdp_gather(table_loc, "data", ctx, axis=1,
                                mode=ctx.mdmp_mode)
    if ctx.tp == 1:
        return _lookup(table_loc, tokens)
    b, s = tokens.shape
    v_loc = table_loc.shape[0]
    tok2 = tokens.t().reshape(s * b).long() - ctx.axis_index("model") * v_loc
    onehot = table_loc.new_zeros((s * b, v_loc))
    onehot[torch.arange(s * b, device=tokens.device),
           tok2.clamp(0, v_loc - 1)] = ((tok2 >= 0) & (tok2 < v_loc)).to(
               table_loc.dtype)
    x2 = managed.matmul_reduce_scatter(onehot, table_loc, "model", ctx,
                                       mode=ctx.mdmp_mode)
    return from_ring(x2, b)


class _LogitsF32(torch.autograd.Function):
    """[N, D] @ [D, V] -> [N, V] f32 with f32 accumulation of low-precision
    operands.  On CUDA (and on meta tensors, which stand for the card in a
    dry run) the forward is ``aten::mm.dtype`` (no f32 copy of the
    [D, V] unembedding); torch has no derivative for it, so the backward
    is written here and keeps bf16 products, as a bf16 matmul's would.  On
    the CPU, which has no ``mm.dtype``, the forward upcasts the chunk's
    operands."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if instrument.on_card(x2):
            return torch.mm(x2, w, out_dtype=torch.float32)
        return x2.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.t(), x2.t() @ g


def logits_f32(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] in f32 of ``xs`` [..., D] against ``w`` [D, V]: the
    f32 accumulator of the operands' product, as the reference's
    ``jnp.dot(..., preferred_element_type=jnp.float32)``."""
    if xs.dtype == torch.float32 and w.dtype == torch.float32:
        return xs @ w
    out = _LogitsF32.apply(xs.reshape(-1, xs.shape[-1]), w)
    return out.reshape(*xs.shape[:-1], w.shape[1])


def lm_loss_sp(x: torch.Tensor, unembed_loc: torch.Tensor,
               tokens: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx, *,
               chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over vocab-parallel logits, chunked over the sequence
    so the [*, V_loc] logits tensor never fully materialises (as the
    reference, whose chunks cover ``(S // chunk') * chunk'`` positions).

    The final hidden is first gathered over 'model' so that every rank
    holds every position; the logsumexp's statistics and the target logit
    then cross the model axis, the logits do not.

    x: [B, S_loc, D]; unembed_loc: [D_loc(data), V_loc(model)]; tokens:
    [B, S] labels (< 0 are ignored).  Returns (sum_loss / tp, count / tp);
    the caller sums over all axes.  Each chunk's logits keep the f32
    accumulator of the bf16 operands, as the reference's
    ``preferred_element_type=f32`` (``logits_f32``)."""
    b = x.shape[0]
    w = fsdp_gather(unembed_loc, "data", ctx, mode=ctx.mdmp_mode)  # [D, V]
    v_loc = w.shape[1]
    vidx = ctx.axis_index("model") * v_loc
    x_full = from_ring(managed.managed_all_gather(to_ring(x), "model", ctx,
                                                  mode=ctx.mdmp_mode), b)
    s = x_full.shape[1]
    n_chunks = max(1, s // max(chunk, 1))
    chunk = s // n_chunks
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xs = x_full[:, i * chunk:(i + 1) * chunk]
        lbl = tokens[:, i * chunk:(i + 1) * chunk].long()
        logits = logits_f32(xs, w)                          # [B, c, V_loc]
        # the max is a constant shift: detached, as the reference's
        # stop_gradient keeps it out of AD
        lmax = managed.all_reduce_max(
            logits.amax(dim=-1, keepdim=True).detach(), ("model",), ctx)
        lse = torch.log(managed.managed_all_reduce(
            torch.exp(logits - lmax).sum(dim=-1, keepdim=True), "model",
            ctx)) + lmax
        # the target logit: the reference's sum of logits * one-hot, whose
        # one nonzero term lives on the rank that holds the label's block
        loc = lbl - vidx
        inside = (loc >= 0) & (loc < v_loc)
        tgt = managed.managed_all_reduce(
            logits.gather(-1, loc.clamp(0, v_loc - 1)[..., None])
            * inside[..., None], "model", ctx)
        nll = (lse - tgt)[..., 0]
        valid = (lbl >= 0).float()
        loss_sum = loss_sum + (nll * valid).sum()
        count = count + valid.sum()
    return loss_sum / ctx.tp, count / ctx.tp


def embed_decode(tokens: torch.Tensor, table_loc: torch.Tensor,
                 cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """Decode-flow lookup: tokens [B] (replicated) -> x [B, D_loc(data)].
    table_loc: [V_loc(model), D_loc(data)]; each model rank looks up its
    vocab block (zeros elsewhere) and the blocks sum over 'model'."""
    v_loc = table_loc.shape[0]
    part = _lookup(table_loc, tokens.long() - ctx.axis_index("model") * v_loc)
    return managed.managed_all_reduce(part, "model", ctx,
                                      mode=ctx.mdmp_mode)


def logits_decode(x: torch.Tensor, unembed_loc: torch.Tensor,
                  ctx: MeshCtx) -> torch.Tensor:
    """Decode-flow logits: x [B, D_loc(data)] @ W_un [D_loc, V_loc(model)]
    -> psum('data') -> [B, V_loc(model)]."""
    return managed.managed_all_reduce(x @ unembed_loc, "data", ctx,
                                      mode=ctx.mdmp_mode)


def greedy_sample(logits_loc: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Greedy decode across vocab-parallel logits [B, V_loc(model)]: the
    lowest global index among the maxima (``torch.argmax`` returns the
    first maximum), int32, on the device."""
    arg = torch.argmax(logits_loc, dim=-1).to(torch.int32)
    if ctx.tp == 1:
        return arg
    local_max = logits_loc.amax(dim=-1)
    gmax = managed.all_reduce_max(local_max, ("model",), ctx)
    local_arg = arg + ctx.axis_index("model") * logits_loc.shape[-1]
    cand = torch.where(local_max >= gmax, local_arg,
                       torch.iinfo(torch.int32).max)
    return managed.all_reduce_min(cand, ("model",), ctx)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] (global positions).  Rotate-half
    (not interleaved), computed in f32 and cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]               # [1, S, 1, hd/2]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope_slots(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """Per-slot RoPE for the serving decode flow: every batch row sits at
    its OWN position.  x: [B, H, hd]; positions: [B].  The batch axis
    plays apply_rope's position axis — the same rotation."""
    return apply_rope(x[None], positions, theta)[0]
