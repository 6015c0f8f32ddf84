"""The plain reference of the decoder configurations: float32 PyTorch,
no kernels, no cache, no batching across requests.

It follows the published description with the departures its
configuration file lists: RMSNorm scaling by ``1 + w``; RoPE rotating
half of each head over the whole head; grouped-query attention where
head ``h`` reads key and value head ``h // (H / KV)``; a SwiGLU MLP
``silu(x w_up) * (x w_gate) w_down``.

``lowp=True`` is the control, the nearest precision below the
configurations' bfloat16: both operands of every weight product are
rounded to float8 (e4m3, one scale a tensor) before an f32 product.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest
    magnitude at 448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Decoder:
    """A decoder of ``arch`` (a configuration file's ``arch``) over
    float32 weights in the published layout (``reference.weights``)."""

    def __init__(self, arch: dict, weights: dict[str, torch.Tensor], *,
                 lowp: bool = False):
        self.arch = arch
        self.w = weights
        self.lowp = lowp

    # -- pieces -----------------------------------------------------------

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.lowp:
            return _fp8(x) @ _fp8(w)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.arch["norm_eps"]) * (1.0 + scale)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, H, hd] at positions 0..S-1."""
        hd = x.shape[-1]
        inv = 1.0 / (self.arch["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device)
            / hd))
        ang = torch.arange(x.shape[1], dtype=torch.float32,
                           device=x.device)[:, None] * inv[None]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, x: torch.Tensor, l: int) -> torch.Tensor:
        a, w = self.arch, self.w
        b, s, _ = x.shape
        h, kv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
        q = self.rope(self.mm(x, w["layers/w_q"][l]).view(b, s, h, hd))
        k = self.rope(self.mm(x, w["layers/w_k"][l]).view(b, s, kv, hd))
        v = self.mm(x, w["layers/w_v"][l]).view(b, s, kv, hd)
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * hd)
        return self.mm(o, w["layers/w_o"][l])

    def mlp(self, x: torch.Tensor, l: int) -> torch.Tensor:
        w = self.w
        u = self.mm(x, w["layers/w_up"][l])
        g = self.mm(x, w["layers/w_gate"][l])
        return self.mm(F.silu(u) * g, w["layers/w_down"][l])

    # -- the model ----------------------------------------------------------

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> final-normed hidden [B, S, D]."""
        w = self.w
        x = w["embed"][tokens.long()]
        for l in range(self.arch["n_layers"]):
            x = x + self.attention(self.norm(x, w["layers/ln1"][l]), l)
            x = x + self.mlp(self.norm(x, w["layers/ln2"][l]), l)
        return self.norm(x, w["final_ln"])

    def unembed(self) -> torch.Tensor:
        w = self.w
        return w["embed"].T if self.arch["tie_embeddings"] else w["unembed"]

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [S, V] of one sequence [S]."""
        x = self.hidden(tokens[None])
        return self.mm(x[0], self.unembed())
