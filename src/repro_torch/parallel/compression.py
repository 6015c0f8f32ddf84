"""Gradient compression for the thin cross-pod links: int8 quantisation
with error feedback (port of ``repro.parallel.compression``).

``compressed_psum(g, axis, ctx, err)``: quantise (g + err) to int8 with a
per-tensor scale, exchange the int8 payload and the scales with an
all-gather (summing happens after dequantisation, so no int8 overflow),
and keep the local quantisation residual as the next step's error
feedback.  Bytes on the wire: n * (size/4 + 4) vs n * size for an f32
ring — about 4x less.
"""

from __future__ import annotations

import torch

from repro_torch.core import managed
from repro_torch.parallel.sharding import MeshCtx


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 0-d scale) with ``absmax / 127`` as the scale."""
    absmax = torch.max(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, axis_name: str, ctx: MeshCtx,
                    err: torch.Tensor | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 sum of ``g`` across ``axis_name``.  Returns
    (summed grad, f32-accurate up to quantisation; new error)."""
    g32 = g.to(torch.float32)
    if err is not None and err.shape == g.shape:
        g32 = g32 + err.to(torch.float32)
    q, scale = quantize_int8(g32)
    new_err = (g32 - dequantize_int8(q, scale)).to(g.dtype)

    n = ctx.axis_sizes.get(axis_name, 1)
    # exchange int8 payloads; dequantise with each sender's scale, then sum
    q_all = managed.managed_all_gather(q[None], axis_name, ctx)   # [n, ...]
    s_all = managed.managed_all_gather(scale.reshape(1), axis_name, ctx)
    deq = q_all.to(torch.float32) * s_all.reshape((n,) + (1,) * q.dim())
    total = torch.sum(deq, dim=0)
    return total.to(g.dtype), new_err
