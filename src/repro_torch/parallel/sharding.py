"""Mesh context and parameter specs (port of ``repro.parallel.sharding``).

The reference runs model code per rank inside one ``shard_map`` over the
``data`` / ``model`` (/ ``pod``) mesh, with every cross-device byte going
through a managed collective.  The port keeps that per-rank style.  In
this slice every mesh axis has size 1: one process drives one card, and
each managed collective is the identity (core/managed.py).  The
``torch.distributed`` mesh comes with the managed collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import pad_to_multiple

__all__ = ["LOGICAL_RULES", "MeshCtx", "ParamSpec", "pad_to_multiple",
           "padded"]


def padded(n: int, m: int) -> tuple[int, int]:
    """(padded_size, pad_amount)."""
    p = pad_to_multiple(n, m)
    return p, p - n


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Static view of the mesh as seen by per-rank model code.

    Axis conventions: ``data`` = FSDP + batch, ``model`` = TP/EP/SP,
    ``pod`` = cross-pod DP (or pipeline stages).  Sizes are static.
    """
    axis_sizes: dict[str, int] = dataclasses.field(
        default_factory=lambda: {"data": 1, "model": 1})
    mdmp_mode: str = "auto"             # threaded into managed collectives

    @property
    def tp(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def dp(self) -> int:
        return self.axis_sizes.get("data", 1)

    @property
    def pods(self) -> int:
        return self.axis_sizes.get("pod", 1)

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_sizes

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return (("pod", "data") if self.has_pod else ("data",))

    @property
    def batch_shards(self) -> int:
        return self.dp * self.pods

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.axis_sizes.keys())

    def local_batch(self, global_batch: int) -> int:
        if global_batch % self.batch_shards:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{self.batch_shards} batch shards")
        return global_batch // self.batch_shards


#: logical dimension names -> mesh axis they shard over (None = replicated)
LOGICAL_RULES: dict[str, str | None] = {
    "layers": None,        # stacked-layer dimension, never sharded
    "embed": "data",       # d_model rows: the FSDP shard
    "embed_nofsdp": None,  # d_model when the tensor is tiny (norms)
    "heads": "model",
    "kv_heads": None,      # replicated (GQA kv < tp)
    "ff": "model",
    "vocab": "model",
    "experts": "model",    # EP: experts sharded by expert id
    "expert_ff": None,
    "ssm_heads": "model",
    "inner": "model",      # SSM d_inner (= heads * headdim), head-sharded
    "conv": None,
    "state": None,
    "frames": None,
    "null": None,
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Global shape + logical axes of one parameter."""
    shape: tuple[int, ...]
    logical: tuple[str, ...]
    dtype: Any = None

    def local_shape(self, ctx: MeshCtx) -> tuple[int, ...]:
        out = []
        for s, l in zip(self.shape, self.logical):
            ax = LOGICAL_RULES[l]
            n = ctx.axis_sizes.get(ax, 1) if ax else 1
            if s % n:
                raise ValueError(f"dim {l}={s} not divisible by {ax}={n}")
            out.append(s // n)
        return tuple(out)
