"""Mesh context and parameter specs (port of ``repro.parallel.sharding``).

The reference runs model code per rank inside one ``shard_map`` over the
``data`` / ``model`` (/ ``pod``) mesh, with every cross-device byte going
through a managed collective.  The port keeps that per-rank style: one
process per rank, and a ``torch.distributed`` process group per mesh
axis.  ``MeshCtx.from_mesh`` reads the axes, their sizes, this rank's
coordinates and the groups from a ``DeviceMesh`` (launch/mesh.py); the
mesh only supplies groups, DTensor places no collective.  A ``MeshCtx``
built from sizes alone is one rank's view with every axis at size 1
(or an axis above 1 whose group a caller passes itself, as the ring
does).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["LOGICAL_RULES", "MeshCtx", "ParamSpec", "pad_to_multiple",
           "padded", "shard_of"]


def pad_to_multiple(n: int, m: int) -> int:
    """``n`` rounded up to a multiple of ``m``."""
    return ((n + m - 1) // m) * m


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
    #: this rank's coordinate along each axis (0 where absent)
    coords: dict[str, int] = dataclasses.field(default_factory=dict,
                                               compare=False)
    #: the process group of each axis above size 1
    groups: dict[str, Any] = dataclasses.field(default_factory=dict,
                                               compare=False, repr=False)

    @staticmethod
    def from_mesh(mesh: Any, mdmp_mode: str = "auto") -> "MeshCtx":
        """The view of one rank of a ``torch.distributed`` DeviceMesh with
        named dims (``("data", "model")`` or ``("pod", "data",
        "model")``): sizes, this rank's coordinates, one group per axis."""
        names = tuple(mesh.mesh_dim_names)
        sizes = {ax: int(n) for ax, n in zip(names, mesh.mesh.shape)}
        return MeshCtx(axis_sizes=sizes, mdmp_mode=mdmp_mode,
                       coords={ax: int(mesh.get_local_rank(ax))
                               for ax in names},
                       groups={ax: mesh.get_group(ax) for ax in names
                               if sizes[ax] > 1})

    def axis_index(self, axis_name: str) -> int:
        """This rank's coordinate along ``axis_name`` (the reference's
        ``lax.axis_index``)."""
        return self.coords.get(axis_name, 0)

    def group(self, axis_name: str) -> Any:
        """The process group of ``axis_name`` (None at size 1)."""
        if self.axis_sizes.get(axis_name, 1) == 1:
            return None
        if axis_name not in self.groups:
            raise ValueError(
                f"axis {axis_name!r} of size {self.axis_sizes[axis_name]} "
                "needs its process group: build the MeshCtx with "
                "MeshCtx.from_mesh")
        return self.groups[axis_name]

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

    def local_batch(self, global_batch: int,
                    axes: tuple[str, ...] | None = None) -> int:
        shards = 1
        for ax in (self.batch_axes if axes is None else axes):
            shards *= self.axis_sizes.get(ax, 1)
        if global_batch % shards:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{shards} batch shards")
        return global_batch // shards

    def batch_index(self, axes: tuple[str, ...] | None = None) -> int:
        """This rank's shard of the batch over ``axes`` (default
        ``batch_axes``), row-major."""
        i = 0
        for ax in (self.batch_axes if axes is None else axes):
            i = i * self.axis_sizes.get(ax, 1) + self.axis_index(ax)
        return i

    def shard_batch(self, batch: dict,
                    axes: tuple[str, ...] | None = None) -> dict:
        """This rank's rows of a global batch: the leading dim sharded
        over ``axes`` (default ``batch_axes``; the reference's
        ``P(batch_axes, ...)``).  Pipeline training passes ``("data",)``:
        every stage then holds the same rows."""
        i = self.batch_index(axes)
        out = {}
        for k, v in batch.items():
            b = self.local_batch(v.shape[0], axes)
            out[k] = v[i * b:(i + 1) * b]
        return out


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


def shard_of(full: Any, spec: ParamSpec, ctx: MeshCtx) -> Any:
    """This rank's block of a full (global-shape) array or tensor: each
    dim sharded over a mesh axis keeps the rank's slice along it (the
    reference's ``device_put`` under ``NamedSharding(mesh, pspec)``)."""
    if tuple(full.shape) != tuple(spec.shape):
        raise ValueError(f"shape {tuple(full.shape)} != spec "
                         f"{tuple(spec.shape)}")
    idx = []
    for s, l in zip(spec.shape, spec.logical):
        ax = LOGICAL_RULES[l]
        n = ctx.axis_sizes.get(ax, 1) if ax else 1
        if s % n:
            raise ValueError(f"dim {l}={s} not divisible by {ax}={n}")
        r = ctx.axis_index(ax) if ax else 0
        idx.append(slice(r * (s // n), (r + 1) * (s // n)))
    return full[tuple(idx)]
