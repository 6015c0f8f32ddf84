"""Data-access instrumentation — the paper's read/write tracking (port of
``repro.core.instrument``).

MDMP instruments every read and write of communicated data inside a
communication region, and uses the counts from iteration k to schedule
iteration k+1 ("launch the communication of that data once it is ready").

The reference extracts the same information at trace time by walking the
jaxpr of the region.  Eager PyTorch has no trace: the region runs ONCE on
its example inputs under a recorder, a ``TorchDispatchMode`` that sees
every aten op.  For each tracked operand it counts the ops that consume it
(reads), the ops that produce it along its def-use chain (writes), and the
program depth — one step per aten op — of the last write and the first
read.  ``readiness`` (how early a send operand is fully produced, how late
a receive operand is first consumed) is what the managed scheduler needs
to know how much compute can hide the message.

Example arguments may be specs (``Spec(shape, dtype)``), the
counterpart of the reference's ``ShapeDtypeStruct``:
they become ``meta`` tensors, so instrumenting allocates no device memory
and launches nothing — the paper's runtime counters cost 10-20x on
STREAM, this walk costs nothing at run time.

What the dispatcher does not see reports itself:

  * a kernel wrapper (``kernels/``) reports each launch as ONE op that
    reads its inputs and writes its outputs (``note_kernel``), the
    counterpart of one ``pallas_call`` equation; handed meta tensors under
    a recorder it returns meta outputs (``meta_kernel``), and outside a
    recorder a meta tensor raises;
  * every message passes through ``core/transport.py``, whose calls
    become ``CollectiveRecord``s under the reference's primitive names,
    with the mesh axis learnt from the ``MeshCtx`` whose group it is.
    Repeated calls from one site with the same primitive, axis and bytes
    fold into one record whose ``trips`` is the call count (the
    counterpart of a scan's trip count).  Meta operands are recorded and
    nothing is sent.

Tracking propagates through the aliasing ops (reshape-like views,
transposes, dtype conversion, copies: the reference's ``alias_prims``)
and through functional updates (``*_scatter``, ``index_put``: its
``dynamic_update_slice``); an in-place update of a tracked tensor, or of
a view of one (``copy_``, ``index_put_``, ``add_``, ...), is a write.  A
slice is a read, as the reference's ``slice``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map


@dataclasses.dataclass
class AccessRecord:
    """Read/write profile of one tracked operand inside a region."""
    label: str
    reads: int = 0
    writes: int = 0
    first_read_depth: int | None = None
    last_write_depth: int | None = None

    def readiness(self, total_depth: int) -> float:
        """For send operands: fraction of the region's program that runs
        *before* the operand is fully produced (0 = ready immediately,
        1 = ready only at the end — no overlap opportunity)."""
        if total_depth <= 0 or self.last_write_depth is None:
            return 0.0
        return self.last_write_depth / total_depth

    def consumption_slack(self, total_depth: int) -> float:
        """For recv operands: fraction of the region that runs before the
        first read (1 = consumed only at the end — maximal overlap)."""
        if total_depth <= 0 or self.first_read_depth is None:
            return 1.0
        return self.first_read_depth / total_depth


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective the region ran — the planner needs the mesh axis
    and the payload bytes to serialise link contention across ops sharing
    that axis.  ``trips`` is how many times the site ran per region run
    (a ring loop's permute is ONE logical site); ``source`` is the
    user-code ``file:line`` of the call, for the static verifier's
    diagnostics."""
    primitive: str                 # the reference's name ("psum", ...)
    axis: str                      # mesh axis the bytes cross
    nbytes: int                    # payload bytes (sum of array operands)
    depth: int                     # program depth of the first call
    trips: int = 1                 # executions per region run
    source: str = ""               # user-frame "file:line" provenance


@dataclasses.dataclass
class RegionReport:
    records: dict[str, AccessRecord]
    total_eqns: int
    collectives: list[CollectiveRecord] = dataclasses.field(
        default_factory=list)

    def overlap_budget(self, label: str) -> float:
        """Fraction of the region's ops available to overlap the
        communication of ``label`` (sends: after last write; recvs: before
        first read)."""
        rec = self.records[label]
        if rec.writes > 0:
            return 1.0 - rec.readiness(self.total_eqns)
        return rec.consumption_slack(self.total_eqns)

    def collective_bytes_by_axis(self) -> dict[str, int]:
        """Total payload bytes per mesh axis (a site that ran ``trips``
        times contributes ``nbytes * trips`` — the bytes a full region run
        actually moves)."""
        out: dict[str, int] = {}
        for c in self.collectives:
            out[c.axis] = out.get(c.axis, 0) + c.nbytes * max(1, c.trips)
        return out


@dataclasses.dataclass(frozen=True)
class Spec:
    """A shape and dtype standing in for an example argument: instrumented
    as a ``meta`` tensor (the reference's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: Any = torch.float32


def itemsize(dtype: Any) -> int:
    """Bytes per element of a torch dtype, a dtype name (``"bfloat16"``)
    or anything numpy takes as a dtype."""
    if isinstance(dtype, str) and hasattr(torch, dtype):
        dtype = getattr(torch, dtype)
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

#: aten ops (overload packets) that pass a tracked operand through as the
#: same data: the reference's alias_prims (reshape, transpose, squeeze,
#: broadcast_in_dim, convert_element_type, copy)
ALIAS_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "transpose", "t", "permute",
    "squeeze", "unsqueeze", "expand", "alias", "detach", "_to_copy",
    "clone", "copy", "lift_fresh", "lift_fresh_copy"})

#: functional updates of their first operand: the reference's
#: dynamic_update_slice
UPDATE_OPS = frozenset({
    "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "index_put", "index_copy", "index_add",
    "scatter", "scatter_add", "scatter_reduce", "masked_scatter"})

#: allocations: no data is read and the reference has no equation for them
ALLOC_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided"})

#: factories that read only their argument's shape, never its data
SHAPE_ONLY_OPS = frozenset({
    "zeros_like", "ones_like", "full_like", "rand_like", "randn_like",
    "new_zeros", "new_ones", "new_full"})

#: path markers that make a source file repo-relative (the reference's
#: ``instrument.py:123``, with the port's package)
SOURCE_MARKERS = ("src/repro_torch/", "tests/", "benchmarks/", "examples/")

#: frames inside these directories are the runtime, not the caller
_RUNTIME_DIRS = ("repro_torch/core/",)


def _source() -> str:
    """Repo-relative ``file:line`` of the first frame outside
    ``repro_torch/core/`` (the user call site of a collective)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if not any(d in fn for d in _RUNTIME_DIRS):
            for marker in SOURCE_MARKERS:
                i = fn.find(marker)
                if i >= 0:
                    fn = fn[i:]
                    break
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return ""


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Recorder(TorchDispatchMode):
    """Counts the reads and writes of the tracked tensors over every aten
    op it sees, and the collectives and kernels that report themselves."""

    def __init__(self, tracked: dict[int, tuple[torch.Tensor, str]],
                 records: dict[str, AccessRecord],
                 axes: dict[int, str] | None = None):
        super().__init__()
        self.tracked = dict(tracked)      # id(tensor) -> (tensor, label)
        self.views: dict[int, tuple[torch.Tensor, str]] = {}
        self.records = records
        self.axes = dict(axes or {})      # id(group) -> mesh axis name
        self.depth = 0
        self.collectives: list[CollectiveRecord] = []
        self._sites: dict[tuple, int] = {}
        self._quiet = 0

    # -- bookkeeping --------------------------------------------------------

    def _label(self, t: Any) -> str | None:
        hit = self.tracked.get(id(t)) if isinstance(t, torch.Tensor) \
            else None
        return hit[1] if hit is not None and hit[0] is t else None

    def _view_label(self, t: Any) -> str | None:
        lab = self._label(t)
        if lab is not None:
            return lab
        hit = self.views.get(id(t)) if isinstance(t, torch.Tensor) \
            else None
        return hit[1] if hit is not None and hit[0] is t else None

    def _read(self, tensors: Sequence[Any]) -> None:
        for t in tensors:
            lab = self._label(t)
            if lab is not None:
                rec = self.records[lab]
                rec.reads += 1
                if rec.first_read_depth is None:
                    rec.first_read_depth = self.depth

    def _write(self, label: str) -> None:
        rec = self.records[label]
        rec.writes += 1
        rec.last_write_depth = self.depth

    def _track(self, outs: Any, label: str) -> None:
        for o in tree_leaves(outs):
            if isinstance(o, torch.Tensor):
                self.tracked[id(o)] = (o, label)

    # -- the aten ops -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        if name in ALLOC_OPS:
            return out
        self.depth += 1
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if name not in SHAPE_ONLY_OPS:
            self._read(ins)
        if name in ALIAS_OPS or name in UPDATE_OPS:
            # the first tracked operand's label flows to the outputs
            # (update ops: only through the operand being updated)
            cands = ins[:1] if name in UPDATE_OPS else ins
            for t in cands:
                lab = self._label(t)
                if lab is not None:
                    self._track(out, lab)
                    self._write(lab)
                    break
        elif func.is_view and ins:
            lab = self._view_label(ins[0])
            if lab is not None:       # a slice of a tracked tensor: a
                for o in tree_leaves(out):     # write through it lands
                    if isinstance(o, torch.Tensor):     # in the tensor
                        self.views[id(o)] = (o, lab)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_leaves(val):
                lab = self._view_label(t)
                if lab is not None:
                    self._write(lab)
        return out

    # -- what reports itself --------------------------------------------------

    def kernel(self, name: str, reads: Sequence[Any],
               writes: Sequence[Any] = (), work: Callable | None = None
               ) -> None:
        """One kernel launch: one op reading ``reads`` and writing
        ``writes`` (a write counts where an output is tracked).  ``work``
        returns the launch's (flops, bytes), for a recorder that counts
        them (launch/hlo.py)."""
        self.depth += 1
        self._read([t for t in reads if t is not None])
        for t in writes:
            lab = self._view_label(t)
            if lab is not None:
                self._write(lab)

    def collective(self, primitive: str, group: Any,
                   operands: Sequence[torch.Tensor]) -> None:
        """One collective call: one op reading ``operands``, folded with
        earlier calls of the same site, primitive, axis and bytes."""
        self.depth += 1
        self._read(operands)
        g = group if group is not None else dist.group.WORLD
        axis = self.axes.get(id(g), "?")
        nbytes = _nbytes(operands)
        src = _source()
        key = (primitive, axis, nbytes, src)
        i = self._sites.get(key)
        if i is None:
            self._sites[key] = len(self.collectives)
            self.collectives.append(CollectiveRecord(
                primitive=primitive, axis=axis, nbytes=nbytes,
                depth=self.depth, trips=1, source=src))
        else:
            c = self.collectives[i]
            self.collectives[i] = dataclasses.replace(c, trips=c.trips + 1)

    def quiet(self) -> "_Quiet":
        """``with rec.quiet():`` — the ops inside are not recorded (the
        body of a call that reported itself as one op)."""
        return _Quiet(self)


class _Quiet:
    def __init__(self, rec: Recorder):
        self._rec = rec

    def __enter__(self) -> None:
        self._rec._quiet += 1

    def __exit__(self, *exc: Any) -> None:
        self._rec._quiet -= 1


#: the recorder of the region being instrumented (None: nothing records)
ACTIVE: Recorder | None = None


def note_kernel(name: str, reads: Sequence[Any],
                writes: Sequence[Any] = (), *,
                work: Callable | None = None) -> None:
    """Report one kernel launch to the active recorder (a wrapper calls
    this where it counts its launches; without a recorder it does
    nothing).  ``work`` returns the launch's (flops, bytes): the kernel
    module's work function of the call's shapes."""
    if ACTIVE is not None:
        ACTIVE.kernel(name, reads, writes, work)


def meta_kernel(name: str, reads: Sequence[Any], outputs: Any, *,
                work: Callable | None = None) -> Any:
    """A kernel wrapper handed meta tensors, past the checks of what its
    kernel takes: under a recorder, report one launch and return the meta
    ``outputs``; outside one, raise (a meta tensor is neither CUDA nor
    CPU, and no plain version stands in)."""
    if ACTIVE is None:
        raise RuntimeError(f"no {name} kernel for meta tensors: they run "
                           f"only under instrument.analyze_region")
    ACTIVE.kernel(name, reads, [o for o in tree_leaves(outputs)
                                if isinstance(o, torch.Tensor)], work)
    return outputs


def is_meta(*tensors: Any) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tensors)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's side of a device branch: a CUDA
    tensor, or a meta one, which stands for the card under a recorder (a
    dry run counts the path a CUDA tensor takes, kernels included)."""
    return t.device.type in ("cuda", "meta")


# ---------------------------------------------------------------------------
# MoE routing statistics — the data-dependent communication counters
# ---------------------------------------------------------------------------
#
# MoE dispatch bytes are decided by a ROUTER at run time: the walk above
# cannot see them.  This is where the paper's runtime read/write counters
# earn their keep, so the routing path gets true runtime instrumentation:
# ``moe_routing_stats`` stays on the device (one histogram per layer) and
# ``capture_routing`` records host-side summaries that feed the
# iteration-(k)->(k+1) capacity/schedule re-resolution
# (cost_model.decide_moe_dispatch's measured_* inputs).


@dataclasses.dataclass
class RoutingRecord:
    """Host-side routing profile of one MoE dispatch call site."""
    label: str
    n_experts: int
    capacity: int
    tokens: int
    top_k: int
    histogram: np.ndarray          # [E] routed (t, k) assignments
    drop_rate: float               # fraction of assignments over capacity
    occupancy: float               # kept rows / (E * C) buffer slots
    imbalance: float               # max expert load / mean expert load


def moe_routing_stats(top_idx: torch.Tensor, n_experts: int,
                      capacity: int) -> dict:
    """Routing statistics from a router's top-k expert ids [T, K]
    (tensors on the ids' device):

      histogram [E]   assignments per expert,
      drop_rate []    fraction of (t, k) assignments past capacity,
      occupancy []    realised buffer occupancy (kept / E*C),
      imbalance []    max load / mean load (feeds the capacity-factor
                      re-resolution: cf >= imbalance drops nothing).
    """
    flat = top_idx.reshape(-1).long()
    # scatter-add histogram: O(T*K), not the O(T*K*E) one-hot blow-up
    hist = torch.zeros(n_experts, dtype=torch.float32,
                       device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                            device=flat.device))
    kept = torch.clamp(hist, max=float(capacity))
    total = max(float(flat.shape[0]), 1.0)
    mean_load = torch.clamp(hist.mean(), min=1e-9)
    return {
        "histogram": hist,
        "drop_rate": 1.0 - kept.sum() / total,
        "occupancy": kept.sum() / float(n_experts * capacity),
        "imbalance": hist.max() / mean_load,
    }


_ROUTING_LOG: list[RoutingRecord] = []


def capture_routing(label: str, top_idx: Any, n_experts: int,
                    capacity: int) -> RoutingRecord:
    """Summarise CONCRETE routed ids and append to the routing log (the
    runtime counter readout: benchmarks/tuners call this on a sampled
    batch between steps, then hand ``imbalance``/``drop_rate`` back to
    ``managed.resolve_moe_dispatch``)."""
    ids = torch.as_tensor(np.asarray(top_idx) if not isinstance(
        top_idx, torch.Tensor) else top_idx)
    t, k = ids.shape
    stats = moe_routing_stats(ids, n_experts, capacity)
    rec = RoutingRecord(
        label=label, n_experts=n_experts, capacity=capacity, tokens=t,
        top_k=k, histogram=stats["histogram"].cpu().numpy(),
        drop_rate=float(stats["drop_rate"]),
        occupancy=float(stats["occupancy"]),
        imbalance=float(stats["imbalance"]))
    _ROUTING_LOG.append(rec)
    return rec


def routing_log() -> list[RoutingRecord]:
    return list(_ROUTING_LOG)


def clear_routing_log() -> None:
    _ROUTING_LOG.clear()


# ---------------------------------------------------------------------------
# The region walk
# ---------------------------------------------------------------------------


def _example(a: Any) -> Any:
    """A spec becomes a meta tensor, an array a tensor; the rest as is."""
    if isinstance(a, Spec):
        return torch.empty(tuple(a.shape), dtype=a.dtype, device="meta")
    if isinstance(a, np.ndarray):
        return torch.from_numpy(a)
    return a


def _axes_of(mesh: Any) -> dict[int, str]:
    """id(process group) -> axis name, from a ``MeshCtx`` or a dict of
    axis name -> group."""
    if mesh is None:
        return {}
    groups = mesh if isinstance(mesh, dict) else getattr(mesh, "groups", {})
    return {id(g): ax for ax, g in groups.items() if g is not None}


def analyze_region(fn: Callable, *example_args: Any,
                   tracked_args: Sequence[int] | None = None,
                   labels: Sequence[str] | None = None,
                   mesh: Any = None) -> RegionReport:
    """Run ``fn`` once on its example arguments under the recorder and
    produce read/write records for the tracked inputs.

    ``tracked_args``: indices into the flattened tensor arguments
    (default: all of them).  ``labels``: names for the report.  ``mesh``:
    the ``MeshCtx`` (or axis -> group dict) whose groups name the axes of
    the collectives the region runs."""
    global ACTIVE
    args = tree_map(_example, list(example_args),
                    is_leaf=lambda a: isinstance(a, Spec))
    flat = [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
    if tracked_args is None:
        tracked_args = list(range(len(flat)))
    if labels is None:
        labels = [f"arg{i}" for i in tracked_args]
    tracked: dict[int, tuple[torch.Tensor, str]] = {}
    records: dict[str, AccessRecord] = {}
    for i, label in zip(tracked_args, labels):
        tracked[id(flat[i])] = (flat[i], label)
        records[label] = AccessRecord(label=label)
    rec = Recorder(tracked, records, _axes_of(mesh))
    outer = ACTIVE
    ACTIVE = rec
    try:
        with rec:
            fn(*args)
    finally:
        ACTIVE = outer
    return RegionReport(records=records, total_eqns=rec.depth,
                        collectives=rec.collectives)
