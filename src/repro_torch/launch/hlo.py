"""Static work count of one rank's step: FLOPs, device-memory bytes,
collective link bytes and peak memory for the roofline (port of
``repro.launch.hlo``).

The reference parses the optimised HLO text of the compiled SPMD module.
The port's counterpart of "the compiled module" is one rank's aten op
stream, recorded while the step runs ONCE on abstract (``meta``) tensors
under ``OpCounter``, a recorder of core/instrument.py: nothing is
allocated on a card and nothing is launched.  Meta tensors stand for the
card, so every kernel wrapper takes its card branch (checks included)
and reports its launch with its kernel module's work function.

  * FLOPs: every matmul-like aten op (mm, bmm, addmm, baddbmm, the
    decompositions of matmul and einsum, convolutions) by its result and
    contracted dims, with ``torch.utils.flop_counter``'s formulas; every
    kernel launch by its work function (``flash_work``, ``paged_work``,
    ``grouped_work``, ``grouped_bwd_work``, ``stencil_work``) and by no
    aten op of its plain version.
  * Device-memory bytes: eager PyTorch fuses nothing, so every non-view
    aten op reads its operands and writes its result once; views cost 0;
    an in-place update of a slice (``copy_`` into a view, ``index_put_``)
    costs the slice, read and written — the reference's
    ``dynamic-update-slice`` rule.  The reference's 1 MiB threshold
    (tensors below it live in TPU VMEM) does not carry over: a GPU's eager
    ops go through device memory at every size.  A kernel launch costs its
    work function's bytes.
  * Collectives: from the transport's calls (core/transport.py), each
    converted from its operands to its RESULT bytes (an all-gather's
    result is n shards, a reduce-scatter's 1/n of its operand, the rest
    equal their operands), then to per-chip link bytes with the
    reference's ring algebra (``_link_bytes``; n = the group's size):
        all-gather          (n-1)/n * result
        reduce-scatter      (n-1)   * result
        all-reduce          2(n-1)/n * result
        all-to-all          (n-1)/n * result
        collective-permute  result
  * Peak memory: the live bytes of the abstract tensors' storages, added
    at creation and taken away when the storage dies.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core import instrument

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the transport's primitives (the reference's names) -> HLO kinds
HLO_KIND = {"all_gather": "all-gather", "psum": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "ppermute": "collective-permute"}

#: aten ops that return a view of their input without being schema views
VIEW_OPS = frozenset({"_unsafe_view", "_reshape_alias", "alias", "detach",
                      "lift_fresh"})

#: in-place ops that overwrite their target without reading it
OVERWRITE_OPS = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_",
                           "random_", "bernoulli_", "set_"})

#: in-place updates of a slice addressed by indices: the slice (the size
#: of the values) is read and written, not the whole target
SCATTER_OPS = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                         "index_add_", "scatter_", "scatter_add_",
                         "scatter_reduce_", "masked_scatter_", "put_"})

#: the schema names of a scatter's values
VALUE_ARGS = frozenset({"values", "source", "src"})

#: the abstract device whose tensors are counted
DEVICE = "meta"


def _link_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-chip link bytes of one ring collective of ``result_bytes``
    result over a group of ``n`` (the reference's ``hlo._link_bytes``)."""
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return (n - 1) * result_bytes
    if op == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    if op == "collective-permute":
        return float(result_bytes)
    return 0.0


def result_bytes(primitive: str, operand_bytes: float, n: int) -> float:
    """The result bytes of one transport call from its operand bytes: the
    transport records operands, the ring algebra reads results."""
    if primitive == "all_gather":
        return operand_bytes * n
    if primitive == "reduce_scatter":
        return operand_bytes / max(n, 1)
    return float(operand_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _counted(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == DEVICE


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One kernel launch as the count saw it."""
    name: str
    flops: float
    nbytes: float
    shapes: tuple                  # the shapes of the tensors it reads


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One transport call as the count saw it (its result, not its
    operands)."""
    kind: str                      # HLO kind
    n: int                         # group size
    result_bytes: float
    itemsize: int                  # bytes per element of its operands


class OpCounter(instrument.Recorder):
    """Counts one rank's op stream: FLOPs and bytes of every aten op on
    abstract tensors, the kernels and collectives that report themselves,
    and the live bytes of every abstract storage.

    Use as ``with counter.recording(): ...`` (installs it as the active
    recorder): build the model and the step's arguments, then
    ``counter.start()`` (the arguments' live bytes; counting starts), run
    the step, then ``counter.stop(outputs)``."""

    def __init__(self, axes: dict[int, str] | None = None):
        super().__init__({}, {}, axes)
        self.counting = False
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.kernels: list[KernelLaunch] = []
        self.calls: list[CollectiveCall] = []
        self.ops = 0          # aten ops that cost: no view, no allocation
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}       # id(storage) -> bytes
        self._args: set[int] = set()
        self._aliased: dict[int, int] = {}
        self.memory: dict[str, int] = {}
        self.seconds = 0.0
        self._t0 = 0.0

    # -- lifetime -------------------------------------------------------------

    def recording(self) -> "_Recording":
        return _Recording(self)

    def start(self) -> None:
        """The step's arguments are built: count from here on."""
        self._args = set(self._storages)
        self.memory["argument_bytes"] = self.live
        self.peak = self.live
        self.counting = True
        self._t0 = time.perf_counter()

    def stop(self, outputs: Any = ()) -> None:
        """The step has returned ``outputs``: stop counting, fix the
        memory record."""
        self.seconds = time.perf_counter() - self._t0
        self.counting = False
        seen: dict[int, int] = {}
        for o in tree_leaves(outputs):
            if _counted(o):
                s = o.untyped_storage()
                seen[id(s)] = s.nbytes()
        arg = self.memory["argument_bytes"]
        self.memory.update(
            output_bytes=sum(seen.values()),
            temp_bytes=self.peak - arg,
            alias_bytes=sum(self._aliased.values()),
            peak_bytes=self.peak)

    def _free(self, key: int, nbytes: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, outs: Any) -> None:
        for o in tree_leaves(outs):
            if not _counted(o):
                continue
            s = o.untyped_storage()
            key = id(s)
            if key in self._storages:
                continue
            n = s.nbytes()
            self._storages[key] = n
            weakref.finalize(s, self._free, key, n)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live

    # -- the aten ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(out)
        if not self.counting or self._quiet:
            return out
        name = func.overloadpacket.__name__
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if not any(_counted(t) for t in ins + [o for o in tree_leaves(out)
                                               if isinstance(o,
                                                             torch.Tensor)]):
            return out
        if name in instrument.ALLOC_OPS or func.is_view or name in VIEW_OPS:
            return out
        self.ops += 1
        if func.overloadpacket in flop_registry:
            self.flops += float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        written = self._written(func, args, kwargs)
        for t in written:
            key = id(t.untyped_storage())
            if key in self._args:
                self._aliased[key] = self._storages.get(key, 0)
        wids = {id(t) for t in written}
        reads = 0 if name in instrument.SHAPE_ONLY_OPS else sum(
            _nbytes(t) for t in ins if _counted(t) and id(t) not in wids)
        if not written:
            self.hbm_bytes += reads + sum(
                _nbytes(o) for o in tree_leaves(out) if _counted(o))
        elif name in SCATTER_OPS:
            # the values are read (in ``reads``) and written into the slice
            vals = [kwargs.get(a.name) if i >= len(args) else args[i]
                    for i, a in enumerate(func._schema.arguments)
                    if a.name in VALUE_ARGS]
            self.hbm_bytes += reads + sum(_nbytes(t) for t in vals
                                          if _counted(t))
        else:
            w = sum(_nbytes(t) for t in written if _counted(t))
            self.hbm_bytes += reads + w + (0 if name in OVERWRITE_OPS
                                           else w)
        return out

    @staticmethod
    def _written(func, args, kwargs) -> list[torch.Tensor]:
        out = []
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            out += [t for t in tree_leaves(val)
                    if isinstance(t, torch.Tensor)]
        return out

    # -- what reports itself ------------------------------------------------------

    def kernel(self, name: str, reads: Sequence[Any],
               writes: Sequence[Any] = (), work: Callable | None = None
               ) -> None:
        super().kernel(name, reads, writes, work)
        if not self.counting:
            return
        flops = nbytes = 0.0
        if work is not None:
            with self.quiet():
                flops, nbytes = work()
        self.flops += flops
        self.hbm_bytes += nbytes
        self.kernels.append(KernelLaunch(
            name=name, flops=float(flops), nbytes=float(nbytes),
            shapes=tuple(tuple(t.shape) for t in reads
                         if isinstance(t, torch.Tensor))))

    def collective(self, primitive: str, group: Any,
                   operands: Sequence[torch.Tensor]) -> None:
        super().collective(primitive, group, operands)
        if not self.counting:
            return
        g = group if group is not None else dist.group.WORLD
        n = dist.get_world_size(g)
        res = result_bytes(primitive, sum(_nbytes(t) for t in operands), n)
        self.hbm_bytes += res
        self.calls.append(CollectiveCall(
            kind=HLO_KIND[primitive], n=n, result_bytes=res,
            itemsize=max((t.element_size() for t in operands), default=0)))

    def launches(self) -> dict[str, int]:
        """Kernel launches of the counted step, by kernel."""
        out: dict[str, int] = {}
        for k in self.kernels:
            out[k.name] = out.get(k.name, 0) + 1
        return out


class _Recording:
    def __init__(self, counter: OpCounter):
        self._c = counter
        self._outer = None

    def __enter__(self) -> OpCounter:
        self._outer = instrument.ACTIVE
        instrument.ACTIVE = self._c
        self._c.__enter__()
        return self._c

    def __exit__(self, *exc: Any) -> None:
        try:
            self._c.__exit__(*exc)
        finally:
            instrument.ACTIVE = self._outer


def count(fn: Callable, *args: Any) -> OpCounter:
    """Run ``fn(*args)`` once under a fresh counter (the arguments already
    built, counted as its arguments) and return the counter."""
    c = OpCounter()
    with c.recording():
        for a in tree_leaves(args):
            c._track(a)
        c.start()
        out = fn(*args)
        c.stop(out)
    return c


def analyze_ops(counter: OpCounter) -> dict[str, Any]:
    """The counted step's totals under the keys of the reference's
    ``analyze_hlo_text``."""
    link = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0.0 for k in COLLECTIVES}
    for c in counter.calls:
        link[c.kind] += _link_bytes(c.kind, c.result_bytes, c.n)
        counts[c.kind] += 1
    return {
        "flops": counter.flops,
        "hbm_bytes": counter.hbm_bytes,
        "collective_bytes": sum(link.values()),
        "collective_detail": {"bytes_per_kind": link, "counts": counts},
    }


def analyze_compiled(counter: OpCounter, n_chips: int) -> dict[str, Any]:
    """Roofline inputs of one counted cell under the keys of the
    reference's ``analyze_compiled``.  All numbers are PER CHIP: the count
    is one rank's step (rank 0's).  ``raw_cost_analysis`` holds the same
    totals: an eager op stream has no loop body counted once."""
    stats = analyze_ops(counter)
    return {
        "n_chips": n_chips,
        "flops_per_chip": stats["flops"],
        "hbm_bytes_per_chip": stats["hbm_bytes"],
        "collective_bytes_per_chip": stats["collective_bytes"],
        "collective_detail": stats["collective_detail"],
        "raw_cost_analysis": {"flops_body_once": stats["flops"],
                              "bytes_body_once": stats["hbm_bytes"]},
        "memory": dict(counter.memory),
    }
