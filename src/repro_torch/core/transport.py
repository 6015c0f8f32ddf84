"""Message transport over ``torch.distributed`` process groups — the one
place the port's collectives, ring permutes and halo exchange hand
tensors to a backend.

NCCL takes CUDA tensors directly.  Gloo takes CPU tensors for every op,
but CUDA tensors only for all-reduce and broadcast (``GLOO_CUDA_OPS``).
Where a gloo group meets a CUDA tensor in any other op — the multi-rank
path of processes that share one card — the message is copied to a host
buffer, moved, and copied back; the compute stays on the card.  The
choice reads ``dist.get_backend(group)`` and the tensor's device, never a
failure.  ``REGISTRY`` counts under ``STAGED_BYTES`` every byte that
crosses between the card and host memory, each way: the copies made
here, and those gloo makes itself when it all-reduces a CUDA tensor (the
message to host memory and the sum back).  Gloo has no reduce-scatter: a
gloo group reduces the whole message and keeps its block; nor, in every
build, an all-to-all: a gloo group sends the blocks point to point.

Under the instrumentation's recorder (core/instrument.py) each call is one
``CollectiveRecord`` under the reference's primitive name (``psum``,
``all_gather``, ``reduce_scatter``, ``all_to_all``, ``ppermute``); meta
operands are recorded and nothing is sent.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import instrument
from repro_torch.obs.registry import MetricsRegistry

Group = dist.ProcessGroup | None

#: the ops gloo runs on CUDA tensors itself
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})

#: counters of this module (bytes copied between the card and host memory)
REGISTRY = MetricsRegistry()
STAGED_BYTES = "transport.staged_bytes"


def staged_bytes() -> int:
    return int(REGISTRY.counter(STAGED_BYTES).value)


def reset_staged_bytes() -> None:
    REGISTRY.counter(STAGED_BYTES).value = 0


def stages(op: str, group: Group, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through host buffers."""
    return (t.device.type == "cuda" and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    REGISTRY.counter(STAGED_BYTES).add(t.numel() * t.element_size())
    return t.detach().to("cpu")


def _to_device(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    REGISTRY.counter(STAGED_BYTES).add(host.numel() * host.element_size())
    return host.to(like.device)


def _like(x: torch.Tensor) -> torch.Tensor:
    """A meta call's result: contiguous, as every message a backend
    returns."""
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _recorded(primitive: str, group: Group,
              operands: Sequence[torch.Tensor], meta, run):
    """One call under the active recorder: record it, then run it with
    its own ops unrecorded, or only shape it when the operands are
    meta."""
    rec = instrument.ACTIVE
    rec.collective(primitive, group, operands)
    with rec.quiet():
        return meta() if instrument.is_meta(*operands) else run()


def all_reduce(x: torch.Tensor, group: Group,
               op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """The reduction of ``x`` over ``group`` as a new tensor."""
    if instrument.ACTIVE is not None:
        return _recorded("psum", group, [x], lambda: _like(x),
                         lambda: _all_reduce(x, group, op))
    return _all_reduce(x, group, op)


def _all_reduce(x: torch.Tensor, group: Group,
                op: dist.ReduceOp.RedOpType) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if stages("all_reduce", group, out):
        host = _to_host(out)
        dist.all_reduce(host, op=op, group=group)
        return _to_device(host, out)
    if out.device.type == "cuda" and dist.get_backend(group) == "gloo":
        # gloo copies the message to host memory and the sum back itself
        REGISTRY.counter(STAGED_BYTES).add(
            2 * out.numel() * out.element_size())
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(x: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """Every rank's ``x`` in group-rank order."""
    if instrument.ACTIVE is not None:
        return _recorded(
            "all_gather", group, [x],
            lambda: [_like(x) for _ in range(dist.get_world_size(group))],
            lambda: _all_gather(x, group))
    return _all_gather(x, group)


def _all_gather(x: torch.Tensor, group: Group) -> list[torch.Tensor]:
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    if stages("all_gather", group, src):
        host = _to_host(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return [_to_device(p, src) for p in parts]
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def reduce_scatter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Block ``rank`` of axis 0 of the sum of every rank's ``x`` (axis 0
    divisible by the group's size)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0] // n
    if instrument.ACTIVE is not None:
        return _recorded(
            "reduce_scatter", group, [x],
            lambda: x.new_empty((m,) + tuple(x.shape[1:])),
            lambda: _reduce_scatter(x, group, m, idx))
    return _reduce_scatter(x, group, m, idx)


def _reduce_scatter(x: torch.Tensor, group: Group, m: int,
                    idx: int) -> torch.Tensor:
    if dist.get_backend(group) == "gloo":
        return _all_reduce(x, group, dist.ReduceOp.SUM)[
            idx * m:(idx + 1) * m].contiguous()
    out = x.new_empty((m,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.detach().contiguous(), group=group)
    return out


def all_to_all(blocks: Sequence[torch.Tensor],
               group: Group) -> list[torch.Tensor]:
    """``blocks[j]`` goes to rank j; returns the blocks received, in
    source-rank order (blocks of one shape).  Gloo has no all-to-all in
    every build: over a gloo group the blocks go as one batch of
    point-to-point messages (staged through host buffers for CUDA
    tensors, as every gloo message)."""
    if instrument.ACTIVE is not None:
        return _recorded("all_to_all", group, list(blocks),
                         lambda: [_like(b) for b in blocks],
                         lambda: _all_to_all(blocks, group))
    return _all_to_all(blocks, group)


def _all_to_all(blocks: Sequence[torch.Tensor],
                group: Group) -> list[torch.Tensor]:
    src = [b.detach().contiguous() for b in blocks]
    if dist.get_backend(group) == "gloo":
        me = dist.get_rank(group)
        got = [torch.empty_like(b) for b in src]
        got[me] = src[me].clone()
        peers = [j for j in range(len(src)) if j != me]
        _p2p_start([(src[j], j, 0) for j in peers],
                   [(got[j], j, 0) for j in peers], group).wait()
        return got
    got = [torch.empty_like(b) for b in src]
    dist.all_to_all(got, src, group=group)
    return got


class Pending:
    """Posted point-to-point messages: ``wait()`` blocks until every one
    has arrived (and a staged one is back on its device)."""

    def __init__(self, works: list, copies: list, keep: list):
        self._works = works
        self._copies = copies      # (host buffer, device tensor) pairs
        self._keep = keep          # sent buffers, alive until the wait

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        for host, dst in self._copies:
            dst.copy_(_to_device(host, dst))
        self._works, self._copies, self._keep = [], [], []


def p2p_start(sends: Sequence[tuple[torch.Tensor, int, int]],
              recvs: Sequence[tuple[torch.Tensor, int, int]],
              group: Group) -> Pending:
    """Post ``(tensor, peer, tag)`` sends and receives in one batch; peers
    are group ranks.  A receive fills its tensor once the returned
    ``Pending`` is waited for; a sent tensor must stay unchanged until
    then.  Every rank posts its ops in the same order (NCCL pairs them by
    order, gloo by tag).  Under the recorder the batch is one
    ``ppermute`` of the sent bytes."""
    if instrument.ACTIVE is not None:
        return _recorded("ppermute", group, [t for t, _, _ in sends],
                         lambda: Pending([], [], []),
                         lambda: _p2p_start(sends, recvs, group))
    return _p2p_start(sends, recvs, group)


def _p2p_start(sends: Sequence[tuple[torch.Tensor, int, int]],
               recvs: Sequence[tuple[torch.Tensor, int, int]],
               group: Group) -> Pending:
    ops, copies, keep = [], [], []
    for t, peer, tag in sends:
        if not t.is_contiguous():
            raise ValueError("messages are contiguous tensors")
        buf = _to_host(t) if stages("p2p", group, t) else t
        keep.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, dist.get_global_rank(group,
                                                                    peer),
                              group, tag=tag))
    for t, peer, tag in recvs:
        if not t.is_contiguous():
            raise ValueError("messages are contiguous tensors")
        buf = t
        if stages("p2p", group, t):
            buf = torch.empty(t.shape, dtype=t.dtype)
            copies.append((buf, t))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group,
                                                                    peer),
                              group, tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, copies, keep)
