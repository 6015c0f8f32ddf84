"""Managed halo exchange — the paper's running Jacobi example (port of
``repro.core.halo``).

The paper's Figure 2 (bulk: exchange full halos, then compute) vs Figure 3
(intermingled: post the messages, compute the interior while they fly,
then the boundary rows), plus the third knob, message AGGREGATION:
exchange a k-row slab once per k sweeps instead of a 1-row slab every
sweep, and redundantly compute the ghost trapezoid
(``kernels/stencil.py::jacobi_ksweep_parts``).  Per sweep this pays

    comm:  2*alpha/k + 2*cols*B/link_bw      (k x fewer messages)
    mem:   ~3*rows*cols*B/(k*hbm_bw)         (k sweeps per round trip)
    flops: (rows + 2*(k-1))*cols*c/peak      (redundant ghost rows)

which is the decision ``core/cost_model.py::decide_halo_aggregation``
makes.

Rows are split over one ``torch.distributed`` process group (the
reference's mesh axis ``axis_name``; ``None`` is one rank).  Messages go
through ``core/transport.py``'s batched point-to-point ops (through host
buffers where a gloo group meets CUDA tensors): non-periodic edge ranks
receive zero slabs (MPI_PROC_NULL), periodic is a ring, and one rank gets
zeros or, when periodic, its own wrapped rows.  On a CUDA tensor every
sweep runs the stencil kernels; the halo-padded update of the reference's
``_five_point`` on ``[lo; u; hi]`` is ``stencil.jacobi_step`` with the
halos passed as ``lo`` / ``hi``, so no padded copy of the block is made,
and a solve ping-pongs between two buffers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import transport
from repro_torch.kernels.stencil import jacobi_ksweep_parts, jacobi_step
from repro_torch.obs.tracer import dispatch_span

Group = dist.ProcessGroup | None
Halos = tuple[torch.Tensor, torch.Tensor]


def _ring(group: Group) -> tuple[int, int]:
    """(this rank's index, ranks) along the group (one rank for None)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def halo_exchange_start(x: torch.Tensor, group: Group = None, *,
                        halo: int = 1, periodic: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   transport.Pending]:
    """Post the exchange of ``halo`` rows with the ring neighbours.

    Returns ``(lo, hi, pending)``: the slabs that will hold the rows from
    the previous / next rank once ``pending.wait()`` has returned.  A slab
    that no message fills (a non-periodic edge) stays zero."""
    if halo > x.shape[0]:
        raise ValueError(f"a {halo}-row halo from a {x.shape[0]}-row block")
    idx, n = _ring(group)
    if n == 1 and periodic:
        return x[x.shape[0] - halo:], x[:halo], transport.Pending([], [], [])
    shape = (halo,) + tuple(x.shape[1:])
    lo, hi = x.new_zeros(shape), x.new_zeros(shape)
    if n == 1:
        return lo, hi, transport.Pending([], [], [])
    nxt, prv = idx + 1, idx - 1
    if periodic:
        nxt, prv = nxt % n, prv % n
    sends, recvs = [], []
    # tag 0: my last rows -> the next rank's lo; tag 1: my first rows ->
    # the previous rank's hi.  With two ranks on a ring both messages
    # join the same pair; the tags (gloo) and the common order of the ops
    # on every rank (NCCL) keep them apart.
    if nxt < n:
        sends.append((x[x.shape[0] - halo:], nxt, 0))
    if prv >= 0:
        sends.append((x[:halo], prv, 1))
        recvs.append((lo, prv, 0))
    if nxt < n:
        recvs.append((hi, nxt, 1))
    return lo, hi, transport.p2p_start(sends, recvs, group)


def halo_exchange(x: torch.Tensor, group: Group = None, *, halo: int = 1,
                  periodic: bool = False) -> Halos:
    """Exchange ``halo`` rows with ring neighbours along ``group``.

    Returns ``(lo_halo, hi_halo)`` — the rows received from the previous /
    next rank (zeros at the boundary when non-periodic, matching
    MPI_PROC_NULL semantics in the paper's code)."""
    lo, hi, pending = halo_exchange_start(x, group, halo=halo,
                                          periodic=periodic)
    pending.wait()
    return lo, hi


def jacobi_step_bulk(u: torch.Tensor, f: torch.Tensor, group: Group = None,
                     periodic: bool = False, *,
                     out: torch.Tensor | None = None,
                     engine: str = "auto") -> torch.Tensor:
    """Paper Figure 2: exchange halos, then the 5-point update of every
    row (the reference's ``_five_point`` on ``[lo; u; hi]``)."""
    lo, hi = halo_exchange(u, group, periodic=periodic)
    return jacobi_step(u, f, lo=lo, hi=hi, out=out, engine=engine)


def jacobi_step_overlapped(u: torch.Tensor, f: torch.Tensor,
                           group: Group = None, periodic: bool = False, *,
                           out: torch.Tensor | None = None,
                           engine: str = "auto") -> torch.Tensor:
    """Paper Figure 3: post the halo messages, update the interior rows
    (local data only) while they are in flight, wait, then update the two
    boundary rows that need the halos.  Identical result."""
    lo, hi, pending = halo_exchange_start(u, group, periodic=periodic)
    m = u.shape[0]
    out = torch.empty_like(u) if out is None else out
    jacobi_step(u, f, rows=((1, m - 1),), out=out, engine=engine)
    pending.wait()
    return jacobi_step(u, f, lo=lo, hi=hi, rows=((0, 1), (m - 1, m)),
                       out=out, engine=engine)


def _frozen_depths(group: Group, k: int, periodic: bool) -> tuple[int, int]:
    """Ghost-slab rows outside the physical domain must stay constant
    (zeros) through all k sweeps; rows from a real neighbour take part in
    the redundant trapezoid instead.  Returns (frozen_top, frozen_bot)."""
    if periodic:
        return 0, 0
    idx, n = _ring(group)
    return (k if idx == 0 else 0), (k if idx == n - 1 else 0)


def jacobi_step_aggregated(u: torch.Tensor, f: torch.Tensor,
                           flo: torch.Tensor, fhi: torch.Tensor,
                           group: Group, k: int, *, periodic: bool = False,
                           out: torch.Tensor | None = None,
                           engine: str = "auto") -> torch.Tensor:
    """k Jacobi sweeps for ONE k-row halo exchange (the aggregation knob).

    ``flo`` / ``fhi`` are the source term's k-row ghost slabs — f is
    iteration-invariant, so the caller exchanges it once per solve."""
    lo, hi = halo_exchange(u, group, halo=k, periodic=periodic)
    frozen_top, frozen_bot = _frozen_depths(group, k, periodic)
    return jacobi_ksweep_parts(lo, u, hi, flo, f, fhi, k, frozen_top,
                               frozen_bot, out=out, engine=engine)


def jacobi_solve(u0: torch.Tensor, f: torch.Tensor, group: Group,
                 iters: int, mode: str = "bulk", *, k: int = 1,
                 periodic: bool = False,
                 engine: str = "auto") -> torch.Tensor:
    """Run ``iters`` Jacobi sweeps of this rank's row block ``u0`` with the
    selected halo schedule.

    mode="bulk"        — paper Fig 2: 1-row exchange, then compute.
    mode="interleaved" — paper Fig 3: 1-row exchange overlapped with the
                         interior compute.
    mode="aggregated"  — deep halos: one k-row exchange per k sweeps plus a
                         redundant ghost trapezoid; pick ``k`` with
                         ``managed.resolve_halo_aggregation`` (k=1 is
                         bulk).  Message count drops from 2*iters to
                         2*ceil(iters/k) + 2 (the +2 is the one-time
                         f-ghost exchange).  On the card a launch of
                         the k-sweep kernel takes k <= 8
                         (``stencil.KSWEEP_MAX_K``: one instantiation per
                         k), and a deeper k runs as chained launches over
                         the same slab; the plain path takes any k.  The
                         managed decision never picks a k above 8, whose
                         chained launches save no sweep time on one card,
                         and clamps a forced one to at most 8.

    ``u0`` is not written; the result is a new tensor (``u0`` itself when
    ``iters`` is 0).  The trace span names the rows' axis ``x``, the axis
    the halo decision is resolved for."""
    row_bytes = u0[:1].numel() * u0.element_size()
    with dispatch_span("halo.solve", u0, op="halo_aggregation", axis="x",
                       nbytes=k * row_bytes, mode=mode, k=k, scale=iters,
                       buffer="halo_rows"):
        return _jacobi_solve(u0, f, group, iters, mode, k=k,
                             periodic=periodic, engine=engine)


def _jacobi_solve(u0: torch.Tensor, f: torch.Tensor, group: Group,
                  iters: int, mode: str = "bulk", *, k: int = 1,
                  periodic: bool = False,
                  engine: str = "auto") -> torch.Tensor:
    if mode not in ("bulk", "interleaved", "aggregated"):
        raise ValueError(f"unknown halo schedule {mode!r}")
    if iters <= 0:
        return u0
    bufs = (torch.empty_like(u0), torch.empty_like(u0))   # ping-pong
    u, turn = u0, 0
    blocks, rem = 0, iters
    if mode == "aggregated":
        k = max(1, int(k))
        blocks, rem = divmod(iters, k)
        if blocks > 0 and k > u0.shape[0]:
            raise ValueError(
                f"aggregation factor k={k} exceeds the local block height "
                f"{u0.shape[0]}: the ghost trapezoid would swallow the "
                f"whole shard (cost_model.decide_halo_aggregation caps k)")
    if blocks > 0:
        # f is iteration-invariant: ship its ghost slabs once
        flo, fhi = halo_exchange(f, group, halo=k, periodic=periodic)
        for _ in range(blocks):
            u = jacobi_step_aggregated(u, f, flo, fhi, group, k,
                                       periodic=periodic, out=bufs[turn],
                                       engine=engine)
            turn ^= 1
    step = (jacobi_step_overlapped if mode == "interleaved"
            else jacobi_step_bulk)
    for _ in range(rem):
        u = step(u, f, group, periodic, out=bufs[turn], engine=engine)
        turn ^= 1
    return u
