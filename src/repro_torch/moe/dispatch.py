"""Capacity-limited token dispatch bookkeeping (index-based, GShard
semantics; port of ``repro.moe.dispatch``).

Dispatch is a stable expert-major argsort: entry (t, k) lands at slot
``pos`` within expert e's capacity block iff fewer than C earlier entries
routed to e (``keep``); overflow entries park in a sentinel row that
contributes exactly zero on combine.  Everything stays on the device: no
``.item()`` and no ``.nonzero()``, so a layer never waits on the host.
"""

from __future__ import annotations

import torch

from repro_torch.core.cost_model import moe_capacity


def capacity_for(tokens: int, e_cfg, capacity_factor: float | None = None
                 ) -> int:
    """Per-expert capacity C for ``tokens`` routed top-k among
    ``e_cfg.n_experts`` experts, rounded UP so a capacity factor of 1.0
    never drops under perfectly balanced routing.  ``capacity_factor``
    overrides the config's static guess (the managed decision's pick)."""
    cf = e_cfg.capacity_factor if capacity_factor is None else capacity_factor
    return moe_capacity(tokens, e_cfg.top_k, e_cfg.n_experts, cf)


def dispatch_indices(top_idx: torch.Tensor, n_experts: int, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """top_idx: [T, K] expert ids.  Returns

      dest  [T*K] slot in the [E*C] buffer (or E*C for dropped entries),
      tok   [T*K] source token of each entry in expert-sorted order,
      keep  [T*K] 1.0 where the entry fit under capacity (f32),
      order [T*K] the stable expert-major argsort of the flat (t, k)
            entries (combine_from_buffers aligns the gates with it).
    """
    t, k = top_idx.shape
    flat_e = top_idx.reshape(t * k).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    tok = order // k
    pos = (torch.arange(t * k, device=top_idx.device)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    fits = pos < capacity
    keep = fits.float()
    dest = torch.where(fits, sorted_e * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return dest, tok, keep, order


def expert_counts(top_idx: torch.Tensor, n_experts: int, capacity: int
                  ) -> torch.Tensor:
    """Per-expert KEPT row counts [E] int32 (``min(load_e, C)``): the
    valid counts the grouped-expert kernel reads.  Rows [0, count_e) of
    expert e's capacity block hold real tokens, the rest are padding."""
    flat = torch.sort(top_idx.reshape(-1).long()).values
    eids = torch.arange(n_experts, device=top_idx.device)
    load = (torch.searchsorted(flat, eids, side="right")
            - torch.searchsorted(flat, eids, side="left"))
    return torch.clamp(load, max=capacity).to(torch.int32)


def gather_to_buffers(x2: torch.Tensor, dest: torch.Tensor,
                      tok: torch.Tensor, keep: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """x2: [T, D] -> expert buffers [E, C, D] (dropped tokens zeroed).
    torch has no drop-mode scatter: the rows go into E*C + 1 rows, whose
    last (the overflow sentinel every dropped entry writes) is cut off."""
    d = x2.shape[-1]
    rows = x2[tok] * keep[:, None].to(x2.dtype)
    buf = x2.new_zeros((n_experts * capacity + 1, d))
    buf = buf.index_copy(0, dest, rows)
    return buf[:-1].reshape(n_experts, capacity, d)


def combine_from_buffers(out: torch.Tensor, dest: torch.Tensor,
                         tok: torch.Tensor, keep: torch.Tensor,
                         gates: torch.Tensor, order: torch.Tensor, t: int
                         ) -> torch.Tensor:
    """out: [E, C, D] -> y [T, D], weighting by the (t, k) gate, in out's
    type.  dest/tok/keep are in expert-sorted order; ``order`` permutes
    the flat [T*K] gate entries into that order.

    The reference scatter-adds the rows into y in expert-sorted order.
    Here each token gathers its K rows and adds them in that same fixed
    order, starting from zero: deterministic on every device (an
    ``index_add_`` on CUDA adds with atomics in a varying order)."""
    e, c, d = out.shape
    flat = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))])
    k = gates.shape[1]
    g = gates.reshape(t * k)[order]
    rows = flat[dest] * (g * keep)[:, None].to(out.dtype)
    # each token's K entries by their place in the expert-sorted order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    slots = torch.sort(inv.reshape(t, k), dim=1).values
    y = out.new_zeros((t, d))
    for j in range(k):
        y = y + rows[slots[:, j]]
    return y
