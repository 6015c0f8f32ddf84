"""Managed expert-parallel dispatch (port of ``repro.moe``): the capacity
math, index-based gather/combine and per-expert valid counts shared by
the model blocks (models/moe.py), the grouped-expert kernel
(kernels/grouped_matmul.py) and the decision
(core/cost_model.py::decide_moe_dispatch)."""

from repro_torch.moe.dispatch import (capacity_for, combine_from_buffers,
                                      dispatch_indices, expert_counts,
                                      gather_to_buffers)

__all__ = ["capacity_for", "combine_from_buffers", "dispatch_indices",
           "expert_counts", "gather_to_buffers"]
