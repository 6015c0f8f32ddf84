"""Carry the reference's weights into the port.

``repro.models.model.Model.init(key)`` draws its weights with
``jax.random``, which torch cannot reproduce.  A parity test therefore
converts the reference tree to numpy (``np.asarray`` on each leaf) and
copies it into the port's ``Model`` here, so that both compute the same
function.  The layouts are identical by construction (the port's
``param_specs`` equal the reference's), so this is a shape-checked copy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.model import Model, flatten_specs


def _to_torch(arr: Any) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def params_from_numpy(tree: dict, model: Model) -> Model:
    """Copy the reference parameter tree (numpy leaves, the reference's
    nesting) into ``model``'s parameters; returns ``model``."""
    got = flatten_specs(tree)
    dst = flatten_specs(model.params())
    if set(got) != set(dst):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(dst) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(dst))}")
    for name, arr in got.items():
        src = _to_torch(arr)
        if tuple(src.shape) != tuple(dst[name].shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(dst[name].shape)}")
        dst[name].copy_(src.to(dst[name].dtype))
    return model
