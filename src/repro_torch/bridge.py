"""Carry the reference's weights and optimizer state into the port, and
back.

``repro.models.model.Model.init(key)`` draws its weights with
``jax.random``, which torch cannot reproduce.  A parity test therefore
converts the reference tree to numpy (``np.asarray`` on each leaf) and
copies it into the port's ``Model`` here, so that both compute the same
function.  The layouts are identical by construction (the port's
``param_specs`` equal the reference's), so this is a shape-checked copy.
The way back (``params_to_numpy``, ``adamw_state_to_numpy``) gives numpy
trees in the reference's nesting, bf16 widened to f32 (numpy has no
bf16), so a test can compare updated weights and moments.

Over a mesh each rank holds its shards: ``params_from_numpy`` cuts the
reference's full arrays to this rank's blocks by ``ParamSpec`` and the
rank's coordinates (the reference's ``infer_shardings`` +
``device_put``), and ``params_to_numpy_full`` gathers them back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import transport
from repro_torch.models.model import (Model, flatten_specs,
                                      unflatten_specs)
from repro_torch.parallel.sharding import LOGICAL_RULES, shard_of


def _to_torch(arr: Any) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def params_from_numpy(tree: dict, model: Model) -> Model:
    """Copy the reference parameter tree (numpy leaves of the GLOBAL
    shapes, the reference's nesting) into ``model``'s parameters, each
    cut to this rank's block; returns ``model``."""
    got = flatten_specs(tree)
    dst = flatten_specs(model.params())
    specs = flatten_specs(model.param_specs())
    if set(got) != set(dst):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(dst) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(dst))}")
    for name, arr in got.items():
        src = _to_torch(shard_of(arr, specs[name], model.ctx))
        if tuple(src.shape) != tuple(dst[name].shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(dst[name].shape)}")
        dst[name].copy_(src.to(dst[name].dtype))
    return model


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _tree_to_numpy(tree: dict) -> dict:
    return unflatten_specs({k: _to_numpy(v)
                            for k, v in flatten_specs(tree).items()})


def params_to_numpy(model: Model) -> dict:
    """The model's parameters as a numpy tree in the reference's nesting."""
    return _tree_to_numpy(model.params())


def param_full(model: Model, name: str) -> torch.Tensor:
    """Parameter ``name`` ("a/b") at its GLOBAL shape on the model's
    device, gathered over every mesh axis a dim is sharded on (a
    collective: every rank calls it)."""
    spec = flatten_specs(model.param_specs())[name]
    t = flatten_specs(model.params())[name].detach()
    for dim, logical in enumerate(spec.logical):
        ax = LOGICAL_RULES[logical]
        if ax and model.ctx.axis_sizes.get(ax, 1) > 1:
            t = torch.cat(transport.all_gather(
                t.movedim(dim, 0).contiguous(), model.ctx.group(ax)))
            t = t.movedim(0, dim)
    return t


def params_to_numpy_full(model: Model) -> dict:
    """The model's parameters at their GLOBAL shapes (``param_full``), on
    every rank, as a numpy tree."""
    return unflatten_specs({name: _to_numpy(param_full(model, name))
                            for name in flatten_specs(model.params())})


def adamw_state_to_numpy(state: dict) -> dict:
    """AdamW state {"mu", "nu", "step"} (optim/adamw.py) as numpy."""
    return {"mu": _tree_to_numpy(state["mu"]),
            "nu": _tree_to_numpy(state["nu"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def adamw_state_from_numpy(tree: dict, model: Model,
                           moment_dtype: str = "float32") -> dict:
    """The reference's AdamW state (numpy leaves) as the port's, on the
    model's device, shape-checked against the model's parameters."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moment_dtype]
    params = flatten_specs(model.params())
    out = {}
    for which in ("mu", "nu"):
        got = flatten_specs(tree[which])
        if set(got) != set(params):
            raise ValueError(f"{which}: parameter names differ")
        leaves = {}
        specs = flatten_specs(model.param_specs())
        for name, arr in got.items():
            t = _to_torch(shard_of(arr, specs[name], model.ctx)).to(dt)
            if tuple(t.shape) != tuple(params[name].shape):
                raise ValueError(f"{which}/{name}: shape {tuple(t.shape)} "
                                 f"!= {tuple(params[name].shape)}")
            leaves[name] = t.to(model.device)
        out[which] = unflatten_specs(leaves)
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=model.device)
    return out

