"""Seeded weights of a configuration in its published layout.

The benchmark makes every weight itself, on the device, from ``--seed``:
one generator a leaf, seeded from the run's seed and the leaf's name, so
any leaf can be made again alone and the same seed gives the same
numbers on the same device.  Matrices are N(0, 1/fan_in) drawn in the
configuration's type; norm scales are zero (the models scale by 1 + w).
The program gets these numbers through its own loading path
(``portbench/load.py``); the reference makes them again and computes in
float32.

The published layout, for ``L`` layers, ``H`` heads of ``hd``, ``KV`` key
and value heads, width ``D``, vocabulary ``V``: ``embed`` [V, D],
``unembed`` [D, V] (untied models), ``final_ln`` [D], and stacked over
layers ``ln1``, ``ln2`` [L, D], ``w_q`` [L, D, H*hd], ``w_k``, ``w_v`` [L,
D, KV*hd], ``w_o`` [L, H*hd, D]; the MLP's ``w_up``, ``w_gate`` [L, D, F]
and ``w_down`` [L, F, D].
"""

from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def leaf_specs(arch: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (shape, fan_in); fan_in 0 marks a norm scale (zeros)."""
    d, v, n = arch["d_model"], arch["vocab_size"], arch["n_layers"]
    h, kv, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    f = arch["d_ff"]
    specs = {"embed": ((v, d), v), "final_ln": ((d,), 0)}
    if not arch["tie_embeddings"]:
        specs["unembed"] = ((d, v), d)
    lay = {"ln1": ((d,), 0), "ln2": ((d,), 0),
           "w_q": ((d, h * hd), d), "w_k": ((d, kv * hd), d),
           "w_v": ((d, kv * hd), d), "w_o": ((h * hd, d), h * hd),
           "w_up": ((d, f), d), "w_gate": ((d, f), d), "w_down": ((f, d), f)}
    for k, (shape, fan) in lay.items():
        specs[f"layers/{k}"] = ((n,) + shape, fan)
    return specs


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a leaf's name."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_leaf(arch: dict, seed: int, name: str,
              device: torch.device | str) -> torch.Tensor:
    """One leaf in the configuration's type, on ``device``."""
    shape, fan = leaf_specs(arch)[name]
    dtype = DTYPES[arch["dtype"]]
    if fan == 0:
        return torch.zeros(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, name))
    w = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return w.mul_(1.0 / math.sqrt(fan))


def make_all(arch: dict, seed: int, device: torch.device | str,
             dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Every leaf, cast to ``dtype`` (default: the configuration's)."""
    out = {}
    for name in leaf_specs(arch):
        w = make_leaf(arch, seed, name, device)
        out[name] = w if dtype is None else w.to(dtype)
    return out
