"""The program's side of a configuration: its ``ModelConfig``, a ``Model``
holding the benchmark's weights, and the map between the published
layout (``reference/weights.py``) and the program's.

The program keeps its parameters in its own layout: query heads padded
to its tensor-parallel multiple (phi4-mini's 24 to 32, groups of 4 query
heads a key and value head where the published model has groups of 3),
keys and values in one ``w_kv`` [L, D, 2 * KV * hd].  Published head
``h`` goes to program head ``(h // g) * gp + h % g`` (``g``, ``gp`` the
two group sizes); the padding heads' query columns and output rows are
zeros, so the program computes the published model.
"""

from __future__ import annotations

import torch

from portbench.reference import weights as ref_weights

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model


def model_config(conf: dict) -> ModelConfig:
    """The program's configuration of a configuration file."""
    a = conf["arch"]
    return ModelConfig(
        name=conf["name"], family="dense",
        n_layers=a["n_layers"], d_model=a["d_model"], n_heads=a["n_heads"],
        n_kv_heads=a["n_kv_heads"], d_head=a["head_dim"], d_ff=a["d_ff"],
        vocab_size=a["vocab_size"], mlp="swiglu", rope_theta=a["rope_theta"],
        norm_eps=a["norm_eps"], tie_embeddings=a["tie_embeddings"],
        dtype=a["dtype"], tp_multiple=a.get("tp_multiple", 16))


def _groups(arch: dict, model: Model) -> tuple[int, int, int]:
    """(g, gp, hd): published and program query heads a key and value
    head, and the head size."""
    hd = arch["head_dim"]
    kv = arch["n_kv_heads"]
    hp = model.flat["layers/w_q"].shape[-1] // hd
    kvp = model.flat["layers/w_kv"].shape[-1] // (2 * hd)
    if kvp != kv or hp % kv or hp < arch["n_heads"]:
        raise ValueError(f"the program holds {hp} query and {kvp} key and "
                         f"value heads for {arch['n_heads']} and {kv}")
    return arch["n_heads"] // kv, hp // kv, hd


def head_columns(arch: dict, model: Model, device) -> torch.Tensor:
    """The program's query columns of the published ones, in order."""
    g, gp, hd = _groups(arch, model)
    heads = torch.arange(arch["n_heads"], device=device)
    ph = (heads // g) * gp + heads % g
    return (ph[:, None] * hd + torch.arange(hd, device=device)).reshape(-1)


def to_program(arch: dict, model: Model, name: str, w: torch.Tensor
               ) -> tuple[str, torch.Tensor]:
    """A published leaf as the program's leaf (name, tensor); ``w_k`` and
    ``w_v`` come back as the two halves of ``w_kv`` ("w_kv:k" / ":v")."""
    if name in ("layers/w_q", "layers/w_o"):
        dst = torch.zeros(model.flat[name].shape, dtype=w.dtype,
                          device=w.device)
        cols = head_columns(arch, model, w.device)
        if name == "layers/w_q":
            dst[..., cols] = w
        else:
            dst[:, cols] = w
        return name, dst
    if name in ("layers/w_k", "layers/w_v"):
        return "layers/w_kv:" + name[-1], w
    return name, w


def to_published(arch: dict, model: Model, name: str, t: torch.Tensor
                 ) -> torch.Tensor:
    """The published leaf ``name`` out of a tensor in the program's layout
    of its program leaf (the reverse of ``to_program``)."""
    if name == "layers/w_q":
        return t[..., head_columns(arch, model, t.device)]
    if name == "layers/w_o":
        return t[:, head_columns(arch, model, t.device)]
    if name in ("layers/w_k", "layers/w_v"):
        k, v = t.chunk(2, dim=-1)
        return k if name.endswith("k") else v
    return t


def program_leaf(name: str) -> str:
    """The program's leaf that holds published leaf ``name``."""
    return "layers/w_kv" if name in ("layers/w_k", "layers/w_v") else name


def build_model(conf: dict, seed: int, device: torch.device) -> Model:
    """A ``Model`` of the configuration with the benchmark's weights of
    ``seed``, loaded leaf by leaf through ``load_state_dict``."""
    arch = conf["arch"]
    model = Model(model_config(conf), device=device)
    loaded = set()
    halves: dict[str, torch.Tensor] = {}
    for name in ref_weights.leaf_specs(arch):
        key, t = to_program(arch, model, name,
                            ref_weights.make_leaf(arch, seed, name, device))
        if key.startswith("layers/w_kv:"):
            halves[key[-1]] = t
            if len(halves) < 2:
                continue
            key, t = "layers/w_kv", torch.cat([halves["k"], halves["v"]],
                                             dim=-1)
            halves = {}
        model.load_state_dict({"flat." + key: t}, strict=False)
        loaded.add(key)
        del t
    missing = set(model.flat.keys()) - loaded
    if missing:
        raise ValueError(f"no benchmark weights for {sorted(missing)}")
    return model
