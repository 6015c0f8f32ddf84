#!/usr/bin/env python3
"""Compare one loss and gradient of the reference and the port in a
config's own type, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/bf16_parity.py \\
        [ARCH] [DTYPE]

Draws the reference's seed-0 weights of the reduced ARCH (default
granite-34b) in DTYPE (default: the config's, bf16), carries them into
the port, and computes the loss and its gradient on the quickstart's
first batch (8 x 128, ``SyntheticLMData``) on both sides: the reference
under ``shard_map`` on a 1x1 mesh, the port with ``torch.autograd``.
Prints both losses and, per parameter, the share of gradient elements
that differ and the largest difference beside the largest magnitude.
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap, spec_pspecs
from repro_torch import bridge, configs
from repro_torch.models.model import Model, flatten_specs


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def main(arch: str = "granite-34b", dtype: str | None = None) -> None:
    cfg = ref_configs.get_reduced(arch)
    port_cfg = configs.get_reduced(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        port_cfg = dataclasses.replace(port_cfg, dtype=dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(cfg, RefMeshCtx.from_mesh(mesh))
    params = ref.init(jax.random.key(0))
    batch = SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128,
        global_batch=8)).global_batch_at(0)

    def loss_of(p, b):
        return ref.loss_sp(p, b)[0]

    batch_spec = {k: P(("data",), None) for k in batch}
    pspecs = spec_pspecs(ref.param_specs())
    ref_loss, ref_grads = jax.jit(smap(
        jax.value_and_grad(loss_of), mesh, in_specs=(pspecs, batch_spec),
        out_specs=(P(), pspecs)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    model = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     Model(port_cfg, device="cpu"))
    loss, _ = model.loss_sp({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    leaves = flatten_specs(model.params())
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    print(f"{arch} {port_cfg.dtype}: loss port {loss.item()!r} reference "
          f"{float(ref_loss)!r}")
    want = _flat(ref_grads)
    for name in sorted(grads):
        got = grads[name].float().numpy()
        ref_g = want[name].astype(np.float32)
        print(f"  {name:16s} differing {float((got != ref_g).mean()):.4f}"
              f"  max|diff| {float(np.abs(got - ref_g).max()):.3e}"
              f"  max|grad| {float(np.abs(ref_g).max()):.3e}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
