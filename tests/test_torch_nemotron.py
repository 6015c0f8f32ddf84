"""nemotron-4-340b's head_dim of 192 in the port, held against the
reference on the CPU.

The reduced nemotron config (2 layers, vocab 256) widened to d_model 768
over 4 query and 2 kv heads, so that its head_dim is nemotron's 192, and
d_ff 3072 (relu2, untied), in f32, with the reference's ``Model.init``
weights carried across by ``bridge.params_from_numpy``:

  * one ``build_train_step`` step (default AdamW) gives the reference's
    loss and gradient norm (rtol 1e-5) and updated parameters (1e-4,
    relative or absolute, as tests/test_torch_families.py);
  * ``prefill_sp`` gives the reference's last-position logits (1e-5) with
    the attention on the dense path and with the plain blockwise flash
    engine pinned (``attn_engine="torch"``, the CPU stand-in of the
    kernels);
  * the paged ``Generator`` gives the reference's greedy tokens;
  * the dry run counts nemotron's uncut prefill_32k cell on the
    production 16x16 mesh as ok (the flash kernels take head_dim 192 on
    abstract tensors as on the card).  Its train_4k cell is ok too, but
    takes about 100 s to count here, so it is run by hand
    (``python -m repro_torch.launch.dryrun --arch nemotron-4-340b
    --both-meshes``), not in this file.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.data.pipeline import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.train.serve_loop import Generator as RefGenerator
from repro.train.serve_loop import build_prefill_step
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.serve_loop import Generator
from repro_torch.train.train_loop import build_train_step

ARCH = "nemotron-4-340b"
#: the reduced config at nemotron's head_dim: 768 / 4 = 192
NARROW = dict(d_model=768, n_heads=4, n_kv_heads=2, d_ff=3072,
              dtype="float32")
TOL = 1e-5
PARAM_TOL = 1e-4


def _port_model(params, **kw):
    cfg = dataclasses.replace(configs.get_reduced(ARCH), **NARROW)
    return bridge.params_from_numpy(params, Model(cfg, device="cpu", **kw))


@pytest.fixture(scope="module")
def pair():
    """(reference model, mesh, device params, numpy params)."""
    cfg = dataclasses.replace(ref_configs.get_reduced(ARCH), **NARROW)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    dev = jax.tree.map(lambda a, s: jax.device_put(a, s), params,
                       infer_shardings(ref.param_specs(), mesh))
    return ref, mesh, dev, params


def _flat(tree, prefix=""):
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else ((k, tree[k]) for k in sorted(tree)))
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_narrow_config_keeps_nemotrons_head_dim_and_shapes(pair):
    ref, *_ = pair
    port = _port_model(pair[3])
    full = configs.get_config(ARCH)
    assert full.d_model // full.n_heads == 192
    for cfg in (ref.cfg, port.cfg):
        assert cfg.d_model // cfg.n_heads == 192
        assert (cfg.n_layers, cfg.vocab_size, cfg.mlp) == (2, 256, "relu2")
        assert not cfg.tie_embeddings


def test_train_step_matches_reference(pair):
    ref, mesh, _, params = pair
    batch = dict(SyntheticLMData(DataConfig(
        vocab_size=ref.cfg.vocab_size, seq_len=32,
        global_batch=2)).global_batch_at(0))
    step, pshard, bshard = ref_build_train_step(ref, RefAdamWConfig(), mesh,
                                                donate=False)
    p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
    p2, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()),
                    {k: jax.device_put(v, bshard[k]) for k, v in
                     batch.items()})
    want = _flat(jax.tree.map(np.asarray, p2))

    port = _port_model(params)
    _, metrics = build_train_step(port, AdamWConfig())(
        adamw_init(port.params(), AdamWConfig()),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(m[key]),
                                   rtol=TOL, err_msg=key)
    got = flatten_specs(bridge.params_to_numpy(port))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("attn_engine", ["auto", "torch"])
def test_prefill_logits_match_reference(pair, attn_engine):
    ref, mesh, dev, params = pair
    tokens = np.random.default_rng(2).integers(
        0, ref.cfg.vocab_size - 1, size=(2, 40)).astype(np.int32)
    want, _ = build_prefill_step(ref, mesh)(dev, {"tokens": tokens})
    port = _port_model(params, attn_engine=attn_engine)
    got, cache = port.prefill_sp({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert cache["kv"][0].shape[-1] == 192


def test_paged_greedy_tokens_match_reference(pair):
    ref, mesh, dev, params = pair
    prompts = np.random.default_rng(0).integers(
        0, ref.cfg.vocab_size - 1, size=(2, 5)).astype(np.int32)
    want = RefGenerator(ref, mesh, RefShapeConfig("serve", 16, 2, "decode"),
                        dev).generate(prompts, n_new=4)
    got = Generator(_port_model(params), ShapeConfig("serve", 16, 2,
                                                     "decode"),
                    engine="paged", page_size=4).generate(prompts, n_new=4)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_dry_run_counts_the_uncut_prefill_32k_cell():
    rec = dryrun.lower_cell(ARCH, "prefill_32k", False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_chips"] == 256
    assert rec["flops_per_chip"] > 0 and rec["hbm_bytes_per_chip"] > 0
    assert rec["memory"]["peak_bytes"] > 0
