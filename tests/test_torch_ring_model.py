"""The port's model with ``attn_impl`` in {ring, ulysses, auto} held
against the reference's at a (1, 1) mesh, on the CPU.

Reduced phi4-mini-3.8b (GQA) and granite-34b (MQA) in f32 with the
reference's ``Model.init`` weights (``bridge.params_from_numpy``) and the
same ``SyntheticLMData`` batch, both sides with the same ``attn_impl``
and managed mode "auto" (which at tp = 1 ties the three schedules and
picks bulk):

  * ``loss_sp`` within rtol 2e-4 and one AdamW step's parameters within
    rtol 2e-3 / atol 3e-4 (the tolerances of
    tests/dist_suite/test_ring_attention.py::test_train_step_with_ring_
    attention);
  * ``prefill_sp``'s last-position logits within 1e-4;
  * greedy tokens: the port continuing its prefill cache
    (``Generator.generate_from_prefill``) equals the reference's
    contiguous ``Generator``;
  * the model resolves (and logs) the attention decisions once per shape,
    not per layer per step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.serve_loop import Generator as RefGenerator
from repro.train.serve_loop import build_prefill_step
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import managed
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.serve_loop import Generator
from repro_torch.train.train_loop import build_train_step

ARCHS = ["phi4-mini-3.8b", "granite-34b"]
IMPLS = ["ring", "ulysses", "auto"]
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    arch = request.param
    cfg = dataclasses.replace(ref_configs.get_reduced(arch), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = RefModel(cfg, RefMeshCtx.from_mesh(mesh)).init(
        jax.random.key(0))
    return arch, jax.tree.map(np.asarray, params)


def _batch(vocab):
    return RefData(RefDataConfig(vocab_size=vocab, seq_len=SEQ,
                                 global_batch=BATCH)).global_batch_at(0)


def _reference(arch, impl, params):
    """The reference's loss and parameters after one AdamW step, prefill
    logits and greedy tokens under ``impl``."""
    cfg = dataclasses.replace(ref_configs.get_reduced(arch),
                              dtype="float32", attn_impl=impl)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="auto"))
    step, pshard, bshard = ref_build_train_step(
        model, RefAdamWConfig(lr=1e-2), mesh, donate=False)
    p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
    batch = {k: jax.device_put(v, bshard[k])
             for k, v in _batch(cfg.vocab_size).items()}
    p2, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()), batch)
    prompts = _batch(cfg.vocab_size)["tokens"][:3, :7]
    logits, _ = build_prefill_step(model, mesh)(p, {"tokens": prompts})
    tokens = RefGenerator(model, mesh, RefShape("t", 32, 3, "decode"),
                          p).generate(prompts, 6)
    return (float(m["loss"]), jax.tree.map(np.asarray, p2),
            np.asarray(logits), np.asarray(tokens))


@pytest.mark.parametrize("impl", IMPLS)
def test_model_with_sp_schedule_matches_reference(weights, impl):
    arch, params = weights
    want_loss, want_params, want_logits, want_tokens = _reference(
        arch, impl, params)
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                              attn_impl=impl)
    port = bridge.params_from_numpy(params, Model(cfg, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size).items()}
    step = build_train_step(port, AdamWConfig(lr=1e-2))
    with managed.capture_decisions() as cap:
        _, metrics = step(adamw_init(port.params(), AdamWConfig()), batch)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=2e-4)
    got = flatten_specs(bridge.params_to_numpy(port))
    for name, want in flatten_specs(want_params).items():
        np.testing.assert_allclose(got[name], want, rtol=2e-3, atol=3e-4,
                                   err_msg=name)
    # one decision per shape for the whole stack, forward and backward
    want_ops = {"ring": ["ring_attention"], "ulysses": [],
                "auto": ["attention_schedule"]}[impl]
    assert [r.op for r in cap.records] == want_ops

    port = bridge.params_from_numpy(params, Model(cfg, device="cpu"))
    prompts = _batch(cfg.vocab_size)["tokens"][:3, :7]
    logits, cache = port.prefill_sp({"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4)
    tokens = Generator(port, ShapeConfig("t", 32, 3, "decode")) \
        .generate_from_prefill(logits, cache, 6)
    np.testing.assert_array_equal(tokens, want_tokens)


def test_generate_from_prefill_rejects_what_it_cannot_continue():
    cfg = configs.get_reduced("phi4-mini-3.8b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = torch.zeros((1, 30), dtype=torch.int32)
    logits, cache = model.prefill_sp({"tokens": prompts})
    with pytest.raises(ValueError, match="exceed"):
        Generator(model, ShapeConfig("t", 32, 1, "decode")) \
            .generate_from_prefill(logits, cache, 6)
    with pytest.raises(ValueError, match="contiguous"):
        Generator(model, ShapeConfig("t", 32, 1, "decode"), engine="paged") \
            .generate_from_prefill(logits, cache, 2)
