"""The port's prefill and contiguous-cache generation held against the
reference's, and against the port's own paged serving engine, on the CPU.

Reduced dense and MoE configs (moonshot's ep_a2a experts, grok's
expert_tp experts) in f32 on a (1, 1) mesh with the reference's weights
(``bridge.params_from_numpy``):

  * ``prefill_sp``: the last position's logits and the per-layer K/V
    cache against the reference's prefill step, with the default
    dispatch and with the plain flash attention and grouped-expert FFN
    pinned (f32, within 1e-4);
  * ``Generator(engine="contiguous")``: greedy tokens equal the
    reference's contiguous Generator's, and equal the port's paged
    ``ServeEngine`` (``Generator(engine="paged")``), with full attention
    and with a sliding window smaller than the prompt (the contiguous
    cache is then a ring buffer).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShape
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.train.serve_loop import Generator as RefGenerator
from repro.train.serve_loop import build_prefill_step
from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.model import Model
from repro_torch.train.serve_loop import Generator

ARCHS = ["phi4-mini-3.8b", "granite-34b", "starcoder2-7b",
         "moonshot-v1-16b-a3b", "grok-1-314b"]
TOL = 1e-4


def _pair(arch, window=0, engine="auto"):
    """(reference model, mesh, params) and the port model on the same f32
    weights."""
    def cfg_of(mod):
        return dataclasses.replace(mod.get_reduced(arch), dtype="float32",
                                   sliding_window=window)

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(cfg_of(ref_configs),
                   RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(
        lambda a, s: jax.device_put(np.asarray(a), s),
        ref.init(jax.random.key(0)),
        infer_shardings(ref.param_specs(), mesh))
    port = bridge.params_from_numpy(
        jax.tree.map(np.asarray, params),
        Model(cfg_of(configs), device="cpu", attn_engine=engine,
              moe_engine=engine))
    return (ref, mesh, params), port


def _prompts(vocab, b=3, p=7, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab - 1, size=(b, p)).astype(np.int32)


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, engine):
    (ref, mesh, params), port = _pair(arch, engine=engine)
    tokens = _prompts(port.cfg.vocab_size, b=2, p=24)
    want_logits, want_cache = build_prefill_step(ref, mesh)(
        params, {"tokens": tokens})
    logits, cache = port.prefill_sp({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    for got, want in zip(cache["kv"], want_cache["kv"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(want_logits).argmax(-1))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_generator_tokens_match_reference_and_paged_engine(arch, window):
    (ref, mesh, params), port = _pair(arch, window=window)
    prompts = _prompts(port.cfg.vocab_size)
    want = RefGenerator(ref, mesh, RefShape("t", 32, 3, "decode"),
                        params).generate(prompts, 6)
    shape = ShapeConfig("t", 32, 3, "decode")
    got = Generator(port, shape).generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    paged = Generator(port, shape, engine="paged", page_size=4).generate(
        prompts, 6)
    np.testing.assert_array_equal(paged, got)


def test_contiguous_cache_is_a_ring_buffer_under_a_window():
    (ref, _, _), port = _pair("phi4-mini-3.8b", window=5)
    specs = port.decode_cache_specs(ShapeConfig("t", 32, 3, "decode"))
    sds, _ = ref.decode_cache_specs(RefShape("t", 32, 3, "decode"))
    for k in ("k", "v"):
        assert specs[k][0] == tuple(sds[k].shape) == (2, 3, 5, 2, 16)
        assert specs[k][1] == torch.float32


def test_generator_rejects_unknown_engines():
    _, port = _pair("phi4-mini-3.8b")
    with pytest.raises(ValueError, match="engine"):
        Generator(port, ShapeConfig("t", 32, 3, "decode"), engine="ring")
    with pytest.raises(ValueError, match="paged"):
        Generator(port, ShapeConfig("t", 32, 3, "decode"),
                  engine="paged").empty_cache()
