"""The contiguous decode step (``train.serve_loop.DecodeStep``) on the CPU.

``build_decode_step`` returns a ``DecodeStep``, the port of the
reference's ``jax.jit(smap(model.decode_step), donate_argnums=(1,))``
with a traced position: ``Model.decode_step`` takes the position as a 0-d
int32 tensor on the model's device and reads nothing on the host, so on
one card ``Generator`` runs every token as one replay of a captured CUDA
graph.  Here, on the CPU, with reduced configs in f32 and the same
weights in both packages (``bridge.params_to_numpy``) — phi4-mini (dense),
phi4-mini with an 8-position sliding window (smaller than the prompts
and the positions below), hymba (hybrid, a per-layer list cache),
mamba2 (SSM), whisper (audio: cross-attention K/V in the cache) and
moonshot (MoE):

  * (a) one step through the plan buffers (``load``, then ``run_eager``)
    against one call of the reference's jitted ``build_decode_step`` (the
    step its ``Generator`` builds) on
    the same random cache, at position 0, in the middle, past the
    window's ring and past the cache's end: next tokens equal, every
    cache leaf within rtol 1e-5 / atol 1e-5 of the leaf's largest
    magnitude (at least 1);
  * (b) ``Generator.generate`` (its steps through ``run_eager``) against
    the reference's ``Generator.generate`` at ``start_pos`` 0 and 5 (the
    windowed config's later start decodes past its window), and
    ``prefill_generate`` against the reference's ``generate`` of the same
    prompt, tokens equal.  Whisper and moonshot are left out of the
    latter: whisper's prefill attends the encoder's frames where its
    ``generate`` attends a zero encoder output, and moonshot's prefill
    routes the prompt through capacity buffers (capacity factor 1.25),
    which drop tokens that the per-token decode keeps;
  * (c) the step on meta tensors, the position a 0-d meta tensor, for
    every family: a meta tensor raises on any read on the host;
  * (d) ``decode_mode`` is "eager" on the CPU, on meta tensors, over a
    mesh and under an ``instrument`` recorder, "graph" for a model on a
    card (its device named cuda) with every mesh axis of size 1;
  * (e) the binding: two generations keep the cache's address and bind
    once; a rebound parameter, an engine attribute and a generation
    longer than the buffers each make a new binding, with the same
    tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.train.serve_loop import Generator as RefGenerator
from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import instrument
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.serve_loop import (DecodeStep, Generator,
                                          build_decode_step)

#: family -> (arch, sliding window override or None)
FAMILIES = {"phi4-mini": ("phi4-mini-3.8b", None),
            "phi4-window8": ("phi4-mini-3.8b", 8),
            "hymba": ("hymba-1.5b", None),
            "mamba2": ("mamba2-130m", None),
            "whisper": ("whisper-small", None),
            "moonshot": ("moonshot-v1-16b-a3b", None)}
SEQ, BATCH = 24, 2
#: position 0, one in the middle, one past every window's ring (8, and
#: hymba's 16), one past the 24-position cache
POSITIONS = [0, 5, 19, 30]
RTOL, ATOL = 1e-5, 1e-5


def _cfg(cfgs, family):
    arch, window = FAMILIES[family]
    cfg = dataclasses.replace(cfgs.get_reduced(arch), dtype="float32")
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return cfg


@functools.cache
def _pair(family):
    """(reference model, mesh, device params, port model), once a family:
    the weights drawn by the port's ``init`` (the reference's scheme) and
    carried to the reference as numpy arrays (``bridge.params_to_numpy``),
    which costs no compile of the reference's init."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(_cfg(ref_configs, family),
                   RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    port = Model(_cfg(configs, family), device="cpu").init(
        torch.Generator().manual_seed(0))
    dev = jax.tree.map(lambda a, s: jax.device_put(a, s),
                       bridge.params_to_numpy(port),
                       infer_shardings(ref.param_specs(), mesh))
    return ref, mesh, dev, port


@functools.cache
def _ref_gen(family):
    """The reference's contiguous ``Generator``, once a family: its
    ``decode_fn``, ``cache_sds`` and ``cache_shardings`` are what its
    ``build_decode_step`` returns, compiled once."""
    ref, mesh, params, _ = _pair(family)
    return RefGenerator(ref, mesh, RefShapeConfig("t", SEQ, BATCH, "decode"),
                        params)


def _layers(cache):
    return cache if isinstance(cache, list) else [cache]


def _shape():
    return ShapeConfig("t", SEQ, BATCH, "decode")


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_matches_reference_jit(family, pos):
    ref, _, params, port = _pair(family)
    g = _ref_gen(family)
    ref_step, sds, shardings = g.decode_fn, g.cache_sds, g.cache_shardings
    rng = np.random.default_rng(pos)
    rand = jax.tree.map(lambda s: (0.5 * rng.standard_normal(s.shape))
                        .astype(s.dtype), sds)
    token = rng.integers(0, port.cfg.vocab_size - 1, size=BATCH) \
        .astype(np.int32)
    want_tok, want_cache = ref_step(
        params, jax.tree.map(jax.device_put, rand, shardings),
        jnp.asarray(token), jnp.int32(pos))

    step, _ = build_decode_step(port, _shape())
    step.load(token[:, None], 1, start_pos=pos)
    for got, src in zip(_layers(step.cache), _layers(rand)):
        for k, leaf in got.items():
            leaf.copy_(torch.from_numpy(np.asarray(src[k])))
    step.run_eager()
    np.testing.assert_array_equal(step.out[:, 0].numpy(),
                                  np.asarray(want_tok))
    assert int(step.t) == 1 and int(step.pos) == pos + 1
    for i, (got, want) in enumerate(zip(_layers(step.cache),
                                        _layers(want_cache))):
        assert set(got) == set(want)
        for k, leaf in got.items():
            w = np.asarray(want[k])
            np.testing.assert_allclose(
                leaf.numpy(), w, rtol=RTOL,
                atol=ATOL * max(1.0, float(np.abs(w).max())),
                err_msg=f"{family} at {pos}: layer group {i}, {k}")


@pytest.mark.parametrize("start_pos", [0, 5])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_generate_matches_reference(family, start_pos):
    ref, mesh, params, port = _pair(family)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, port.cfg.vocab_size - 1, size=(BATCH, 6)) \
        .astype(np.int32)
    want = _ref_gen(family).generate(prompts, 6, start_pos=start_pos)
    gen = Generator(port, _shape())
    assert gen.step.decode_mode == "eager"
    got = gen.generate(prompts, 6, start_pos=start_pos)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(gen.step.pos) == start_pos + 6 + 6 - 1


@pytest.mark.parametrize("family", [f for f in FAMILIES
                                    if f not in ("whisper", "moonshot")])
def test_prefill_generate_matches_reference(family):
    ref, mesh, params, port = _pair(family)
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, port.cfg.vocab_size - 1, size=(BATCH, 10)) \
        .astype(np.int32)
    want = _ref_gen(family).generate(prompts, 6)
    gen = Generator(port, _shape())
    np.testing.assert_array_equal(gen.prefill_generate(prompts, 6),
                                  np.asarray(want))
    assert int(gen.step.pos) == 10 + 6 - 1


@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_runs_on_meta_tensors(family):
    model = Model(_cfg(configs, family), device="meta")
    step, specs = build_decode_step(model, _shape())

    def alloc(entry):
        return {k: torch.empty(s, dtype=dt, device="meta")
                for k, (s, dt) in entry.items()}
    cache = [alloc(e) for e in specs] if isinstance(specs, list) \
        else alloc(specs)
    token = torch.empty((BATCH,), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    nxt, out = step(cache, token, pos)
    assert out is cache
    assert nxt.device.type == "meta" and nxt.shape == (BATCH,)
    assert nxt.dtype == torch.int32
    # the owned state and the plan on meta too
    step.load(np.zeros((BATCH, 3), np.int32), 4, start_pos=2)
    assert step.decode_mode == "eager"
    step.advance(6)
    assert step.pos.device.type == "meta" and step.graph is None


@pytest.mark.parametrize("where", ["cpu", "meta", "mesh", "recorder"])
def test_decode_mode_is_eager_off_one_card(where):
    cfg = _cfg(configs, "phi4-mini")
    if where == "mesh":
        model = Model(cfg, MeshCtx(axis_sizes={"data": 1, "model": 2}),
                      device="meta")
    else:
        model = Model(cfg, device="cpu" if where == "cpu" else "meta")
    step = build_decode_step(model, _shape())[0]
    assert isinstance(step, DecodeStep)
    assert step.decode_mode == "eager"
    if where in ("meta", "recorder"):
        # the same model on a card (its device named cuda): graph, and
        # eager again while a recorder sees the ops
        model.device = torch.device("cuda")
        assert step.decode_mode == "graph"
    if where == "recorder":
        seen = []
        instrument.analyze_region(lambda _x: seen.append(step.decode_mode),
                                  torch.zeros(1))
        assert seen == ["eager"] and step.decode_mode == "graph"


def test_rebinding():
    port = _pair("phi4-mini")[3]
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, port.cfg.vocab_size - 1, size=(BATCH, 5)) \
        .astype(np.int32)
    gen = Generator(port, _shape())
    st = gen.step
    first = gen.generate(prompts, 4)
    ptrs = [t.data_ptr() for layer in _layers(st.cache)
            for t in layer.values()]
    np.testing.assert_array_equal(gen.generate(prompts, 4), first)
    assert st.bindings == 1
    assert [t.data_ptr() for layer in _layers(st.cache)
            for t in layer.values()] == ptrs

    # a rebound parameter: a new binding, the same cache and tokens
    name = "layers/w_q"
    old = port.flat[name]
    port.flat[name] = nn.Parameter(old.detach().clone(),
                                   requires_grad=old.requires_grad)
    try:
        np.testing.assert_array_equal(gen.generate(prompts, 4), first)
        assert st.bindings == 2
        assert [t.data_ptr() for layer in _layers(st.cache)
                for t in layer.values()] == ptrs
    finally:
        port.flat[name] = old
    np.testing.assert_array_equal(gen.generate(prompts, 4), first)
    assert st.bindings == 3

    # an engine attribute the step froze, and buffers that grow
    port.moe_engine = "torch"
    try:
        gen.generate(prompts, 4)
        assert st.bindings == 4
    finally:
        port.moe_engine = "auto"
    width = st.width
    long = gen.generate(prompts, SEQ)          # 5 + 24 - 1 steps > SEQ
    assert st.width == 5 + SEQ - 1 > width and st.bindings == 5
    np.testing.assert_array_equal(long[:, :4], first)
