"""The port's model held against the reference's, layer stack and all.

Reduced dense configs (phi4-mini's GQA, granite's MQA with a 2-matrix
GELU MLP, starcoder2's GQA) and MoE configs (moonshot's ep_a2a SwiGLU
experts, grok's expert_tp GeGLU experts) carry the reference's
``Model.init`` weights across through ``bridge.params_from_numpy``; then
``decode_step_paged`` runs 8 steps on both sides against the same paged
cache geometry, with slots at different positions and an inactive slot,
in f32.  For the MoE configs ``loss_sp`` (with its load-balance aux term)
and every gradient are held to ``jax.grad`` of the reference's, with the
grouped-expert FFN's autograd Function and with its plain version
pinned (loss within 1e-5, gradients within 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap, spec_pspecs
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers
from repro_torch.models.model import Model, flatten_specs
from repro_torch.parallel.sharding import MeshCtx

MOE = ["moonshot-v1-16b-a3b", "grok-1-314b"]
ARCHS = ["phi4-mini-3.8b", "granite-34b", "starcoder2-7b"] + MOE
DENSE = ["nemotron-4-340b", "granite-34b", "starcoder2-7b", "phi4-mini-3.8b"]
TOL = 1e-4


def _ref_model(cfg):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")), mesh


def _ref_step(model, mesh, cache_pspecs):
    """Jitted reference step: (next token, logits, new cache).  The token
    comes from the reference's own decode_step_paged; the logits repeat
    its computation up to the sampler."""
    def body(params, cache, table, tok, pos, act):
        cfg, ctx = model.cfg, model.ctx
        nxt, new_cache = model.decode_step_paged(params, cache, table, tok,
                                                 pos, act)
        x = ref_layers.embed_decode(tok, params["embed"], cfg, ctx)
        x, _ = ref_transformer.stack_decode_paged(
            x, params["layers"], cache, table, pos, act, cfg, ctx)
        x = ref_layers.rms_norm_sharded(x, params["final_ln"], cfg.norm_eps,
                                        "data")
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return nxt, jnp.dot(x, w), new_cache

    pspecs = spec_pspecs(model.param_specs())
    return jax.jit(smap(body, mesh,
                        in_specs=(pspecs, cache_pspecs, P(None, None),
                                  P(None), P(None), P(None)),
                        out_specs=(P(None), P(None, None), cache_pspecs)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_reference(arch):
    cfg_ref = dataclasses.replace(ref_configs.get_reduced(arch),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    ref, mesh = _ref_model(cfg_ref)
    params = ref.init(jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, params),
                             Model(cfg, device="cpu"))

    slots, page, n_pages, pmax = 3, 4, 12, 4
    sds, cps = ref.paged_cache_specs(slots, n_pages, page)
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), sds)
    specs = port.paged_cache_specs(slots, n_pages, page)
    cache = {k: torch.zeros(shape, dtype=dt)
             for k, (shape, dt) in specs.items()}
    for k in ref_cache:       # same pools, plus the port's trailing page
        assert specs[k][0] == (ref_cache[k].shape[:1]
                               + (ref_cache[k].shape[1] + 1,)
                               + ref_cache[k].shape[2:])
    step = _ref_step(ref, mesh, cps)

    rng = np.random.default_rng(1)
    table = rng.permutation(n_pages)[:slots * pmax].reshape(slots, pmax) \
        .astype(np.int32)
    pos = np.array([0, 3, 5], np.int32)
    tok = rng.integers(0, cfg.vocab_size - 1, size=slots).astype(np.int32)
    for t in range(8):
        act = np.array([True, True, t not in (2, 5)])
        nxt_ref, logits_ref, ref_cache = step(
            params, ref_cache, jnp.asarray(table), jnp.asarray(tok),
            jnp.asarray(pos), jnp.asarray(act))
        logits, cache = port.decode_logits_paged(
            cache, torch.from_numpy(table), torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(act))
        nxt = layers.greedy_sample(logits, port.ctx)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref),
                                      err_msg=f"step {t}")
        pos = pos + act.astype(np.int32)
        tok = np.where(act, np.asarray(nxt_ref), tok).astype(np.int32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               rtol=TOL, atol=TOL)
    for k in ref_cache:
        np.testing.assert_allclose(cache[k][:, :n_pages].numpy(),
                                   np.asarray(ref_cache[k]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_param_specs_equal_reference_at_published_size(arch):
    """The bridge is a plain copy because the layouts are identical:
    every parameter shape equals the reference's, at full size (meta
    tensors allocate nothing)."""
    ref, _ = _ref_model(ref_configs.get_config(arch))
    port = Model(configs.get_config(arch), device="meta")
    want = {k: s.shape for k, s in flatten_specs(
        jax.tree.map(lambda s: s, ref.param_specs(),
                     is_leaf=lambda x: hasattr(x, "logical"))).items()}
    got = {k: tuple(p.shape) for k, p in flatten_specs(port.params()).items()}
    assert got == want


def test_init_is_seeded_and_scaled():
    cfg = configs.get_reduced("phi4-mini-3.8b")
    a = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, x), y in zip(flatten_specs(a.params()).items(),
                            flatten_specs(b.params()).values()):
        assert torch.equal(x, y), name
    p = a.params()
    assert p["final_ln"].abs().max() == 0
    assert p["layers"]["ln1"].abs().max() == 0
    w_up = p["layers"]["w_up"].float()                  # fan_in = d_model
    assert abs(w_up.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert p["embed"].dtype == torch.bfloat16


def test_embed_decode_matches_reference_one_hot():
    """Row lookup == the reference's one-hot contraction, including tokens
    outside the vocab, which embed to zeros on both sides."""
    cfg_ref = dataclasses.replace(ref_configs.get_reduced("phi4-mini-3.8b"),
                                  dtype="float32")
    ref, mesh = _ref_model(cfg_ref)
    table = np.random.default_rng(2).normal(
        size=(cfg_ref.padded_vocab, cfg_ref.d_model)).astype(np.float32)
    tok = np.array([0, 5, cfg_ref.padded_vocab - 1, cfg_ref.padded_vocab,
                    1000, -1], np.int32)
    want = jax.jit(smap(
        lambda t, k: ref_layers.embed_decode(k, t, cfg_ref, ref.ctx), mesh,
        in_specs=(P(None, None), P(None)), out_specs=P(None, None)))(
        jnp.asarray(table), jnp.asarray(tok))
    got = layers.embed_decode(torch.from_numpy(tok), torch.from_numpy(table),
                              configs.get_reduced("phi4-mini-3.8b"),
                              MeshCtx())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_gradients_match_reference(arch, engine):
    cfg_ref = dataclasses.replace(ref_configs.get_reduced(arch),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    ref, mesh = _ref_model(cfg_ref)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    port = params_from_numpy(params, Model(cfg, device="cpu",
                                           moe_engine=engine))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size - 1, size=(2, 32)) \
        .astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}

    def body(p, b):
        (loss, _), g = jax.value_and_grad(ref.loss_sp, has_aux=True)(p, b)
        return loss, g

    pspecs = spec_pspecs(ref.param_specs())
    bspec = {"tokens": P("data", None), "labels": P("data", None)}
    want_loss, want_grads = jax.jit(smap(
        body, mesh, in_specs=(pspecs, bspec), out_specs=(P(), pspecs)))(
        params, batch)
    loss, _ = port.loss_sp({k: torch.from_numpy(v)
                            for k, v in batch.items()})
    names = list(flatten_specs(port.params()))
    grads = torch.autograd.grad(loss, list(flatten_specs(
        port.params()).values()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    want = flatten_specs(jax.tree.map(np.asarray, want_grads))
    assert set(names) >= {"layers/w_router", "layers/w1", "layers/w2"}
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_moe_dispatch_is_resolved_once_per_token_count():
    """The eager port logs one moe_dispatch record per token count (the
    reference logs one per traced call site), not one per layer per
    call."""
    from repro_torch.core import managed

    model = Model(configs.get_reduced("moonshot-v1-16b-a3b"),
                  device="cpu").init(torch.Generator().manual_seed(0))
    tok = torch.zeros((2, 16), dtype=torch.int32)
    with managed.capture_decisions() as cap:
        for _ in range(3):
            model.prefill_sp({"tokens": tok})
        model.loss_sp({"tokens": tok, "labels": tok})
        model.prefill_sp({"tokens": tok[:, :8]})
    recs = [r for r in cap.records if r.op == "moe_dispatch"]
    assert [r.mode for r in recs] == ["bulk", "bulk"]
    assert recs[0].nbytes != recs[1].nbytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_bridge_carries_moe_leaves_unchanged(arch, dtype):
    """The reference's router and expert weights go into the port and back
    bit for bit (bf16 too), each in its reference shape."""
    from repro_torch.bridge import params_to_numpy

    cfg_ref = dataclasses.replace(ref_configs.get_reduced(arch), dtype=dtype)
    ref, _ = _ref_model(cfg_ref)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(1)))
    port = params_from_numpy(params, Model(dataclasses.replace(
        configs.get_reduced(arch), dtype=dtype), device="cpu"))
    back = flatten_specs(params_to_numpy(port))
    want = flatten_specs(params)
    leaves = ["layers/w_router", "layers/w1", "layers/w2"]
    if cfg_ref.mlp in ("swiglu", "geglu"):
        leaves.append("layers/w1_gate")
    for name in leaves:
        assert back[name].shape == want[name].shape, name
        np.testing.assert_array_equal(back[name],
                                      want[name].astype(np.float32),
                                      err_msg=name)
        assert flatten_specs(port.params())[name].dtype == getattr(
            torch, str(want[name].dtype)), name
