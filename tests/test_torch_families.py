"""Every architecture of the reference in the port, held against the
reference on the CPU (the counterpart of tests/test_smoke_archs.py, at
the reduced configs in f32, with the reference's ``Model.init`` weights
carried across by ``bridge.params_from_numpy``):

  * one ``build_train_step`` step (default AdamW) of every arch — stub
    ``frames`` for whisper, ``patches`` for internvl — gives the
    reference's loss (rtol 1e-5) and updated parameters (1e-4, relative
    or absolute: the first AdamW update divides by sqrt(nu), which
    carries last-digit gradient differences into the parameters);
  * the contiguous ``Generator`` gives the reference's greedy tokens for
    every arch;
  * the paged ``Generator`` gives the reference's contiguous tokens for
    granite, mamba2, hymba and moonshot (tests/test_serving.py's paged ==
    contiguous case);
  * whisper's and internvl's prefill logits (encoder over the stub
    frames; patches spliced into the first positions) within 1e-5 of the
    reference's ``build_prefill_step``;
  * the port's ``Generator.prefill_generate`` continues each family's
    prefill cache (K/V, SSM state and conv ring, the encoder output as
    cross-attention K/V) to the tokens a prefill of the longer sequence
    picks.  Whisper only to its first token: the reference's decode block
    runs the cross-attention between self-attention and the MLP, its
    prefill after the MLP, and the port copies both.
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
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.serve_loop import Generator
from repro_torch.train.train_loop import build_train_step

ARCHS = ref_configs.list_archs()
PAGED_ARCHS = ["granite-34b", "mamba2-130m", "hymba-1.5b",
               "moonshot-v1-16b-a3b"]
STUB_ARCHS = ["whisper-small", "internvl2-1b"]
TOL = 1e-5
PARAM_TOL = 1e-4


def _stubs(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.normal(size=(b, cfg.encoder.n_frames,
                                         cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        out["patches"] = rng.normal(size=(b, cfg.vision.n_patches,
                                          cfg.d_model)).astype(np.float32)
    return out


_PAIRS: dict = {}


def _pair(arch):
    """(reference model, mesh, device params, numpy params, port model),
    built once per arch."""
    if arch not in _PAIRS:
        cfg = dataclasses.replace(ref_configs.get_reduced(arch),
                                  dtype="float32")
        mesh = jax.make_mesh((1, 1), ("data", "model"))
        ref = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
        params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
        dev = jax.tree.map(lambda a, s: jax.device_put(a, s), params,
                           infer_shardings(ref.param_specs(), mesh))
        port = bridge.params_from_numpy(params, Model(dataclasses.replace(
            configs.get_reduced(arch), dtype="float32"), device="cpu"))
        _PAIRS[arch] = (ref, mesh, dev, params, port)
    return _PAIRS[arch]


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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    ref, mesh, dev, params, _ = _pair(arch)
    cfg = ref.cfg
    batch = dict(SyntheticLMData(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32,
        global_batch=2)).global_batch_at(0))
    batch.update(_stubs(cfg, 2))
    step, pshard, bshard = ref_build_train_step(ref, RefAdamWConfig(), mesh,
                                                donate=False)
    p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
    p2, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()),
                    {k: jax.device_put(v, bshard[k]) if k in bshard else v
                     for k, v in batch.items()})
    want = _flat(jax.tree.map(np.asarray, p2))

    # a fresh port model: the cached one serves the decode tests
    port = bridge.params_from_numpy(params, Model(dataclasses.replace(
        configs.get_reduced(arch), dtype="float32"), device="cpu"))
    pstep = build_train_step(port, AdamWConfig())
    _, metrics = pstep(adamw_init(port.params(), AdamWConfig()),
                       {k: torch.from_numpy(np.asarray(v))
                        for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(m["loss"]),
                               rtol=TOL)
    got = flatten_specs(bridge.params_to_numpy(port))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    ref, mesh, dev, _, port = _pair(arch)
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    want = RefGenerator(ref, mesh, RefShapeConfig("smoke", 16, 2, "decode"),
                        dev).generate(prompt, n_new=4)
    got = Generator(port, ShapeConfig("smoke", 16, 2, "decode")).generate(
        prompt, n_new=4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_generator_matches_contiguous(arch):
    ref, mesh, dev, _, port = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, ref.cfg.vocab_size - 1, size=(2, 5)) \
        .astype(np.int32)
    want = RefGenerator(ref, mesh, RefShapeConfig("serve", 32, 2, "decode"),
                        dev).generate(prompts, n_new=6)
    got = Generator(port, ShapeConfig("serve", 32, 2, "decode"),
                    engine="paged", page_size=4).generate(prompts, n_new=6)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_prefill_logits_match_reference(arch):
    ref, mesh, dev, _, port = _pair(arch)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, ref.cfg.vocab_size - 1, size=(2, 12)) \
        .astype(np.int32)
    batch = {"tokens": tokens, **_stubs(ref.cfg, 2, seed=3)}
    want, _ = build_prefill_step(ref, mesh)(dev, batch)
    got, cache = port.prefill_sp({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if ref.cfg.encoder is not None:
        assert cache["enc_out"].shape == (2, ref.cfg.encoder.n_frames,
                                          ref.cfg.d_model)


def test_paged_cache_refuses_encoder_and_vision_models():
    for arch in STUB_ARCHS:
        port = _pair(arch)[4]
        with pytest.raises(ValueError, match="token-only"):
            port.paged_cache_specs(2, 8, 4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b",
                                  "whisper-small", "internvl2-1b"])
def test_prefill_generate_continues_the_prefill(arch):
    """Decoding from the prefill cache gives the tokens a prefill of the
    prompt and the tokens so far picks (hymba's prompt outruns its
    16-position window, so its ring buffers wrap)."""
    port = _pair(arch)[4]
    cfg = port.cfg
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size - 1, size=(2, 20)) \
        .astype(np.int32)
    stubs = _stubs(cfg, 2, seed=5)
    gen = Generator(port, ShapeConfig("t", 32, 2, "decode"))
    toks = gen.prefill_generate(prompt, 4, **stubs)
    seq = prompt
    # whisper's decode and prefill blocks order the cross-attention
    # differently (as the reference's): only the prefill's own pick agrees
    for i in range(1 if cfg.encoder is not None else 4):
        logits, _ = port.prefill_sp(
            {"tokens": torch.from_numpy(seq),
             **{k: torch.from_numpy(v) for k, v in stubs.items()}})
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      toks[:, i], err_msg=f"token {i}")
        seq = np.concatenate([seq, toks[:, i:i + 1]], axis=1)


def test_serve_batched_example_on_cpu(capsys):
    """``repro_torch.examples.serve_batched --device cpu``: the four
    mixed-length prompts of reduced mamba2-130m each get 16 tokens, and
    the managed serve-schedule decision is printed."""
    from repro_torch.examples import serve_batched
    out = serve_batched.main(["--device", "cpu"])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == serve_batched.NEW_TOKENS for v in out.values())
    text = capsys.readouterr().out
    assert text.count("request ") == 4
    assert "managed decision: serve_schedule(" in text
