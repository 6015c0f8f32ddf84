"""The contiguous decode step as a CUDA graph, on the card.

``train.serve_loop.build_decode_step`` returns a ``DecodeStep``; on a
card with every mesh axis of size 1 ``Generator`` runs a binding's first
step eagerly, captures it, and replays the graph for every later token.
For the reduced families in f32 and bf16 — phi4-mini (dense), phi4-mini
with an 8-position window, hymba (hybrid), mamba2 (SSM), whisper (audio)
and moonshot (MoE) — the replayed tokens equal the tokens of the same
steps run from Python (``run_eager``), at ``start_pos`` 0 and past the
window, through ``generate`` and ``prefill_generate`` (internvl's too),
and the step's ``bindings`` and ``replays`` count what ran.  The decode
step launches no hand-written kernel, so a replay adds no launch.  Under
an ``instrument`` recorder the step runs eager and ``capture()`` raises.
These tests need a CUDA card and skip without one.  The file imports
neither jax nor the reference:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_decode_graph_card.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import instrument
from repro_torch.models.model import Model
from repro_torch.train.serve_loop import Generator

#: family -> (arch, sliding window override or None)
FAMILIES = {"phi4-mini": ("phi4-mini-3.8b", None),
            "phi4-window8": ("phi4-mini-3.8b", 8),
            "hymba": ("hymba-1.5b", None),
            "mamba2": ("mamba2-130m", None),
            "whisper": ("whisper-small", None),
            "moonshot": ("moonshot-v1-16b-a3b", None)}
SEQ, BATCH, P, NEW = 32, 2, 6, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _model(arch, window, dtype):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype=dtype)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))


def _eager(gen, run):
    """``run()`` with ``gen``'s decode steps issued from Python through
    ``run_eager`` (the step has no switch for it)."""
    st = gen.step
    st.capture = st.replay = st.run_eager
    try:
        return run()
    finally:
        del st.capture, st.replay


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_replayed_tokens_equal_eager_tokens(cuda, family, dtype):
    model = _model(*FAMILIES[family], dtype)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, model.cfg.vocab_size - 1, size=(BATCH, P)) \
        .astype(np.int32)
    gen = Generator(model, ShapeConfig("t", SEQ, BATCH, "decode"))
    st = gen.step
    assert st.decode_mode == "graph"
    steps = P + NEW - 1
    for start in (0, 12):
        got = gen.generate(prompts, NEW, start_pos=start)
        eager_gen = Generator(model, ShapeConfig("t", SEQ, BATCH, "decode"))
        want = _eager(eager_gen, lambda: eager_gen.generate(
            prompts, NEW, start_pos=start))
        np.testing.assert_array_equal(got, want, err_msg=f"start {start}")
        assert eager_gen.step.graph is None and eager_gen.step.replays == 0
        del eager_gen
    assert st.graph is not None and st.bindings == 1
    assert st.replays == 2 * (steps - 1) + 1
    assert st.replay_launches == {}
    assert int(st.pos) == 12 + steps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m",
                                  "whisper-small", "internvl2-1b"])
def test_prefill_generate_replays_equal_eager(cuda, arch, dtype):
    model = _model(arch, None, dtype)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size - 1, size=(BATCH, 20)) \
        .astype(np.int32)
    stubs = {}
    if cfg.encoder is not None:
        stubs["frames"] = rng.normal(size=(BATCH, cfg.encoder.n_frames,
                                           cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        stubs["patches"] = rng.normal(size=(BATCH, cfg.vision.n_patches,
                                            cfg.d_model)).astype(np.float32)
    shape = ShapeConfig("t", 64, BATCH, "decode")
    gen = Generator(model, shape)
    got = [gen.prefill_generate(prompts, NEW, **stubs) for _ in range(2)]
    eager_gen = Generator(model, shape)
    want = _eager(eager_gen, lambda: eager_gen.prefill_generate(
        prompts, NEW, **stubs))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    assert gen.step.bindings == 1
    assert gen.step.replays == 2 * (NEW - 1) - 1


@pytest.mark.gpu
def test_recorder_runs_the_step_eager(cuda):
    model = _model("phi4-mini-3.8b", None, "bfloat16")
    gen = Generator(model, ShapeConfig("t", SEQ, BATCH, "decode"))
    prompts = np.ones((BATCH, P), np.int32)
    seen = []

    def region(_x):
        seen.append(gen.step.decode_mode)
        seen.append(gen.generate(prompts, NEW))
        with pytest.raises(RuntimeError, match="recorder"):
            gen.step.capture()

    instrument.analyze_region(region, torch.zeros(1, device="cuda"))
    assert seen[0] == "eager" and gen.step.graph is None
    assert gen.step.decode_mode == "graph"
    np.testing.assert_array_equal(gen.generate(prompts, NEW), seen[1])
    assert gen.step.graph is not None
