"""The serving engine's decode quantum as a CUDA graph, on the card.

``serve.engine.build_paged_step`` captured once and replayed against the
same step run from Python (``run_eager``), for reduced phi4-mini (dense)
and moonshot (MoE) in bf16; the engine's swap preemption between quanta
with the graph; and the launch counts a replay adds against the paged
kernels torch.profiler sees in it.  These tests need a CUDA card and skip
without one.  The file imports neither jax nor the reference:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_serve_graph_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import paged_attention as paged
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine, build_paged_step

SLOTS, PAGE, N_PAGES, PMAX, CHUNK = 4, 16, 32, 8, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _model(arch):
    return Model(configs.get_reduced(arch), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))


def _step(model):
    specs = model.paged_cache_specs(SLOTS, N_PAGES, PAGE)
    cache = {k: torch.zeros(shape, dtype=dt, device="cuda")
             for k, (shape, dt) in specs.items()}
    return build_paged_step(model, cache, slots=SLOTS, max_pages=PMAX,
                            max_chunk=CHUNK)


def _captured(model, table):
    step = _step(model)
    z = np.zeros(SLOTS, np.int32)
    step.load(table, z[:, None], z + 1, z, z)
    step.capture()
    return step


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "moonshot-v1-16b-a3b"])
def test_graph_replay_equals_run_eager_bit_for_bit(cuda, arch):
    """Three quanta (prompts, decode, an inactive slot, a slot stopping
    early): the replays' tokens and every cache leaf equal the eager
    step's bit for bit, and each replay adds one paged launch a layer."""
    model = _model(arch)
    rng = np.random.default_rng(1)
    table = rng.permutation(N_PAGES).reshape(SLOTS, PMAX).astype(np.int32)
    graph = _captured(model, table)
    eager = _step(model)
    assert graph.graph is not None and eager.graph is None
    pos = np.zeros(SLOTS, np.int32)
    last = np.zeros(SLOTS, np.int32)
    for q, (n_in, steps) in enumerate((([8, 5, 1, 3], [8, 8, 0, 6]),
                                       ([1, 1, 1, 2], [8, 4, 0, 8]),
                                       ([1, 1, 4, 1], [8, 8, 8, 2]))):
        n_in, steps = np.array(n_in, np.int32), np.array(steps, np.int32)
        tokens = rng.integers(0, model.cfg.vocab_size - 1,
                              size=(SLOTS, CHUNK)).astype(np.int32)
        tokens[n_in == 1, 0] = last[n_in == 1]
        outs = []
        for st, run in ((graph, graph.replay), (eager, eager.run_eager)):
            st.load(table, tokens, n_in, steps, pos)
            before = paged.LAUNCHES
            for _ in range(int(steps.max())):
                run()
            assert paged.LAUNCHES - before == (model.cfg.n_layers
                                               * int(steps.max()))
            outs.append(st.read(CHUNK))
        np.testing.assert_array_equal(outs[0], outs[1], err_msg=f"quantum {q}")
        for k in graph.cache:
            assert torch.equal(graph.cache[k], eager.cache[k]), (q, k)
        assert torch.equal(graph.pos, eager.pos)
        pos = pos + steps
        np.testing.assert_array_equal(graph.pos.cpu().numpy(), pos)
        last = np.where(steps > 0, outs[0][np.arange(SLOTS),
                                           np.maximum(steps - 1, 0)], last)


@pytest.mark.gpu
def test_swap_between_quanta_keeps_tokens(cuda):
    """An under-provisioned pool swaps a victim's pages out to host and
    back in between quanta (written into the captured pools in place);
    every request decodes to the no-overload run's tokens."""
    model = _model("phi4-mini-3.8b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size - 1, size=p)
               .astype(np.int32) for p in (10, 12, 6, 9)]

    def serve(**kw):
        eng = ServeEngine(model, slots=2, max_seq=32, page_size=4,
                          schedule="continuous", chunk=4, **kw)
        rids = [eng.submit(p, 8) for p in prompts]
        out = eng.run()
        assert eng.quantum_mode == "graph" and eng.step.graph is not None
        return [out[r] for r in rids], eng

    want, eng0 = serve()
    assert not eng0.metrics.preempts
    got, eng = serve(n_pages=8, preempt="swap")
    assert eng.metrics.preempts and eng.metrics.swap_bytes > 0
    assert all(p == "swap" for _, p in eng.metrics.preempts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_replay_launch_count_equals_profiled_paged_kernels(cuda):
    """``paged_attention.LAUNCHES`` over one replay equals the paged
    kernels (the single-pass or split kernel; a split plan adds its
    merge) that torch.profiler sees in that replay."""
    from torch.profiler import ProfilerActivity, profile

    model = _model("phi4-mini-3.8b")
    table = np.arange(N_PAGES, dtype=np.int32).reshape(SLOTS, PMAX)
    step = _captured(model, table)
    z = np.zeros(SLOTS, np.int32)
    step.load(table, z[:, None], z + 1, z + CHUNK, z + 40)
    step.replay()
    torch.cuda.synchronize()
    before = paged.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step.replay()
        torch.cuda.synchronize()
    launched = paged.LAUNCHES - before
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and "paged_" in e.name
               and "merge" not in e.name]
    assert launched == model.cfg.n_layers
    assert len(kernels) == launched, [e.name for e in kernels]
