"""The port's decode quantum (``serve.engine.build_paged_step``) held
against the reference's (``repro.serve.engine.build_paged_step``, one
jitted ``lax.scan`` over ``decode_step_paged``) on the CPU.

Reduced phi4-mini (dense), moonshot (MoE), mamba2 (SSM) and hymba
(hybrid, per-layer windows) in f32 carry the reference's weights across
through ``bridge.params_from_numpy``.  Two quanta of C = 4 steps over 3
slots and pages of 4: a slot in its prompt, a slot that finishes its
prompt and decodes, an inactive slot, and a slot whose step count is
below C.  The sampled tokens are equal at every (b, t < steps[b]); the
pool pages the table names and the SSM state agree within rtol 1e-5 and
atol 1e-5 of the leaf's largest magnitude (at least 1): the f32 K/V and
SSM state, of magnitude 3-13, differ by up to 1.3e-5 between the two
packages (hymba's second quantum), which is rounding of the same sums in
another order; each slot's position ends at pos0 + steps.

On the engine: a re-tuned C between quanta reuses the one step object
(the reference compiles one function per C), ``decode_steps`` counts the
steps run, and a rebound pool is refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.serve.engine import build_paged_step as ref_build_paged_step
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine, build_paged_step

FAMILIES = ["phi4-mini-3.8b", "moonshot-v1-16b-a3b", "mamba2-130m",
            "hymba-1.5b"]
SLOTS, PAGE, CHUNK, N_PAGES, PMAX = 3, 4, 4, 12, 4
RTOL, ATOL = 1e-5, 1e-5
#: per quantum: prompt tokens fed (n_in) and steps, by slot.  Quantum 1:
#: slot 0 in its prompt for all 4 steps, slot 1 ends its 2-token prompt
#: and decodes 1 step (3 < C), slot 2 inactive.  Quantum 2: slot 0 ends
#: its prompt and decodes (3 steps), slot 1 decodes 4 from its last
#: sample across a page boundary, slot 2 still inactive.
#: ``prompt``: whether the slot's inputs are prompt tokens (else its last
#: sample).
QUANTA = [dict(n_in=[4, 2, 1], steps=[4, 3, 0], prompt=[1, 1, 1]),
          dict(n_in=[2, 1, 1], steps=[3, 4, 0], prompt=[1, 0, 1])]


@functools.cache
def _pair(arch):
    cfg = dataclasses.replace(ref_configs.get_reduced(arch), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    dev = jax.tree.map(lambda a, s: jax.device_put(a, s), params,
                       infer_shardings(ref.param_specs(), mesh))
    port = params_from_numpy(params, Model(dataclasses.replace(
        configs.get_reduced(arch), dtype="float32"), device="cpu"))
    return ref, mesh, dev, port


def _stacked(ref_cache):
    """The reference's cache as the port's names -> [L, ...] arrays (the
    hybrid family's is a per-layer list there)."""
    if isinstance(ref_cache, list):
        return {k: np.stack([np.asarray(layer[k]) for layer in ref_cache])
                for k in ref_cache[0]}
    return {k: np.asarray(v) for k, v in ref_cache.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_step_matches_reference_quantum(arch):
    ref, mesh, params, port = _pair(arch)
    sds, cps = ref.paged_cache_specs(SLOTS, N_PAGES, PAGE)
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), sds)
    ref_step = ref_build_paged_step(ref, mesh, cps, CHUNK)
    specs = port.paged_cache_specs(SLOTS, N_PAGES, PAGE)
    cache = {k: torch.zeros(shape, dtype=dt)
             for k, (shape, dt) in specs.items()}
    step = build_paged_step(port, cache, slots=SLOTS, max_pages=PMAX,
                            max_chunk=CHUNK)

    rng = np.random.default_rng(7)
    table = rng.permutation(N_PAGES)[:SLOTS * PMAX].reshape(SLOTS, PMAX) \
        .astype(np.int32)
    prompts = rng.integers(0, port.cfg.vocab_size - 1, size=(SLOTS, 6)) \
        .astype(np.int32)
    pos0 = np.zeros(SLOTS, np.int32)
    last = np.zeros(SLOTS, np.int32)
    for q in QUANTA:
        n_in = np.array(q["n_in"], np.int32)
        steps = np.array(q["steps"], np.int32)
        tokens = np.zeros((SLOTS, CHUNK), np.int32)
        for b in range(SLOTS):
            if q["prompt"][b]:
                tokens[b, :n_in[b]] = prompts[b, pos0[b]:pos0[b] + n_in[b]]
            else:
                tokens[b, 0] = last[b]
        want, ref_cache = ref_step(
            params, ref_cache, jnp.asarray(table), jnp.asarray(tokens),
            jnp.asarray(n_in), jnp.asarray(pos0), jnp.asarray(steps))
        want = np.asarray(want)
        step.load(table, tokens, n_in, steps, pos0)
        for _ in range(int(steps.max())):
            step.run_eager()
        got = step.read(CHUNK)
        for b in range(SLOTS):
            np.testing.assert_array_equal(
                got[b, :steps[b]], want[b, :steps[b]],
                err_msg=f"{arch}: slot {b}, steps {steps.tolist()}")
            if steps[b]:
                last[b] = want[b, steps[b] - 1]
        pos0 = pos0 + steps
        np.testing.assert_array_equal(step.pos.numpy(), pos0)
        ref_np = _stacked(ref_cache)
        assert set(ref_np) == set(cache)
        ids = table.ravel()
        for k, leaf in cache.items():
            g, w = leaf.numpy(), ref_np[k]
            if k in ("kp", "vp"):
                g, w = g[:, ids], w[:, ids]
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(w).max())),
                err_msg=f"{arch}: {k}")


def _engine(model, chunk):
    return ServeEngine(model, slots=2, max_seq=32, page_size=4,
                       schedule="continuous", chunk=chunk)


def test_retuned_chunk_reuses_the_step_and_counts_steps():
    port = _pair("phi4-mini-3.8b")[3]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, port.cfg.vocab_size - 1, size=p)
               .astype(np.int32) for p in (5, 9, 3, 7)]
    oracle = _engine(port, 4)
    rids = [oracle.submit(p, 5) for p in prompts]
    done = oracle.run()
    want = [done[r] for r in rids]

    eng = _engine(port, 4)
    assert eng.quantum_mode == "eager" and eng.step.graph is None
    step = eng.step
    calls, longest = [], []
    run_eager, run_quantum = step.run_eager, eng._run_quantum
    step.run_eager = lambda: (calls.append(1), run_eager())
    eng._run_quantum = lambda plan: (longest.append(int(plan.steps.max())),
                                     run_quantum(plan))[1]
    first = [eng.submit(p, 5) for p in prompts[:2]]
    eng.run()
    # a re-tuned quantum: the next run resolves C = 3
    eng.scheduler._pinned_chunk = 3
    second = [eng.submit(p, 5) for p in prompts[2:]]
    res = eng.run()
    assert eng.step is step
    assert {q.chunk for q in eng.metrics.quanta} == {4, 3}
    for rid, w in zip(first + second, want):
        np.testing.assert_array_equal(res[rid], w)
    # the warm-up step and each quantum's longest slot's steps, each run
    assert eng.decode_steps == len(calls) == 1 + sum(longest)


def test_rebound_pool_is_refused():
    port = _pair("phi4-mini-3.8b")[3]
    eng = _engine(port, 4)
    eng.cache["kp"] = eng.cache["kp"].clone()
    eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    with pytest.raises(RuntimeError, match="rebound"):
        eng.run()
