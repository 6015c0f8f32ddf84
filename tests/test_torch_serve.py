"""The port's ServeEngine held against the reference's, and against its
own oracles.

  * engine — port tokens equal the reference ServeEngine's on the same
    mixed-length prompts and weights (reduced phi4-mini, f32, pinned
    schedule and quantum);
  * scheduler — continuous batching equals one-request-at-a-time
    decoding, in fewer quanta than static waves;
  * overload — swap and recompute preemption decode every request equal
    to the no-overload run (the reference's swap path cannot run under
    jax 0.9.0, so the no-overload tokens are the oracle), and the overload
    fault kinds are deterministic;
  * bookkeeping — the page table's free list.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core import managed
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import paged_attention as paged
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import PagedCacheConfig, PageTable
from repro_torch.serve.scheduler import Request, RequestRejected

ARCH = "phi4-mini-3.8b"


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, mesh, model, params) and the port model on the same
    weights (f32)."""
    cfg = dataclasses.replace(ref_configs.get_reduced(ARCH), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(
        lambda a, s: jax.device_put(np.asarray(a), s),
        ref.init(jax.random.key(0)),
        infer_shardings(ref.param_specs(), mesh))
    port = params_from_numpy(
        jax.tree.map(np.asarray, params),
        Model(dataclasses.replace(configs.get_reduced(ARCH),
                                  dtype="float32"), device="cpu"))
    return (ref, mesh, params), port


def _prompts(seed, plens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, size=p).astype(np.int32)
            for p in plens]


def _serve(model, prompts, n_new, **kw):
    base = dict(slots=2, max_seq=32, page_size=4, schedule="continuous",
                chunk=4)
    base.update(kw)
    eng = ServeEngine(model, **base)
    rids = [eng.submit(p, n_new) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids], eng


@pytest.mark.parametrize("schedule", ["continuous", "static"])
def test_engine_tokens_match_reference_engine(pair, schedule):
    (ref, mesh, params), port = pair
    prompts = _prompts(1, [4, 9, 3, 7, 5, 2], port.cfg.vocab_size)
    kw = dict(slots=2, max_seq=32, page_size=4, schedule=schedule, chunk=4)
    ref_eng = RefServeEngine(ref, mesh, params, **kw)
    ref_rids = [ref_eng.submit(p, 6) for p in prompts]
    ref_out = ref_eng.run()
    got, eng = _serve(port, prompts, 6, **kw)
    for r, g in zip(ref_rids, got):
        np.testing.assert_array_equal(g, ref_out[r])
    # the same quanta and schedule decisions as the reference
    assert len(eng.metrics.quanta) == len(ref_eng.metrics.quanta)
    assert eng.pt.high_water == ref_eng.pt.high_water


def test_continuous_batching_matches_sequential_oracle(pair):
    """Mixed-length queue through 2 continuously-batched slots decodes
    every request to the same tokens as one-request-at-a-time, in fewer
    quanta than static waves, reusing freed pages."""
    _, port = pair
    prompts = _prompts(1, [4, 9, 3, 7, 5, 2], port.cfg.vocab_size)
    oracle = [_serve(port, [p], 6, slots=1)[0][0] for p in prompts]
    got_c, eng_c = _serve(port, prompts, 6, schedule="continuous")
    got_s, eng_s = _serve(port, prompts, 6, schedule="static")
    for want, gc, gs in zip(oracle, got_c, got_s):
        np.testing.assert_array_equal(gc, want)
        np.testing.assert_array_equal(gs, want)
    assert len(eng_c.metrics.quanta) < len(eng_s.metrics.quanta)
    assert eng_c.metrics.occupancy() > eng_s.metrics.occupancy()
    assert eng_c.pt.high_water <= 2 * eng_c.cache_cfg.max_pages_per_seq
    assert eng_c.pt.free_pages == eng_c.cache_cfg.n_pages   # all released


def test_preemption_swap_and_recompute_match_no_overload(pair):
    """An under-provisioned pool forces preemptions, and both eviction
    paths (page swap to host, drop + prefill replay) decode every request
    equal to the no-overload run; the squeeze run drives exhaustion
    through the pool_squeeze fault kind."""
    _, port = pair
    prompts = _prompts(3, [10, 12, 6, 9], port.cfg.vocab_size)
    oracle, eng0 = _serve(port, prompts, 8)
    assert not eng0.metrics.preempts
    for policy, kw in (
            ("swap", dict(n_pages=8)),
            ("recompute", dict(n_pages=8)),
            ("swap", dict(fault_plan=FaultPlan.parse("pool_squeeze@1:0.5"),
                          n_pages=12))):
        got, eng = _serve(port, prompts, 8, preempt=policy, **kw)
        assert eng.metrics.preempts, (policy, kw)
        assert all(p == policy for _, p in eng.metrics.preempts)
        for want, g in zip(oracle, got):
            np.testing.assert_array_equal(g, want)
        assert eng.pt.free_pages == eng.pt.usable_pages      # all released
        if policy == "swap":
            assert eng.metrics.swap_bytes > 0


def test_preempt_auto_policy_in_decision_trail(pair):
    _, port = pair
    prompts = _prompts(4, [10, 12, 6, 9], port.cfg.vocab_size)
    oracle, _ = _serve(port, prompts, 8)
    with managed.capture_decisions() as cap:
        got, eng = _serve(port, prompts, 8, n_pages=8, preempt="auto")
    for want, g in zip(oracle, got):
        np.testing.assert_array_equal(g, want)
    recs = [r for r in cap.records if r.op == "preempt_policy"]
    evicted = [r.mode for r in recs if r.mode != "wait"]
    assert evicted and set(evicted) <= {"swap", "recompute"}
    assert evicted == [p for _, p in eng.metrics.preempts]


def test_overload_faults_deterministic(pair):
    """Same plan + same seed => identical shed/preempt/decision/token
    sequences."""
    _, port = pair
    prompts = _prompts(6, [10, 8, 6], port.cfg.vocab_size)

    def run():
        with managed.capture_decisions() as cap:
            got, eng = _serve(
                port, prompts, 8, n_pages=8, preempt="recompute",
                max_queue=3,
                fault_plan=FaultPlan.parse("burst@1:6;pool_squeeze@3:0.8"))
        decisions = [(r.op, r.mode, r.chunks) for r in cap.records
                     if r.op == "preempt_policy"]
        return (got, eng.metrics.sheds, eng.metrics.preempts, decisions,
                sorted((k, v.tolist()) for k, v in eng.results.items()))

    got1, sheds1, pre1, dec1, res1 = run()
    got2, sheds2, pre2, dec2, res2 = run()
    assert sheds1 == sheds2 and sheds1
    assert pre1 == pre2 and pre1
    assert dec1 == dec2 and res1 == res2
    for a, b in zip(got1, got2):
        np.testing.assert_array_equal(a, b)


def test_preempt_none_stalls_typed(pair):
    _, port = pair
    eng = ServeEngine(port, slots=2, max_seq=32, page_size=4, n_pages=4,
                      schedule="continuous", chunk=4, preempt="none",
                      admission="commit")
    rng = np.random.default_rng(5)
    eng.scheduler.pending.append(Request(
        rid=0, prompt=rng.integers(0, 255, size=12).astype(np.int32),
        max_new=8))                              # 5 pages > 4-page pool
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()


def test_engine_submit_typed_rejection_and_launch_count(pair):
    """Infeasible requests are rejected typed; on the CPU the engine's
    decode steps never launch the kernel (it takes the plain version)."""
    _, port = pair
    eng = ServeEngine(port, slots=2, max_seq=32, page_size=4, n_pages=4,
                      schedule="continuous", chunk=4)
    rng = np.random.default_rng(7)
    with pytest.raises(RequestRejected):
        eng.submit(rng.integers(0, 255, size=12).astype(np.int32), 8)
    rid = eng.submit(rng.integers(0, 255, size=6).astype(np.int32), 6)
    before = paged.LAUNCHES
    out = eng.run()
    assert len(out[rid]) == 6
    assert eng.decode_steps == 1 + 6 + 6 - 1     # warmup + total steps
    assert paged.LAUNCHES == before


def test_cache_writes_of_inactive_slots_land_in_the_trailing_page(pair):
    """Inactive slots write only the pool's trailing page: the table's
    pages are untouched by a step with every slot inactive."""
    _, port = pair
    specs = port.paged_cache_specs(2, 6, 4)
    cache = {k: torch.zeros(s, dtype=d) for k, (s, d) in specs.items()}
    table = torch.zeros((2, 3), dtype=torch.int32)
    tok = torch.tensor([5, 7], dtype=torch.int32)
    pos = torch.tensor([3, 11], dtype=torch.int32)      # 11 // 4 = col 2
    port.decode_step_paged(cache, table, tok, pos,
                           torch.tensor([False, False]))
    for leaf in cache.values():
        assert leaf[:, :6].abs().max() == 0
        assert leaf[:, 6].abs().max() > 0


def test_page_table_free_list():
    cfg = PagedCacheConfig(slots=2, page_size=4, n_pages=6,
                           max_pages_per_seq=3)
    pt = PageTable(cfg)
    pt.ensure(0, 9)                     # 3 pages
    pt.ensure(1, 1)                     # 1 page
    assert pt.pages_held(0) == 3 and pt.pages_held(1) == 1
    assert pt.free_pages == 2
    assert sorted(pt.table[0].tolist()) == [0, 1, 2]
    pt.release(0)
    assert pt.free_pages == 5
    pt.ensure(1, 12)                    # grows to 3, reuses freed pages
    assert pt.pages_held(1) == 3 and pt.free_pages == 3
    assert pt.high_water == 4
    assert not pt.can_fit(16) and pt.can_fit(12)
    assert pt.squeeze(0.5) == 3 and pt.usable_pages == 3
    assert pt.free_pages == 0           # quarantined the free pages
