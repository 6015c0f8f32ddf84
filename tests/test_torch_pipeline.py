"""The port's pipeline subsystem on one rank (the pod axis of size 1),
held against the reference on the CPU (the mirror of
tests/test_pipeline.py; the multi-rank runs are in
tests/test_torch_pipeline_parallel.py):

  * the stage partition's remainder rule and composed stages against the
    sequential stack;
  * ``build_schedule``'s timetables array for array equal to the
    reference's over a grid of (schedule, M, S, v), their invariants, the
    O(S)-vs-O(M) stash contrast and the tick counts;
  * the executor's loss and gradients under all three schedules against
    the sequential autograd oracle and the reference's executor (f32),
    and the grad-accumulate contract;
  * ``decide_pipeline_schedule``, ``pipeline_stash_slots``,
    ``pipeline_schedule_time``, ``decide_checkpoint`` and
    ``checkpoint_overhead`` equal to the reference's under ``TPU_V5E``,
    and the two resolvers' decision records equal to the reference's;
  * ``build_train_step(pipeline=...)`` on a 1x1x1 pod mesh under each
    schedule against the reference's pipelined step on the same weights
    and batch (f32: loss within 1e-5 relative, gradient norm within 1e-5,
    parameters within rtol 3e-4 / atol 1e-6), and its flash-attention
    call count (each chunk's forward twice, its backward once).

Not mirrored here: the reference file's three instrument tests
(``tests/test_pipeline.py:196-265``) hold its jaxpr walk's binder
alignment through scan, cond and while, which an eager recorder does not
have; its region test (``:337``) is held in
``tests/test_torch_instrument.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.core import overlap as ref_overlap
from repro.data.pipeline import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.parallel import pipeline as ref_pipeline
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.core import cost_model as cm
from repro_torch.core import managed, overlap
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import pipeline
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.train_loop import build_train_step

# -- stage partitioning ------------------------------------------------------


def test_chunk_bounds_distributes_remainder():
    assert pipeline.chunk_bounds(5, 2, 0) == (0, 3)
    assert pipeline.chunk_bounds(5, 2, 1) == (3, 2)


@pytest.mark.parametrize("n_layers,n_chunks",
                         [(5, 2), (7, 3), (2, 8), (9, 4), (16, 8), (3, 3)])
def test_chunk_bounds_cover_all_layers_as_reference(n_layers, n_chunks):
    seen = []
    for q in range(n_chunks):
        lo, per = pipeline.chunk_bounds(n_layers, n_chunks, q)
        assert (lo, per) == ref_pipeline.chunk_bounds(n_layers, n_chunks, q)
        seen.extend(range(lo, lo + per))
        assert per <= pipeline.max_chunk_layers(n_layers, n_chunks)
    assert seen == list(range(n_layers))
    assert pipeline.max_chunk_layers(n_layers, n_chunks) == \
        ref_pipeline.max_chunk_layers(n_layers, n_chunks)


def _layer(x, w):
    return torch.tanh(x @ w)


def test_composed_stages_match_sequential_oracle():
    """5 layers over 2 stages: stage 0's exact slice then stage 1's ==
    the sequential stack."""
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(size=(5, 8, 8)).astype(np.float32)
                          * 0.3)
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    want = x
    for i in range(5):
        want = _layer(want, ws[i])
    got = x
    for stage in range(2):
        for w in pipeline.chunk_slice({"w": ws}, 5, 2, stage)["w"]:
            got = _layer(got, w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- timetables --------------------------------------------------------------

GRID = [(name, m, s, v) for name in ("gpipe", "1f1b")
        for m in (1, 2, 3, 4, 8) for s in (1, 2, 3, 4) for v in (1,)] + \
       [("interleaved", m, s, v) for s in (1, 2, 4) for v in (2, 3)
        for m in (s, 2 * s, 4 * s)]


@pytest.mark.parametrize("name,m,s,v", GRID)
def test_build_schedule_equals_reference(name, m, s, v):
    got = pipeline.build_schedule(name, m, s, v)
    want = ref_pipeline.build_schedule(name, m, s, v)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name,m,s,v,ticks,stash", [
    ("gpipe", 2, 2, 1, 6, 2), ("1f1b", 2, 2, 1, 5, 2),
    ("interleaved", 2, 2, 2, 9, 4), ("gpipe", 2, 1, 1, 4, 2),
    ("1f1b", 2, 1, 1, 3, 2)])
def test_timetable_sizes(name, m, s, v, ticks, stash):
    sch = pipeline.build_schedule(name, m, s, v)
    assert (sch.ticks, sch.n_stash) == (ticks, stash)


@pytest.mark.parametrize("name,m,s,v", [
    ("gpipe", 4, 2, 1), ("gpipe", 8, 4, 1), ("1f1b", 4, 2, 1),
    ("1f1b", 16, 8, 1), ("interleaved", 8, 4, 2), ("interleaved", 8, 2, 3),
])
def test_build_schedule_invariants(name, m, s, v):
    """Every (mb, chunk) appears once per lane."""
    sch = pipeline.build_schedule(name, m, s, v)
    n_virtual = s * sch.virtual
    for mb_tab, ch_tab in ((sch.f_mb, sch.f_chunk), (sch.b_mb, sch.b_chunk)):
        units = sorted((int(mb), int(q))
                       for mb, q in zip(mb_tab.ravel(), ch_tab.ravel())
                       if mb >= 0)
        assert units == sorted((mb, q) for mb in range(m)
                               for q in range(n_virtual))
    assert (sch.f_slot >= 0).sum() == m * n_virtual


def test_1f1b_stash_is_o_n_stage_not_o_m():
    s = 4
    for m in (8, 16, 32, 64):
        assert pipeline.build_schedule("gpipe", m, s).n_stash == m
        assert pipeline.build_schedule("1f1b", m, s).n_stash <= 2 * s
    assert pipeline.build_schedule("interleaved", 32, s, 2).n_stash <= \
        2 * 2 * s + s


def test_1f1b_fewer_ticks_than_gpipe():
    for m, s in ((8, 4), (16, 8)):
        assert pipeline.build_schedule("1f1b", m, s).ticks < \
            pipeline.build_schedule("gpipe", m, s).ticks


@pytest.mark.parametrize("args", [("interleaved", 6, 4, 2),
                                  ("interleaved", 4, 2, 1),
                                  ("zigzag", 4, 2, 1)])
def test_build_schedule_rejects_what_the_reference_rejects(args):
    with pytest.raises(ValueError):
        ref_pipeline.build_schedule(*args)
    with pytest.raises(ValueError):
        pipeline.build_schedule(*args)


# -- the executor against the sequential oracle (one stage) ------------------


def _toy_problem():
    rng = np.random.default_rng(1)
    n_layers, d, m, b = 5, 8, 4, 4
    ws = rng.normal(size=(n_layers, d, d)).astype(np.float32) * 0.3
    xs = rng.normal(size=(m, b, d)).astype(np.float32)
    tg = rng.normal(size=(m, b, d)).astype(np.float32)
    return n_layers, d, m, b, ws, xs, tg


def _ref_executor(name, virtual, ws, xs, tg, n_layers, b, d):
    n_virtual = virtual
    m = xs.shape[0]
    sched = ref_pipeline.build_schedule(name, m, 1, virtual)
    xs_j, tg_j = jnp.asarray(xs), jnp.asarray(tg)

    def chunk_fn(p, q, mb, x):
        x = jnp.where(q == 0, xs_j[mb], x)
        cp, per = ref_pipeline.slice_chunk_params(p, n_layers, n_virtual, q)
        return ref_pipeline.masked_chunk_apply(
            lambda xc, w: jnp.tanh(xc @ w), cp, per, x)

    def loss_fn(p, y, mb):
        return jnp.mean((y - tg_j[mb]) ** 2)

    loss, grads = jax.jit(lambda p: ref_pipeline.pipeline_value_and_grad(
        chunk_fn, loss_fn, p, jax.ShapeDtypeStruct((b, d), np.float32),
        sched, "pod"))(jnp.asarray(ws))
    return float(loss), np.asarray(grads)


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("name,virtual", [("gpipe", 1), ("1f1b", 1),
                                          ("interleaved", 2)])
def test_pipeline_matches_sequential_oracle_and_reference(name, virtual,
                                                          mean):
    n_layers, d, m, b, ws, xs, tg = _toy_problem()
    w0 = torch.from_numpy(ws).requires_grad_()
    losses = []
    for mb in range(m):
        x = torch.from_numpy(xs[mb])
        for i in range(n_layers):
            x = _layer(x, w0[i])
        losses.append(torch.mean((x - torch.from_numpy(tg[mb])) ** 2))
    want_loss = torch.stack(losses).mean() if mean else \
        torch.stack(losses).sum()
    want_g, = torch.autograd.grad(want_loss, [w0])

    sched = pipeline.build_schedule(name, m, 1, virtual)
    xs_t, tg_t = torch.from_numpy(xs), torch.from_numpy(tg)

    def chunk_fn(p, q, mb, x):
        if q == 0:
            x = xs_t[mb]
        for w in pipeline.chunk_slice(p, n_layers, virtual, q)["w"]:
            x = _layer(x, w)
        return x

    def loss_fn(p, y, mb):
        return torch.mean((y - tg_t[mb]) ** 2)

    loss, grads = pipeline.pipeline_value_and_grad(
        chunk_fn, loss_fn, {"w": torch.from_numpy(ws)},
        torch.empty((b, d), device="meta"), sched, "pod", MeshCtx(),
        mean=mean)
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(grads["w"], want_g, rtol=2e-5, atol=1e-7)
    if mean:
        ref_loss, ref_g = _ref_executor(name, virtual, ws, xs, tg,
                                        n_layers, b, d)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
        np.testing.assert_allclose(grads["w"].numpy(), ref_g, rtol=2e-5,
                                   atol=1e-7)


def test_pipeline_grad_seed_scale_scales_grads_not_loss():
    n_layers, d, m, b, ws, xs, tg = _toy_problem()
    sched = pipeline.build_schedule("1f1b", m, 1)
    xs_t, tg_t = torch.from_numpy(xs), torch.from_numpy(tg)

    def chunk_fn(p, q, mb, x):
        x = xs_t[mb]
        for w in p["w"]:
            x = _layer(x, w)
        return x

    def loss_fn(p, y, mb):
        return torch.mean((y - tg_t[mb]) ** 2)

    proto = torch.empty((b, d), device="meta")
    params = {"w": torch.from_numpy(ws)}
    l1, g1 = pipeline.pipeline_value_and_grad(
        chunk_fn, loss_fn, params, proto, sched, "pod", MeshCtx())
    l2, g2 = pipeline.pipeline_value_and_grad(
        chunk_fn, loss_fn, params, proto, sched, "pod", MeshCtx(),
        grad_seed_scale=0.25)
    assert float(l1) == float(l2)
    torch.testing.assert_close(g2["w"], 0.25 * g1["w"], rtol=1e-6,
                               atol=1e-9)


# -- grad accumulation contract ---------------------------------------------


def test_grad_accumulate_contract_vs_hand_loop_and_reference():
    rng = np.random.default_rng(2)
    w_np = rng.normal(size=(4,)).astype(np.float32)
    xs_np = rng.normal(size=(3, 4)).astype(np.float32)
    w = torch.from_numpy(w_np)

    def step_fn(mb):
        wv = w.clone().requires_grad_()
        loss = torch.sum((wv * mb) ** 2)
        g, = torch.autograd.grad(loss, [wv])
        return loss.detach(), g

    losses, grads = [], []
    for i in range(3):
        l, g = step_fn(torch.from_numpy(xs_np[i]))
        losses.append(float(l))
        grads.append(g.numpy())
    want_sum_g = np.sum(grads, axis=0)

    def ref_step(mb):
        return jax.value_and_grad(
            lambda wv: jnp.sum((wv * mb) ** 2))(jnp.asarray(w_np))

    for mean in (True, False):
        loss, g = overlap.grad_accumulate(step_fn, 3, mean=mean)(
            torch.from_numpy(xs_np))
        np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-6)
        np.testing.assert_allclose(
            g.numpy(), want_sum_g / 3 if mean else want_sum_g, rtol=1e-6)
        r_loss, r_g = jax.jit(ref_overlap.grad_accumulate(
            ref_step, 3, mean=mean))(jnp.asarray(xs_np))
        np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(r_g), rtol=1e-6)


# -- the managed decisions: equal to the reference under TPU_V5E -------------

PIPE_CASES = [
    # n_stage, batch_fwd_s, batch_bytes, kwargs
    (4, 1e-3, 1e6, dict(n_layers=16)),
    (4, 1e-3, 1e6, dict(force_schedule="gpipe", force_micro=8)),
    (4, 1e-3, 1e9, dict(n_layers=16, stash_cap_bytes=0.5e9)),
    (8, 1e-9, 1e2, dict(n_layers=16)),
    (2, 5e-2, 3.1e7, dict(n_layers=4, candidate_micro=(1, 2))),
    (2, 5e-2, 3.1e7, dict(n_layers=4, candidate_micro=(1, 2),
                          force_schedule="interleaved", force_micro=2,
                          force_virtual=2)),
    (1, 2e-2, 1.2e7, dict(n_layers=32, candidate_micro=(1, 2))),
    (4, 1e-3, 1e6, dict(n_layers=16, force_schedule="1f1b")),
    (4, 1e-3, 1e6, dict(n_layers=16, force_micro=16, overlap_budget=0.3)),
    (3, 1e-4, 1e8, dict(n_layers=9, candidate_virtual=(2, 3))),
]


@pytest.mark.parametrize("s,fwd,nbytes,kw", PIPE_CASES)
def test_decide_pipeline_schedule_equals_reference(s, fwd, nbytes, kw):
    got = cm.decide_pipeline_schedule(s, fwd, nbytes, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_pipeline_schedule(s, fwd, nbytes,
                                           hw=ref_cm.TPU_V5E, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.predicted_speedup == want.predicted_speedup


@pytest.mark.parametrize("kw", [
    dict(force_schedule="interleaved", force_micro=6),
    dict(force_schedule="interleaved", force_micro=4, force_virtual=8)])
def test_decide_pipeline_schedule_rejects_invalid_interleaved(kw):
    with pytest.raises(ValueError):
        ref_cm.decide_pipeline_schedule(4, 1e-3, 1e6, n_layers=16,
                                        hw=ref_cm.TPU_V5E, **kw)
    with pytest.raises(ValueError):
        cm.decide_pipeline_schedule(4, 1e-3, 1e6, n_layers=16,
                                    hw=cm.TPU_V5E, **kw)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
@pytest.mark.parametrize("m,s,v", [(1, 1, 1), (8, 4, 2), (16, 2, 3)])
def test_pipeline_terms_equal_reference(sched, m, s, v):
    assert cm.pipeline_stash_slots(sched, m, s, v) == \
        ref_cm.pipeline_stash_slots(sched, m, s, v)
    assert cm.pipeline_schedule_time(
        sched, m, s, v, 1e-3, 1e7, hw=cm.TPU_V5E, overlap_budget=0.5) == \
        ref_cm.pipeline_schedule_time(
            sched, m, s, v, 1e-3, 1e7, hw=ref_cm.TPU_V5E, overlap_budget=0.5)


def test_decide_pipeline_gpipe_bubble_formula():
    d = cm.decide_pipeline_schedule(4, 1e-3, 1e6, force_schedule="gpipe",
                                    force_micro=8)
    assert d.bubble_frac == pytest.approx((4 - 1) / (8 + 4 - 1))


CKPT_CASES = [
    # step_s, snapshot_bytes, kwargs
    (0.05, 1 << 20, dict(mtbf_s=120.0)),
    (0.5, 4e9, dict()),
    (0.1, 1.1e9, dict(mtbf_s=2.0, write_bw=3e9, ckpt_cost_s=0.2,
                      restore_s=0.4)),
    (0.1, 1.1e9, dict(force_interval=7)),
    (2.0, 4.6e10, dict(mtbf_s=3600.0, write_bw=1e9)),
    (0.01, 1 << 30, dict(candidate_intervals=(1, 3, 9))),
]


@pytest.mark.parametrize("step_s,nbytes,kw", CKPT_CASES)
def test_decide_checkpoint_equals_reference(step_s, nbytes, kw):
    got = cm.decide_checkpoint(step_s, nbytes, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_checkpoint(step_s, nbytes, hw=ref_cm.TPU_V5E, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.predicted_speedup == want.predicted_speedup
    assert cm.checkpoint_overhead(10, step_s, 0.3, 60.0, 0.1) == \
        ref_cm.checkpoint_overhead(10, step_s, 0.3, 60.0, 0.1)
    assert (cm.CKPT_FIXED_INTERVAL, cm.CKPT_WRITE_BW) == \
        (ref_cm.CKPT_FIXED_INTERVAL, ref_cm.CKPT_WRITE_BW)


def _records(log):
    return [(r.op, r.axis, r.nbytes, r.mode, r.chunks, r.predicted_bulk_s,
             r.predicted_interleaved_s) for r in log]


RESOLVE_PIPE = [
    dict(), dict(mode="bulk"), dict(mode="interleaved"),
    dict(schedule="interleaved", n_micro=8, virtual=2),
    dict(mode="bulk", schedule="1f1b"),
    dict(candidate_micro=(1, 2), n_micro=2),
]


@pytest.mark.parametrize("kw", RESOLVE_PIPE)
def test_resolve_pipeline_schedule_records_equal_reference(kw):
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        ref_managed.clear_decision_log()
        want = ref_managed.resolve_pipeline_schedule("pod", 4, 1e-3, 1e6,
                                                     n_layers=16, **kw)
        want_log = _records(ref_managed.decision_log())
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            got = managed.resolve_pipeline_schedule("pod", 4, 1e-3, 1e6,
                                                    n_layers=16, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _records(cap.records) == want_log
    assert cap.records[-1].op == "pipeline_schedule"
    assert cap.records[-1].chunks == got.n_micro


def test_resolve_pipeline_schedule_precedence():
    assert managed.resolve_pipeline_schedule(
        "pod", 4, 1e-3, 1e6, mode="bulk").schedule == "gpipe"
    assert managed.resolve_pipeline_schedule(
        "pod", 4, 1e-3, 1e6, mode="interleaved").schedule == "1f1b"
    assert managed.resolve_pipeline_schedule(
        "pod", 4, 1e-3, 1e6, mode="bulk", schedule="1f1b").schedule == "1f1b"


RESOLVE_CKPT = [dict(), dict(mode="bulk"), dict(interval=7),
                dict(mode="bulk", interval=3),
                dict(measured_write_bw=5e9, measured_ckpt_cost_s=0.05,
                     measured_restore_s=0.2, mtbf_s=30.0)]


@pytest.mark.parametrize("kw", RESOLVE_CKPT)
def test_resolve_checkpoint_records_equal_reference(kw):
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        ref_managed.clear_decision_log()
        want = ref_managed.resolve_checkpoint("mesh", 0.1, 1 << 30, **kw)
        want_log = _records(ref_managed.decision_log())
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            got = managed.resolve_checkpoint("mesh", 0.1, 1 << 30, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _records(cap.records) == want_log
    rec = cap.records[-1]
    assert (rec.op, rec.chunks) == ("ckpt_interval", got.interval)
    if kw.get("mode") == "bulk" and "interval" not in kw:
        assert got.interval == cm.CKPT_FIXED_INTERVAL


# -- the pipelined train step on a 1x1x1 pod mesh ----------------------------

ARCH = "phi4-mini-3.8b"
B, S = 4, 32
LR = 1e-2


def _cfg(n_layers):
    return dataclasses.replace(ref_configs.get_reduced(ARCH),
                               dtype="float32", n_layers=n_layers)


@pytest.fixture(scope="module")
def pod_step():
    """The reference's pipelined (and plain) step on a 1x1x1 pod mesh:
    {schedule: (loss, grad_norm, params)}, the weights and the batch."""
    cfg = _cfg(2)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="auto"))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=S, global_batch=B)
                            ).global_batch_at(0)
    out = {}
    for sched in ("none", "gpipe", "1f1b", "interleaved"):
        step, pshard, bshard = ref_build_train_step(
            model, RefAdamWConfig(lr=LR), mesh, donate=False,
            pipeline=sched, pipe_microbatches=None if sched == "none"
            else 2, global_batch=B, seq_len=S)
        p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
        bb = {k: jax.device_put(v, bshard[k]) for k, v in batch.items()}
        p2, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()), bb)
        out[sched] = (float(m["loss"]), float(m["grad_norm"]),
                      jax.tree.map(np.asarray, p2))
    return out, params, batch


def _port_step(params, batch, sched, engine="auto"):
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32",
                              n_layers=2)
    ctx = MeshCtx(axis_sizes={"pod": 1, "data": 1, "model": 1})
    model = bridge.params_from_numpy(
        params, Model(cfg, ctx, device="cpu", attn_engine=engine))
    step = build_train_step(model, AdamWConfig(lr=LR), pipeline=sched,
                            pipe_microbatches=None if sched == "none"
                            else 2, global_batch=B, seq_len=S)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step(adamw_init(model.params(), AdamWConfig()), tb)
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            bridge.params_to_numpy(model))


@pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
def test_pipeline_train_step_equals_reference(pod_step, sched):
    ref, params, batch = pod_step
    loss, gnorm, got = _port_step(params, batch, sched)
    want_loss, want_norm, want = ref[sched]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(gnorm, want_norm, rtol=1e-5)
    # the pipelined step on one stage is the plain step
    np.testing.assert_allclose(loss, ref["none"][0], rtol=1e-5)
    got_f, want_f = flatten_specs(got), flatten_specs(want)
    for name, w in want_f.items():
        np.testing.assert_allclose(got_f[name], w, rtol=3e-4, atol=1e-6,
                                   err_msg=f"{sched} {name}")


def test_pipeline_train_step_flash_calls(pod_step, monkeypatch):
    """One rank, L layers, M microbatches: every chunk's forward runs in
    its F unit and again in its B unit, its backward once: 2 M L forward
    and M L backward calls of the flash attention (the plain version on
    the CPU, through the wrappers the card's kernels sit behind)."""
    _, params, batch = pod_step
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = kernel_ops.flash_attention_fwd, kernel_ops.flash_attention_bwd

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kernel_ops, "flash_attention_fwd",
                        count("fwd", fwd))
    monkeypatch.setattr(kernel_ops, "flash_attention_bwd",
                        count("bwd", bwd))
    for sched in ("gpipe", "1f1b", "interleaved"):
        calls.update(fwd=0, bwd=0)
        _port_step(params, batch, sched, engine="torch")
        assert (calls["fwd"], calls["bwd"]) == (2 * 2 * 2, 2 * 2), sched


def test_auto_pipeline_logs_the_reference_decision(pod_step):
    """pipeline='auto' on one stage resolves what the reference resolves
    under TPU_V5E, and its timetable runs."""
    _, params, batch = pod_step
    cfg = _cfg(2)
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        ref_managed.clear_decision_log()
        mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
        ref_build_train_step(
            RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="auto")),
            RefAdamWConfig(lr=LR), mesh, pipeline="auto", global_batch=B,
            seq_len=S)
        want = [r for r in _records(ref_managed.decision_log())
                if r[0] == "pipeline_schedule"]
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            model = bridge.params_from_numpy(params, Model(
                dataclasses.replace(configs.get_reduced(ARCH),
                                    dtype="float32", n_layers=2),
                MeshCtx(axis_sizes={"pod": 1, "data": 1, "model": 1}),
                device="cpu"))
            step = build_train_step(model, AdamWConfig(lr=LR),
                                    pipeline="auto", global_batch=B,
                                    seq_len=S)
    got = [r for r in _records(cap.records) if r[0] == "pipeline_schedule"]
    assert got == want and len(got) == 1
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step(adamw_init(model.params(), AdamWConfig()), tb)
    assert np.isfinite(float(metrics["loss"]))


def test_pipeline_needs_a_pod_axis_and_a_uniform_stack():
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")
    with pytest.raises(ValueError, match="pod"):
        build_train_step(Model(cfg, device="cpu"), AdamWConfig(),
                         pipeline="1f1b")
    moe = dataclasses.replace(configs.get_reduced("moonshot-v1-16b-a3b"),
                              dtype="float32")
    with pytest.raises(ValueError, match="uniform"):
        build_train_step(
            Model(moe, MeshCtx(axis_sizes={"pod": 1, "data": 1,
                                           "model": 1}), device="cpu"),
            AdamWConfig(), pipeline="1f1b")
