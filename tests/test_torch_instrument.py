"""The port's instrumentation and directives (``core/instrument.py``,
``core/region.py``) held against the reference's:

  * raw transport collectives on one-process gloo groups named ``x`` and
    ``y`` against raw ``lax`` collectives on the reference's one-device
    mesh (the cases of ``test_plan.py:87`` and ``test_analysis.py:74``):
    primitive, axis, bytes and trips equal; a ring loop's permute is one
    record whose trips is the loop's count, and ``source`` is this file's
    line (``test_analysis.py:101`` expects the same of the reference,
    which under jax 0.9.0 records no source: a gap of the reference);
  * the declared-vs-recorded graph flags the undeclared ``y`` collective
    (MDMP101) at this file's line (``test_analysis.py:363``, the other
    reference gap);
  * the access records of the Jacobi shard compute (reads and writes
    equal, the overlap budget within 0.1), and the stencil kernel as ONE
    op on meta specs;
  * ``moe_routing_stats`` and ``capture_routing`` (histograms exact, rates
    within 1e-6);
  * ``CommRegion.lower`` / ``CommRegion.plan`` entries (mode, chunks) for
    every declaration kind, and ``UnknownAxisError``;
  * every kernel wrapper: a meta tensor raises outside a recorder and is
    one op of meta outputs inside one.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import instrument as ref_instrument
from repro.core import managed as ref_managed
from repro.core.region import CommRegion as RefRegion
from repro.core.region import UnknownAxisError as RefUnknownAxisError
from repro.parallel.sharding import smap
from repro_torch import analysis
from repro_torch.core import cost_model as cm
from repro_torch.core import instrument, managed, transport
from repro_torch.core.region import CommRegion, UnknownAxisError
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import stencil
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.plan import ir

THIS = "tests/test_torch_instrument.py"


@pytest.fixture(scope="module")
def groups():
    """Two one-process gloo groups, named ``x`` and ``y`` by a MeshCtx."""
    own = not dist.is_initialized()
    tmp = tempfile.mkdtemp()
    if own:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            tmp, "init"), rank=0, world_size=1)
    gx, gy = dist.new_group([0]), dist.new_group([0])
    yield MeshCtx({"x": 1, "y": 1}, groups={"x": gx, "y": gy})
    if own:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _tpu():
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        yield


def _ref_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("x", "y"))


def _ref_records(body, *args, in_specs):
    f = smap(body, _ref_mesh(), in_specs=in_specs, out_specs=P())
    return ref_instrument.analyze_region(f, *args).collectives


def _key(recs):
    return [(c.primitive, c.axis, c.nbytes, c.trips) for c in recs]


def test_raw_collectives_equal_reference(groups):
    gx, gy = groups.groups["x"], groups.groups["y"]

    def body(a, b):
        g = torch.cat(transport.all_gather(a, gx))
        s = transport.all_reduce(b, gy)
        r = transport.reduce_scatter(a, gx)
        t = torch.cat(transport.all_to_all([a], gy))
        c = torch.empty_like(a, device="meta")   # a one-rank group has no
        for _ in range(5):           # peer: the ring loop's messages are
            nxt = torch.empty_like(c)           # meta (recorded, not sent)
            transport.p2p_start([(c, 0, 0)], [(nxt, 0, 0)], gx)
            c = nxt
        return g.sum() + s.sum() + r.sum() + t.sum()

    rep = instrument.analyze_region(
        body, torch.ones(4, 2), torch.ones(3), mesh=groups)

    def ref_body(a, b):
        g = lax.all_gather(a, "x", tiled=True)
        s = lax.psum(b, "y")
        r = lax.psum_scatter(a, "x", tiled=True)
        t = lax.all_to_all(a, "y", 0, 0, tiled=True)

        def step(c, _):
            c = lax.ppermute(c, "x", [(0, 0)])
            return c, c.sum()
        o, _ = lax.scan(step, a, None, length=5)
        return g.sum() + s.sum() + r.sum() + t.sum() + o.sum()

    want = _ref_records(ref_body, jnp.ones((4, 2), jnp.float32),
                        jnp.ones((3,), jnp.float32),
                        in_specs=(P("x"), P(None)))
    assert _key(rep.collectives) == _key(want)
    assert rep.collective_bytes_by_axis() == \
        ref_instrument.RegionReport({}, 0, want).collective_bytes_by_axis()
    first = body.__code__.co_firstlineno
    lines = [int(c.source.rsplit(":", 1)[1]) - first
             for c in rep.collectives]
    assert all(c.source.startswith(THIS) for c in rep.collectives)
    assert lines == [1, 2, 3, 4, 8]
    depths = [c.depth for c in rep.collectives]
    assert depths == sorted(depths)


def test_ring_permute_extracted_once_with_trips_on_meta(groups):
    """The counterpart of the reference's scan-body ppermute test
    (``test_analysis.py:74``, failing under jax 0.9.0 on its source):
    one logical site, the loop's trip count, the test line as source,
    meta operands recorded and nothing sent."""
    gx = groups.groups["x"]
    LEN = 5

    def body(a):
        c = a
        for _ in range(LEN):
            transport.p2p_start([(c, 0, 0)], [], gx)
        return c

    rep = instrument.analyze_region(body, instrument.Spec((4, 2)),
                                    mesh=groups)
    perms = [c for c in rep.collectives if c.primitive == "ppermute"]
    assert len(perms) == 1 and perms[0].trips == LEN
    assert perms[0].nbytes == 4 * 2 * 4
    assert rep.collective_bytes_by_axis()["x"] == LEN * 4 * 2 * 4
    ops = ir.lower_collectives(perms, {"x": 1})
    assert ops[0].meta["trips"] == LEN
    assert ops[0].meta["source"] == \
        f"{THIS}:{body.__code__.co_firstlineno + 3}"


def test_graph_from_region_record_and_plan(groups):
    """Declare, record, lower (the reference's ``test_analysis.py:363``,
    failing under jax 0.9.0): the undeclared ``y`` all-reduce is MDMP101
    at this file's line."""
    gx, gy = groups.groups["x"], groups.groups["y"]
    region = CommRegion("r", axis_sizes={"x": 1, "y": 1})
    region.send("gathered", axis="x", shape=(4, 2), dtype=torch.float32)

    def body(a, b):
        g = torch.cat(transport.all_gather(a, gx))
        s = transport.all_reduce(b, gy)          # never declared
        return g.sum() + s.sum()

    rep = instrument.analyze_region(body, torch.ones(4, 2), torch.ones(3),
                                    mesh=groups)
    graph = analysis.from_ops(
        "r", axis_sizes=region.axis_sizes, declared=region.lower(),
        traced=ir.lower_collectives(rep.collectives, region.axis_sizes))
    undecl = [d for d in analysis.run_all(graph) if d.code == "MDMP101"]
    assert len(undecl) == 1 and undecl[0].axis == "y"
    assert str(undecl[0].site) == \
        f"{THIS}:{body.__code__.co_firstlineno + 2}"
    assert region._specs[0].site[0] == THIS


def test_managed_collectives_at_axis_size_one_record_nothing(groups):
    """At axis size 1 the managed layer returns its input (as the
    reference's), so a 1x1 region records no managed collective."""
    x = torch.ones(4, 2)

    def body(a):
        return (managed.managed_all_gather(a, "x", groups)
                + managed.managed_all_reduce(a, "y", groups))

    rep = instrument.analyze_region(body, x, mesh=groups)
    f = smap(lambda a: ref_managed.managed_all_gather(a, "x")
             + ref_managed.managed_all_reduce(a, "y"), _ref_mesh(),
             in_specs=(P(),), out_specs=P())
    want = ref_instrument.analyze_region(f, jnp.ones((4, 2), jnp.float32))
    assert rep.collectives == [] and want.collectives == []


def test_meta_operands_send_nothing(groups):
    gx = groups.groups["x"]
    rep = instrument.analyze_region(
        lambda a: transport.all_gather(a, gx)[0].sum(),
        instrument.Spec((8, 3), torch.bfloat16), mesh=groups)
    assert _key(rep.collectives) == [("all_gather", "x", 48, 1)]
    # without a recorder nothing is recorded and the call is a plain one
    assert instrument.ACTIVE is None
    assert torch.equal(transport.all_gather(torch.ones(2), gx)[0],
                       torch.ones(2))


# -- access records ----------------------------------------------------------

LOCAL = (128, 514)


def shard_compute_torch(u, ff):
    return 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
                   - ff[1:-1, 1:-1])


def shard_compute_jnp(u, ff):
    return 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
                   - ff[1:-1, 1:-1])


@pytest.mark.parametrize("tracked", [[0], [0, 1], [1]])
def test_jacobi_access_records_equal_reference(tracked):
    labels = [("u", "f")[i] for i in tracked]
    spec = jax.ShapeDtypeStruct(LOCAL, jnp.float32)
    want = ref_instrument.analyze_region(shard_compute_jnp, spec, spec,
                                         tracked_args=tracked,
                                         labels=labels)
    got = instrument.analyze_region(shard_compute_torch,
                                    instrument.Spec(LOCAL),
                                    instrument.Spec(LOCAL, torch.float32),
                                    tracked_args=tracked, labels=labels)
    for lab in labels:
        g, w = got.records[lab], want.records[lab]
        assert (g.reads, g.writes) == (w.reads, w.writes)
        assert abs(got.overlap_budget(lab) - want.overlap_budget(lab)) < 0.1
    assert got.collectives == []


def test_stencil_kernel_is_one_op_on_meta_specs():
    rep = instrument.analyze_region(
        lambda u, f: stencil.jacobi_step(u, f), instrument.Spec(LOCAL),
        instrument.Spec(LOCAL), labels=("u", "f"))
    assert rep.total_eqns == 1
    assert [(r.reads, r.writes, r.first_read_depth)
            for r in rep.records.values()] == [(1, 0, 1), (1, 0, 1)]


def test_writes_propagate_through_views_and_updates():
    def body(a, b):
        v = a.view(-1)                    # alias: read + write
        c = torch.zeros(8)
        c[2:4] = b                        # copy_ into an untracked slice
        a[0] = 5.0                        # in-place through a slice of a
        d = torch.slice_scatter(c, v[:2], 0, 0, 2)   # reads v's slice
        return d.sum() + b.sum()

    rep = instrument.analyze_region(body, torch.ones(2, 2), torch.ones(2),
                                    labels=("a", "b"))
    a, b = rep.records["a"], rep.records["b"]
    # reads: the view, the select of a[0], the slice of the view (a
    # slice is a read and is not tracked onward); writes: the view, the
    # in-place fill through the select
    assert (a.reads, a.writes) == (3, 2)
    assert (b.reads, b.writes) == (2, 0)
    assert a.last_write_depth > a.first_read_depth


# -- MoE routing counters -----------------------------------------------------


@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_moe_routing_stats_equal_reference(skew):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(257, 8))
    logits[:, 0] += skew
    top = np.argsort(-logits, axis=1)[:, :2].astype(np.int32)
    got = instrument.moe_routing_stats(torch.from_numpy(top), 8, 40)
    want = ref_instrument.moe_routing_stats(jnp.asarray(top), 8, 40)
    np.testing.assert_array_equal(got["histogram"].numpy(),
                                  np.asarray(want["histogram"]))
    for k in ("drop_rate", "occupancy", "imbalance"):
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-6)
    instrument.clear_routing_log()
    rec = instrument.capture_routing("demo", top, 8, 40)
    ref_rec = ref_instrument.capture_routing("demo", top, 8, 40)
    np.testing.assert_array_equal(rec.histogram, ref_rec.histogram)
    assert (rec.tokens, rec.top_k) == (ref_rec.tokens, ref_rec.top_k)
    assert rec.imbalance == pytest.approx(ref_rec.imbalance, abs=1e-6)
    assert instrument.routing_log() == [rec]


# -- the directives -----------------------------------------------------------


def _declare(region, dt):
    region.send("kv", axis="model", shape=(16, 8), dtype=dt)
    region.recv("kv_in", axis="model", shape=(16, 8), dtype=dt)
    region.collective("grads", axis="data", shape=(1024,), dtype=dt,
                      collective="all_reduce")
    region.halo("h", axis="x", rows_local=256, cols=1026, dtype=dt)
    region.attention("attn", axis="model", batch=2, s_local=256, heads=8,
                     kv_heads=8, head_dim=64, d_model=512, dtype=dt)
    region.pipeline("stage", axis="pod", n_layers=16,
                    batch_shape=(8, 128, 64), dtype=dt, batch_fwd_s=1e-3)
    region.moe("moe", axis="model", tokens_local=512, d_model=512,
               n_experts=8, top_k=2, d_ff_expert=256, dtype=dt)
    region.serve("serve", axis="serve", batch_slots=8, mean_prompt=160,
                 mean_new=32, n_params=int(3.8e9), dtype=dt,
                 max_prompt=256, page_bytes=1 << 20, mean_pages=12)
    region.checkpoint("ckpt", axis="data", snapshot_bytes=1 << 30,
                      step_s=0.5, mtbf_s=600.0)


AXES = {"model": 4, "data": 2, "x": 8, "pod": 4, "serve": 8}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_region_lower_and_plan_equal_reference(dt):
    region = CommRegion("r", axis_sizes=AXES)
    ref = RefRegion("r", axis_sizes=AXES)
    _declare(region, getattr(torch, dt))
    _declare(ref, getattr(jnp, dt))

    def strip(d):
        d = dict(d, meta=dict(d["meta"]))
        d["meta"].pop("site", None)
        return d
    assert [strip(o.to_dict()) for o in region.lower()] == \
        [strip(o.to_dict()) for o in ref.lower()]
    assert all(s.site[0] == THIS for s in region._specs)
    managed.clear_decision_log()
    ref_managed.clear_decision_log()
    plan = region.plan(lambda a: a * 2, instrument.Spec((4,)),
                       compute_time_s=1e-4)
    want = ref.plan(lambda a: a * 2, jax.ShapeDtypeStruct((4,), jnp.float32),
                    compute_time_s=1e-4)
    assert list(plan.entries) == list(want.entries)
    for label, e in plan.entries.items():
        w = want.entries[label]
        assert (e.mode, e.chunks) == (w.mode, w.chunks), label
        assert e.overlap_budget == pytest.approx(w.overlap_budget), label
        assert e.predicted_bulk_s == pytest.approx(w.predicted_bulk_s,
                                                   rel=1e-12), label
    assert plan.total_eqns == want.total_eqns == 1
    assert [(r.op, r.mode, r.chunks) for r in managed.decision_log()] == \
        [(r.op, r.mode, r.chunks) for r in ref_managed.decision_log()]
    assert plan.k_for("h") == want.k_for("h")
    assert plan.schedule_for("attn") == want.schedule_for("attn")
    # the planned region lowers with its instrumented windows
    assert [strip(o.to_dict()) for o in region.lower()] == \
        [strip(o.to_dict()) for o in ref.lower()]
    assert "MDMP plan (1 eqns in region)" in plan.summary()


def test_unknown_axis_error_equals_reference():
    region = CommRegion("r", axis_sizes={"model": 4, "data": 2})
    ref = RefRegion("r", axis_sizes={"model": 4, "data": 2})
    with pytest.raises(UnknownAxisError) as ei:
        region.send("grads", axis="modle", shape=(16,), dtype=torch.float32)
    with pytest.raises(RefUnknownAxisError) as ri:
        ref.send("grads", axis="modle", shape=(16,), dtype=jnp.float32)
    assert str(ei.value) == str(ri.value) and "MDMP001" in str(ei.value)
    assert region._specs == []
    with pytest.raises(UnknownAxisError):
        region.moe("m", axis="pod", tokens_local=64, d_model=8, n_experts=4,
                   top_k=1, d_ff_expert=16, dtype=torch.float32)


def test_pipeline_region_plans_schedule_from_readiness():
    """The reference's ``test_pipeline.py:337``: the pipeline spec takes
    its overlap budget from the report."""
    r = CommRegion("train", axis_sizes={"pod": 4})
    r.pipeline("stage_boundary", axis="pod", n_layers=16,
               batch_shape=(8, 128, 64), dtype=np.float32, batch_fwd_s=1e-3)
    ref = RefRegion("train", axis_sizes={"pod": 4})
    ref.pipeline("stage_boundary", axis="pod", n_layers=16,
                 batch_shape=(8, 128, 64), dtype=np.float32,
                 batch_fwd_s=1e-3)
    plan = r.plan(lambda x: torch.tanh(x) @ x.T, torch.ones(8, 8))
    want = ref.plan(lambda x: jnp.tanh(x) @ x.T, jnp.ones((8, 8)))
    e, w = plan.entries["stage_boundary"], want.entries["stage_boundary"]
    assert (e.mode, e.chunks) == (w.mode, w.chunks)
    assert e.overlap_budget == pytest.approx(w.overlap_budget)
    assert plan.schedule_for("stage_boundary") == e.mode


# -- the kernel wrappers and meta tensors -------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _calls():
    q = _meta(1, 64, 4, 64, dtype=torch.bfloat16)
    lse = _meta(1, 64, 4)
    st = _meta(1, 64, 4)
    acc = _meta(1, 64, 4, 64)
    qd = _meta(2, 4, 64, dtype=torch.bfloat16)
    pages = _meta(16, 8, 2, 64, dtype=torch.bfloat16)
    table = _meta(2, 8, dtype=torch.int32)
    lens = _meta(2, dtype=torch.int32)
    h = _meta(4, 16, 32)
    u = _meta(16, 8)
    halo = _meta(2, 8)
    return {
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, q, q),
                                [(1, 64, 4, 64), (1, 64, 4)]),
        "flash_attention_bwd": (lambda: fa.flash_attention_bwd(
            q, q, q, q, lse, q), [(1, 64, 4, 64)] * 3),
        "flash_attention_carry": (lambda: fa.flash_attention_carry(
            q, q, q, st, st, acc), [(1, 64, 4), (1, 64, 4),
                                    (1, 64, 4, 64)]),
        "flash_attention_bwd_block": (lambda: fa.flash_attention_bwd_block(
            q, q, q, q, lse, lse, causal=True), [(1, 64, 4, 64)] * 3),
        "paged_attention": (lambda: paged.paged_attention(
            qd, pages, pages, table, lens), [(2, 4, 64)]),
        "grouped_expert_ffn": (lambda: gm.grouped_expert_ffn(
            h, _meta(4, 32, 48), None, _meta(4, 48, 32),
            _meta(4, dtype=torch.int32), mlp="gelu"), [(4, 16, 32)]),
        "jacobi_step": (lambda: stencil.jacobi_step(u, u), [(16, 8)]),
        "jacobi_ksweep": (lambda: stencil.jacobi_ksweep_parts(
            halo, u, halo, halo, u, halo, 2, 0, 0), [(16, 8)]),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_kernel_wrappers_on_meta_tensors(name):
    call, shapes = _calls()[name]
    with pytest.raises(RuntimeError, match="meta"):
        call()
    got = {}

    def body():
        got["out"] = call()

    rep = instrument.analyze_region(body)
    outs = got["out"] if isinstance(got["out"], tuple) else (got["out"],)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.device.type == "meta" for o in outs)
    assert rep.total_eqns == 1


# -- the examples' directives -------------------------------------------------


def test_jacobi_example_plans_through_its_region():
    from repro_torch.examples import jacobi_mdmp

    region, plan = jacobi_mdmp.plan_region(8, 128, 514)
    assert plan.k_for("halo_agg") == \
        managed.resolve_halo_aggregation("x", 8, 128, 514).k
    assert region.last_report.total_eqns == 1       # one jacobi_step op
    assert [s.kind for s in region._specs] == ["send", "send", "halo"]


def test_moe_dispatch_example_one_rank():
    import argparse

    from repro_torch.examples import moe_dispatch

    got = moe_dispatch.run(0, 1, argparse.Namespace(device="cpu", seed=0))
    for disp in ("stream", "dense"):
        np.testing.assert_allclose(got["outs"][disp], got["outs"]["bulk"],
                                   rtol=2e-4, atol=2e-5)
    assert got["launches"] == {"bulk": 0, "stream": 0, "dense": 0}  # CPU
    rec, d = got["routing"], got["decision"]
    want = ref_managed.resolve_moe_dispatch(
        "model", 1, moe_dispatch.B * moe_dispatch.S, moe_dispatch.D,
        moe_dispatch.E, moe_dispatch.K, moe_dispatch.F, dtype_bytes=4,
        capacity_factor=2.0, measured_imbalance=rec.imbalance,
        measured_drop_rate=rec.drop_rate)
    assert (d.schedule, d.g, d.capacity_factor) == \
        (want.schedule, want.g, want.capacity_factor)
