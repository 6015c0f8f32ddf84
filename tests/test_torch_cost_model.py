"""The port's managed-runtime host logic held against the reference's:
the serve-schedule, preemption and halo-aggregation decisions (priced on
``TPU_V5E`` on both sides), their decision-trail records, the drain meter,
the fault-plan parser and the recalibration trigger; and the halo
decision priced on the ``H100``, whose stencil kernel stages a 2-D tile."""

import dataclasses
import math

import pytest

from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.core import overlap as ref_overlap
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.obs.calibrate import Recalibrator as RefRecalibrator
from repro_torch.core import cost_model as cm
from repro_torch.core import managed, overlap
from repro_torch.core.faults import FaultPlan
from repro_torch.kernels import stencil
from repro_torch.obs.calibrate import Recalibrator

SERVE_CASES = [
    # n_params, slots, mean_prompt, mean_new, kwargs
    (1e8, 8, 64, 32, dict(max_prompt=256)),
    (1e8, 8, 64, 32, dict(max_prompt=64)),
    (3.8e9, 8, 160, 32, dict(max_prompt=256, dtype_bytes=2)),
    (1e8, 8, 64, 32, dict(max_prompt=256, force_mode="static",
                          force_chunk=5)),
    (1e8, 8, 64, 32, dict(max_prompt=256, measured_step_s=1e-3,
                          ttft_budget_s=0.08)),
    (3.4e10, 4, 16, 16, dict(measured_step_s=2e-2,
                             measured_dispatch_s=3e-4)),
]

PREEMPT_CASES = [
    # victim_pages, page_bytes, replay_tokens, n_params, kwargs
    (2, 1 << 20, 100_000, 1e9, dict(step_s=1e-3)),
    (4, 1 << 16, 10, 1e8, dict()),
    (8, 1 << 22, 512, 3.8e9, dict(wait_s=1e-3, batch_slots=8)),
    (8, 1 << 22, 512, 3.8e9, dict(allow_swap=False)),
    (1, 1 << 20, 64, 1e9, dict(pcie_bw=5e10, chunk_bytes=1 << 18)),
    (1, 1 << 20, 64, 1e9, dict(force_policy="swap")),
]


@pytest.mark.parametrize("n,b,mp,mn,kw", SERVE_CASES)
def test_decide_serve_schedule_equals_reference(n, b, mp, mn, kw):
    got = cm.decide_serve_schedule(n, b, mp, mn, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_serve_schedule(n, b, mp, mn, hw=ref_cm.TPU_V5E,
                                        **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("pages,pb,replay,n,kw", PREEMPT_CASES)
def test_decide_preempt_equals_reference(pages, pb, replay, n, kw):
    got = cm.decide_preempt(pages, pb, replay, n, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_preempt(pages, pb, replay, n, hw=ref_cm.TPU_V5E,
                                 **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("mode", [None, "bulk", "interleaved"])
def test_resolvers_log_the_reference_records(mode):
    def trail(mod, hw):
        with mod.use_config(mod.MDMPConfig(hw=hw)):
            with mod.capture_decisions() as cap:
                mod.resolve_serve_schedule("serve", 8, 64, 32, 1e8,
                                           max_prompt=256, mode=mode)
                mod.resolve_preempt("serve", 2, 1 << 20, 100_000, 1e9,
                                    measured_step_s=1e-3, mode=mode)
                mod.resolve_preempt("serve", 2, 1 << 20, 100_000, 1e9,
                                    mode=mode, policy="swap")
        return cap.records

    got = trail(managed, cm.TPU_V5E)
    want = trail(ref_managed, ref_cm.TPU_V5E)
    assert [dataclasses.asdict(r) | {"t": None} for r in got] == \
        [dataclasses.asdict(r) | {"t": None} for r in want]
    assert all(r.t is not None for r in got)


def test_h100_is_the_default_machine():
    assert cm.DEFAULT_HW is cm.H100
    assert managed.MDMPConfig().hw is cm.H100
    assert cm.H100.peak_flops == 989e12 and cm.H100.hbm_bw == 3.35e12
    assert cm.H100.vmem_bytes == 227 * 1024
    # the decode roofline is priced on the card: phi4-mini in bf16 streams
    # its 8.1 GB of weights per step
    step = cm.serve_step_time(4.04e9, 8)
    assert math.isclose(step, 4.04e9 * 2 / 3.35e12)


@pytest.mark.parametrize("step_s,bw", [(1e-3, 1.6e10), (1e-6, 1.0),
                                       (5.0, 5e10)])
def test_drain_chunk_bytes_equals_reference(step_s, bw):
    assert overlap.drain_chunk_bytes(step_s, bw) == \
        ref_overlap.drain_chunk_bytes(step_s, bw)


def test_fault_plan_parse_and_fire_equal_reference():
    spec = "burst@1:6;pool_squeeze@3:0.8,replica_death@5;burst@1:2"
    got, want = FaultPlan.parse(spec), RefFaultPlan.parse(spec)
    assert [dataclasses.asdict(e) for e in got.events] == \
        [dataclasses.asdict(e) for e in want.events]
    assert [e.arg for e in got.serve_overload(1)] == \
        [e.arg for e in want.serve_overload(1)]
    with pytest.raises(RuntimeError, match="replica death"):
        got.serve_quantum(5)
    assert [e.kind for e in got.unfired()] == ["pool_squeeze"]
    with pytest.raises(ValueError):
        FaultPlan.parse("meteor@3")


def test_recalibrator_fires_like_reference():
    seq = [1.0, 1.0, 1.0, 1.1, 2.0, 2.5, 3.0, 3.0, 1.0, 0.5]
    got, want = Recalibrator(), RefRecalibrator()
    for x in seq:
        got.note(x)
        want.note(x)
        assert got.should_retune() == want.should_retune()
        if want.should_retune():
            got.rebase()
            want.rebase()
    assert got.retunes == want.retunes > 1


HALO_CASES = [
    # rows_local, cols, axis_size, kwargs (tests/test_cost_model.py's
    # cases, then full-width, bf16, forced and one-rank variants)
    (128, 514, 8, dict()),
    (128, 514, 8, dict(force_k=1)),
    (4, 514, 8, dict(candidate_k=(1, 2, 4, 8))),
    (256, 514, 8, dict()),
    (256, 256, 4, dict()),
    (16384, 16386, 1, dict()),
    (2048, 16386, 8, dict(dtype_bytes=2)),
    (2048, 1 << 20, 8, dict()),
    (64, 4096, 2, dict(force_k=16, candidate_k=(1, 2, 4, 8, 16))),
    (3, 100, 4, dict(force_k=8)),
    (512, 8192, 1, dict(candidate_k=(2, 3))),
]


@pytest.mark.parametrize("rows,cols,n,kw", HALO_CASES)
def test_decide_halo_aggregation_equals_reference(rows, cols, n, kw):
    got = cm.decide_halo_aggregation(rows, cols, n, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_halo_aggregation(rows, cols, n, hw=ref_cm.TPU_V5E,
                                          **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.mode, got.predicted_speedup) == \
        (want.mode, want.predicted_speedup)


@pytest.mark.parametrize("k", [1, 2, 8, 32])
@pytest.mark.parametrize("n", [1, 8])
def test_halo_sweep_terms_equal_reference(k, n):
    for fn in ("halo_sweep_terms", "halo_sweep_time"):
        got = getattr(cm, fn)(k, 256, 514, hw=cm.TPU_V5E, axis_size=n)
        want = getattr(ref_cm, fn)(k, 256, 514, hw=ref_cm.TPU_V5E,
                                   axis_size=n)
        assert got == want, fn
    assert cm.JACOBI_FLOPS_PER_POINT == ref_cm.JACOBI_FLOPS_PER_POINT


@pytest.mark.parametrize("mode", [None, "bulk", "interleaved"])
def test_resolve_halo_aggregation_logs_the_reference_records(mode):
    def trail(mod, hw):
        with mod.use_config(mod.MDMPConfig(hw=hw)):
            with mod.capture_decisions() as cap:
                mod.resolve_halo_aggregation("x", 4, 256, 256, mode=mode)
                mod.resolve_halo_aggregation("x", 8, 128, 514, mode=mode)
                mod.resolve_halo_aggregation("x", 8, 128, 514, mode=mode,
                                             k=2)
                mod.resolve_halo_aggregation("y", 1, 4096, 4098,
                                             dtype_bytes=2, mode=mode)
        return cap.records

    got = trail(managed, cm.TPU_V5E)
    want = trail(ref_managed, ref_cm.TPU_V5E)
    assert [dataclasses.asdict(r) | {"t": None} for r in got] == \
        [dataclasses.asdict(r) | {"t": None} for r in want]


def test_h100_prices_the_tile_its_kernel_stages():
    """At the card shape (16386 columns) the reference's whole-row tile
    never fits 227 KB of shared memory, so every k > 1 would fall back to
    bulk; the H100 model prices what the CUDA k-sweep kernel holds (its
    shared-memory ring, the bytes the launcher opts into, in the array's
    type) and drops exactly the k the kernel does not take, so
    aggregation is reachable."""
    assert cm.H100.ksweep_max_k == stencil.KSWEEP_MAX_K
    for k in range(1, stencil.KSWEEP_MAX_K + 1):
        for itemsize in (4, 2):
            assert cm.halo_tile_bytes(k, 16384, 16386, dtype_bytes=itemsize,
                                      hw=cm.H100) == \
                stencil.ksweep_smem_bytes(k, itemsize) <= cm.H100.vmem_bytes
    d = cm.decide_halo_aggregation(16384, 16386, 1, hw=cm.H100)
    assert d.k == 8 and d.mode == "aggregated"
    assert d.comm_sweep_s == 0.0 and d.predicted_speedup > 7.0
    whole_row = dataclasses.replace(cm.H100, ksweep_max_k=0)
    assert cm.decide_halo_aggregation(16384, 16386, 1,
                                      hw=whole_row).k == 1
    # a k the kernel does not take is never chosen, nor forced
    k_over = stencil.KSWEEP_MAX_K + 1
    d = cm.decide_halo_aggregation(16384, 16386, 1, hw=cm.H100,
                                   candidate_k=(1, 8, k_over))
    assert d.k == 8 and k_over not in d.per_sweep_s
    assert cm.decide_halo_aggregation(16384, 16386, 1, hw=cm.H100,
                                      force_k=k_over).k == 8
    with pytest.raises(ValueError, match="k <= 8"):
        stencil.ksweep_smem_bytes(k_over)


# -- the generic call-site decision and the attention schedule --------------

#: (nbytes, axis size, compute s, collective, force)
DECIDE_CASES = [
    (1 << 20, 1, 0.0, "all_gather", None),
    (1 << 20, 8, 0.0, "all_gather", None),
    (1 << 24, 8, 1e-3, "all_gather", None),
    (1 << 16, 4, 1e-6, "reduce_scatter", None),
    (1 << 22, 8, 5e-4, "all_reduce", None),
    (1 << 22, 16, 5e-4, "all_to_all", None),
    (1 << 20, 8, 1e-3, "all_gather", "bulk"),
    (1 << 10, 8, 0.0, "all_gather", "interleaved"),
]

#: (B, S_loc, H, KV, hd, D, axis size, dtype bytes, causal)
ATTN_CASES = [
    (1, 4096, 32, 8, 128, 4096, 8, 2, True),
    (1, 4096, 32, 8, 128, 4096, 1, 2, True),
    (2, 128, 8, 2, 16, 64, 8, 4, False),
    (4, 512, 48, 1, 128, 6144, 4, 2, True),
    (1, 16384, 24, 8, 128, 3072, 16, 2, False),
    (8, 64, 16, 16, 64, 1024, 2, 2, True),
]


@pytest.mark.parametrize("nbytes,n,compute,coll,force", DECIDE_CASES)
def test_decide_equals_reference(nbytes, n, compute, coll, force):
    kw = dict(compute_time_s=compute, collective=coll, force_mode=force)
    got = cm.decide(nbytes, n, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide(nbytes, n, hw=ref_cm.TPU_V5E, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.predicted_speedup == want.predicted_speedup
    assert cm.point_to_point_time(nbytes, cm.TPU_V5E, messages=n) == \
        ref_cm.point_to_point_time(nbytes, ref_cm.TPU_V5E, messages=n)


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("force", [None, "bulk", "ulysses", "ring"])
def test_attention_schedule_equals_reference(case, force):
    b, s, h, kvh, hd, d, n, nb, causal = case
    args = (b, s, h, kvh, hd, d, n)
    kw = dict(dtype_bytes=nb, causal=causal)
    assert cm.attention_schedule_times(*args, hw=cm.TPU_V5E, **kw) == \
        ref_cm.attention_schedule_times(*args, hw=ref_cm.TPU_V5E, **kw)
    assert cm.attention_flash_step_s(b, s, h, hd, cm.TPU_V5E) == \
        ref_cm.attention_flash_step_s(b, s, h, hd, ref_cm.TPU_V5E)
    got = cm.decide_attention_schedule(*args, hw=cm.TPU_V5E,
                                       force_schedule=force, **kw)
    want = ref_cm.decide_attention_schedule(*args, hw=ref_cm.TPU_V5E,
                                            force_schedule=force, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.predicted_speedup == want.predicted_speedup


def test_attention_schedule_ties_to_bulk_at_one_rank_on_the_h100():
    d = cm.decide_attention_schedule(1, 8192, 32, 8, 128, 3072, 1)
    assert len(set(d.times_s.values())) == 1 and d.schedule == "bulk"


@pytest.mark.parametrize("mode", [None, "auto", "bulk", "interleaved"])
def test_resolve_attention_schedule_logs_the_reference_records(mode):
    def trail(mod, hw):
        with mod.use_config(mod.MDMPConfig(hw=hw)):
            with mod.capture_decisions() as cap:
                mod.resolve_attention_schedule(
                    "model", 8, 1, 4096, 32, 8, 128, 4096, mode=mode)
                mod.resolve_attention_schedule(
                    "model", 1, 2, 128, 8, 2, 16, 64, dtype_bytes=4,
                    causal=False, mode=mode)
                mod.resolve_attention_schedule(
                    "model", 4, 1, 1024, 16, 4, 64, 1024, mode=mode,
                    schedule="ulysses")
        return cap.records

    got = trail(managed, cm.TPU_V5E)
    want = trail(ref_managed, ref_cm.TPU_V5E)
    assert [dataclasses.asdict(r) | {"t": None} for r in got] == \
        [dataclasses.asdict(r) | {"t": None} for r in want]


def test_forced_interleaved_resolves_to_ring():
    """The paper's always-intermingle mode pins the streaming schedule
    (tests/dist_suite/test_ring_attention.py's case, on the port's
    default machine)."""
    d = managed.resolve_attention_schedule(
        "model", 8, 1, 4096, 32, 8, 128, 4096, mode="interleaved")
    assert d.schedule == "ring"
    d = managed.resolve_attention_schedule(
        "model", 8, 1, 4096, 32, 8, 128, 4096, mode="bulk")
    assert d.schedule == "bulk"


@pytest.mark.parametrize("mode", [None, "bulk", "interleaved"])
def test_ring_attention_resolution_logs_the_reference_record(mode):
    """The ring's call-site record (the reference's ``_ring_attn_resolve``
    through ``_resolve``) on an 8-rank axis, priced on the same machine:
    the port takes the shapes, the reference the traced operands."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.parallel.sharding import smap
    from repro_torch.parallel.sharding import MeshCtx

    b, s_loc, h, kvh, hd = 2, 512, 8, 2, 64
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        with ref_managed.capture_decisions() as cap:
            mesh = jax.make_mesh((1,), ("x",))
            q = jnp.zeros((b, s_loc, h, hd), jnp.bfloat16)
            k = jnp.zeros((b, s_loc, kvh, hd), jnp.bfloat16)
            # the reference takes the axis size from the mesh: one rank
            jax.jit(smap(lambda q_, k_: ref_managed._ring_attn_resolve(
                q_, k_, "x", True, mode)[1] * jnp.ones(()), mesh,
                in_specs=(P(None, "x"),) * 2, out_specs=P()))(q, k)
        want = cap.records
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            got_mode = managed.resolve_ring_attention(
                "x", MeshCtx({"x": 1}), b, s_loc, h, hd,
                b * s_loc * kvh * hd * 2, causal=True, mode=mode)
    assert [dataclasses.asdict(r) | {"t": None} for r in cap.records] == \
        [dataclasses.asdict(r) | {"t": None} for r in want]
    assert got_mode == want[0].mode
    # at 8 ranks the port's record carries the reference's decide
    n = 8
    compute = 0.5 * n * cm.attention_flash_step_s(b, s_loc, h, hd,
                                                  cm.TPU_V5E)
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            managed.resolve_ring_attention(
                "model", MeshCtx({"data": 1, "model": n}), b, s_loc, h, hd,
                b * s_loc * kvh * hd * 2, causal=True, mode=mode)
    d = ref_cm.decide(b * s_loc * kvh * hd * 2, n, compute_time_s=compute,
                      hw=ref_cm.TPU_V5E, collective="all_gather",
                      force_mode=None if mode in (None, "auto") else mode)
    rec = cap.records[0]
    assert (rec.mode, rec.predicted_bulk_s, rec.predicted_interleaved_s) \
        == (d.mode if mode is None else mode, d.bulk_time_s,
            d.interleaved_time_s)


# -- the paper's machines, PingPong and its crossovers, the roofline ---------

MACHINES = ["TPU_V5E", "HECTOR_XE6", "HELIOS_BULLX", "JUQUEEN_BGQ"]


@pytest.mark.parametrize("name", MACHINES[1:])
def test_paper_machines_equal_reference(name):
    got = dataclasses.asdict(getattr(cm, name))
    want = dataclasses.asdict(getattr(ref_cm, name))
    # the port's H100-only fields sit at their defaults
    assert {k: got[k] for k in want} == want
    assert (got["tile_rows"], got["ksweep_max_k"]) == (256, 0)


@pytest.mark.parametrize("name", MACHINES)
@pytest.mark.parametrize("n", [1, 64, 4096, 1 << 20])
def test_pingpong_times_equal_reference(name, n):
    hw, ref_hw = getattr(cm, name), getattr(ref_cm, name)
    for delay in (0.0, 1.0, 37.5, 1e4):
        for sent in (None, 1, max(1, n // 8)):
            for nbytes in (4.0, 8.0):
                assert cm.pingpong_times(n, delay, hw, nbytes, 1.0, sent) \
                    == ref_cm.pingpong_times(n, delay, ref_hw, nbytes, 1.0,
                                             sent)


@pytest.mark.parametrize("name", MACHINES)
@pytest.mark.parametrize("n", [64, 4096, 1 << 20])
def test_crossovers_equal_reference(name, n):
    hw, ref_hw = getattr(cm, name), getattr(ref_cm, name)
    for sent in (None, max(1, n // 16)):
        assert cm.crossover_compute_per_element(n, hw, 4.0, sent) == \
            ref_cm.crossover_compute_per_element(n, ref_hw, 4.0, sent)
    for chunks in (1, 2, 8, 64, 1024):
        assert cm.crossover_compute_chunked(n, chunks, hw) == \
            ref_cm.crossover_compute_chunked(n, chunks, ref_hw)


def test_h100_crossover_prices_the_delay_loop_at_its_peak():
    """The H100 has no scalar rate: the delay loop runs at its peak, as
    the reference's code does for any machine without one."""
    assert cm.H100.scalar_flops == 0.0
    bulk, fine = cm.pingpong_times(4096, 10.0, cm.H100)
    compute = 4096 * 10.0 / cm.H100.peak_flops
    assert bulk == pytest.approx(compute + cm.H100.alpha_s
                                 + 4096 * 4.0 / cm.H100.link_bw, rel=1e-12)
    assert fine > 0.0
    assert cm.crossover_compute_chunked(1 << 20, 8) == \
        cm.crossover_compute_chunked(1 << 20, 8, hw=cm.H100)


@pytest.mark.parametrize("name", MACHINES)
@pytest.mark.parametrize("flops,nbytes,coll,n", [
    (197e12, 819e9, 50e9, 1), (1e9, 1e12, 0.0, 1), (3.1e15, 2.2e12, 9e11, 256),
    (0.0, 0.0, 1e6, 512)])
def test_roofline_equals_reference(name, flops, nbytes, coll, n):
    got = cm.roofline(flops, nbytes, coll, n, getattr(cm, name))
    want = ref_cm.roofline(flops, nbytes, coll, n, getattr(ref_cm, name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.dominant, got.bound_s) == (want.dominant, want.bound_s)


def test_roofline_defaults_to_the_h100():
    got = cm.roofline(989e12, 3.35e12, 450e9, 1)
    assert got == cm.roofline(989e12, 3.35e12, 450e9, 1, cm.H100)
    assert got.bound_s == pytest.approx(1.0)
