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
    bulk; the H100 model prices the CUDA kernel's 2-D tile plus its k-wide
    apron in f32 (the bytes the kernel opts into), and aggregation is
    reachable."""
    assert (cm.H100.tile_rows, cm.H100.tile_cols) == stencil.KSWEEP_TILE
    for k in (1, 2, 4, 8):
        assert cm.halo_tile_bytes(k, 16384, 16386, hw=cm.H100) == \
            stencil.ksweep_smem_bytes(k)
    d = cm.decide_halo_aggregation(16384, 16386, 1, hw=cm.H100)
    assert d.k == 8 and d.mode == "aggregated"
    assert d.comm_sweep_s == 0.0 and d.predicted_speedup > 7.0
    whole_row = dataclasses.replace(cm.H100, tile_rows=256, tile_cols=None)
    assert cm.decide_halo_aggregation(16384, 16386, 1,
                                      hw=whole_row).k == 1
    # a k whose tile does not fit shared memory is never chosen
    d = cm.decide_halo_aggregation(16384, 16386, 1, hw=cm.H100,
                                   candidate_k=(1, 8, 32))
    assert d.k == 8 and 32 not in d.per_sweep_s
    assert stencil.ksweep_smem_bytes(32) > cm.H100.vmem_bytes
