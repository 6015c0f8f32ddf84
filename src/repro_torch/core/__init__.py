"""MDMP core — the paper's contribution as a composable PyTorch module
(port of ``repro.core``).

Public surface:
  * managed collectives (bulk / interleaved / auto) .......... managed.py
  * fused comm+compute rings (AG-matmul, matmul-RS) ........... managed.py
  * halo exchange + the paper's Jacobi schedules .............. halo.py
  * communication regions (declarative directives) ............ region.py
  * read/write instrumentation of a region .................... instrument.py
  * alpha-beta cost model + roofline terms .................... cost_model.py
  * as-ready gradient reduction / FSDP overlap ................ overlap.py
  * runtime schedule tuner ..................................... tuner.py

The names resolve on first use: the kernel modules import
``core.instrument``, and ``core.halo`` imports the kernels, so importing
every module here would import the kernels half made.
"""

import importlib

#: module -> the public names it holds
_EXPORTS = {
    "cost_model": ("DEFAULT_HW", "HECTOR_XE6", "HELIOS_BULLX", "JUQUEEN_BGQ",
                   "TPU_V5E", "HaloAggregationDecision", "HardwareModel",
                   "PipelineScheduleDecision", "RooflineTerms",
                   "crossover_compute_per_element", "decide",
                   "decide_halo_aggregation", "decide_pipeline_schedule",
                   "halo_sweep_time", "roofline"),
    "halo": ("halo_exchange", "jacobi_solve", "jacobi_step_aggregated",
             "jacobi_step_bulk", "jacobi_step_overlapped"),
    "instrument": ("AccessRecord", "RegionReport", "analyze_region"),
    "managed": ("DecisionRecord", "MDMPConfig", "all_gather_matmul",
                "clear_decision_log", "decision_log", "get_config",
                "managed_all_gather", "managed_all_reduce",
                "managed_all_to_all", "managed_psum_scatter_gather",
                "managed_reduce_scatter", "matmul_reduce_scatter",
                "resolve_halo_aggregation", "resolve_pipeline_schedule",
                "use_config"),
    "overlap": ("bucketed_all_reduce", "fsdp_gather", "fsdp_gather_tree",
                "grad_accumulate", "reduce_replicated_grads"),
    "region": ("CommRegion", "CommSpec", "Plan", "PlanEntry"),
    "tuner": ("ScheduleTuner", "TunerEntry", "call_site_key"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [
    "AccessRecord", "CommRegion", "CommSpec", "DEFAULT_HW", "DecisionRecord",
    "HardwareModel", "HECTOR_XE6", "HELIOS_BULLX", "JUQUEEN_BGQ",
    "MDMPConfig", "Plan", "PlanEntry", "RegionReport", "RooflineTerms",
    "ScheduleTuner", "TPU_V5E", "TunerEntry", "all_gather_matmul",
    "analyze_region", "bucketed_all_reduce", "call_site_key",
    "clear_decision_log", "crossover_compute_per_element", "decide",
    "decide_halo_aggregation", "decision_log", "fsdp_gather",
    "fsdp_gather_tree", "get_config", "grad_accumulate",
    "HaloAggregationDecision", "halo_exchange", "halo_sweep_time",
    "decide_pipeline_schedule", "jacobi_solve", "jacobi_step_aggregated",
    "jacobi_step_bulk", "jacobi_step_overlapped", "managed_all_gather",
    "managed_all_reduce", "managed_all_to_all",
    "managed_psum_scatter_gather", "managed_reduce_scatter",
    "matmul_reduce_scatter", "PipelineScheduleDecision",
    "reduce_replicated_grads", "resolve_halo_aggregation",
    "resolve_pipeline_schedule", "roofline", "use_config",
]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
