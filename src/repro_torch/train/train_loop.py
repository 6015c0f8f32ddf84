"""Fault-tolerant training loop + the train step builder (port of
``repro.train.train_loop``).

The train step is per-rank code over the mesh (one process per rank):
every collective in the forward, the backward and the gradient sync is a
managed op.  Gradient flow:

  * FSDP-sharded params: the fsdp_gather's gradient reduce-scatters each
    layer's gradient in that layer's backward — MDMP's as-ready "send on
    last write" (core/overlap.py);
  * replicated params (and the pod axis): explicit all-reduces over
    exactly the mesh axes absent from each param's spec (``sync_grads``).

The step differentiates ``Model.loss_sp`` with autograd — the
flash-attention backward is the CUDA kernel on a card — then takes one
AdamW step that updates the model's parameters IN PLACE (the reference
donates its buffers and returns new ones).

Fault tolerance: periodic async checkpoints, restore-and-retry on a
failed step (``fault_hook`` injects failures in tests), straggler
detection from the step-time EWMA.  The deterministic fault plan, the
schedule tuner and the managed (Young/Daly) checkpoint cadence come with
ROADMAP Queue 1 slice 10.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.core import managed
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.model import (Model, flatten_specs,
                                      unflatten_specs)
from repro_torch.obs.calibrate import Recalibrator
from repro_torch.obs.tracer import get_tracer
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel.sharding import LOGICAL_RULES, MeshCtx, ParamSpec


def _later(what: str, slice_: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with ROADMAP Queue 1 slice {slice_}")


# ---------------------------------------------------------------------------
# Gradient post-processing: reduce over the axes a param is NOT sharded on
# ---------------------------------------------------------------------------


def _missing_axes(spec: ParamSpec, all_axes: tuple[str, ...]
                  ) -> tuple[str, ...]:
    present = {LOGICAL_RULES[l] for l in spec.logical}
    return tuple(ax for ax in all_axes if ax not in present)


def sync_grads(grads: Any, spec_tree: Any, ctx: MeshCtx) -> Any:
    """Sum each grad over the mesh axes absent from its spec: the
    FSDP/TP-sharded dims were already reduced by the collectives'
    gradients."""
    specs = flatten_specs(spec_tree)
    out = {}
    for name, g in flatten_specs(grads).items():
        for ax in _missing_axes(specs[name], ctx.all_axes):
            g = managed.managed_all_reduce(g, ax, ctx)
        out[name] = g
    return unflatten_specs(out)


def _replication_factor(spec: ParamSpec, ctx: MeshCtx) -> int:
    n = 1
    for ax in _missing_axes(spec, ctx.all_axes):
        n *= ctx.axis_sizes[ax]
    return n


# ---------------------------------------------------------------------------
# Train step builder
# ---------------------------------------------------------------------------


def build_train_step(model: Model, opt_cfg: AdamWConfig, *,
                     pipeline: str = "none"
                     ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """Returns ``step(opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` holds the GLOBAL tokens and labels [B, S] on the model's
    device; each rank takes its rows (``ctx.shard_batch``).  The step
    updates this rank's parameter shards and ``opt_state`` in place;
    metrics are 0-d tensors (loss, grad_norm, lr), the same on every
    rank, read without a host sync.  ``cfg.accum_steps`` > 1 splits the
    local batch into that many microbatches along B and averages their
    gradients, as the reference."""
    cfg, ctx = model.cfg, model.ctx
    if pipeline != "none":
        raise _later(f"pipeline={pipeline!r}", 9)
    accum = max(1, cfg.accum_steps)
    names = list(flatten_specs(model.params()))
    spec_tree = model.param_specs()
    rep = [_replication_factor(sp, ctx)
           for sp in flatten_specs(spec_tree).values()]
    n_devices = 1
    for n in ctx.axis_sizes.values():
        n_devices *= n

    def grads_of(batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
        leaves = list(flatten_specs(model.params()).values())
        loss, _ = model.loss_sp(batch)
        # the summed loss is replicated on every rank, and the gradient of
        # each all-reduce is an all-reduce: the raw gradient is n_devices
        # times too large, so differentiate loss / n_devices (as the
        # reference)
        return loss.detach(), list(torch.autograd.grad(loss / n_devices,
                                                       leaves))

    def step(opt_state: dict, batch: dict) -> tuple[dict, dict]:
        batch = ctx.shard_batch(batch)
        if accum > 1:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} over {accum} microbatches")
            mb = b // accum
            loss, grads = grads_of({k: v[:mb] for k, v in batch.items()})
            for i in range(1, accum):
                l, g = grads_of({k: v[i * mb:(i + 1) * mb]
                                 for k, v in batch.items()})
                loss = loss + l
                grads = [a + c for a, c in zip(grads, g)]
            loss = loss / accum
            grads = [g / accum for g in grads]
        else:
            loss, grads = grads_of(batch)
        grad_tree = unflatten_specs(dict(zip(names, grads)))
        grad_tree = sync_grads(grad_tree, spec_tree, ctx)
        # the replication-aware global norm
        ssq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g, r in zip(flatten_specs(grad_tree).values(), rep):
            ssq = ssq + torch.sum(torch.square(g.float())) / r
        for ax in ctx.all_axes:
            ssq = managed.managed_all_reduce(ssq, ax, ctx)
        gnorm = torch.sqrt(ssq)
        del grads
        _, opt_state, metrics = adamw_update(model.params(), grad_tree,
                                             opt_state, opt_cfg, gnorm=gnorm)
        metrics["loss"] = loss
        return opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# Fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0       # step > factor * EWMA -> straggler
    ewma: float = 0.9
    managed_cadence: bool = False       # Young/Daly-chosen ckpt interval


class TrainLoop:
    """Drives (step fn, data, checkpoints) with restart-on-failure.

    ``fault_hook(step)`` (tests) may raise to simulate a node failure; the
    loop restores the latest readable checkpoint into the model and the
    optimizer state and retries.  Step times feed a straggler detector.
    The checkpoint's on-device snapshot doubles the state's device
    memory (checkpoint/ckpt.py)."""

    def __init__(self, step_fn: Callable, model: Model,
                 opt_cfg: AdamWConfig, data: SyntheticLMData,
                 loop_cfg: TrainLoopConfig,
                 fault_hook: Callable[[int], None] | None = None, *,
                 tuner: Any = None, fault_plan: Any = None):
        if fault_plan is not None:
            raise _later("the deterministic fault plan in TrainLoop", 10)
        if tuner is not None:
            raise _later("the schedule tuner in TrainLoop", 10)
        if loop_cfg.managed_cadence:
            raise _later("the managed checkpoint cadence", 10)
        self.step_fn = step_fn
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = data
        self.cfg = loop_cfg
        self.fault_hook = fault_hook
        self.ckpt_metrics = ckpt_lib.CheckpointMetrics()
        self.mgr = ckpt_lib.CheckpointManager(loop_cfg.ckpt_dir,
                                              keep=loop_cfg.keep,
                                              metrics=self.ckpt_metrics)
        self.ckpt_interval = max(1, loop_cfg.ckpt_every)
        self.recal = Recalibrator(threshold=0.25, warmup=1,
                                  alpha=loop_cfg.ewma)
        self.stragglers: list[int] = []
        self.restarts = 0
        self.history: list[dict] = []

    # -- state management ----------------------------------------------------

    def init_state(self, seed: int = 0) -> tuple[dict, int]:
        """Fresh weights from ``seed`` and a zero optimizer state:
        (opt_state, 0)."""
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        self.model.init(gen)
        return adamw_init(self.model.params(), self.opt_cfg), 0

    @torch.no_grad()
    def resume_or_init(self, seed: int = 0) -> tuple[dict, int]:
        """The newest readable checkpoint restored into the model, or a
        fresh state: (opt_state, step)."""
        opt, _ = self.init_state(seed)
        params = self.model.params()
        t0 = time.monotonic()
        hit = ckpt_lib.restore_latest(self.cfg.ckpt_dir,
                                      {"params": params, "opt": opt})
        if hit is None:
            return opt, 0
        tree, extra, ck_step = hit
        self.ckpt_metrics.note_restore(ck_step, time.monotonic() - t0)
        live = flatten_specs(params)
        for name, arr in flatten_specs(tree["params"]).items():
            live[name].copy_(arr)
        step = int(extra.get("step", ck_step))
        if "data" in extra:
            # the data pipeline resumes WITH the model
            self.data, _ = SyntheticLMData.resume(self.data.cfg,
                                                  extra["data"])
        return tree["opt"], step

    def _mesh_dict(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.model.ctx.axis_sizes.items()}

    def _batch(self, step: int) -> dict:
        g = self.data.global_batch_at(step)
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in g.items()}

    def _save(self, step: int, opt: dict) -> None:
        extra = {"step": step, "data": self.data.state_dict(step),
                 "mesh": self._mesh_dict()}
        self.mgr.save_async(step, {"params": self.model.params(),
                                   "opt": opt}, extra=extra)

    # -- the loop ------------------------------------------------------------

    def run(self, opt: dict, start_step: int = 0) -> dict:
        cfg = self.cfg
        tr = get_tracer()
        step = start_step
        retries = 0
        warmup_until = start_step + 2
        last_saved = start_step
        steps_executed = 0
        wall_t0 = time.monotonic()
        snapshot_bytes = sum(
            t.numel() * t.element_size() for t in
            flatten_specs({"params": self.model.params(),
                           "opt": opt}).values())
        while step < cfg.total_steps:
            batch = self._batch(step)
            t0 = time.monotonic()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                with tr.span("train.step", track="compute", step=step):
                    opt, metrics = self.step_fn(opt, batch)
                    # float() waits for the device — the span measures
                    # the realized step, not the launch
                    loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except Exception:               # noqa: BLE001 — restart path
                retries += 1
                self.restarts += 1
                if retries > cfg.max_retries:
                    raise
                self.mgr.wait()
                opt, step = self.resume_or_init()
                last_saved = step
                # the first post-restore steps re-warm: judging them
                # against the pre-fault EWMA flags every recovery
                warmup_until = step + 2
                continue
            retries = 0
            steps_executed += 1
            dt = time.monotonic() - t0
            in_warmup = step < warmup_until
            ewma_t = self.recal.value
            if (not in_warmup and ewma_t is not None
                    and dt > cfg.straggler_factor * ewma_t):
                self.stragglers.append(step)
            if not in_warmup:
                self.recal.note(dt)
            self.history.append({"step": step, "loss": loss,
                                 "time_s": dt})
            step += 1
            if step - last_saved >= self.ckpt_interval \
                    or step == cfg.total_steps:
                with tr.span("ckpt.save", op="ckpt_interval", axis="mesh",
                             track="ckpt", nbytes=snapshot_bytes,
                             scale=self.ckpt_interval
                             * max(self.recal.value or dt, 1e-9)):
                    self._save(step, opt)
                last_saved = step
        self.mgr.wait()
        return {"params": self.model.params(), "opt": opt, "step": step,
                "history": self.history, "stragglers": self.stragglers,
                "restarts": self.restarts,
                "steps_executed": steps_executed,
                "wall_s": time.monotonic() - wall_t0,
                "ckpt_interval": self.ckpt_interval, "replayed": []}
