"""Training CLI — the fault-tolerant train loop (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --reduced --device cpu --steps 5

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is there.  Weights are random, drawn from ``--seed`` (over a mesh each
rank draws its shards); the batches come from the synthetic, resumable
data pipeline.  ``--mesh DxM`` (or ``PxDxM``) above 1x1 runs one process
per rank under torchrun, e.g.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-34b --reduced --device cpu --mesh 2x2

(gloo on the CPU or where ranks share a card, NCCL with a card per
rank; launch/mesh.py).  ``--pipeline gpipe|1f1b|interleaved|auto`` runs
the pod axis of a ``PxDxM`` mesh as pipeline stages (``auto``: the
managed cost model picks the schedule and ``--microbatches`` M) and
prints the ``pipeline_schedule`` decision; ``--compress-pod`` sums the
pod axis's gradients as int8 with error feedback.  ``--fault-plan``
injects the deterministic faults of core/faults.py, ``--ckpt-every
auto`` lets the managed Young/Daly cadence (with ``--mtbf``) pick the
checkpoint interval; both print their decisions and the unfired events.
``--moe-dispatch`` pins the MoE dispatch schedule of an MoE arch
(``auto`` lets the managed cost model pick) and prints the decisions.
``--plan program|auto`` runs the whole-program planner (plan/) over the
step's communication set, prints the ``program_plan`` decision and its
trail and installs the plan; ``--verify warn|strict`` (default ``warn``)
runs the static verifier (analysis/) over the same set under the knobs
the launch will run, and ``strict`` exits 1 on an error; ``--trace PATH``
records the run's spans and decisions to a Chrome-trace JSON with the
calibration ledger (``python -m repro_torch.launch.trace PATH``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch import configs, obs
from repro_torch.core import managed
from repro_torch.core.faults import FaultPlan
from repro_torch.core.tuner import ScheduleTuner
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.launch import mesh as launch_mesh
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)


def main(argv: list[str] | None = None) -> dict:
    """Run the launch; returns ``TrainLoop.run``'s result (the losses are
    in its ``history``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mdmp-mode", default="auto",
                    choices=["auto", "bulk", "interleaved"])
    ap.add_argument("--pipeline", default="none",
                    choices=["none", "gpipe", "1f1b", "interleaved",
                             "auto"],
                    help="run the pod axis as pipeline stages (auto = "
                         "managed schedule decision)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="pipeline microbatch count M (default: the "
                         "cost model's pick)")
    ap.add_argument("--plan", default="local",
                    choices=["local", "program", "auto"],
                    help="communication planning scope: 'local' keeps "
                         "per-subsystem resolution; 'program'/'auto' run "
                         "the whole-program planner (repro_torch.plan) "
                         "over the step's comm set and install the "
                         "coordinated ProgramPlan before the step is built")
    ap.add_argument("--verify", default="warn",
                    choices=["off", "warn", "strict"],
                    help="static-verifier preflight (repro_torch.analysis):"
                         " 'warn' prints findings and logs a "
                         "DecisionRecord(op=\"lint\"); 'strict' exits "
                         "non-zero on any error with the declared/"
                         "traced side-by-side")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; above 1x1 under torchrun with a "
                         "matching WORLD_SIZE")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: under the "
                         "system's temporary directory)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", default=None,
                    help="checkpoint interval in steps, or 'auto' for "
                         "the managed Young/Daly cadence (re-resolved "
                         "online from measured step time + write bw)")
    ap.add_argument("--mtbf", type=float, default=1800.0,
                    help="assumed mean time between failures, seconds "
                         "(feeds the Young/Daly cadence)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["bulk", "stream", "dense", "auto"],
                    help="MoE expert-dispatch schedule (auto = managed "
                         "cost-model decision)")
    ap.add_argument("--compress-pod", action="store_true",
                    help="int8 error-feedback sum over the pod axis")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault injection spec, e.g. "
                         "'transient@6;slow@9:0.5;corrupt@14' "
                         "(core/faults.py grammar)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record every hot path to a Chrome-trace JSON "
                         "(open in ui.perfetto.dev), print the "
                         "predicted-vs-measured calibration report, and "
                         "embed the calibration ledger in the file")
    args = ap.parse_args(argv)

    if args.trace:
        # install before anything resolves so planner/lint/step spans
        # and decision timestamps all land on one ring
        obs.install_tracer(obs.Tracer())
    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if args.moe_dispatch is not None:
        if cfg.moe is None:
            ap.error(f"--moe-dispatch set but {args.arch} has no MoE "
                     "layers")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=args.moe_dispatch))
    _, axes = launch_mesh.parse_mesh(args.mesh)
    if args.pipeline != "none" and "pod" not in axes:
        ap.error("--pipeline needs a pod axis: pass a 3-axis --mesh like "
                 "2x1x1 (pod x data x model)")
    ctx = launch_mesh.mesh_ctx(args.mesh, device, args.mdmp_mode)
    say = print if launch_mesh.is_main() else (lambda *a, **k: None)
    model = Model(cfg, ctx, device=device)
    say(f"arch={args.arch} params={cfg.param_count() / 1e6:.1f}M "
        f"mesh={tuple(ctx.axis_sizes.values())} device={device} "
        f"mdmp={args.mdmp_mode} pipeline={args.pipeline}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps,
                          moment_dtype=cfg.moment_dtype)
    managed.clear_decision_log()
    tuner = ScheduleTuner()
    prog = None
    if args.plan != "local" or args.verify != "off":
        # Lower this step's communication set to comm-IR ops once — the
        # whole-program planner (--plan) and the static-verifier preflight
        # (--verify) both consume it, so the linted program is exactly the
        # planned one.
        from repro_torch.plan import (lower_train_ops, plan_program,
                                      train_geometry)
        hw = managed.get_config().hw
        geo = train_geometry(cfg, mesh_axes=dict(ctx.axis_sizes),
                             batch=args.batch, seq=args.seq, hw=hw,
                             pipeline=args.pipeline)
        ops = lower_train_ops(
            mesh_axes=geo["mesh_axes"], grad_bytes=geo["grad_bytes"],
            pipeline=geo["pipeline"], attention=geo["attention"],
            moe=geo["moe"])
        prog = plan_program(ops, hw=hw, notes=[f"launch.train {args.arch}"])
    if args.plan != "local":
        # Whole-program pass: price the JOINT schedule and install the
        # plan so every resolve_* call below prefers the coordinated knob.
        kind = "coordinated" if prog.coordinated else "local"
        say(f"decision program_plan({kind} ops={len(prog.choices)} "
            f"topo={prog.topology} "
            f"local-concat={prog.local_solo_sum_s * 1e6:.1f}us "
            f"joint={prog.joint_cost_s * 1e6:.1f}us)")
        for line in prog.summary().splitlines()[1:]:
            say(f"  trail{line}")
        tuner.store_program_plan(prog)
        managed.install_plan(prog)
    if args.verify != "off":
        # Static-verifier preflight: drift/permute/deadlock/race/
        # feasibility passes over the lowered comm set under the knobs
        # this launch will actually run (forced flags override the plan's
        # picks, so strict mode catches the clamp BEFORE the executor
        # silently degrades it).
        from repro_torch import analysis
        key = "pipeline_schedule|pod"
        if args.microbatches is not None:
            knob = dict(prog.knobs.get(key)
                        or {"mode": args.pipeline, "virtual": 2})
            knob["chunks"] = args.microbatches
            if args.pipeline not in ("none", "auto"):
                knob["mode"] = args.pipeline
            prog.knobs[key] = knob
        elif args.pipeline not in ("none", "auto") and key in prog.knobs:
            prog.knobs[key] = dict(prog.knobs[key], mode=args.pipeline)
        graph = analysis.from_ops(
            f"train:{args.arch}", axis_sizes=dict(ctx.axis_sizes),
            declared=ops, plan=prog, hw=hw)
        analysis.preflight(graph, args.verify, out=say)
    step_fn = build_train_step(
        model, opt_cfg, compress_pod=args.compress_pod,
        pipeline=args.pipeline, pipe_microbatches=args.microbatches,
        global_batch=args.batch, seq_len=args.seq)
    say(f"train step: {step_fn.step_mode}")
    for rec in managed.decision_log():
        if rec.op == "pipeline_schedule":
            say(f"decision pipeline_schedule({rec.mode} M={rec.chunks} "
                f"axis={rec.axis} handoff={rec.nbytes / 1e3:.1f}kB "
                f"bulk={rec.predicted_bulk_s * 1e3:.2f}ms "
                f"chosen={rec.predicted_interleaved_s * 1e3:.2f}ms)")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    managed_cadence = args.ckpt_every == "auto"
    ckpt_every = (max(5, args.steps // 4)
                  if args.ckpt_every in (None, "auto")
                  else int(args.ckpt_every))
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=ckpt_every,
                               managed_cadence=managed_cadence,
                               mtbf_s=args.mtbf)
    if args.ckpt is not None:
        loop_cfg.ckpt_dir = args.ckpt
    if launch_mesh.dist.is_initialized():
        # every rank checkpoints its own shards
        loop_cfg.ckpt_dir = os.path.join(
            loop_cfg.ckpt_dir, f"rank{launch_mesh.dist.get_rank()}")
    fault_plan = (FaultPlan.parse(args.fault_plan) if args.fault_plan
                  else None)
    loop = TrainLoop(step_fn, model, opt_cfg, data, loop_cfg,
                     tuner=tuner, fault_plan=fault_plan)
    opt, s0 = (loop.resume_or_init(args.seed) if args.resume
               else loop.init_state(args.seed))
    out = loop.run(opt, s0)
    for rec in managed.decision_log():
        if rec.op == "ckpt_interval":
            say(f"decision ckpt_interval({rec.mode} N={rec.chunks} "
                f"axis={rec.axis} snap={rec.nbytes / 1e6:.1f}MB "
                f"fixed_ovh={rec.predicted_bulk_s:.4f} "
                f"chosen_ovh={rec.predicted_interleaved_s:.4f})")
    for d in loop.ckpt_decisions[-1:]:
        say(f"  cadence from step {d.step_s * 1e3:.2f} ms, write bandwidth "
            f"{d.write_bw / 1e9:.3f} GB/s, checkpoint cost "
            f"{d.ckpt_cost_s * 1e3:.2f} ms, mtbf {d.mtbf_s:.0f} s")
    for r in out["replayed"]:
        say(f"replan {r['op']}: {r['mode']}:{r['chunks']} "
            f"{r['axis']}{r['old_n']} -> {r['axis']}{r['new_n']}")
    if fault_plan is not None:
        left = fault_plan.unfired()
        say(f"faults injected={len(fault_plan.events) - len(left)} "
            f"unfired={len(left)} restarts={out['restarts']} "
            f"steps_executed={out['steps_executed']}")
    if args.moe_dispatch is not None:
        seen = set()
        for rec in managed.decision_log():
            key = (rec.op, rec.mode, rec.chunks, rec.nbytes)
            if rec.op == "moe_dispatch" and key not in seen:
                seen.add(key)
                say(f"decision moe_dispatch({rec.mode} g={rec.chunks} "
                      f"axis={rec.axis} a2a={rec.nbytes / 1e3:.1f}kB "
                      f"bulk={rec.predicted_bulk_s * 1e3:.3f}ms "
                      f"chosen={rec.predicted_interleaved_s * 1e3:.3f}ms)")
    for h in out["history"][:: max(1, len(out["history"]) // 10)]:
        say(f"  step {h['step']:4d} loss {h['loss']:.4f} "
              f"{h['time_s']:.2f}s")
    say(f"done at step {out['step']}, final loss "
          f"{out['history'][-1]['loss']:.4f}")
    if args.trace:
        tr = obs.get_tracer()
        decisions = managed.decision_log()
        # decisions made inside the step (attention/MoE/pipeline modes)
        # have no host-side span of their own — the train.step span
        # covers the work they chose
        obs.cover_with(tr.spans(), "train.step", (r.op for r in decisions))
        led = obs.CalibrationLedger()
        led.correlate(tr.spans(), decisions)
        say(led.report())
        if launch_mesh.is_main():
            obs.write_chrome_trace(
                args.trace, tr, decisions,
                other_data={"run": f"train:{args.arch}",
                            "calibration": led.snapshot()})
        say(f"trace: {args.trace} ({tr.n_spans} spans, "
            f"{len(decisions)} decisions, "
            f"coverage {led.coverage() * 100:.0f}%)")
    return out


if __name__ == "__main__":
    main()
