"""The port's training path held against the reference's, on the CPU.

Reduced dense configs (phi4-mini's GQA, granite's MQA with a 2-matrix
GELU MLP, starcoder2's GQA) in f32 on a (1, 1) mesh, the reference's
``Model.init`` weights carried across with ``bridge.params_from_numpy``,
batches from the same ``SyntheticLMData``:

  * ``loss_sp`` and every parameter's gradient against ``jax.grad`` of the
    reference's ``loss_sp`` inside ``smap``;
  * 5 steps of ``build_train_step``: the loss trajectory, the final
    parameters and the AdamW moments against the reference's train step
    (mirrors tests/test_system.py::test_loss_decreases);
  * the AdamW update alone, in the pieces the port updates in place;
  * ``TrainLoop`` restarts from its checkpoint after an injected failure
    and ends where an uninterrupted run ends (mirrors
    tests/test_system.py::test_train_loop_fault_recovery), and a port
    checkpoint restores into the port unchanged.

The port side runs with the default dispatch (the dense attention below
DENSE_MAX_SEQ**2 logits, as the reference on the CPU) and with
``attn_engine="torch"`` (the plain flash forward and backward that the
CUDA kernels are held to).  Tolerances, in f32: the loss within 1e-5 and
gradients within 1e-4 (relative or absolute); after 5 AdamW steps,
losses within 1e-5 and parameters and moments within 1e-4 (the update
divides by sqrt(nu), which carries last-digit differences of small
gradients into the parameters).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models.model import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap, spec_pspecs
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim import adamw
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["phi4-mini-3.8b", "granite-34b", "starcoder2-7b"]
ENGINES = ["auto", "torch"]
SEQ, BATCH = 64, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """(arch, reference model, mesh, numpy weights) in f32."""
    arch = request.param
    cfg = dataclasses.replace(ref_configs.get_reduced(arch), dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    return arch, model, mesh, params


def _port(arch, params, engine):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    return bridge.params_from_numpy(
        params, Model(cfg, device="cpu", attn_engine=engine))


def _batch(cfg, step=0):
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SEQ, global_batch=BATCH))
    return data.global_batch_at(step)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def ref_loss_and_grads(ref):
    arch, model, mesh, params = ref
    pspecs = spec_pspecs(model.param_specs())
    bspec = {"tokens": P("data", None), "labels": P("data", None)}

    def body(p, b):
        (loss, _), g = jax.value_and_grad(model.loss_sp, has_aux=True)(p, b)
        return loss, g

    fn = jax.jit(smap(body, mesh, in_specs=(pspecs, bspec),
                      out_specs=(P(), pspecs)))
    loss, grads = fn(params, _batch(model.cfg))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("engine", ENGINES)
def test_loss_and_gradients_match_reference(ref, ref_loss_and_grads,
                                            engine):
    arch, model, _, params = ref
    want_loss, want_grads = ref_loss_and_grads
    port = _port(arch, params, engine)
    loss, _ = port.loss_sp(_torch_batch(_batch(model.cfg)))
    names = list(flatten_specs(port.params()))
    leaves = list(flatten_specs(port.params()).values())
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), want_loss, 1e-5, "loss")
    want = flatten_specs(want_grads)
    for name, g in zip(names, grads):
        _close(g.numpy(), want[name], 1e-4, name)


@pytest.fixture(scope="module")
def ref_trajectory(ref):
    """Losses, final parameters and moments of 5 reference train steps."""
    arch, model, mesh, params = ref
    opt_cfg = ref_adamw.AdamWConfig(**OPT)
    step_fn, pshard, bshard = ref_build_train_step(model, opt_cfg, mesh)
    p = jax.tree.map(jax.device_put, params, pshard)
    opt = ref_adamw.adamw_init(p, opt_cfg)
    data = RefData(RefDataConfig(vocab_size=model.cfg.vocab_size,
                                 seq_len=SEQ, global_batch=BATCH))
    losses = []
    for step in range(5):
        batch = {k: jax.device_put(v, bshard[k])
                 for k, v in data.global_batch_at(step).items()}
        p, opt, m = step_fn(p, opt, batch)
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, opt)


@pytest.mark.parametrize("engine", ENGINES)
def test_five_train_steps_match_reference(ref, ref_trajectory, engine):
    arch, model, _, params = ref
    want_losses, want_params, want_opt = ref_trajectory
    port = _port(arch, params, engine)
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = build_train_step(port, opt_cfg)
    opt = adamw.adamw_init(port.params(), opt_cfg)
    losses = []
    for i in range(5):
        opt, m = step(opt, _torch_batch(_batch(model.cfg, i)))
        losses.append(float(m["loss"]))
    _close(np.array(losses), np.array(want_losses), 1e-5, "losses")
    assert losses[-1] < losses[0]
    got_params = flatten_specs(bridge.params_to_numpy(port))
    for name, want in flatten_specs(want_params).items():
        _close(got_params[name], want, 1e-4, name)
    got_opt = bridge.adamw_state_to_numpy(opt)
    assert int(got_opt["step"]) == int(want_opt["step"]) == 5
    for which in ("mu", "nu"):
        got = flatten_specs(got_opt[which])
        for name, want in flatten_specs(want_opt[which]).items():
            _close(got[name], want, 1e-4, f"{which}/{name}")


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_in_pieces_matches_reference(monkeypatch, clip):
    """The in-place update cut into pieces of 7 elements' rows (stacked
    leaves a slice at a time) equals the reference's whole-tree update."""
    rng = np.random.default_rng(3)
    shapes = {"embed": (11, 6), "final_ln": (6,),
              "layers": {"w": (3, 4, 5), "ln": (3, 6)}}

    def tree(scale):
        return jax.tree.map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    params, grads = tree(1.0), tree(0.3)
    mu, nu = tree(0.1), jax.tree.map(np.abs, tree(0.01))
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    state = {"mu": mu, "nu": nu, "step": np.int32(3)}
    want_p, want_s, want_m = ref_adamw.adamw_update(
        params, grads, state, ref_adamw.AdamWConfig(**cfg_kw))

    monkeypatch.setattr(adamw, "_PIECE", 7)
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)
    got_p = to_t(jax.tree.map(np.copy, params))
    got_s = {"mu": to_t(jax.tree.map(np.copy, mu)),
             "nu": to_t(jax.tree.map(np.copy, nu)),
             "step": torch.tensor(3, dtype=torch.int32)}
    _, got_s, got_m = adamw.adamw_update(got_p, to_t(grads), got_s,
                                         adamw.AdamWConfig(**cfg_kw))
    _close(float(got_m["grad_norm"]), float(want_m["grad_norm"]), 1e-6,
           "grad_norm")
    _close(float(got_m["lr"]), float(want_m["lr"]), 1e-7, "lr")
    assert int(got_s["step"]) == 4
    for got, want in ((got_p, want_p), (got_s["mu"], want_s["mu"]),
                      (got_s["nu"], want_s["nu"])):
        for name, w in flatten_specs(jax.tree.map(np.asarray, want)).items():
            _close(flatten_specs(got)[name].numpy(), w, 1e-6, name)


def test_bf16_loss_keeps_the_f32_accumulator():
    """In a bf16 model the loss's logits are the f32 accumulator of the
    bf16 operands (the reference's ``preferred_element_type=f32``), not
    the bf16 product cast to f32, whose rounding (about 2^-9 of each
    logit, 0.02 at these magnitudes) the tolerances below reject.  The
    loss within 1e-5 (relative), each logit within 1e-4, the gradients
    within 2e-2 of their largest magnitude (bf16 backward products)."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import MeshCtx

    cfg = ref_configs.get_reduced("phi4-mini-3.8b")
    b, s, d, v = 2, 64, 64, 384
    rng = np.random.default_rng(5)
    bf16 = lambda a: np.asarray(jax.numpy.asarray(a, jax.numpy.bfloat16))
    x = bf16(rng.normal(size=(b, s, d)))
    w = bf16(rng.normal(size=(d, v)) * 3.0 / np.sqrt(d))
    tokens = rng.integers(0, v, size=(b, s)).astype(np.int32)
    tokens[:, -3:] = -1                                  # ignored labels
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")

    def ref_loss(xx, ww, tt):
        return ref_layers.lm_loss_sp(xx, ww, tt, cfg, ctx, chunk=16)[0]

    fn = jax.jit(smap(jax.value_and_grad(ref_loss, argnums=(0, 1)), mesh,
                      in_specs=(P(), P(), P()), out_specs=(P(), (P(), P()))))
    want_loss, (want_dx, want_dw) = fn(x, w, tokens)
    want_logits = jax.numpy.dot(x, w, preferred_element_type=np.float32)

    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    tx.requires_grad_()
    tw.requires_grad_()
    loss, count = layers.lm_loss_sp(tx, tw, torch.from_numpy(tokens), cfg,
                                    MeshCtx(), chunk=16)
    assert loss.dtype == torch.float32 and count.item() == b * (s - 3)
    _close(loss.item(), float(want_loss), 1e-5, "loss")
    got_logits = layers.logits_f32(tx, tw)
    assert got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), rtol=0, atol=1e-4)
    dx, dw = torch.autograd.grad(loss, (tx, tw))
    for got, want, name in ((dx, want_dx, "dx"), (dw, want_dw, "dw")):
        assert got.dtype == torch.bfloat16, name
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max(),
                                   err_msg=name)


def _loop(tmp_path, name, fault_hook=None, total=12):
    cfg = configs.get_reduced("granite-34b")
    model = Model(cfg, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=200)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                      global_batch=BATCH))
    loop = TrainLoop(build_train_step(model, opt_cfg), model, opt_cfg, data,
                     TrainLoopConfig(total_steps=total, ckpt_every=4,
                                     ckpt_dir=str(tmp_path / name),
                                     max_retries=3),
                     fault_hook=fault_hook)
    opt, s0 = loop.init_state()
    return loop.run(opt, s0)


def test_train_loop_recovers_from_a_failed_step(tmp_path):
    boom = {"armed": True}

    def fault(step):
        if step == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = _loop(tmp_path, "faulted", fault)
    assert out["step"] == 12
    assert out["restarts"] == 1
    assert out["steps_executed"] == 14          # steps 4 and 5 run twice
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ckpt.valid_steps(str(tmp_path / "faulted")) == [4, 8, 12]
    clean = _loop(tmp_path, "clean")
    for name, p in flatten_specs(out["params"]).items():
        assert torch.equal(p, flatten_specs(clean["params"])[name]), name
    assert [h["loss"] for h in out["history"][-6:]] == \
        [h["loss"] for h in clean["history"][-6:]]


def test_train_loop_gives_up_after_max_retries(tmp_path):
    def always(step):
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="dead node"):
        _loop(tmp_path, "dead", always)


def test_checkpoint_round_trip_is_exact(tmp_path):
    """bf16 parameters (widened to f32 in the npz), f32 moments and the
    step counter restore bit for bit; a corrupt newest checkpoint is
    skipped and quarantined."""
    cfg = configs.get_reduced("phi4-mini-3.8b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    opt = adamw.adamw_init(model.params(), adamw.AdamWConfig())
    opt["step"].fill_(7)
    for leaf in flatten_specs(opt["mu"]).values():
        leaf.normal_()
    tree = {"params": model.params(), "opt": opt}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree, extra={"step": 3})
    ckpt.save(d, 5, tree, extra={"step": 5})
    with open(tmp_path / "ck" / "step_00000005" / "arrays.npz", "wb") as f:
        f.write(b"truncated")
    fresh = Model(cfg, device="cpu")
    like = {"params": fresh.params(),
            "opt": adamw.adamw_init(fresh.params(), adamw.AdamWConfig())}
    got, extra, step = ckpt.restore_latest(d, like)
    assert (step, extra) == (3, {"step": 3})
    assert ckpt.valid_steps(d) == [3]
    want = flatten_specs(tree)
    for name, t in flatten_specs(got).items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name].detach()), name


def test_train_cli_runs_on_cpu_and_refuses_later_slices(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--reduced", "--arch", "phi4-mini-3.8b", "--ckpt",
            str(tmp_path / "ck")]
    # no flag is left to a later slice: --trace, --plan and --verify run
    out = subprocess.run(
        base + ["--steps", "5", "--trace", str(tmp_path / "t.json"),
                "--plan", "program", "--verify", "strict"],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "done at step 5, final loss" in out.stdout
    assert "decision program_plan(" in out.stdout
    assert (tmp_path / "t.json").exists()


def test_train_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "1"])


def test_later_slices_raise_and_name_their_slice():
    """The pipeline, the fault plan, the tuner and the managed cadence
    are ported; what they lack raises and names what brings it: the
    pipeline needs a pod axis.  The tuner's program plans, once left to
    the planner's slice, now store and read back."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.tuner import ScheduleTuner

    cfg = configs.get_reduced("phi4-mini-3.8b")
    model = Model(cfg, device="cpu")
    opt_cfg = adamw.AdamWConfig()
    with pytest.raises(ValueError, match="pod"):
        build_train_step(model, opt_cfg, pipeline="gpipe")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                      global_batch=2))
    loop = TrainLoop(build_train_step(model, opt_cfg), model, opt_cfg, data,
                     TrainLoopConfig(managed_cadence=True),
                     fault_plan=FaultPlan.parse("transient@1"),
                     tuner=ScheduleTuner())
    assert loop.fault_hook is not None and loop.tuner is not None
    from repro_torch.plan import plan_program, lower_train_ops
    plan = plan_program(lower_train_ops(mesh_axes={"data": 2, "model": 1},
                                        grad_bytes=1 << 20), log=False)
    loop.tuner.store_program_plan(plan)
    assert loop.tuner.get_program_plan(plan.signature,
                                       plan.topology).knobs == plan.knobs
