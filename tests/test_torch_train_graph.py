"""The training step object (``TrainStep``) on the CPU.

``build_train_step`` returns a ``TrainStep``: on one card a captured CUDA
graph replayed from its second call, elsewhere the step issued from
Python.  Here, on the CPU:

  * ``step_mode`` is "eager" on the CPU, on meta tensors and for the
    pipelined step;
  * ``run_eager`` through the static buffers (``load``), over 3 steps of
    reduced phi4-mini and moonshot-v1-16b-a3b in f32, against the
    reference's jitted ``build_train_step`` on the same weights
    (``bridge.params_from_numpy``) and batches (``SyntheticLMData``):
    losses within 1e-5, parameters and moments within 1e-4 (relative or
    absolute), as tests/test_torch_train.py holds 5 steps; and the port's
    eager call on the arguments themselves, bit for bit;
  * a state restored through ``TrainLoop.resume_or_init``, a new batch
    shape and ``release`` bind the step again, and the next step leaves
    the old tensors untouched.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          TrainStep, build_train_step)

ARCHS = ["phi4-mini-3.8b", "moonshot-v1-16b-a3b"]
SEQ, BATCH, STEPS = 32, 4, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _cfg(arch):
    return dataclasses.replace(configs.get_reduced(arch), dtype="float32")


def _data(cfg, seq=SEQ):
    return SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq, global_batch=BATCH))


def _torch_batch(data, i):
    return {k: torch.from_numpy(v) for k, v in data.global_batch_at(i).items()}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("where", ["cpu", "meta", "1f1b"])
def test_step_mode_is_eager_off_the_card(where):
    cfg = _cfg("phi4-mini-3.8b")
    if where == "1f1b":
        model = Model(cfg, MeshCtx(axis_sizes={"pod": 1, "data": 1,
                                               "model": 1}), device="cpu")
        step = build_train_step(model, AdamWConfig(**OPT), pipeline="1f1b",
                                pipe_microbatches=1, global_batch=BATCH,
                                seq_len=SEQ)
    else:
        step = build_train_step(Model(cfg, device=where),
                                AdamWConfig(**OPT))
    assert isinstance(step, TrainStep)
    assert step.step_mode == "eager" and step.graph is None


@pytest.mark.parametrize("arch", ARCHS)
def test_run_eager_matches_reference_and_the_eager_call(arch):
    ref_cfg = dataclasses.replace(ref_configs.get_reduced(arch),
                                  dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = RefModel(ref_cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    ref_opt_cfg = ref_adamw.AdamWConfig(**OPT)
    step_fn, pshard, bshard = ref_build_train_step(ref, ref_opt_cfg, mesh)
    p = jax.tree.map(jax.device_put, params, pshard)
    ref_opt = ref_adamw.adamw_init(p, ref_opt_cfg)
    data = _data(_cfg(arch))
    want_losses = []
    for i in range(STEPS):
        batch = {k: jax.device_put(v, bshard[k])
                 for k, v in data.global_batch_at(i).items()}
        p, ref_opt, m = step_fn(p, ref_opt, batch)
        want_losses.append(float(m["loss"]))
    want_params = flatten_specs(jax.tree.map(np.asarray, p))
    want_opt = jax.tree.map(np.asarray, ref_opt)

    runs = {}
    for way in ("run_eager", "call"):
        port = bridge.params_from_numpy(params,
                                        Model(_cfg(arch), device="cpu"))
        opt_cfg = AdamWConfig(**OPT)
        step = build_train_step(port, opt_cfg)
        opt = adamw_init(port.params(), opt_cfg)
        losses, gnorms = [], []
        for i in range(STEPS):
            if way == "run_eager":
                step.load(opt, _torch_batch(data, i))
                m = step.run_eager()
            else:
                opt, m = step(opt, _torch_batch(data, i))
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
        assert step.bindings == (1 if way == "run_eager" else 0)
        runs[way] = (losses, gnorms, port, opt)

    losses, gnorms, port, opt = runs["run_eager"]
    _close(np.array(losses), np.array(want_losses), 1e-5, "losses")
    got_params = flatten_specs(bridge.params_to_numpy(port))
    for name, want in want_params.items():
        _close(got_params[name], want, 1e-4, name)
    got_opt = bridge.adamw_state_to_numpy(opt)
    assert int(got_opt["step"]) == int(want_opt["step"]) == STEPS
    for which in ("mu", "nu"):
        got = flatten_specs(got_opt[which])
        for name, want in flatten_specs(want_opt[which]).items():
            _close(got[name], want, 1e-4, f"{which}/{name}")

    c_losses, c_gnorms, c_port, c_opt = runs["call"]
    assert losses == c_losses and gnorms == c_gnorms
    a = flatten_specs({"p": port.params(), "mu": opt["mu"],
                       "nu": opt["nu"]})
    b = flatten_specs({"p": c_port.params(), "mu": c_opt["mu"],
                       "nu": c_opt["nu"]})
    for name, t in a.items():
        assert torch.equal(t, b[name]), name


def test_restore_and_new_shape_bind_again(tmp_path):
    cfg = _cfg("phi4-mini-3.8b")
    model = Model(cfg, device="cpu")
    opt_cfg = AdamWConfig(**OPT)
    step = build_train_step(model, opt_cfg)
    data = _data(cfg)
    loop = TrainLoop(step, model, opt_cfg, data,
                     TrainLoopConfig(total_steps=4, ckpt_dir=str(tmp_path)))
    opt, _ = loop.init_state(0)
    step.load(opt, _torch_batch(data, 0))
    step.run_eager()
    step.load(opt, _torch_batch(data, 1))          # the same binding
    step.run_eager()
    assert step.bindings == 1
    loop._save(2, opt)
    loop.mgr.wait()

    old = {k: v.clone() for k, v in flatten_specs(opt).items()}
    restored, at = loop.resume_or_init(0)
    assert at == 2
    step.load(restored, _torch_batch(data, 2))
    assert step.bindings == 2 and step.opt_state is restored
    step.run_eager()
    assert int(restored["step"]) == 3
    for name, t in flatten_specs(opt).items():
        assert torch.equal(t, old[name]), f"old {name} was written"

    longer = _torch_batch(_data(cfg, 2 * SEQ), 3)
    before = {k: v.clone() for k, v in step.batch.items()}
    kept = step.batch
    step.load(restored, longer)
    assert step.bindings == 3
    assert tuple(step.batch["tokens"].shape) == (BATCH, 2 * SEQ)
    step.run_eager()
    assert int(restored["step"]) == 4
    for k, v in kept.items():
        assert torch.equal(v, before[k]), f"old {k} buffer was written"

    step.release()
    assert step.opt_state is None and step.batch is None
    step.load(restored, longer)
    assert step.bindings == 4
