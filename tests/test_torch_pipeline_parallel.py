"""The port's pipeline over gloo ranks on the CPU (the mirror of
tests/dist_suite/test_pipeline.py, which passes when run alone), and the
int8 pod compression.

One group of 2 processes (mesh 2x1x1) and one of 4 (meshes 4x1x1, 2x2x1
and 2x1x2) start at once (file:// init).  In each:

  * the executor's loss and gradients under gpipe, 1f1b and interleaved
    (v = 2) over the pod stages against the sequential autograd oracle
    (16 tanh layers of width 16, 8 microbatches of 4 rows; loss within
    1e-5 relative, gradients within rtol 3e-4 / atol 1e-6, the reference
    suite's tolerances);
  * forward-only GPipe (``pipeline_apply`` + ``select_last_stage``) over
    uneven stages (3 layers over 2, 6 over 4) against the sequential
    stack;
  * ``build_train_step`` on reduced phi4-mini in f32 (the reference's
    weights, one ``SyntheticLMData`` batch of 4 x 32) under each schedule
    against the non-pipelined step on the same mesh (the pod axis as DP):
    loss within 1e-5 relative, gradient norm within 1e-5, every gradient
    within rtol 3e-4 / atol 1e-6 and every updated parameter within rtol
    3e-4 / atol 1e-6.  Uneven stages: 3 layers over 2 stages, 5 over 4;
    interleaved: 4 layers over 2 stages, 8 over 4; with data parallelism
    (2x2x1)
    and tensor parallelism (2x1x2) inside the stages.  Each step's loss
    and gradient norm are also held to the reference's one-device step;
  * ``pipeline="auto"``: the decision every rank logs builds a timetable
    that trains;
  * ``compressed_psum`` over 2 ranks against each rank's quantisation by
    the reference, and ``--compress-pod`` on a 2x1x1 data-parallel step:
    3 steps' losses against the uncompressed run's, and the int8 payload
    (the all-gathers' bytes) a quarter of the f32 all-reduces' bytes plus
    4 bytes of scale per gradient;
  * ``launch.train --mesh 2x1x1 --pipeline 1f1b`` under torchrun.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.parallel import compression as ref_compression
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch.parallel import compression

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi4-mini-3.8b"
B, S, LR = 4, 32, 1e-2
#: world size -> meshes it runs
MESHES = {2: ("2x1x1",), 4: ("4x1x1", "2x2x1", "2x1x2")}
#: mesh -> train runs (n_layers, pipeline, microbatches)
TRAIN = {"2x1x1": [(3, "gpipe", 2), (3, "1f1b", 2), (4, "interleaved", 2),
                   (4, "1f1b", 1)],
         "4x1x1": [(5, "1f1b", 4), (5, "gpipe", 2), (8, "interleaved", 4)],
         "2x2x1": [(3, "1f1b", 2)],
         "2x1x2": [(4, "gpipe", 2), (4, "interleaved", 2)]}
COMPRESS_STEPS = 3
#: the launcher under torchrun: two ranks as 1f1b stages
CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "2x1x1",
       "--pipeline", "1f1b", "--microbatches", "2", "--steps", "3",
       "--batch", str(B), "--seq", str(S)]
RTOL, ATOL = 3e-4, 1e-6
TOY = dict(n_layers=16, d=16, m=8, b=4)


def _toy():
    rng = np.random.default_rng(1)
    t = TOY
    ws = rng.normal(size=(t["n_layers"], t["d"], t["d"])).astype(
        np.float32) * 0.25
    xs = rng.normal(size=(t["m"], t["b"], t["d"])).astype(np.float32)
    tg = rng.normal(size=(t["m"], t["b"], t["d"])).astype(np.float32)
    return ws, xs, tg


def _excess(got, want):
    """max(|got - want| - RTOL |want|): at most ATOL when allclose."""
    return float(torch.max(torch.abs(got - want) - RTOL * torch.abs(want)))


def rank_main(rank, world, init, inputs, out_dir):
    import torch.distributed as dist

    from repro_torch import bridge, configs
    from repro_torch.core import managed
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import pipeline
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train import train_loop

    torch.set_num_threads(1)
    launch_mesh.init_distributed("cpu", init_method=init, rank=rank,
                                 world_size=world)
    data = np.load(inputs, allow_pickle=True)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in data["batches"]]
    res = {}

    captured = {}
    adamw_update = train_loop.adamw_update

    def capture(params, grads, state, cfg, *, gnorm=None):
        captured["grads"] = {k: v.detach().clone()
                             for k, v in flatten_specs(grads).items()}
        return adamw_update(params, grads, state, cfg, gnorm=gnorm)

    train_loop.adamw_update = capture

    def train(ctx, n_layers, sched, micro, steps=1, compress=False):
        cfg = dataclasses.replace(configs.get_reduced(ARCH),
                                  dtype="float32", n_layers=n_layers)
        model = bridge.params_from_numpy(
            data[f"params{n_layers}"].item(), Model(cfg, ctx, device="cpu"))
        step = train_loop.build_train_step(
            model, AdamWConfig(lr=LR), pipeline=sched,
            pipe_microbatches=micro, global_batch=B, seq_len=S,
            compress_pod=compress)
        opt = adamw_init(model.params(), AdamWConfig())
        losses, grads, norm = [], None, None
        for i in range(steps):
            opt, metrics = step(opt, batches[i])
            losses.append(float(metrics["loss"]))
            if i == 0:
                grads, norm = captured["grads"], float(metrics["grad_norm"])
        params = {k: v.detach().clone()
                  for k, v in flatten_specs(model.params()).items()}
        return losses, norm, grads, params

    ws, xs, tg = (torch.from_numpy(a) for a in _toy())
    for spec in MESHES[world]:
        shape, axes = launch_mesh.parse_mesh(spec)
        ctx = MeshCtx.from_mesh(launch_mesh.make_mesh(shape, axes, "cpu"),
                                "auto")
        n_stage = ctx.pods
        if n_stage == world:
            # the executor on the toy problem, every schedule
            n_layers = TOY["n_layers"]
            for name, v in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
                sched = pipeline.build_schedule(name, TOY["m"], n_stage, v)
                n_virtual = n_stage * sched.virtual

                def chunk_fn(p, q, mb, x, n_virtual=n_virtual):
                    if q == 0:
                        x = xs[mb]
                    for w in pipeline.chunk_slice(p, n_layers, n_virtual,
                                                  q)["w"]:
                        x = torch.tanh(x @ w)
                    return x

                def loss_fn(p, y, mb):
                    return torch.mean((y - tg[mb]) ** 2)

                pipeline.reset_handoffs()
                loss, grads = pipeline.pipeline_value_and_grad(
                    chunk_fn, loss_fn, {"w": ws},
                    torch.empty((TOY["b"], TOY["d"]), device="meta"), sched,
                    "pod", ctx)
                res[f"{spec}/toy/{name}/loss"] = float(loss)
                res[f"{spec}/toy/{name}/grads"] = grads["w"].numpy()
                res[f"{spec}/toy/{name}/handoffs"] = pipeline.handoffs()[0]
            # forward-only GPipe over uneven stages
            n_fwd = 3 if n_stage == 2 else 6
            lo, per = pipeline.chunk_bounds(n_fwd, n_stage,
                                            ctx.axis_index("pod"))

            def stage_fn(x, stage_ws):
                for w in stage_ws:
                    x = torch.tanh(x @ w)
                return x

            y = pipeline.pipeline_apply(stage_fn, ws[lo:lo + per], xs,
                                        "pod", ctx)
            res[f"{spec}/apply"] = pipeline.select_last_stage(
                y, "pod", ctx).numpy()
        for n_layers, sched, micro in TRAIN[spec]:
            key = f"{spec}/L{n_layers}"
            if f"{key}/none/loss" not in res:
                losses, norm, base_g, base_p = train(ctx, n_layers, "none",
                                                     None)
                res[f"{key}/none/loss"], res[f"{key}/none/norm"] = (
                    losses[0], norm)
            losses, norm, grads, params = train(ctx, n_layers, sched, micro)
            res[f"{key}/{sched}{micro}/loss"] = losses[0]
            res[f"{key}/{sched}{micro}/norm"] = norm
            res[f"{key}/{sched}{micro}/grad_excess"] = max(
                _excess(grads[k], base_g[k]) for k in base_g)
            res[f"{key}/{sched}{micro}/param_excess"] = max(
                _excess(params[k], base_p[k]) for k in base_p)
        if spec == "2x1x1":
            with managed.capture_decisions() as cap:
                losses, _, _, _ = train(ctx, 4, "auto", None)
            rec = [r for r in cap.records if r.op == "pipeline_schedule"]
            res["auto"] = np.array([(r.mode, r.chunks) for r in rec],
                                   dtype=object)
            res["auto/loss"] = losses[0]
            # the int8 pod reduction: compressed_psum, then a DP step
            g = torch.from_numpy(data["compress_g"][rank])
            err = torch.from_numpy(data["compress_err"][rank])
            total, new_err = compression.compressed_psum(g, "pod", ctx, err)
            res["psum/total"], res["psum/err"] = total.numpy(), \
                new_err.numpy()
            for compress in (False, True):
                with managed.capture_decisions() as cap:
                    losses, _, grads, _ = train(ctx, 3, "none", None,
                                                steps=COMPRESS_STEPS,
                                                compress=compress)
                res[f"compress{int(compress)}/losses"] = np.array(losses)
                pod = [r for r in cap.records if r.axis == "pod"]
                # bytes a step
                res[f"compress{int(compress)}/gather_bytes"] = sum(
                    r.nbytes for r in pod
                    if r.op == "all_gather") / COMPRESS_STEPS
                res[f"compress{int(compress)}/reduce_bytes"] = sum(
                    r.nbytes for r in pod
                    if r.op == "all_reduce") / COMPRESS_STEPS
            res["compress/big_numel"] = sum(
                g.numel() for g in grads.values() if g.numel() > 4096)
            res["compress/big_count"] = sum(
                1 for g in grads.values() if g.numel() > 4096)
    np.savez(os.path.join(out_dir, f"w{world}r{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


WORKER = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_pipeline_parallel import rank_main
rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5])
"""


def _ref_model(n_layers):
    cfg = dataclasses.replace(ref_configs.get_reduced(ARCH), dtype="float32",
                              n_layers=n_layers)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="auto"))
    return model, mesh, jax.tree.map(np.asarray,
                                     model.init(jax.random.key(0)))


def _ref_step(model, mesh, params, batch):
    """The reference's one-device step: (loss, grad norm)."""
    step, pshard, bshard = ref_build_train_step(
        model, RefAdamWConfig(lr=LR), mesh, donate=False)
    p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
    b = {k: jax.device_put(v, bshard[k]) for k, v in batch.items()}
    _, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()), b)
    return float(m["loss"]), float(m["grad_norm"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start both process groups; meanwhile the reference's one-device
    steps and the oracles.  Returns (reference, toy oracle, per-rank
    results keyed (world, rank), inputs)."""
    tmp = tmp_path_factory.mktemp("pipeline_parallel")
    data = SyntheticLMData(DataConfig(
        vocab_size=ref_configs.get_reduced(ARCH).vocab_size, seq_len=S,
        global_batch=B))
    batches = [data.global_batch_at(i) for i in range(COMPRESS_STEPS)]
    models = {n: _ref_model(n) for n in sorted(
        {n for cases in TRAIN.values() for n, _, _ in cases})}
    rng = np.random.default_rng(7)
    compress_g = rng.normal(size=(2, 64, 96)).astype(np.float32)
    compress_err = (rng.normal(size=(2, 64, 96)) * 1e-3).astype(np.float32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, batches=np.array(batches, dtype=object),
             compress_g=compress_g, compress_err=compress_err,
             **{f"params{n}": np.array(r[2], dtype=object)
                for n, r in models.items()})
    (tmp / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + CLI
        + ["--ckpt", str(tmp / "cli")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = []
    for world in MESHES:
        procs += [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(world),
             "file://" + str(tmp / f"init{world}"), str(inputs), str(tmp)],
            env=env, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    try:
        ref = {n: _ref_step(*r, batches[0]) for n, r in models.items()}
        ws, xs, tg = (torch.from_numpy(a) for a in _toy())
        w0 = ws.clone().requires_grad_()
        losses = []
        for mb in range(TOY["m"]):
            x = xs[mb]
            for i in range(TOY["n_layers"]):
                x = torch.tanh(x @ w0[i])
            losses.append(torch.mean((x - tg[mb]) ** 2))
        want_loss = torch.stack(losses).mean()
        want_g, = torch.autograd.grad(want_loss, [w0])
        oracle_fwd = {}
        for n_fwd in (3, 6):
            y = xs
            for i in range(n_fwd):
                y = torch.tanh(y @ ws[i])
            oracle_fwd[n_fwd] = y.detach().numpy()
        oracle = {"loss": float(want_loss.detach()),
                  "grads": want_g.numpy(),
                  "fwd": oracle_fwd}
        errs = [p.communicate(timeout=420)[1] for p in procs]
        cli_out, cli_err = cli.communicate(timeout=420)
    finally:
        for p in procs + [cli]:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    oracle["cli"] = (cli.returncode, cli_out, cli_err)
    port = {(w, r): dict(np.load(tmp / f"w{w}r{r}.npz", allow_pickle=True))
            for w in MESHES for r in range(w)}
    return ref, oracle, port, {"g": compress_g, "err": compress_err}


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("name", ["gpipe", "1f1b", "interleaved"])
def test_training_schedules_match_sequential_oracle(runs, world, name):
    _, oracle, port, _ = runs
    spec = f"{world}x1x1"
    for r in range(world):
        got = port[(world, r)]
        np.testing.assert_allclose(got[f"{spec}/toy/{name}/loss"],
                                   oracle["loss"], rtol=1e-5)
        np.testing.assert_allclose(got[f"{spec}/toy/{name}/grads"],
                                   oracle["grads"], rtol=RTOL, atol=ATOL)
        assert got[f"{spec}/toy/{name}/handoffs"] > 0


@pytest.mark.parametrize("world", list(MESHES))
def test_forward_pipeline_matches_sequential_uneven_stages(runs, world):
    _, oracle, port, _ = runs
    n_fwd = 3 if world == 2 else 6
    for r in range(world):
        np.testing.assert_allclose(
            port[(world, r)][f"{world}x1x1/apply"], oracle["fwd"][n_fwd],
            rtol=2e-5, atol=1e-6)


CASES = [(w, spec, n, sched, m) for w, specs in MESHES.items()
         for spec in specs for n, sched, m in TRAIN[spec]]


@pytest.mark.parametrize("world,spec,n_layers,sched,micro", CASES)
def test_train_step_pipeline_matches_dp_baseline(runs, world, spec,
                                                  n_layers, sched, micro):
    ref, _, port, _ = runs
    ref_loss, ref_norm = ref[n_layers]
    key = f"{spec}/L{n_layers}"
    for r in range(world):
        got = port[(world, r)]
        base = float(got[f"{key}/none/loss"])
        loss = float(got[f"{key}/{sched}{micro}/loss"])
        norm = float(got[f"{key}/{sched}{micro}/norm"])
        np.testing.assert_allclose(loss, base, rtol=1e-5)
        np.testing.assert_allclose(norm, float(got[f"{key}/none/norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        np.testing.assert_allclose(norm, ref_norm, rtol=1e-5)
        assert float(got[f"{key}/{sched}{micro}/grad_excess"]) <= ATOL, \
            f"rank {r}: gradients off the DP step beyond rtol {RTOL}"
        assert float(got[f"{key}/{sched}{micro}/param_excess"]) <= ATOL, \
            f"rank {r}: parameters off the DP step beyond rtol {RTOL}"


def test_auto_schedule_decision_trail(runs):
    _, _, port, _ = runs
    decisions = [port[(2, r)]["auto"].tolist() for r in range(2)]
    assert decisions[0] == decisions[1] and len(decisions[0]) == 1
    mode, chunks = decisions[0][0]
    assert mode in ("gpipe", "1f1b", "interleaved") and B % chunks == 0
    assert np.isfinite(float(port[(2, 0)]["auto/loss"]))


def test_quantize_int8_equals_reference():
    rng = np.random.default_rng(3)
    for shape, scale in (((7, 33), 1.0), ((4096,), 1e-6), ((3, 5, 9), 50.0)):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        q, s = compression.quantize_int8(torch.from_numpy(x))
        rq, rs = ref_compression.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(ref_compression.dequantize_int8(rq, rs)))
    zeros = compression.quantize_int8(torch.zeros(5))
    assert float(zeros[1]) == float(
        ref_compression.quantize_int8(jnp.zeros(5))[1])


def test_compressed_psum_over_two_ranks(runs):
    _, _, port, inp = runs
    deq, errs = [], []
    for r in range(2):
        g32 = jnp.asarray(inp["g"][r]) + jnp.asarray(inp["err"][r])
        q, s = ref_compression.quantize_int8(g32)
        d = ref_compression.dequantize_int8(q, s)
        deq.append(np.asarray(d))
        errs.append(np.asarray(g32 - d))
    for r in range(2):
        got = port[(2, r)]
        np.testing.assert_allclose(got["psum/total"], deq[0] + deq[1],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["psum/err"], errs[r], rtol=1e-6,
                                   atol=1e-9)


def test_compress_pod_tracks_uncompressed_and_sends_a_quarter(runs):
    _, _, port, _ = runs
    for r in range(2):
        got = port[(2, r)]
        plain, packed = got["compress0/losses"], got["compress1/losses"]
        assert plain[0] == packed[0]            # before any update
        np.testing.assert_allclose(packed, plain, rtol=2e-3)
        n, count = int(got["compress/big_numel"]), int(
            got["compress/big_count"])
        # int8 payload + one f32 scale per compressed gradient, against
        # the f32 all-reduces of the same gradients
        assert float(got["compress1/gather_bytes"]) == n + 4 * count
        assert float(got["compress0/reduce_bytes"]) - float(
            got["compress1/reduce_bytes"]) == 4 * n


def test_launcher_pipeline_under_torchrun(runs):
    rc, out, err = runs[1]["cli"]
    assert rc == 0, err[-4000:]
    assert "decision pipeline_schedule(1f1b M=2 axis=pod" in out, out
    assert "done at step 3" in out, out
