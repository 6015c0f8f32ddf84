"""The port's model, trainer and decode over a mesh of gloo processes,
held against the reference's one-device run on the CPU (the oracle of
tests/dist_suite/test_model_parallel.py, which passes when run alone).

Reduced granite-34b (dense, MQA) in f32, the reference's weights
(``Model.init(jax.random.key(0))``) carried to every rank's shards by
``bridge.params_from_numpy``, one ``SyntheticLMData`` batch (B 4, S 32):

  * one ``build_train_step`` step (AdamW lr 1e-2) on the (2, 2) mesh in
    bulk and in interleaved mode and on the (2, 2, 2) pod mesh in bulk,
    and on (2, 2) with ``attn_impl`` ulysses and ring (interleaved): the
    loss within rtol 2e-4 and every updated parameter, gathered back to
    its global shape, within rtol 2e-3 / atol 3e-4 of the reference's 1x1
    step — the reference's own tolerances — and the gradient norm within
    rtol 1e-5 (the first AdamW update hardly depends on the gradients'
    scale, so the norm is what holds their sums over the mesh);
  * ``prefill_sp`` on (2, 2): the last position's vocab-parallel logits,
    gathered over 'model', within rtol 1e-5 / atol 1e-5 of the
    reference's 1x1 prefill;
  * greedy decode through the contiguous cache sharded over (data x
    model) on (2, 2): the reference's 1x1 tokens exactly.

Reduced mamba2-130m (ssm) and moonshot-v1-16b-a3b (moe, ep_a2a,
capacity factor 16), the other two families of
tests/dist_suite/test_model_parallel.py, run in the same processes: one
train step on (2, 2) in bulk and interleaved mode and on (2, 2, 2) in
bulk (loss within rtol 2e-4, 1e-3 for the MoE, and updated parameters
within rtol 2e-3 / atol 3e-4 of the reference's 1x1 step, the
reference's tolerances), and greedy decode on (2, 2) and (2, 2, 2)
equal to the reference's 1x1 tokens.

The (2, 2) processes run their steps, the prefill and the decodes; the
(2, 2, 2) ones start at the same time.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as ref_configs
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.data.pipeline import DataConfig, SyntheticLMData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.serve_loop import Generator as RefGenerator
from repro.train.serve_loop import build_prefill_step as \
    ref_build_prefill_step
from repro.train.train_loop import build_train_step as ref_build_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-34b"
#: (mesh, runs on it): an MDMP mode, or an attn_impl run interleaved
MESHES = [("2x2", ("bulk", "interleaved", "ulysses", "ring")),
          ("2x2x2", ("bulk",))]
ATTN_IMPLS = ("ulysses", "ring")
#: the other families of the reference's suite: mesh -> train modes
FAMILIES = ("mamba2-130m", "moonshot-v1-16b-a3b")
FAMILY_MESHES = {"2x2": ("bulk", "interleaved"), "2x2x2": ("bulk",)}
LR = 1e-2


def _family_cfg(cfg):
    """f32, and the reference suite's capacity factor 16 for the MoE."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


def _ref_cfg(arch=ARCH):
    return _family_cfg(ref_configs.get_reduced(arch))


def _prompt(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size - 1, size=(4, 6)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def rank_main(rank, world, init, mesh_spec, modes, inputs, out):
    """One rank: a train step per mode from the same weights, and (on the
    (2, 2) mesh) prefill and greedy decode; rank 0 saves the gathered
    parameters."""
    import torch
    import torch.distributed as dist

    from repro_torch import bridge, configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import transport
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train.serve_loop import Generator
    from repro_torch.train.train_loop import build_train_step

    torch.set_num_threads(1)
    launch_mesh.init_distributed("cpu", init_method=init, rank=rank,
                                 world_size=world)
    shape, axes = launch_mesh.parse_mesh(mesh_spec)
    # the pod mesh is the launcher's multi-pod test miniature
    mesh = (launch_mesh.make_test_mesh(multi_pod=True, device_type="cpu")
            if mesh_spec == "2x2x2"
            else launch_mesh.make_mesh(shape, axes, "cpu"))
    assert mesh.mesh_dim_names == axes and tuple(mesh.shape) == shape
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")
    data = np.load(inputs, allow_pickle=True)
    params = data["params"].item()
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].item().items()}
    res = {}
    for mode in modes:
        run_cfg, mdmp = cfg, mode
        if mode in ATTN_IMPLS:
            run_cfg = dataclasses.replace(cfg, attn_impl=mode)
            mdmp = "interleaved"
        model = bridge.params_from_numpy(
            params, Model(run_cfg, MeshCtx.from_mesh(mesh, mdmp),
                          device="cpu"))
        step = build_train_step(model, AdamWConfig(lr=LR))
        _, metrics = step(adamw_init(model.params(), AdamWConfig()), batch)
        res[f"{mode}_loss"] = float(metrics["loss"])
        res[f"{mode}_grad_norm"] = float(metrics["grad_norm"])
        for k, v in flatten_specs(bridge.params_to_numpy_full(model)).items():
            res[f"{mode}/{k}"] = v
    if mesh_spec == "2x2":
        model = bridge.params_from_numpy(
            params, Model(cfg, MeshCtx.from_mesh(mesh, "bulk"),
                          device="cpu"))
        with torch.no_grad():
            logits, _ = model.prefill_sp(model.ctx.shard_batch(
                {"tokens": batch["tokens"]}))
        rows = transport.all_gather(logits, model.ctx.group("data"))
        res["prefill"] = torch.cat(transport.all_gather(
            torch.cat(rows), model.ctx.group("model")), dim=-1).numpy()
        gen = Generator(model, ShapeConfig("t", seq_len=32, global_batch=4,
                                           kind="decode"))
        res["decode"] = gen.generate(data["prompt"], n_new=5)
    for arch in FAMILIES:
        fcfg = _family_cfg(configs.get_reduced(arch))
        fparams = data[f"params_{arch}"].item()
        for mode in FAMILY_MESHES[mesh_spec]:
            model = bridge.params_from_numpy(
                fparams, Model(fcfg, MeshCtx.from_mesh(mesh, mode),
                               device="cpu"))
            step = build_train_step(model, AdamWConfig(lr=LR))
            _, metrics = step(adamw_init(model.params(), AdamWConfig()),
                              batch)
            res[f"{arch}/{mode}_loss"] = float(metrics["loss"])
            for k, v in flatten_specs(
                    bridge.params_to_numpy_full(model)).items():
                res[f"{arch}/{mode}/{k}"] = v
        model = bridge.params_from_numpy(
            fparams, Model(fcfg, MeshCtx.from_mesh(mesh, "bulk"),
                           device="cpu"))
        gen = Generator(model, ShapeConfig("t", seq_len=32, global_batch=4,
                                           kind="decode"))
        res[f"{arch}/decode"] = gen.generate(data["prompt"], n_new=5)
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


WORKER = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_model_parallel import rank_main
rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          tuple(sys.argv[5].split(",")), sys.argv[6], sys.argv[7])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every mesh's processes, then run the reference's 1x1 step and
    decode meanwhile.  Returns (reference, port by mesh)."""
    tmp = tmp_path_factory.mktemp("model_parallel")
    cfg = _ref_cfg()
    mesh1 = jax.make_mesh((1, 1), ("data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh1, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=32,
                                       global_batch=4)).global_batch_at(0)
    prompt = _prompt(cfg)
    inputs = tmp / "inputs.npz"
    fam = {}
    for arch in FAMILIES:
        fmodel = RefModel(_ref_cfg(arch),
                          RefMeshCtx.from_mesh(mesh1, mdmp_mode="bulk"))
        fam[arch] = (fmodel, jax.tree.map(
            np.asarray, fmodel.init(jax.random.key(0))))
    np.savez(inputs, params=np.array(params, dtype=object),
             batch=np.array(batch, dtype=object), prompt=prompt,
             **{f"params_{a}": np.array(p, dtype=object)
                for a, (_, p) in fam.items()})
    (tmp / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = {}
    for spec, modes in MESHES:
        world = int(np.prod([int(n) for n in spec.split("x")]))
        procs[spec] = [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(world),
             "file://" + str(tmp / f"init{spec}"), spec, ",".join(modes),
             str(inputs), str(tmp / f"{spec}.npz")], env=env,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        step, pshard, bshard = ref_build_train_step(
            model, RefAdamWConfig(lr=LR), mesh1, donate=False)
        p = jax.tree.map(lambda a, s: jax.device_put(a, s), params, pshard)
        b = {k: jax.device_put(v, bshard[k]) for k, v in batch.items()}
        p2, _, m = step(p, ref_adamw_init(p, RefAdamWConfig()), b)
        ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "params": _flat(jax.tree.map(np.asarray, p2))}
        prefill = ref_build_prefill_step(model, mesh1)
        ref["prefill"] = np.asarray(prefill(p, {"tokens": b["tokens"]})[0])
        ref["decode"] = RefGenerator(
            model, mesh1, RefShapeConfig("t", seq_len=32, global_batch=4,
                                         kind="decode"),
            p).generate(prompt, n_new=5)
        for arch, (fmodel, fparams) in fam.items():
            fstep, fpshard, _ = ref_build_train_step(
                fmodel, RefAdamWConfig(lr=LR), mesh1, donate=False)
            fp = jax.tree.map(lambda a, s: jax.device_put(a, s), fparams,
                              fpshard)
            fp2, _, fm = fstep(fp, ref_adamw_init(fp, RefAdamWConfig()), b)
            ref[arch] = {"loss": float(fm["loss"]),
                         "params": _flat(jax.tree.map(np.asarray, fp2)),
                         "decode": RefGenerator(
                             fmodel, mesh1,
                             RefShapeConfig("t", seq_len=32, global_batch=4,
                                            kind="decode"),
                             fp).generate(prompt, n_new=5)}
        everyone = [p for ps in procs.values() for p in ps]
        errs = [p.communicate(timeout=420)[1] for p in everyone]
    finally:
        for p in [p for ps in procs.values() for p in ps]:
            p.kill()
    for p, err in zip(everyone, errs):
        assert p.returncode == 0, err[-4000:]
    return ref, {spec: dict(np.load(tmp / f"{spec}.npz"))
                 for spec, _ in MESHES}


@pytest.mark.parametrize("spec,mode", [(s, m) for s, ms in MESHES
                                       for m in ms])
def test_train_step_matches_reference_one_device(runs, spec, mode):
    ref, port = runs[0], runs[1][spec]
    np.testing.assert_allclose(port[f"{mode}_loss"], ref["loss"], rtol=2e-4)
    # the first AdamW update hardly depends on the gradients' scale: the
    # norm holds the mesh's gradient sums and replication factors to 1x1
    np.testing.assert_allclose(port[f"{mode}_grad_norm"], ref["grad_norm"],
                               rtol=1e-5)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(port[f"{mode}/{name}"], want, rtol=2e-3,
                                   atol=3e-4, err_msg=f"{spec} {mode} {name}")


def test_prefill_2x2_matches_reference_one_device(runs):
    ref, port = runs[0], runs[1]["2x2"]
    np.testing.assert_allclose(port["prefill"], ref["prefill"], rtol=1e-5,
                               atol=1e-5)


def test_decode_2x2_matches_reference_one_device(runs):
    ref, port = runs[0], runs[1]["2x2"]
    np.testing.assert_array_equal(port["decode"], ref["decode"])


@pytest.mark.parametrize("arch,spec,mode", [
    (a, s, m) for a in FAMILIES for s, ms in FAMILY_MESHES.items()
    for m in ms])
def test_family_train_step_matches_reference_one_device(runs, arch, spec,
                                                         mode):
    """mamba2 and moonshot train steps over the mesh equal the
    reference's 1x1 step (the reference suite's tolerances)."""
    ref, port = runs[0][arch], runs[1][spec]
    rtol = 1e-3 if "moonshot" in arch else 2e-4
    np.testing.assert_allclose(port[f"{arch}/{mode}_loss"], ref["loss"],
                               rtol=rtol)
    for name, want in ref["params"].items():
        np.testing.assert_allclose(port[f"{arch}/{mode}/{name}"], want,
                                   rtol=2e-3, atol=3e-4,
                                   err_msg=f"{arch} {spec} {mode} {name}")


@pytest.mark.parametrize("spec", list(FAMILY_MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_reference_one_device(runs, arch, spec):
    np.testing.assert_array_equal(runs[1][spec][f"{arch}/decode"],
                                  runs[0][arch]["decode"])
