"""The port's paged serving engine on the 2x4 (data x model) mesh of gloo
processes, held against the reference on the CPU (the oracle of
tests/dist_suite/test_serving.py, which passes when run alone).

Reduced granite-34b in f32 with the reference's weights:

  * continuous batching (2 slots, pages of 4, quantum 4) of four prompts
    on 2x4: each rank's pool holds its shard of the pages, the new K/V
    row is written by the page's owner, and each rank's plain partials
    LSE-merge over the cache axes.  The greedy tokens equal the port's
    1x1 engine (the paged kernel's plain version on one shard), the
    reference's 1x1 engine and the reference's contiguous ``Generator``;
    so do the managed schedule's (``schedule="auto"``), whose decisions
    read measured times that every rank agrees on;
  * 8 pages on 2x4: every rank owns exactly one page (its cache rank's),
    the 14-token prompt and 5 new tokens live on 5 pages, each written on
    the rank that owns it, and the tokens equal the reference's
    ``Generator``;
  * reduced mamba2-130m (ssm, dist_suite/test_serving.py's other arch):
    the four prompts' continuous batching on 2x4 — SSM heads sharded over
    'model', slot state reset on reuse — equal to the reference's 1x1
    engine and its contiguous ``Generator``.
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
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import infer_shardings
from repro.serve.engine import ServeEngine as RefServeEngine
from repro.train.serve_loop import Generator as RefGenerator

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-34b"
SSM_ARCH = "mamba2-130m"
ENGINE_KW = dict(slots=2, max_seq=32, page_size=4, schedule="continuous",
                 chunk=4)
AUTO_KW = dict(slots=2, max_seq=32, page_size=4, schedule="auto")
POOL_KW = dict(slots=1, max_seq=32, page_size=4, n_pages=8,
               schedule="static", chunk=8)


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab - 1, size=p).astype(np.int32)
            for p in (4, 7, 3, 9)]


def _long_prompt(vocab):
    rng = np.random.default_rng(3)
    return rng.integers(0, vocab - 1, size=14).astype(np.int32)


def serve_all(model):
    """The engine runs of this file on ``model`` (port or 1x1): the four
    prompts' tokens with the pinned schedule and with the managed one
    (``schedule="auto"``, whose online correction reads measured quantum
    times: over a mesh every rank must take the same decisions), and the
    long prompt's, with the pool-run engine."""
    from repro_torch.serve.engine import ServeEngine

    vocab = model.cfg.vocab_size
    out = []
    for kw in (ENGINE_KW, AUTO_KW):
        eng = ServeEngine(model, **kw)
        rids = [eng.submit(p, 5) for p in _prompts(vocab)]
        res = eng.run()
        out.append(np.stack([res[r] for r in rids]))
    pool = ServeEngine(model, **POOL_KW)
    rid = pool.submit(_long_prompt(vocab), 5)
    return out, pool.run()[rid], pool


def rank_main(rank, world, init, inputs, out):
    import torch
    import torch.distributed as dist

    from repro_torch import bridge, configs
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.serve.engine import ServeEngine

    torch.set_num_threads(1)
    launch_mesh.init_distributed("cpu", init_method=init, rank=rank,
                                 world_size=world)
    mesh = launch_mesh.make_test_mesh(device_type="cpu")
    ctx = MeshCtx.from_mesh(mesh, "bulk")
    refused = []
    for multi_pod in (False, True):
        try:
            launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        except ValueError as e:
            refused.append(str(e))
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")
    model = bridge.params_from_numpy(
        np.load(inputs, allow_pickle=True)["params"].item(),
        Model(cfg, ctx, device="cpu"))
    toks, long_toks, pool = serve_all(model)
    kp = pool.cache["kp"]
    scfg = dataclasses.replace(configs.get_reduced(SSM_ARCH), dtype="float32")
    smodel = bridge.params_from_numpy(
        np.load(inputs, allow_pickle=True)["ssm_params"].item(),
        Model(scfg, ctx, device="cpu"))
    eng = ServeEngine(smodel, **ENGINE_KW)
    rids = [eng.submit(p, 5) for p in _prompts(scfg.vocab_size)]
    res = eng.run()
    np.savez(out, tokens=toks[0], auto=toks[1], long=long_toks,
             ssm_tokens=np.stack([res[r] for r in rids]),
             cache_rank=attention.cache_rank(ctx),
             pool_pages=kp.shape[1], high_water=pool.pt.high_water,
             written=bool(kp[:, 0].abs().sum() > 0),
             mesh_shape=tuple(mesh.shape), mesh_axes=mesh.mesh_dim_names,
             refused=refused)
    dist.barrier()
    dist.destroy_process_group()


WORKER = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_serving_mesh import rank_main
rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 8 ranks, then run the references and the port's 1x1
    engine meanwhile."""
    import torch

    from repro_torch import bridge, configs
    from repro_torch.models.model import Model

    tmp = tmp_path_factory.mktemp("serving_mesh")
    cfg = dataclasses.replace(ref_configs.get_reduced(ARCH), dtype="float32")
    mesh1 = jax.make_mesh((1, 1), ("data", "model"))
    model = RefModel(cfg, RefMeshCtx.from_mesh(mesh1, mdmp_mode="bulk"))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    scfg = dataclasses.replace(ref_configs.get_reduced(SSM_ARCH),
                               dtype="float32")
    smodel = RefModel(scfg, RefMeshCtx.from_mesh(mesh1, mdmp_mode="bulk"))
    sparams = jax.tree.map(np.asarray, smodel.init(jax.random.key(0)))
    inputs = tmp / "inputs.npz"
    np.savez(inputs, params=np.array(params, dtype=object),
             ssm_params=np.array(sparams, dtype=object))
    (tmp / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), "8",
         "file://" + str(tmp / "init"), str(inputs), str(tmp / f"r{r}.npz")],
        env=env, stderr=subprocess.PIPE, text=True) for r in range(8)]
    try:
        p = jax.tree.map(lambda a, s: jax.device_put(a, s), params,
                         infer_shardings(model.param_specs(), mesh1))
        ref = {}
        eng = RefServeEngine(model, mesh1, p, **ENGINE_KW)
        rids = [eng.submit(q, 5) for q in _prompts(cfg.vocab_size)]
        res = eng.run()
        ref["engine"] = np.stack([res[r] for r in rids])
        gen = RefGenerator(model, mesh1, RefShapeConfig("s", 32, 1,
                                                        "decode"), p)
        ref["oracle"] = np.stack([gen.generate(q[None], n_new=5)[0]
                                  for q in _prompts(cfg.vocab_size)])
        ref["long"] = gen.generate(_long_prompt(cfg.vocab_size)[None],
                                   n_new=5)[0]
        sp = jax.tree.map(lambda a, s: jax.device_put(a, s), sparams,
                          infer_shardings(smodel.param_specs(), mesh1))
        eng = RefServeEngine(smodel, mesh1, sp, **ENGINE_KW)
        rids = [eng.submit(q, 5) for q in _prompts(scfg.vocab_size)]
        res = eng.run()
        ref["ssm_engine"] = np.stack([res[r] for r in rids])
        sgen = RefGenerator(smodel, mesh1, RefShapeConfig("s", 32, 1,
                                                          "decode"), sp)
        ref["ssm_oracle"] = np.stack([sgen.generate(q[None], n_new=5)[0]
                                      for q in _prompts(scfg.vocab_size)])
        torch.set_num_threads(2)
        port1 = bridge.params_from_numpy(params, Model(
            dataclasses.replace(configs.get_reduced(ARCH), dtype="float32"),
            device="cpu"))
        toks, long_toks, _ = serve_all(port1)
        one = {"tokens": toks[0], "auto": toks[1], "long": long_toks}
        errs = [q.communicate(timeout=300)[1] for q in procs]
    finally:
        for q in procs:
            q.kill()
    for q, err in zip(procs, errs):
        assert q.returncode == 0, err[-4000:]
    return ref, one, [dict(np.load(tmp / f"r{r}.npz")) for r in range(8)]


def test_paged_serving_2x4_matches_1x1_and_oracle(runs):
    ref, one, ranks = runs
    np.testing.assert_array_equal(ref["engine"], ref["oracle"])
    np.testing.assert_array_equal(one["tokens"], ref["oracle"])
    np.testing.assert_array_equal(one["auto"], ref["oracle"])
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], ref["oracle"])
        np.testing.assert_array_equal(r["auto"], ref["oracle"])


def test_launch_meshes_over_eight_ranks(runs):
    """``make_test_mesh`` is the 2x4 (data, model) miniature the serving
    ran on; ``make_production_mesh`` asks for 256 ranks (512 multi-pod)
    and refuses a group of 8."""
    for r in runs[2]:
        assert tuple(r["mesh_shape"]) == (2, 4)
        assert tuple(r["mesh_axes"]) == ("data", "model")
        assert len(r["refused"]) == 2
        assert "(16, 16) needs 256 ranks" in str(r["refused"][0])
        assert "(2, 16, 16) needs 512 ranks" in str(r["refused"][1])


def test_paged_pool_sharding_covers_all_ranks(runs):
    ref, one, ranks = runs
    assert sorted(int(r["cache_rank"]) for r in ranks) == list(range(8))
    for r in ranks:
        assert int(r["pool_pages"]) == 1 + 1        # its page, the dump
        assert int(r["high_water"]) == 5            # ceil(19 / 4) pages
        np.testing.assert_array_equal(r["long"], ref["long"])
    np.testing.assert_array_equal(one["long"], ref["long"])
    # pages 0..4 of the chain live on cache ranks 0..4 and were written
    # there; the others were never touched
    written = {int(r["cache_rank"]) for r in ranks if bool(r["written"])}
    assert written == set(range(5))


def test_ssm_paged_serving_2x4_matches_1x1_and_oracle(runs):
    """mamba2 over 2x4: every rank's tokens equal the reference's 1x1
    engine and its contiguous Generator."""
    ref, _, ranks = runs
    np.testing.assert_array_equal(ref["ssm_engine"], ref["ssm_oracle"])
    for r in ranks:
        np.testing.assert_array_equal(r["ssm_tokens"], ref["ssm_oracle"])
