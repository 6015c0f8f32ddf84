"""The port's paged decode attention held against the reference's.

On the CPU the wrapper takes the plain PyTorch version; it must equal the
reference's jnp engine and its Pallas kernel (in interpret mode) on
randomized page tables, including lens == 0 slots and garbage table
entries past lens.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_paged
from repro.kernels.flash_attention import (finalize_partials as
                                           ref_finalize,
                                           merge_partials as ref_merge)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as paged

TOL = 1e-5   # f32 on both sides; sums differ only in order


def _inputs(rng, b, h, kvh, hd, page, pmax, npool):
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = rng.integers(0, page * pmax + 1, size=b).astype(np.int32)
    lens[0] = 0                                   # an empty slot
    lens[-1] = max(1, lens[-1] // 2)              # leaves unused columns
    # entries past ceil(lens/page) may hold any in-range id
    for i in range(b):
        used = -(-int(lens[i]) // page)
        table[i, used:] = rng.integers(0, npool, size=pmax - used)
    return q, kp, vp, table, lens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,kvh,hd,page,pmax", [
    (8, 2, 32, 8, 5),     # GQA 4:1
    (4, 4, 16, 4, 7),     # MHA, small pages
    (8, 1, 64, 16, 3),    # MQA
    (32, 8, 128, 16, 4),  # phi4-mini's head geometry
])
@pytest.mark.parametrize("window", [0, 9])
def test_plain_matches_reference_engines(h, kvh, hd, page, pmax, window):
    rng = np.random.default_rng(h * 100 + page + window)
    q, kp, vp, table, lens = _inputs(rng, 4, h, kvh, hd, page, pmax, 32)
    before = paged.LAUNCHES
    got = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                                window=window)
    assert paged.LAUNCHES == before     # a CPU tensor never launches
    want_jnp = ref_paged.paged_attention_jnp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window)
    want_pal = ref_paged.paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)   # lens == 0


def edge_inputs(rng, window):
    """lens past the table's reach (pmax * page) and page ids outside the
    pool inside a chain: only the positions the table names are attended,
    and an out-of-pool page contributes nothing."""
    b, h, kvh, hd, page, pmax, npool = 4, 8, 2, 32, 8, 3, 16
    q, kp, vp, table, _ = _inputs(rng, b, h, kvh, hd, page, pmax, npool)
    lens = np.array([page * pmax + 5, page * pmax + 40, 20, 17], np.int32)
    table[1, 1] = npool + 3
    table[2, 0] = -1
    table[3, :] = npool                    # every page outside the pool
    return q, kp, vp, table, lens, window


@pytest.mark.parametrize("window", [0, 12])
def test_plain_matches_reference_on_edge_inputs(window):
    q, kp, vp, table, lens, window = edge_inputs(
        np.random.default_rng(11), window)
    got = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                                window=window)
    want = ref_paged.paged_attention_jnp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got[3].numpy(), 0.0)


def test_partials_shard_merge():
    """Partials over disjoint pool shards LSE-merge to the full result —
    the distributed flash-decoding contract — and equal the reference's
    partials shard by shard."""
    rng = np.random.default_rng(3)
    b, h, kvh, hd, page, pmax, npool = 2, 4, 2, 16, 4, 6, 16
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = np.array([17, 23], np.int32)
    full = paged.paged_attention_torch(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(lens))
    parts, ref_parts = [], []
    for o in (0, 4, 8, 12):
        parts.append(paged.paged_attention_partials_torch(
            _t(q), _t(kp[o:o + 4]), _t(vp[o:o + 4]), _t(table), _t(lens),
            pool_offset=o))
        ref_parts.append(ref_paged.paged_attention_partials_jnp(
            jnp.asarray(q), jnp.asarray(kp[o:o + 4]),
            jnp.asarray(vp[o:o + 4]), jnp.asarray(table),
            jnp.asarray(lens), pool_offset=o))
    acc, ref_acc = parts[0], ref_parts[0]
    for p, rp in zip(parts[1:], ref_parts[1:]):
        acc = fa.merge_partials(acc, p)
        ref_acc = ref_merge(ref_acc, rp)
    out, lse = fa.finalize_partials(*acc, out_dtype=torch.float32)
    ref_out, ref_lse = ref_finalize(*ref_acc, out_dtype=jnp.float32)
    np.testing.assert_allclose(out[:, 0].numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=TOL, atol=TOL)


def test_empty_partials_are_the_merge_identity():
    rng = np.random.default_rng(5)
    part = (torch.from_numpy(rng.normal(size=(2, 1, 4)).astype(np.float32)),
            torch.from_numpy(rng.random(size=(2, 1, 4)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 1, 4, 8))
                             .astype(np.float32)))
    merged = fa.merge_partials(
        fa.init_partials(2, 1, 4, 8, device="cpu"), part)
    for got, want in zip(merged, part):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_malformed_inputs():
    rng = np.random.default_rng(6)
    q, kp, vp, table, lens = _inputs(rng, 2, 4, 2, 8, 4, 3, 8)
    with pytest.raises(ValueError):
        paged.paged_attention(_t(q[:, :3]), _t(kp), _t(vp), _t(table),
                              _t(lens))                 # 3 heads over 2 kv
    with pytest.raises(TypeError):
        paged.paged_attention(_t(q), _t(kp), _t(vp),
                              _t(table.astype(np.int64)), _t(lens))
    with pytest.raises(ValueError):
        paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                              engine="pallas")
