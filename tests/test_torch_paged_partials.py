"""The paged decode's partials entry (``paged_attention_partials``) on the
CPU: the sharded paged decode's path (``models/attention.py``, a pool
over more than one cache shard) through the entry, held to the plain
version and the reference.

  * on CPU tensors the entry is the plain version bit for bit, at pool
    offsets that cut each slot's chain between two ranks' halves of the
    pool, with and without a window;
  * two ranks' partials LSE-merge to the unsharded output (the plain
    paged attention over the whole pool) and equal the reference's
    ``paged_attention_partials_jnp`` rank by rank (f32, 1e-5);
  * ``engine="torch"`` pins the plain version; on meta tensors under a
    recorder the entry is one ``paged_attention`` launch of
    ``paged_work``, and outside one it raises.

The card's kernel (both engines) is held to the plain partials by
``tests/test_torch_kernels_card.py`` (``test_paged_partials_*``) and
``chip_smoke.py`` phase 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_paged
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as paged
from repro_torch.launch import hlo

TOL = 1e-5
B, H, KV, HD, PAGE, PMAX, NPOOL = 4, 8, 2, 16, 4, 6, 24


def _inputs(seed):
    """q, pools of NPOOL pages, a table of distinct GLOBAL ids whose chains
    cross the two halves of the pool, and lens (one empty slot)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kp = rng.normal(size=(NPOOL, PAGE, KV, HD)).astype(np.float32)
    vp = rng.normal(size=(NPOOL, PAGE, KV, HD)).astype(np.float32)
    table = rng.permutation(NPOOL)[:B * PMAX].reshape(B, PMAX) \
        .astype(np.int32)
    lens = np.array([0, 5, 17, PAGE * PMAX], np.int32)
    return q, kp, vp, table, lens


def _halves(arrs, window):
    """Each rank's (pool offset, partials of the plain version, of the
    entry) over its half of the pool."""
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in arrs)
    half = NPOOL // 2
    out = []
    for off in (0, half):
        args = (q, kp[off:off + half], vp[off:off + half], table, lens)
        out.append((off,
                    paged.paged_attention_partials_torch(
                        *args, window=window, pool_offset=off),
                    paged.paged_attention_partials(
                        *args, window=window, pool_offset=off)))
    return out


@pytest.mark.parametrize("window", [0, 7])
def test_entry_is_the_plain_version_on_the_cpu(window):
    arrs = _inputs(window)
    # every slot with two or more pages has pages in both halves
    owner = arrs[3] >= NPOOL // 2
    assert owner[:, :2].any(axis=1).any() and (~owner[:, :2]).any()
    for _, want, got in _halves(arrs, window):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w)


@pytest.mark.parametrize("window", [0, 7])
def test_two_ranks_partials_merge_to_the_unsharded_output(window):
    arrs = _inputs(10 + window)
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in arrs)
    full = paged.paged_attention_torch(q, kp, vp, table, lens, window=window)
    (off0, _, p0), (off1, _, p1) = _halves(arrs, window)
    merged = fa.merge_partials(p0, p1)
    out, _ = fa.finalize_partials(*merged, out_dtype=torch.float32)
    np.testing.assert_allclose(out[:, 0].numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(out[0].numpy(), 0.0)    # lens 0
    half = NPOOL // 2
    for off, got in ((off0, p0), (off1, p1)):
        want = ref_paged.paged_attention_partials_jnp(
            jnp.asarray(arrs[0]), jnp.asarray(arrs[1][off:off + half]),
            jnp.asarray(arrs[2][off:off + half]), jnp.asarray(arrs[3]),
            jnp.asarray(arrs[4]), window=window, pool_offset=off)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)


def test_a_slot_with_no_page_in_the_pool_is_an_empty_partial():
    arrs = _inputs(3)
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in arrs)
    # an offset past every id: nothing of the table lies in this pool
    m, l, acc = paged.paged_attention_partials(q, kp, vp, table, lens,
                                               pool_offset=NPOOL)
    assert torch.equal(m, torch.full_like(m, fa.NEG_INF))
    assert torch.equal(l, torch.zeros_like(l))
    assert torch.equal(acc, torch.zeros_like(acc))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_entry_on_meta_counts_one_paged_launch():
    q, pages = _meta(3, 4, 64), _meta(10, 8, 2, 64)
    table, lens = _meta(3, 5, dtype=torch.int32), _meta(3, dtype=torch.int32)
    counter = hlo.count(lambda: paged.paged_attention_partials(
        q, pages, pages, table, lens, window=24, pool_offset=10))
    assert counter.launches() == {"paged_attention": 1}
    assert counter.ops == 0
    assert (counter.flops, counter.hbm_bytes) == paged.paged_work(
        [40] * 3, 24, 4, 2, 64, 8, 2)
    with pytest.raises(RuntimeError, match="meta"):
        paged.paged_attention_partials(q, pages, pages, table, lens)


def test_engine_pin_and_checks():
    arrs = _inputs(5)
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in arrs)
    got = paged.paged_attention_partials(q, kp, vp, table, lens,
                                         engine="torch", pool_offset=2)
    want = paged.paged_attention_partials_torch(q, kp, vp, table, lens,
                                                pool_offset=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="engine"):
        paged.paged_attention_partials(q, kp, vp, table, lens,
                                       engine="pallas")
    with pytest.raises(TypeError, match="int32"):
        paged.paged_attention_partials(q, kp, vp, table.long(), lens)
