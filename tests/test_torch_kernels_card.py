"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA card (a hand-written CUDA kernel has no CPU
mode) and skip without one.  The file imports neither jax nor the
reference, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as paged


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _paged_inputs(rng, b, h, kvh, hd, page, pmax, npool):
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = rng.integers(0, page * pmax + 1, size=b).astype(np.int32)
    lens[:4] = 0, 1, page, 2 * page               # empty, 1, page edges
    for i in range(b):                            # garbage past the chain
        used = -(-int(lens[i]) // page)
        table[i, used:] = rng.integers(0, npool, size=pmax - used)
    return q, kp, vp, table, lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh,window", [(32, 8, 0), (32, 8, 64),
                                          (48, 1, 0)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, h, kvh,
                                              window):
    """The kernel against the plain version in f32 on the same inputs
    (f32 atol 1e-4; bf16 atol/rtol 2e-2)."""
    rng = np.random.default_rng(h + window)
    arrs = _paged_inputs(rng, 8, h, kvh, 128, 16, 8, 80)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    for i in range(3):
        args[i] = args[i].to(dtype)
    before = paged.LAUNCHES
    got = paged.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == before + 1
    want = paged.paged_attention_torch(
        *[a.float() if i < 3 else a for i, a in enumerate(args)],
        window=window)
    rtol = 0.0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=tol)
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 12])
def test_paged_attention_kernel_matches_plain_on_edge_inputs(cuda, window):
    """lens past the table's reach and page ids outside the pool inside a
    chain: the kernel attends only what the plain version attends (f32,
    atol 1e-4) and reads nothing outside the table or the pool."""
    rng = np.random.default_rng(11)
    page, pmax, npool = 8, 3, 16
    q, kp, vp, table, _ = _paged_inputs(rng, 4, 8, 2, 32, page, pmax, npool)
    lens = np.array([page * pmax + 5, page * pmax + 40, 20, 17], np.int32)
    table[1, 1] = npool + 3
    table[2, 0] = -1
    table[3, :] = npool
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, table, lens)]
    got = paged.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    want = paged.paged_attention_torch(*args, window=window)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-4)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.gpu
def test_paged_attention_kernel_rejects_noncontiguous(cuda):
    rng = np.random.default_rng(0)
    arrs = _paged_inputs(rng, 8, 32, 8, 128, 16, 4, 40)
    q, kp, vp, table, lens = [torch.from_numpy(a).to(cuda) for a in arrs]
    with pytest.raises(ValueError):
        paged.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                              kp, vp, table, lens)
