"""The frozen work counts against counts made by hand, and against the
program's own count of the paged kernel's bytes as it stood when the
benchmark was defined."""

import pytest

from portbench import work

from repro_torch.kernels import paged_attention


def test_paged_and_model_flops_by_hand():
    arch = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
            "head_dim": 2, "d_ff": 8, "vocab_size": 10}
    assert work.paged_bytes(10, 2, dict(arch, n_layers=2, head_dim=4), 2,
                            2) == 464
    assert work.matmul_params(arch) == (144, 40)
    # 5 tokens through 144 block parameters, 2 through the head's 40, and
    # 15 attended positions at 4 flops a head and unit of width
    assert work.serve_flops(arch, 5, 2, 15) == 2 * (144 * 5 + 40 * 2) + \
        4 * 2 * 2 * 15 == 1840


def test_least_time_takes_the_larger_bound():
    assert work.least_s(work.PEAK_BF16_FLOPS, 0) == pytest.approx(1.0)
    assert work.least_s(0, 2 * work.PEAK_HBM_BYTES) == pytest.approx(2.0)


@pytest.mark.parametrize("lens", [[1], [98, 205, 1024, 17], [2048] * 256])
def test_paged_bytes_equal_the_programs_less_the_page_table(lens):
    arch = {"n_layers": 1, "n_kv_heads": 8, "head_dim": 128}
    page = 16
    _, want = paged_attention.paged_work(lens, 0, 32, 8, 128, page, 2)
    table = 4 * len(lens) * max(1, -(-max(lens) // page))
    assert work.paged_bytes(sum(lens), len(lens), arch, 32, 2) == \
        want - table
