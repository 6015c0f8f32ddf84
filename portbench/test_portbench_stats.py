"""The end-to-end arithmetic on synthetic records: the rate is all the
window's tokens over all its time, tails are over every request that
finished in it, and a stall inside the window moves them."""

import pytest

from portbench.runners.serve_closed import p95, summarize


def test_p95_is_the_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95(list(range(1, 21))) == 19
    assert p95([3.0]) == 3.0
    assert p95([5, 1, 4, 2, 3]) == 5


def _records(n, stall_from=None, stall_s=0.0):
    """n requests of 11 tokens, sent at 0, first token after 0.1 s each
    in turn, 0.01 s a later token; a stall delays every request from
    ``stall_from`` on."""
    out = []
    for i in range(n):
        late = stall_s if stall_from is not None and i >= stall_from else 0.0
        first = 0.1 * (i + 1) + late
        out.append((11, 0.0, first, first + 10 * 0.01))
    return out


def test_rates_and_tails():
    got = summarize(_records(100), 1100, wall_s=10.0)
    assert got["serve_tok_s"] == pytest.approx(1100 / 10.0)
    assert got["ttft_p95_ms"] == pytest.approx(9500.0)
    assert got["tpot_p95_ms"] == pytest.approx(10.0)


def test_a_stall_in_the_window_moves_the_tail_and_the_rate():
    calm = summarize(_records(100), 1100, wall_s=10.0)
    # a 2 s stall before the last tenth of the requests: the window is 2 s
    # longer, and the tail of the time to the first token takes it whole
    stalled = summarize(_records(100, stall_from=90, stall_s=2.0), 1100,
                        wall_s=12.0)
    assert stalled["ttft_p95_ms"] == pytest.approx(calm["ttft_p95_ms"] + 2000)
    assert stalled["serve_tok_s"] < calm["serve_tok_s"]
    # a stall of the last 4% sits above the 95th percentile: no move there
    tail = summarize(_records(100, stall_from=96, stall_s=2.0), 1100,
                     wall_s=12.0)
    assert tail["ttft_p95_ms"] == pytest.approx(calm["ttft_p95_ms"])


def test_a_stall_between_tokens_moves_the_time_per_token():
    slow = [(n, s, f, d + (1.0 if i >= 90 else 0.0))
            for i, (n, s, f, d) in enumerate(_records(100))]
    got = summarize(slow, 1100, wall_s=11.0)
    assert got["tpot_p95_ms"] == pytest.approx((0.1 + 1.0) / 10 * 1e3)


def test_tokens_of_unfinished_requests_count_in_the_rate():
    # requests still running when the window closed made tokens in it, but
    # have no time to the first token or per token yet
    got = summarize(_records(10), 110 + 40, wall_s=2.0)
    assert got["serve_tok_s"] == pytest.approx(150 / 2.0)
    assert got["ttft_p95_ms"] == pytest.approx(1000.0)
