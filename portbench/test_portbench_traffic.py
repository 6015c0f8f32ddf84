"""The traffic generator: a seed repeats exactly, and every seed asks for
the same work in another order."""

import itertools

import numpy as np
import pytest

from portbench import harness, traffic


def _mix():
    spec = harness.load_spec()
    return harness.cell_inputs(spec, "phi4-serve-chat")[2]


def _take(mix, seed, n, vocab=200064):
    return list(itertools.islice(traffic.serve_stream(mix, vocab, seed), n))


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_019])
def test_the_stream_repeats_exactly(seed):
    mix = _mix()
    a, b = _take(mix, seed, 100), _take(mix, seed, 100)
    for (pa, na), (pb, nb) in zip(a, b):
        assert na == nb and np.array_equal(pa, pb)
        assert pa.dtype == np.int32 and pa.min() >= 0 and pa.max() < 200064


def test_every_seed_asks_for_the_same_lengths_block_by_block():
    mix = _mix()
    n = mix["block"]
    want = sorted(traffic.block_lengths(mix))
    for seed in (1, 2**31 + 5):
        got = [(len(p), o) for p, o in _take(mix, seed, 3 * n, vocab=1000)]
        for b in range(3):
            assert sorted(got[b * n:(b + 1) * n]) == want
    order = [[(len(p), o) for p, o in _take(mix, s, n, vocab=1000)]
             for s in (1, 2)]
    assert order[0] != order[1]
    a, b = (_take(mix, s, 1, vocab=1000)[0][0] for s in (1, 2))
    assert not np.array_equal(a, b)


def test_the_lengths_follow_the_mix_and_fit_its_bounds():
    mix = _mix()
    lengths = traffic.block_lengths(mix)
    prompts = np.array([p for p, _ in lengths])
    outs = np.array([o for _, o in lengths])
    assert prompts.min() >= mix["prompt"]["min"]
    assert prompts.max() <= mix["prompt"]["max"]
    assert outs.min() >= mix["output"]["min"]
    assert (prompts + outs).max() <= mix["max_seq"]
    # heavy tails: the mean well above the median; means near the source's
    for xs, dist in ((prompts, mix["prompt"]), (outs, mix["output"])):
        assert xs.mean() > 1.3 * np.median(xs)
        assert abs(xs.mean() - dist["mean"]) < 0.1 * dist["mean"]


def test_log_normal_quantiles_by_hand():
    # sigma 0: every quantile is the mean
    assert traffic.quantiles({"mean": 100.0, "sigma": 0.0}, 4).tolist() == \
        [100] * 4
    got = traffic.quantiles({"mean": 100.0, "sigma": 1.0}, 2)
    # the quartiles of exp(mu + z), mu = ln 100 - 1/2
    assert got.tolist() == [int(round(100 * np.exp(-0.5 + z)))
                            for z in (-0.6744897501960817,
                                      0.6744897501960817)]
