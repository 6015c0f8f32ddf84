"""The general traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that the functions here read.

A serving mix is a stream of requests, each a (prompt, output) length
pair and prompt token ids.  The lengths follow the mix's distribution
(``prompt`` and ``output``, log-normal with the mix's mean and shape, cut
to its bounds) in blocks of ``block`` requests: every block holds the same
lengths, the distribution's values at the midpoints of ``block`` equal
steps of probability, prompts and outputs paired by a permutation drawn
from ``pairing_seed``.  ``--seed`` orders each block and draws the token
ids, so every seed asks for the same work in another order and any stretch
of the stream holds nearly the same mix of lengths.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from statistics import NormalDist
from typing import Iterator

import numpy as np


def _rng(*parts) -> np.random.Generator:
    digest = hashlib.sha256("/".join(map(str, parts)).encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The log-normal ``dist``'s values at the midpoints of ``n`` equal
    steps of probability, rounded (mean ``mean``, shape ``sigma``)."""
    sigma = dist["sigma"]
    mu = math.log(dist["mean"]) - sigma * sigma / 2
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.rint(np.exp(mu + sigma * z)).astype(np.int64)


def block_lengths(mix: dict) -> list[tuple[int, int]]:
    """The (prompt, output) lengths of every block, in a fixed order:
    prompts within ``prompt``'s bounds, outputs within ``output``'s lower
    bound and the room that ``max_seq`` leaves after the prompt."""
    n = mix["block"]
    p_lo, p_hi = mix["prompt"]["min"], mix["prompt"]["max"]
    prompts = np.clip(quantiles(mix["prompt"], n), p_lo, p_hi)
    outputs = quantiles(mix["output"], n)
    perm = _rng("pairing", mix["pairing_seed"]).permutation(n)
    return [(int(p), int(min(max(o, mix["output"]["min"]),
                             mix["max_seq"] - p)))
            for p, o in zip(prompts, outputs[perm])]


def serve_stream(mix: dict, vocab: int, seed: int
                 ) -> Iterator[tuple[np.ndarray, int]]:
    """The requests, (prompt token ids, output length), in the order they
    are sent: block after block, each in an order drawn from the seed."""
    lengths = block_lengths(mix)
    for b in itertools.count():
        order = _rng("order", seed, b).permutation(len(lengths))
        for j, i in enumerate(order):
            p, n = lengths[i]
            ids = _rng("ids", seed, b, j).integers(0, vocab, size=p)
            yield ids.astype(np.int32), n


def warmup_requests(mix: dict, vocab: int, seed: int
                    ) -> list[tuple[np.ndarray, int]]:
    """Short requests that fill every slot once before the window."""
    rng = _rng("warmup", seed)
    return [(rng.integers(0, vocab, size=mix["warmup_prompt"]).astype(
        np.int32), mix["warmup_output"]) for _ in range(mix["slots"])]
