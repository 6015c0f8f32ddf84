"""Deterministic, resumable synthetic LM data pipeline (a copy of
``repro.data.pipeline``, which is plain numpy but lives under ``repro``,
whose package imports jax).

Production posture without external data dependencies: batches are a pure
function of (seed, step), so
  * every host materialises exactly its shard (no cross-host data traffic),
  * resuming from step k reproduces the uninterrupted stream bit-for-bit
    (checkpoint/restart tests rely on this),
  * elastic restarts on a different mesh re-slice the same global stream.

The token stream is a stationary Markov-ish mixture so the LM loss has
learnable structure (quickstart/train_100m show it falling).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_patterns: int = 64          # learnable repeated n-gram patterns
    pattern_len: int = 16


class SyntheticLMData:
    """state = just the step counter (plus config); see module docstring."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = max(cfg.vocab_size - 1, 2)
        self._patterns = rng.integers(
            0, v, size=(cfg.n_patterns, cfg.pattern_len), dtype=np.int32)

    def global_batch_at(self, step: int) -> dict:
        """Full global batch for ``step`` (tokens + next-token labels)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        n_pat = (s + cfg.pattern_len - 1) // cfg.pattern_len + 1
        idx = rng.integers(0, cfg.n_patterns, size=(b, n_pat))
        stream = self._patterns[idx].reshape(b, -1)[:, :s + 1]
        noise = rng.random((b, s + 1)) < 0.05
        rand_tok = rng.integers(0, max(cfg.vocab_size - 1, 2),
                                size=(b, s + 1), dtype=np.int32)
        stream = np.where(noise, rand_tok, stream).astype(np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def shard_at(self, step: int, shard: int, n_shards: int) -> dict:
        """This host's batch-dim shard of the global batch (pure function of
        (seed, step, shard) — no host ever builds another host's data)."""
        g = self.global_batch_at(step)
        b = self.cfg.global_batch
        if b % n_shards:
            raise ValueError(f"global batch {b} over {n_shards} shards")
        lo = shard * (b // n_shards)
        hi = lo + b // n_shards
        return {k: v[lo:hi] for k, v in g.items()}

    # -- checkpointable state ------------------------------------------------

    def state_dict(self, step: int) -> dict:
        return {"seed": self.cfg.seed, "step": int(step)}

    @staticmethod
    def resume(cfg: DataConfig, state: dict) -> tuple["SyntheticLMData", int]:
        if state["seed"] != cfg.seed:
            raise ValueError("data seed mismatch on resume")
        return SyntheticLMData(cfg), int(state["step"])
