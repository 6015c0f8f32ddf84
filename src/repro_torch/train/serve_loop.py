"""Generation driver (port of the ``Generator`` of
``repro.train.serve_loop``).

Two engines behind one facade, with the same greedy tokens:

  * ``engine="contiguous"`` — a static-batch loop over
    ``Model.decode_step`` and the contiguous [L, B, S, KV, hd] cache, the
    numerical oracle of the serving runtime;
  * ``engine="paged"`` — the serving runtime (``serve.ServeEngine``):
    paged KV cache, per-slot positions, static waves so the contract is
    the same.  Extra ``ServeEngine`` knobs ride through
    ``engine_kwargs``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine


class Generator:
    def __init__(self, model: Model, shape: ShapeConfig,
                 engine: str = "contiguous", **engine_kwargs: Any):
        if engine not in ("contiguous", "paged"):
            raise ValueError(f"unknown engine {engine!r}")
        self.model = model
        self.shape = shape
        self.engine = engine
        self.engine_kwargs = engine_kwargs

    def empty_cache(self) -> dict:
        """The zeroed contiguous decode cache on the model's device."""
        if self.engine != "contiguous":
            raise ValueError("empty_cache is the contiguous decode cache; "
                             "the paged engine owns its pool")
        return {k: torch.zeros(shape, dtype=dt, device=self.model.device)
                for k, (shape, dt) in
                self.model.decode_cache_specs(self.shape).items()}

    def generate(self, prompt_tokens: np.ndarray,
                 n_new: int) -> np.ndarray:
        """Greedy generation: feeds the prompt [B, P] token by token through
        the decode path (prompt prefill via decode — exercises the cache
        writes), then returns the ``n_new`` sampled tokens [B, n_new]."""
        if self.engine == "paged":
            return self._generate_paged(prompt_tokens, n_new)
        dev = self.model.device
        cache = self.empty_cache()
        b, p = prompt_tokens.shape
        prompt = torch.from_numpy(prompt_tokens.astype(np.int32)).to(dev)
        out = []
        tok = prompt[:, 0]
        pos = 0
        for i in range(p + n_new - 1):
            nxt, cache = self.model.decode_step(cache, tok, pos)
            pos += 1
            if i + 1 < p:
                tok = prompt[:, i + 1]
            else:
                tok = nxt
                out.append(nxt)
        if not out:
            return np.zeros((b, 0), np.int32)
        return torch.stack(out, dim=1).cpu().numpy()

    @torch.no_grad()
    def generate_from_prefill(self, logits: torch.Tensor, prefill: dict,
                              n_new: int) -> np.ndarray:
        """Greedy generation that continues ``Model.prefill_sp``: its K/V
        ([L, B, P, KV, hd] each) fill the contiguous cache, the first new
        token is the greedy pick of its last-position ``logits``, and
        ``n_new - 1`` decode steps follow.  Returns the ``n_new`` tokens
        [B, n_new] — the tokens ``generate`` gives for the same prompt,
        without feeding the prompt through the decode path."""
        if self.engine != "contiguous":
            raise ValueError("generate_from_prefill continues into the "
                             "contiguous cache")
        if attention.cache_shards(self.model.ctx) != 1:
            raise ValueError("generate_from_prefill fills one cache shard; "
                             "over a mesh, generate() feeds the prompt "
                             "through the sharded decode")
        cache = self.empty_cache()
        k_pre, v_pre = prefill["kv"]
        p = k_pre.shape[2]
        s_cache = cache["k"].shape[2]
        if transformer.layer_window(self.model.cfg, 0):
            keep = torch.arange(max(0, p - s_cache), p)   # the ring buffer
        elif p + n_new - 1 > s_cache:
            raise ValueError(f"{p} prompt and {n_new} new tokens exceed the "
                             f"{s_cache}-position cache")
        else:
            keep = torch.arange(p)
        slots = (keep % s_cache).to(k_pre.device)
        keep = keep.to(k_pre.device)
        cache["k"][:, :, slots] = k_pre[:, :, keep].to(cache["k"].dtype)
        cache["v"][:, :, slots] = v_pre[:, :, keep].to(cache["v"].dtype)
        tok = layers.greedy_sample(logits, self.model.ctx)
        out = [tok]
        for i in range(n_new - 1):
            tok, cache = self.model.decode_step(cache, tok, p + i)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    def _generate_paged(self, prompt_tokens: np.ndarray,
                        n_new: int) -> np.ndarray:
        b = prompt_tokens.shape[0]
        kwargs = dict(slots=b, max_seq=self.shape.seq_len,
                      schedule="static")
        kwargs.update(self.engine_kwargs)
        eng = ServeEngine(self.model, **kwargs)
        rids = [eng.submit(prompt_tokens[i], n_new) for i in range(b)]
        results = eng.run()
        return np.stack([results[r] for r in rids], axis=0)
