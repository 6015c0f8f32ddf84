"""Serving steps and the generation loop (port of
``repro.train.serve_loop``).

``build_decode_step`` / ``build_prefill_step`` are the per-rank
counterparts of the reference's jitted SPMD steps: plain functions over
this rank's parameters (the model holds them), with no ``smap`` or
``jit`` — the dry run (launch/dryrun.py) counts them on abstract tensors.

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

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine


def build_decode_step(model: Model, shape: ShapeConfig
                      ) -> tuple[Callable, dict | list]:
    """Returns (step, cache specs): ``step(cache, token [B], pos) ->
    (next_token [B], cache)``, one greedy decode step against this rank's
    CONTIGUOUS cache (``Model.decode_step``, the cache written in place),
    and the cache's ``{name: (shape, dtype)}`` (``Model.
    decode_cache_specs``; a per-layer list for the hybrid family)."""
    def step(cache: dict | list, token: torch.Tensor, pos: int
             ) -> tuple[torch.Tensor, dict | list]:
        return model.decode_step(cache, token, pos)
    return step, model.decode_cache_specs(shape)


def build_prefill_step(model: Model) -> Callable:
    """Returns ``step(batch) -> (last-token logits [B_loc, V_loc], prefill
    cache)`` over this rank's batch rows (``Model.prefill_sp``)."""
    def step(batch: dict) -> tuple[torch.Tensor, dict]:
        return model.prefill_sp(batch)
    return step


class Generator:
    def __init__(self, model: Model, shape: ShapeConfig,
                 engine: str = "contiguous", **engine_kwargs: Any):
        if engine not in ("contiguous", "paged"):
            raise ValueError(f"unknown engine {engine!r}")
        self.model = model
        self.shape = shape
        self.engine = engine
        self.engine_kwargs = engine_kwargs

    def empty_cache(self) -> dict | list:
        """The zeroed contiguous decode cache on the model's device
        (stacked [L, ...] leaves, or a per-layer list for the hybrid
        family)."""
        if self.engine != "contiguous":
            raise ValueError("empty_cache is the contiguous decode cache; "
                             "the paged engine owns its pool")

        def zeros(entry):
            return {k: torch.zeros(shape, dtype=dt, device=self.model.device)
                    for k, (shape, dt) in entry.items()}
        specs = self.model.decode_cache_specs(self.shape)
        if isinstance(specs, list):
            return [zeros(e) for e in specs]
        return zeros(specs)

    def generate(self, prompt_tokens: np.ndarray,
                 n_new: int) -> np.ndarray:
        """Greedy generation: feeds the prompt [B, P] token by token through
        the decode path (prompt prefill via decode — exercises the cache
        writes), then returns the ``n_new`` sampled tokens [B, n_new].  An
        audio model's cross-attention attends the zeroed encoder K/V, as
        the reference's."""
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
    def prefill_generate(self, prompt_tokens: np.ndarray, n_new: int, *,
                         frames: np.ndarray | None = None,
                         patches: np.ndarray | None = None) -> np.ndarray:
        """Greedy generation after one ``prefill_sp`` of the prompt [B, P]
        (with the audio model's ``frames`` [B, F, D] or the vision model's
        ``patches`` [B, Np, D]): returns the ``n_new`` tokens [B, n_new]."""
        dev = self.model.device
        batch = {"tokens": torch.from_numpy(
            prompt_tokens.astype(np.int32)).to(dev)}
        for name, arr in (("frames", frames), ("patches", patches)):
            if arr is not None:
                batch[name] = torch.from_numpy(
                    np.asarray(arr, np.float32)).to(dev)
        logits, prefill = self.model.prefill_sp(batch)
        return self.generate_from_prefill(logits, prefill, n_new,
                                          prompt_len=prompt_tokens.shape[1])

    @torch.no_grad()
    def generate_from_prefill(self, logits: torch.Tensor, prefill: dict,
                              n_new: int, *,
                              prompt_len: int | None = None) -> np.ndarray:
        """Greedy generation that continues ``Model.prefill_sp``: its
        cache fills the contiguous cache (the K/V of [L, B, P, KV, hd],
        each layer's into its window's ring buffer; the SSM state and conv
        ring; the encoder output through each decoder layer's
        cross-attention K/V), the first new token is the greedy pick of
        its last-position ``logits``, and ``n_new - 1`` decode steps
        follow.  ``prompt_len`` is P where the cache holds no K/V (the
        SSM family).  Returns the ``n_new`` tokens [B, n_new] — the tokens
        ``generate`` gives for the same prompt, without feeding the prompt
        through the decode path."""
        if self.engine != "contiguous":
            raise ValueError("generate_from_prefill continues into the "
                             "contiguous cache")
        model = self.model
        if attention.cache_shards(model.ctx) != 1:
            raise ValueError("generate_from_prefill fills one cache shard; "
                             "over a mesh, generate() feeds the prompt "
                             "through the sharded decode")
        cache = self.empty_cache()
        kv, ssm_state = prefill.get("kv"), prefill.get("ssm")
        enc_out = prefill.get("enc_out")
        p = kv[0].shape[2] if kv is not None else int(prompt_len or 0)
        xkv = model.encoder_kv(enc_out) if enc_out is not None else None
        for i in range(model.cfg.n_layers):
            st = transformer._cache_layer(cache, i)
            if kv is not None:
                s_cache = st["k"].shape[1]
                if transformer.layer_window(model.cfg, i):
                    keep = torch.arange(max(0, p - s_cache), p)  # the ring
                elif p + n_new - 1 > s_cache:
                    raise ValueError(f"{p} prompt and {n_new} new tokens "
                                     f"exceed the {s_cache}-position cache")
                else:
                    keep = torch.arange(p)
                slots = (keep % s_cache).to(kv[0].device)
                keep = keep.to(kv[0].device)
                st["k"][:, slots] = kv[0][i][:, keep].to(st["k"].dtype)
                st["v"][:, slots] = kv[1][i][:, keep].to(st["v"].dtype)
            if ssm_state is not None:
                h, conv = ssm_state[0][i], ssm_state[1][i]
                di = st["ssm_conv_x"].shape[-1]
                st["ssm_h"].copy_(h)
                st["ssm_conv_x"].copy_(conv[..., :di])
                st["ssm_conv_bc"].copy_(conv[..., di:])
            if xkv is not None:
                f = xkv[0].shape[2]
                st["xk"][:, :f] = xkv[0][i]
                st["xv"][:, :f] = xkv[1][i]
        tok = layers.greedy_sample(logits, model.ctx)
        out = [tok]
        for i in range(n_new - 1):
            tok, cache = model.decode_step(cache, tok, p + i)
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
