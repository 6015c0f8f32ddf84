"""Serving steps and the generation loop (port of
``repro.train.serve_loop``).

``build_decode_step`` / ``build_prefill_step`` are the per-rank
counterparts of the reference's jitted SPMD steps over this rank's
parameters (the model holds them), with no ``smap`` — the dry run
(launch/dryrun.py) counts them on abstract tensors.  The decode step is
a ``DecodeStep``: called as ``step(cache, token, pos)`` it is one step
on the caller's cache; driven by ``Generator`` it owns the cache and its
plan, and on one card it runs each token as one replay of a captured
CUDA graph, the port of the reference's ``jax.jit`` with a traced
position and a donated cache.  The prefill stays eager: it runs once a
prompt, and every prompt length would be a graph of its own.

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
from repro_torch.core import instrument
from repro_torch.kernels import counters
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import Model, flatten_specs
from repro_torch.serve.engine import PlanBuffer, ServeEngine


def _cache_leaves(cache: dict | list) -> list[torch.Tensor]:
    entries = cache if isinstance(cache, list) else [cache]
    return [t for e in entries for _, t in sorted(e.items())]


class DecodeStep:
    """The contiguous decode step: the port of the reference's jitted,
    cache-donating ``build_decode_step`` (which makes it).

    ``step(cache, token [B], pos) -> (next_token [B], cache)`` is one
    greedy step on the caller's cache, written in place, issued from
    Python (the dry run counts it so).  ``Generator`` drives the step on
    its own state instead:

      * the contiguous cache, allocated at the first ``load`` and zeroed
        by every ``load`` (the reference starts every generation from a
        zero cache);
      * int32 plan buffers in one ``PlanBuffer``: ``prompt`` [B, W], its
        length ``n_in`` [1], the step counter ``t`` [1], the position
        ``pos`` [] and the last sample ``last`` [B]; the samples go to
        ``out`` [B, W].  W is the shape's sequence length, or a longer
        generation's step count (then the buffers grow: a new binding).

    One step (``run_eager``) feeds ``prompt[:, t]`` while t < n_in and its
    last sample after, runs ``Model.decode_step`` at ``pos``, writes the
    sample to ``out[:, t]`` and advances ``t`` and ``pos``, all on the
    device, so it can be captured.  ``decode_mode`` says how ``advance``
    runs a step:

      * "graph" on a card where every mesh axis has size 1 and no
        ``instrument`` recorder is active: the binding's first step runs
        eagerly on a side stream and is then captured (``capture``);
        every later step is one ``replay``.  The binding is the
        addresses of the parameters, the cache and the buffers, and the
        model's engine attributes; ``load`` drops the graph and its pool
        when it changes, as the reference compiles again for a new
        shape.  A failed capture raises;
      * "eager" elsewhere (the CPU, meta tensors, a mesh of processes,
        under a recorder): ``run_eager``."""

    def __init__(self, model: Model, shape: ShapeConfig):
        self.model = model
        self.shape = shape
        self.specs = model.decode_cache_specs(shape)
        self.cache: dict | list | None = None
        self._plan: PlanBuffer | None = None
        self.width = 0
        self._binding: tuple | None = None
        #: bindings made (a new binding captures again in graph mode)
        self.bindings = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        #: launch counters' change over one step, added on every replay
        self.replay_launches: dict[tuple, int] = {}
        #: steps ``advance`` ran, graphs captured and replays run: in
        #: graph mode every step is a capture (a binding's first) or a
        #: replay
        self.steps = self.captures = self.replays = 0

    def __call__(self, cache: dict | list, token: torch.Tensor,
                 pos: torch.Tensor | int) -> tuple[torch.Tensor,
                                                   dict | list]:
        return self.model.decode_step(cache, token, pos)

    @property
    def decode_mode(self) -> str:
        if (self.model.device.type == "cuda"
                and all(int(n) == 1
                        for n in self.model.ctx.axis_sizes.values())
                and instrument.ACTIVE is None):
            return "graph"
        return "eager"

    def _allocate(self, width: int) -> None:
        dev, b = self.model.device, self.shape.global_batch
        if self.cache is None:
            def zeros(entry):
                return {k: torch.zeros(s, dtype=dt, device=dev)
                        for k, (s, dt) in entry.items()}
            self.cache = ([zeros(e) for e in self.specs]
                          if isinstance(self.specs, list)
                          else zeros(self.specs))
        if width > self.width:
            self._plan = PlanBuffer([(b, width), (1,), (1,), (), (b,)], dev)
            (self.prompt, self.n_in, self.t, self.pos,
             self.last) = self._plan.views
            self.out = torch.zeros((b, width), dtype=torch.int32, device=dev)
            self.width = width

    def _binding_of(self) -> tuple:
        m = self.model
        return (counters.addresses(flatten_specs(m.params()).values()),
                counters.addresses(_cache_leaves(self.cache)),
                counters.addresses([self._plan.buf, self.out]),
                m.paged_engine, m.attn_engine, m.moe_engine,
                m.ctx.mdmp_mode)

    def load(self, prompt: np.ndarray | torch.Tensor, n_new: int,
             start_pos: int = 0) -> None:
        """Bind the step (a new binding drops the graph), zero the cache
        and fill the plan for a generation of ``n_new`` tokens after
        ``prompt`` [B, P] from position ``start_pos``: one H2D copy, and
        one device copy where ``prompt`` is already on the device."""
        b, p = prompt.shape
        if b != self.shape.global_batch:
            raise ValueError(f"{b} prompts; the cache holds "
                             f"{self.shape.global_batch}")
        if p < 1:
            raise ValueError("an empty prompt")
        self._allocate(max(self.shape.seq_len, p, p + n_new - 1))
        binding = self._binding_of()
        if binding != self._binding:
            self.release()
            self._binding = binding
            self.bindings += 1
        for leaf in _cache_leaves(self.cache):
            leaf.zero_()
        h_prompt, h_n_in, h_t, h_pos, h_last = self._plan.host()
        on_host = isinstance(prompt, np.ndarray)
        h_prompt[:] = 0
        if on_host:
            h_prompt[:, :p] = prompt
        h_n_in[:] = p
        h_t[:] = 0
        h_pos[...] = start_pos
        h_last[:] = 0
        self._plan.send()
        if not on_host:
            self.prompt[:, :p].copy_(prompt)

    def release(self) -> None:
        """Drop the captured graph and its memory pool; the next step in
        graph mode captures again."""
        self._binding = self.graph = None
        self.replay_launches = {}
        if self.model.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def run_eager(self) -> None:
        """One step from Python on the step's cache and buffers."""
        idx = self.t.long().clamp(max=self.width - 1).expand(
            self.last.shape[0], 1)
        tok = torch.where(self.t < self.n_in,
                          self.prompt.gather(1, idx)[:, 0], self.last)
        nxt, cache = self.model.decode_step(self.cache, tok, self.pos)
        if cache is not self.cache:
            raise RuntimeError("decode_step returned another cache")
        self.last.copy_(nxt)
        self.out.scatter_(1, idx, nxt[:, None])
        self.t.add_(1)
        self.pos.add_(1)

    def capture(self) -> None:
        """The binding's first step, run eagerly on a side stream, then
        the step captured in a CUDA graph (``counters.capture``): the
        state has advanced by one step.  A failed capture raises."""
        _, self.graph, _, self.replay_launches = counters.capture(
            self.run_eager, self.model.device)
        self.captures += 1

    def replay(self) -> None:
        """One step: the captured graph, its launches counted."""
        counters.replay(self.graph, self.replay_launches)
        self.replays += 1

    def advance(self, n: int) -> None:
        """``n`` steps in ``decode_mode``."""
        graph = self.decode_mode == "graph"
        for _ in range(n):
            self.steps += 1
            if not graph:
                self.run_eager()
            elif self.graph is None:
                self.capture()
            else:
                self.replay()

    def read(self, first: int, n: int,
             lead: torch.Tensor | None = None) -> np.ndarray:
        """The samples of steps [first, first + n) as [B, n] (after the
        tokens ``lead`` [B, k] on the device, where given): one D2H copy,
        which waits for the steps."""
        got = self.out[:, first:first + n]
        if lead is not None:
            got = torch.cat([lead.to(got.dtype), got], dim=1)
        return got.to("cpu", copy=True).numpy()


def build_decode_step(model: Model, shape: ShapeConfig
                      ) -> tuple[DecodeStep, dict | list]:
    """Returns (step, cache specs): the ``DecodeStep`` (``step(cache,
    token [B], pos) -> (next_token [B], cache)``, one greedy decode step
    against this rank's CONTIGUOUS cache, written in place) and the
    cache's ``{name: (shape, dtype)}`` (``Model.decode_cache_specs``; a
    per-layer list for the hybrid family)."""
    step = DecodeStep(model, shape)
    return step, step.specs


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
        #: the contiguous engine's decode step, which owns its cache
        self.step = (build_decode_step(model, shape)[0]
                     if engine == "contiguous" else None)

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
        specs = self.step.specs
        if isinstance(specs, list):
            return [zeros(e) for e in specs]
        return zeros(specs)

    def generate(self, prompt_tokens: np.ndarray, n_new: int,
                 start_pos: int = 0) -> np.ndarray:
        """Greedy generation: feeds the prompt [B, P] token by token through
        the decode path from position ``start_pos`` (prompt prefill via
        decode — exercises the cache writes), then returns the ``n_new``
        sampled tokens [B, n_new].  The steps run through ``self.step``
        (CUDA graph replays on one card); the tokens come back in one
        copy.  An audio model's cross-attention attends the zeroed encoder
        K/V, as the reference's."""
        if self.engine == "paged":
            return self._generate_paged(prompt_tokens, n_new)
        b, p = prompt_tokens.shape
        if n_new < 1:
            return np.zeros((b, 0), np.int32)
        st = self.step
        st.load(prompt_tokens.astype(np.int32), n_new, start_pos)
        st.advance(p + n_new - 1)
        return st.read(p - 1, n_new)

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
        cache fills the step's contiguous cache in place (the K/V of [L,
        B, P, KV, hd], each layer's into its window's ring buffer; the SSM
        state and conv ring; the encoder output through each decoder
        layer's cross-attention K/V), the first new token is the greedy
        pick of its last-position ``logits``, and ``n_new - 1`` decode
        steps follow from position P through ``self.step``.
        ``prompt_len`` is P where the cache holds no K/V (the SSM family).
        Returns the ``n_new`` tokens [B, n_new] — the tokens ``generate``
        gives for the same prompt, without feeding the prompt through the
        decode path."""
        if self.engine != "contiguous":
            raise ValueError("generate_from_prefill continues into the "
                             "contiguous cache")
        model = self.model
        if attention.cache_shards(model.ctx) != 1:
            raise ValueError("generate_from_prefill fills one cache shard; "
                             "over a mesh, generate() feeds the prompt "
                             "through the sharded decode")
        kv, ssm_state = prefill.get("kv"), prefill.get("ssm")
        enc_out = prefill.get("enc_out")
        p = kv[0].shape[2] if kv is not None else int(prompt_len or 0)
        tok = layers.greedy_sample(logits, model.ctx)
        st = self.step
        st.load(tok[:, None], n_new, start_pos=p)
        cache = st.cache
        xkv = model.encoder_kv(enc_out) if enc_out is not None else None
        for i in range(model.cfg.n_layers):
            layer = transformer._cache_layer(cache, i)
            if kv is not None:
                s_cache = layer["k"].shape[1]
                if transformer.layer_window(model.cfg, i):
                    keep = torch.arange(max(0, p - s_cache), p)  # the ring
                elif p + n_new - 1 > s_cache:
                    raise ValueError(f"{p} prompt and {n_new} new tokens "
                                     f"exceed the {s_cache}-position cache")
                else:
                    keep = torch.arange(p)
                slots = (keep % s_cache).to(kv[0].device)
                keep = keep.to(kv[0].device)
                layer["k"][:, slots] = kv[0][i][:, keep].to(layer["k"].dtype)
                layer["v"][:, slots] = kv[1][i][:, keep].to(layer["v"].dtype)
            if ssm_state is not None:
                h, conv = ssm_state[0][i], ssm_state[1][i]
                di = layer["ssm_conv_x"].shape[-1]
                layer["ssm_h"].copy_(h)
                layer["ssm_conv_x"].copy_(conv[..., :di])
                layer["ssm_conv_bc"].copy_(conv[..., di:])
            if xkv is not None:
                f = xkv[0].shape[2]
                layer["xk"][:, :f] = xkv[0][i]
                layer["xv"][:, :f] = xkv[1][i]
        st.advance(n_new - 1)
        return st.read(0, max(n_new - 1, 0), lead=tok[:, None])

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
