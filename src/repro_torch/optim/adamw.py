"""AdamW + gradient clipping + LR schedule (port of
``repro.optim.adamw``).

The arithmetic is the reference's, in f32 and in the same order.  The
reference returns new trees; the port updates parameters and moments IN
PLACE, in pieces of at most ``_PIECE`` elements along the leading dim
(one layer slice or less of a stacked leaf, a block of embedding rows):
the update's f32 temporaries of a whole ``layers/w_up`` of phi4-mini
([32, 3072, 8192], 3.2 GB per f32 copy) would not fit beside the model's
state on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.model import flatten_specs, unflatten_specs

#: elements updated at once (the f32 temporaries' size)
_PIECE = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(tree: Any) -> list[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (jax's tree order)."""
    return list(flatten_specs(tree).values())


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    dt = _DTYPES[cfg.moment_dtype]
    flat = flatten_specs(params)

    def zeros():
        return unflatten_specs({k: torch.zeros(p.shape, dtype=dt,
                                               device=p.device)
                                for k, p in flat.items()})

    device = next(iter(flat.values())).device if flat else "cpu"
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """LR at ``step`` (an int32 tensor) as an f32 tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm of a grad tree (one shard: the sum over the mesh of
    the reference is the identity)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in _leaves(grads)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 *, gnorm: torch.Tensor | None = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step, IN PLACE on ``params`` and ``state``.  ``gnorm`` may
    be precomputed (the train step builds a replication-aware norm).
    Returns (params, state, metrics)."""
    step = state["step"] + 1
    lr = cosine_schedule(step, cfg)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                         max=1.0)
             if cfg.clip_norm > 0 else torch.ones((), device=step.device))

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu32 = mu.float() * b1 + (1 - b1) * g
        nu32 = nu.float() * b2 + (1 - b2) * g * g
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))
        mu.copy_(mu32)
        nu.copy_(nu32)

    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state["mu"]), _leaves(state["nu"])):
        rows = max(1, _PIECE // max(1, p[0].numel())) if p.dim() else 1
        if p.dim() == 0 or rows >= p.shape[0]:
            upd(p, g, mu, nu)
            continue
        for i in range(0, p.shape[0], rows):
            upd(p[i:i + rows], g[i:i + rows], mu[i:i + rows],
                nu[i:i + rows])
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
