"""The comparison that decides ``correct``: what the timed path produced,
against the plain float32 reference (``reference/``), which makes the
weights and the inputs again from the seed and takes nothing from the
program.  Each number compared has its limit in the configuration file
(``limits``, by runner), set from the program's readings over a dozen
seeds and more and the control's (the reference with its weight products
in float8) as ``PERF.md`` records.

Serving: for a sample of finished requests, the reference runs once over
each prompt with its served tokens; ``logit_gap`` is the widest gap by
which a served token's reference logit lies below the reference's best
at that position (greedy tokens).
"""

from __future__ import annotations

import torch

from portbench.reference import weights as ref_weights
from portbench.reference.decoder import Decoder


def _reference(arch: dict, seed: int, device) -> Decoder:
    return Decoder(arch, ref_weights.make_all(arch, seed, device,
                                              torch.float32))


def serve_gaps(arch: dict, seed: int, device,
               sample: list[tuple[torch.Tensor, torch.Tensor]],
               control: bool = False) -> dict[str, float]:
    """``logit_gap`` of the served tokens of ``sample`` ([(prompt,
    served)]); with ``control``, also ``control_gap``: the widest gap of
    the token that the float8 reference puts first at the same
    positions."""
    if not sample:
        return {"logit_gap": float("inf")}
    ref = _reference(arch, seed, device)
    low = Decoder(arch, ref.w, lowp=True) if control else None
    widest, ctl = 0.0, 0.0
    for prompt, served in sample:
        seq = torch.cat([prompt, served[:-1]]).to(device)
        at = slice(len(prompt) - 1, len(seq))
        logits = ref.logits(seq)[at]
        best = logits.max(dim=-1).values
        got = logits.gather(1, served.to(device).long()[:, None])[:, 0]
        widest = max(widest, float((best - got).max()))
        if low is not None:
            pick = low.logits(seq)[at].argmax(dim=-1)
            ctl = max(ctl, float((best - logits.gather(
                1, pick[:, None])[:, 0]).max()))
        del logits
    out = {"logit_gap": widest}
    if control:
        out["control_gap"] = ctl
    return out


def judge(readings: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}})."""
    table = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
