"""What the algorithms need, counted from shapes, and the card's peaks.

The paged attention's bytes are a frozen copy of the kernel's own count
(``repro_torch.kernels.paged_attention.paged_work``) as it stood when the
benchmark was defined, so that a change to the program cannot move its
own yardstick: every input read once, every output written once.
"""

from __future__ import annotations

#: NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def paged_bytes(attended: int, slot_steps: int, arch: dict, hp: int,
                itemsize: int) -> int:
    """Bytes the paged attention of ``slot_steps`` active slot-steps that
    attend ``attended`` positions in all needs over all layers: the
    attended K and V read once, q read and the output written once, the
    length of each row read once (the page table's share is left out:
    its rows are a few words)."""
    kvh, hd = arch["n_kv_heads"], arch["head_dim"]
    per_layer = (attended * kvh * hd * 2 * itemsize
                 + slot_steps * (2 * hp * hd * itemsize + 4))
    return arch["n_layers"] * per_layer


def matmul_params(arch: dict) -> tuple[int, int]:
    """(parameters of the blocks' weight products a token meets, those of
    the output head) at the published head count."""
    d, h, kv, hd = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                    arch["head_dim"])
    per = 2 * d * h * hd + 2 * d * kv * hd + 3 * d * arch["d_ff"]
    return arch["n_layers"] * per, d * arch["vocab_size"]


def attention_flops(arch: dict, contexts: int) -> int:
    """Forward flops of the attention products of tokens that attend
    ``contexts`` positions in all (q.k and p.v, 2 each a multiply-add)."""
    return 4 * arch["n_layers"] * arch["n_heads"] * arch["head_dim"] * \
        contexts


def serve_flops(arch: dict, tokens: int, logits: int, contexts: int
                ) -> float:
    """Model flops of serving: ``tokens`` fed through the blocks,
    ``logits`` of them through the output head (the last prompt token and
    every output token but the last), attending ``contexts`` positions."""
    blocks, head = matmul_params(arch)
    return 2.0 * (blocks * tokens + head * logits) + attention_flops(
        arch, contexts)
