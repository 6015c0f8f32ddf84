"""Model: the model flops of every token that the window's quanta fed
(prompt and output, at the published head count, attending its position
and those before it; the output head only for the output tokens it made)
over the window's wall time at the card's bf16 peak."""

from portbench import work


def read(obs: dict, trace: dict) -> float | None:
    tokens = contexts = 0
    for steps, pos in obs["window_plans"]:
        for n, p in zip(steps.tolist(), pos.tolist()):
            tokens += n
            contexts += n * p + n * (n + 1) // 2
    if tokens == 0 or obs["window_wall_s"] <= 0:
        return None
    flops = work.serve_flops(obs["arch"], tokens, obs["output_tokens"],
                             contexts)
    return 100.0 * flops / (obs["window_wall_s"] * work.PEAK_BF16_FLOPS)
