"""Device: the share of the traced slices in which no operation ran on the
card, while serving."""


def read(obs: dict, trace: dict) -> float | None:
    if trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (trace["window_s"] - trace["busy_s"]) / trace["window_s"]
