"""Decode step: the device's busy time in the traced slices over the
decode steps run in them."""


def read(obs: dict, trace: dict) -> float | None:
    if obs["traced_steps"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 1e3 * trace["busy_s"] / obs["traced_steps"]
