"""Kernels: the paged attention's least time over its profiled time in
the traced slices (the paged kernels and their merge kernel).  The least
time is the bytes that the slices' active slot-steps need: each attends
its position and those before it, reading their K and V once (from each
quantum's plan: a slot at ``pos`` for ``steps`` steps attends ``pos + 1``
.. ``pos + steps`` positions), at the card's peak bandwidth."""

from portbench import devtrace, work


def read(obs: dict, trace: dict) -> float | None:
    t = devtrace.time_of(trace, lambda n: "paged" in n)
    attended = slot_steps = 0
    for steps, pos in obs["plans"]:
        for n, p in zip(steps.tolist(), pos.tolist()):
            attended += n * p + n * (n + 1) // 2
            slot_steps += n
    if t <= 0 or slot_steps == 0:
        return None
    arch = obs["arch"]
    nbytes = work.paged_bytes(attended, slot_steps, arch, obs["hp"],
                              obs["itemsize"])
    flops = 4 * arch["n_layers"] * obs["hp"] * arch["head_dim"] * attended
    return 100.0 * work.least_s(flops, nbytes) / t
