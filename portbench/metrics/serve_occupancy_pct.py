"""Scheduler: useful slot-steps (the engine's ``note_quantum`` hook) over
slots times the decode steps that the window's quanta ran."""


def read(obs: dict, trace: dict) -> float | None:
    steps = sum(int(s.max(initial=0)) for s, _ in obs["window_plans"])
    if steps <= 0:
        return None
    return 100.0 * obs["useful"] / (obs["slots"] * steps)
