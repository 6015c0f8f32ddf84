"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in float8 put in the program's place) and each
fault a serving cell on one card can have (a step that leaves its state
unchanged, half the batch left out, a token altered where it is made),
planted under a whole run of a test-size cell on the CPU, with the
cell's own limit."""

import contextlib

import pytest
import torch

from portbench import check, tiny

from repro_torch.models.model import Model


@contextlib.contextmanager
def patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _stale(orig):
    """A decode step that leaves the cache as it found it."""
    def step(self, cache, *args):
        nxt, _ = orig(self, {k: v.clone() for k, v in cache.items()}, *args)
        return nxt, cache
    return step


def _half(orig):
    """A decode step that serves the first half of the slots only."""
    def step(self, cache, table, token, pos, active):
        nxt, cache = orig(self, cache, table, token, pos, active)
        keep = torch.arange(len(nxt)) < len(nxt) // 2
        return torch.where(keep, nxt, torch.zeros_like(nxt)), cache
    return step


def _altered(orig):
    """A decode step that produces another token wherever a slot's
    position is 3 past a multiple of 7."""
    def step(self, cache, table, token, pos, active):
        nxt, cache = orig(self, cache, table, token, pos, active)
        bump = (pos % 7 == 3).to(nxt.dtype)
        return (nxt + bump) % self.cfg.vocab_size, cache
    return step


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
def test_a_serving_fault_is_not_correct(fault):
    with patched(Model, "decode_step_paged", fault):
        line, _ = tiny.run("phi4-serve-chat", seed=3)
    assert not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > \
        line["checks"]["logit_gap"]["limit"]


def test_the_serving_control_is_not_correct():
    cell, conf, mix = tiny.confs("float32")["phi4-serve-chat"]
    line, _ = tiny.run("phi4-serve-chat", seed=3)
    assert line["correct"]
    # the float8 reference's first tokens at the served positions
    from portbench import harness
    import time
    rc = harness.RunContext(cell=cell, conf=conf, mix=mix, seed=3,
                            seconds=tiny.SECONDS, trace=False,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter())
    res = harness.runner(mix).run(rc)
    got = check.serve_gaps(conf["arch"], 3, rc.device, res["sample"],
                           control=True)
    assert got["control_gap"] > conf["limits"]["serve_closed"]["logit_gap"]
