"""The kernel modules' launch counters, read and advanced together, and
the capture and replay of a step in a CUDA graph that keep them exact.

Each kernel module counts its wrappers' launches in module-level
``*LAUNCHES`` names (an int, or a dict of ints by engine).  A captured
CUDA graph launches its kernels on every replay without running the
wrappers' Python, so a step object captures its step through
``capture`` (which reads the counters over the capture and takes the
capture's change back) and replays it through ``replay`` (which adds
that change): the counts stay those of the launches the card ran.  The
step objects (``PagedStep``, ``TrainStep``, ``DecodeStep``) bind their
graph to the addresses of what it reads and writes (``addresses``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from repro_torch.core import instrument
from repro_torch.kernels import (flash_attention, grouped_matmul,
                                 paged_attention, stencil)

#: the kernel modules whose module-level ``*LAUNCHES`` counters a replay
#: advances by what its capture recorded
COUNTED = (flash_attention, grouped_matmul, paged_attention, stencil)


def launch_counts() -> dict[tuple, int]:
    """Every kernel launch counter: (module, name, key or None) -> count
    (a dict counter, such as launches by engine, per key)."""
    out = {}
    for mod in COUNTED:
        for name, val in vars(mod).items():
            if not name.endswith("LAUNCHES"):
                continue
            if isinstance(val, dict):
                out.update({(mod, name, k): n for k, n in val.items()})
            else:
                out[(mod, name, None)] = val
    return out


def add_launches(delta: dict[tuple, int]) -> None:
    """Add ``delta`` (``launch_counts``' keys) to the counters."""
    for (mod, name, key), n in delta.items():
        if key is None:
            setattr(mod, name, getattr(mod, name) + n)
        else:
            getattr(mod, name)[key] += n


def change_since(before: dict[tuple, int]) -> dict[tuple, int]:
    """The counters' change since ``before`` (a ``launch_counts()``), the
    counters that did not move left out."""
    after = launch_counts()
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def addresses(tensors: Iterable[torch.Tensor]) -> tuple[int, ...]:
    """The tensors' data addresses: a captured graph reads and writes
    these, so a step is bound to them."""
    return tuple(t.data_ptr() for t in tensors)


def capture(run: Callable[[], Any], device: torch.device
            ) -> tuple[Any, torch.cuda.CUDAGraph, Any, dict[tuple, int]]:
    """``run()`` once eagerly on a side stream (a real step: it builds the
    kernels and warms the libraries, so no first-call work falls inside
    the capture), then captured in a CUDA graph on that stream, which
    runs nothing.  The launch counters are set back to where they were
    before the capture.  Returns (the eager run's result, the graph, the
    captured run's result: static tensors every replay overwrites, the
    counters' change over one step, for ``replay``).  A failed capture
    raises, and so does a capture under an ``instrument`` recorder, which
    would see one captured step for every replay."""
    if instrument.ACTIVE is not None:
        raise RuntimeError("a recorder would see one captured step for "
                           "every replay")
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        first = run()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = run()
    launches = change_since(before)
    add_launches({k: -n for k, n in launches.items()})
    return first, graph, out, launches


def replay(graph: torch.cuda.CUDAGraph, launches: dict[tuple, int]) -> None:
    """One replay of ``graph``, and the launches it holds (``capture``'s
    count) added to the kernels' counters."""
    graph.replay()
    add_launches(launches)
