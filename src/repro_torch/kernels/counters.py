"""The kernel modules' launch counters, read and advanced together.

Each kernel module counts its wrappers' launches in module-level
``*LAUNCHES`` names (an int, or a dict of ints by engine).  A captured
CUDA graph launches its kernels on every replay without running the
wrappers' Python, so a step object reads the counters over its capture
(``launch_counts``), takes the capture's change back and adds it on
every replay (``add_launches``): the counts stay those of the launches
the card ran.
"""

from __future__ import annotations

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
