"""Checkpointing: manifest-versioned npz, atomic commit, async save (port
of ``repro.checkpoint.ckpt``).

Layout:   <dir>/step_<k>/arrays.npz + manifest.json  (+ .tmp staging)

The format is the reference's: one npz of unsharded arrays keyed by tree
path ("params/layers/w_up", "opt/mu/embed", ...), bf16 widened to f32 with
its dtype recorded in the manifest, so a checkpoint of either package
carries the same keys, shapes and values.

Fault-tolerance contract:
  * atomic: the step directory is staged as ``.tmp`` and os.replace'd into
    place — a crash mid-save never corrupts the latest checkpoint, and
    ``latest_step`` only trusts directories whose manifest + arrays both
    landed;
  * async: ``save_async`` blocks the train loop only for an on-device
    snapshot (the next step updates the live tensors in place); the
    device->host drain then runs on a writer thread in chunks of
    ``drain_chunk_bytes``, followed by serialisation and the atomic
    commit.  Every save's (snapshot, drain, write) seconds and bytes land
    in checkpoint/metrics.py.
The snapshot is a second copy of the whole state on the device: at
phi4-mini's full width (bf16 parameters, f32 moments) that is 40 GB more,
which one card cannot hold beside the run (a host-side snapshot is open
work, ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.metrics import CheckpointMetrics
from repro_torch.models.model import flatten_specs, unflatten_specs
from repro_torch.obs.tracer import get_tracer

_STEP_RE = re.compile(r"^step_(\d+)$")

#: default drain chunk (64 MiB) when no metered size is configured
DEFAULT_DRAIN_CHUNK = 64 * 1024 * 1024

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array, recorded dtype): bf16 is widened to f32 — npz cannot hold
    it — and its dtype recorded."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    name = _DTYPE_NAMES[t.dtype]
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy(), name


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None
         ) -> str:
    """Synchronous checkpoint write with atomic commit."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "keys": []}
    for key, leaf in flatten_specs(tree).items():
        arr, dtype = _to_numpy(leaf)
        arrays[key] = arr
        manifest["keys"].append(
            {"key": key, "shape": list(arr.shape), "dtype": dtype})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def valid_steps(ckpt_dir: str) -> list[int]:
    """Committed checkpoint steps, ascending.  A directory only counts
    when both the manifest and the arrays landed — a crashed save's
    leftovers (``.tmp`` staging, a partial dir) are never trusted."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if not m:
            continue
        path = os.path.join(ckpt_dir, d)
        if (os.path.exists(os.path.join(path, "manifest.json"))
                and os.path.exists(os.path.join(path, "arrays.npz"))):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any,
            reshard: Callable[[str, np.ndarray], np.ndarray] | None = None
            ) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (nested dicts of tensors):
    new tensors of the recorded dtype on each ``like`` leaf's device.
    ``reshard(key, array)`` maps an array whose shape differs from its
    ``like`` leaf to this rank's block (an elastic resume: a checkpoint of
    whole arrays restored onto a larger mesh).  Raises on a missing key or
    a shape that still differs."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    dtypes = {k["key"]: k["dtype"] for k in manifest["keys"]}
    leaves = {}
    for key, leaf in flatten_specs(like).items():
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = arrays[key]
        if reshard is not None and tuple(arr.shape) != tuple(leaf.shape):
            arr = np.ascontiguousarray(reshard(key, arr))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt {arr.shape} vs model "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(arr).to(_NAMED_DTYPES[dtypes[key]])
        leaves[key] = t.to(leaf.device)
    return unflatten_specs(leaves), manifest["extra"]


def restore_latest(ckpt_dir: str, like: Any,
                   reshard: Callable[[str, np.ndarray], np.ndarray]
                   | None = None) -> tuple[Any, dict, int] | None:
    """Restore the newest readable checkpoint, falling back step by step
    past corrupt ones (a truncated shard passes the directory check but
    fails the load).  A corrupt directory is quarantined (renamed
    ``*.corrupt``) so it is never retried and the next GC removes it.
    Returns (tree, extra, step) or None."""
    for step in reversed(valid_steps(ckpt_dir)):
        try:
            tree, extra = restore(ckpt_dir, step, like, reshard)
            return tree, extra, step
        except Exception:               # noqa: BLE001 — fallback path
            bad = os.path.join(ckpt_dir, f"step_{step:08d}")
            try:
                os.replace(bad, bad + ".corrupt")
            except OSError:
                shutil.rmtree(bad, ignore_errors=True)
    return None


# ---------------------------------------------------------------------------
# Async manager: on-device snapshot -> metered drain -> atomic write
# ---------------------------------------------------------------------------


def _drain_leaf(x: Any, chunk_bytes: int) -> Any:
    """Pull one leaf to host in <= ``chunk_bytes`` pieces, so no single
    device->host copy holds the stream longer than the metered budget."""
    if not isinstance(x, torch.Tensor):
        return x
    nbytes = x.numel() * x.element_size()
    if x.dim() == 0 or nbytes <= chunk_bytes:
        return x.cpu()
    rows_per = max(1, int(chunk_bytes // max(1, nbytes // x.shape[0])))
    return torch.cat([x[i:i + rows_per].cpu()
                      for i in range(0, x.shape[0], rows_per)])


class CheckpointManager:
    """Async saves + retention.  ``wait()`` before reading a checkpoint
    back or exiting.

    ``save_async`` blocks only for the on-device snapshot copy; the drain +
    write ride the writer thread.  ``drain_chunk_bytes`` meters the D2H
    chunking; ``metrics`` collects the per-save counters."""

    def __init__(self, ckpt_dir: str, keep: int = 3, *,
                 metrics: CheckpointMetrics | None = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.metrics = metrics or CheckpointMetrics()
        self.drain_chunk_bytes = DEFAULT_DRAIN_CHUNK
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        self.wait()
        # the ambient tracer, captured here: the writer thread emits its
        # drain/commit spans on the same ring
        tr = get_tracer()
        t0 = time.perf_counter()
        with tr.span("ckpt.snapshot", track="ckpt", step=step,
                     buffer="ckpt_snapshot"):
            snap = [(k, v.detach().clone() if isinstance(v, torch.Tensor)
                     else v) for k, v in flatten_specs(tree).items()]
            # the snapshot must be complete before the caller's next step
            # updates the live tensors in place
            for _, v in snap:
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    torch.cuda.synchronize(v.device)
                    break
        snapshot_s = time.perf_counter() - t0
        nbytes = sum(v.numel() * v.element_size() for _, v in snap
                     if isinstance(v, torch.Tensor))
        chunk = self.drain_chunk_bytes

        def work():
            try:
                t1 = time.perf_counter()
                with tr.span("ckpt.drain", track="ckpt", step=step,
                             nbytes=nbytes, buffer="ckpt_snapshot"):
                    host = {k: _drain_leaf(v, chunk) for k, v in snap}
                drain_s = time.perf_counter() - t1
                t2 = time.perf_counter()
                with tr.span("ckpt.commit", track="ckpt", step=step,
                             nbytes=nbytes):
                    save(self.ckpt_dir, step, host, extra)
                    self._gc()
                self.metrics.note_save(step, nbytes, snapshot_s, drain_s,
                                       time.perf_counter() - t2)
            except BaseException as e:   # surfaced on the next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def _gc(self) -> None:
        """Retention + hygiene: keep the last ``keep`` committed steps,
        drop crashed saves' ``.tmp`` staging dirs and quarantined
        ``.corrupt`` dirs."""
        for d in os.listdir(self.ckpt_dir):
            if d.startswith("step_") and (d.endswith(".tmp")
                                          or d.endswith(".corrupt")):
                shutil.rmtree(os.path.join(self.ckpt_dir, d),
                              ignore_errors=True)
        for s in valid_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
