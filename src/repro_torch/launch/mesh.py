"""Process meshes (port of ``repro.launch.mesh``).

One process per rank.  The reference's meshes are functions so that
importing this module touches no device state; here they also start the
process group when it is not up yet (from ``torchrun``'s environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and return a
``torch.distributed`` DeviceMesh with named dims, from which
``MeshCtx.from_mesh`` takes one group per axis.  Shapes:

  * single pod:  (16, 16)      axes ("data", "model")
  * multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")
  * test:        (2, 4) / (2, 2, 2), the 8-rank miniature

The backend is NCCL when every rank has a card of its own, else gloo:
NCCL refuses two ranks on one card, so processes that share a card, or
run on the CPU, talk over gloo (core/transport.py stages CUDA tensors
through host buffers where gloo needs it).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.parallel.sharding import MeshCtx

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def backend_for(device_type: str, world_size: int) -> str:
    """nccl when each of ``world_size`` ranks has a card of its own."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device_type: str, *, init_method: str = "env://",
                     rank: int | None = None,
                     world_size: int | None = None) -> None:
    """Start the default process group (once).  Without ``rank`` /
    ``world_size`` they come from the environment (torchrun).  On a card,
    rank r uses card ``LOCAL_RANK`` (or r) modulo the cards present."""
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend_for(device_type, world_size),
                            init_method=init_method, rank=rank,
                            world_size=world_size)


def is_main() -> bool:
    """Whether this process prints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DxM"`` -> ((D, M), ("data", "model")); ``"PxDxM"`` adds pod."""
    try:
        shape = tuple(int(n) for n in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: DxM or PxDxM") from None
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {spec!r}: DxM or PxDxM")
    return shape, (AXES if len(shape) == 2 else POD_AXES)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` over the started process group, whose
    world size must be the mesh's."""
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The single-pod (256 ranks) or multi-pod (512) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    init_distributed(device_type)
    return make_mesh(shape, POD_AXES if multi_pod else AXES, device_type)


def make_test_mesh(*, multi_pod: bool = False,
                   device_type: str = "cuda") -> DeviceMesh:
    """The 8-rank miniature with the same axis structure."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    init_distributed(device_type)
    return make_mesh(shape, POD_AXES if multi_pod else AXES, device_type)


def mesh_ctx(spec: str, device: torch.device,
             mdmp_mode: str = "auto") -> MeshCtx:
    """A launcher's ``--mesh``: ``1x1`` is one process with no group;
    anything larger starts (or joins) the process group of ``torchrun``
    and returns this rank's view of the mesh."""
    shape, axes = parse_mesh(spec)
    if all(s == 1 for s in shape):
        return MeshCtx(axis_sizes=dict(zip(axes, shape)),
                       mdmp_mode=mdmp_mode)
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        raise ValueError(f"--mesh {spec} runs one process per rank: start "
                         f"it under torchrun --nproc-per-node N")
    init_distributed(device.type)
    return MeshCtx.from_mesh(make_mesh(shape, axes, device.type), mdmp_mode)
