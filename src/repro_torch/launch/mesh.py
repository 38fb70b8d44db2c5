"""Device meshes: the port of ``repro.launch.mesh`` on ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the running process group (``torchrun`` starts one; a test starts gloo
processes). The functions build meshes only when called; importing this
module touches no device and no process group.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple


def _device_type() -> str:
    """``cuda`` for an NCCL process group, else ``cpu`` (gloo)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh_of(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: Optional[str],
             what: str):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks,
    row-major, with the dim names ``axes``. Every rank of the process group
    calls it (a rank outside the mesh gets a mesh it has no coordinate in)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = int(math.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for the {what} {shape}, have {world}: start "
            f"{n} processes, e.g. torchrun --nproc-per-node {n} ...")
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The production mesh: ``(data=16, model=16)``, or ``(pod=2, data=16,
    model=16)`` with ``multi_pod``, on ``device_type`` (default the process
    group's). Raises when the process group has fewer ranks than the mesh,
    naming the count it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_of(shape, axes, device_type, "production mesh")


def make_test_mesh(shape: Tuple[int, ...] = (2, 2), axes: Tuple[str, ...] = ("data", "model"),
                   device_type: Optional[str] = None):
    """A small mesh over the running process group's first ranks;
    ``device_type`` defaults to the group's (``cuda`` for NCCL, ``cpu`` for
    gloo)."""
    return _mesh_of(tuple(shape), tuple(axes), device_type, "mesh")


def hardware_constants() -> dict:
    """The roofline constants of the card the port runs on: NVIDIA H100 SXM5
    80GB at its 700 W power limit, from NVIDIA's data sheet (dense bf16
    tensor-core rate, HBM3 bandwidth, NVLink bandwidth a direction, device
    memory). A card set below 700 W runs slower under load; read its
    ``nvidia-smi --query-gpu=name,power.limit`` beside any number taken
    against these."""
    return {
        "peak_flops": 989e12,  # bf16 dense / card
        "hbm_gbps": 3.35e12,  # bytes/s per card
        "nvlink_gbps": 450e9,  # bytes/s per direction per card
        "hbm_gib": 80.0,
    }
