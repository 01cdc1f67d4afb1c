"""Device mesh construction: the JAX package's ``parallel/mesh.py`` in the port.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group, one rank a device, with three dims:

  data   — batch (pure DP: gradients averaged over the data ranks)
  fsdp   — batch as well, and parameter shards (the Adam moments and the
           update are split over it, as the JAX rules place them)
  tensor — Megatron tensor parallelism inside each block's attention and MLP

Size-1 dims cost nothing, so one process is the (1, 1, 1) mesh. A JAX process
is a host of several chips; a process of the port is one device, so what JAX
calls the process count is the number of ranks here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from video_vae_tpu_torch.core.config import MeshConfig

AXES = ("data", "fsdp", "tensor")


def build_mesh(
    data: int = -1,
    fsdp: int = 1,
    tensor: int = 1,
    *,
    world_size: Optional[int] = None,
    device_type: str = "cpu",
    axis_names: Sequence[str] = AXES,
) -> DeviceMesh:
    """A (data, fsdp, tensor) mesh over ``world_size`` ranks (default: the process
    group's size, 1 without one). ``data=-1`` absorbs all remaining ranks.

    With an initialised process group the mesh creates its sub-groups (a
    collective: every rank calls it in the same order). Without one it is a
    shape only, e.g. to read the rules of a mesh this process is not part of.
    """
    initialised = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialised else 1
    fixed = fsdp * tensor
    if data == -1:
        if world_size % fixed != 0:
            raise ValueError(f"{world_size} devices not divisible by fsdp*tensor={fixed}")
        data = world_size // fixed
    if data * fsdp * tensor != world_size:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {world_size} devices")
    ranks = torch.arange(world_size).reshape(data, fsdp, tensor)
    if initialised and world_size != dist.get_world_size():
        raise ValueError(f"a {world_size}-rank mesh in a process group of {dist.get_world_size()}")
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names), _init_backend=initialised,
                      _rank=None if initialised else 0)
    if initialised:
        # the batch group: the ranks that hold one tensor coordinate's rows
        mesh[tuple(axis_names[:2])]._flatten("batch")
    return mesh


def mesh_from_config(cfg: MeshConfig, *, world_size: Optional[int] = None, device_type: str = "cpu") -> DeviceMesh:
    return build_mesh(
        cfg.data, cfg.fsdp, cfg.tensor, world_size=world_size, device_type=device_type,
        axis_names=cfg.axis_names,
    )


def mesh_shape(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{axis name: size}; {} for no mesh (the JAX ``mesh.shape``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coordinate(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: this rank's index along it}; all 0 without a process group."""
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    where = (mesh.mesh == rank).nonzero()
    if len(where) != 1:
        raise ValueError(f"rank {rank} is not in the mesh {mesh_shape(mesh)}")
    return dict(zip(mesh.mesh_dim_names, where[0].tolist()))


def batch_ranks(mesh: DeviceMesh) -> int:
    """The number of batch shards: the product of the data and fsdp sizes."""
    shape = mesh_shape(mesh)
    return shape.get("data", 1) * shape.get("fsdp", 1)


def local_batch_size(global_batch: int, mesh: DeviceMesh) -> int:
    """The rows of a global batch one rank loads: global / (data·fsdp), or the
    whole batch where that does not divide (the batch is then replicated, as
    ``shard_process_local_batch`` replicates it in JAX)."""
    n = batch_ranks(mesh)
    return global_batch // n if global_batch % n == 0 else global_batch


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (used to fit shardings to odd dims)."""
    best = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            for c in (d, n // d):
                if c <= cap:
                    best = max(best, c)
    return best
