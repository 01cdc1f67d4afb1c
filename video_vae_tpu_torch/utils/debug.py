"""Gradient-health telemetry: f32 global norm and max |x| over a list of tensors.

Counterpart of the JAX package's ``utils/debug.py`` (``global_norm``,
``global_max_abs``, ``param_norm``). Each stays on the device (no host sync).

Under a mesh each rank holds shards of the gradients: the norm and the max
are then over every shard of every rank, through one all-reduce of a scalar
over the process group (each shard's squares counted once, by the rank that
owns it, where several ranks hold the same piece).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


def global_norm(tensors: Sequence[torch.Tensor], owned: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32; 0 for an empty list.

    With ``owned`` (one flag per tensor: shards of a sharded run) the sum is
    over the tensors this rank owns and then over every rank.
    """
    if owned is None:
        if not tensors:
            return torch.zeros(())
        norms = torch._foreach_norm([t.float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    mine = [t.float() for t, own in zip(tensors, owned) if own]
    device = tensors[0].device if tensors else None
    sumsq = torch.stack(torch._foreach_norm(mine)).square().sum() if mine else torch.zeros((), device=device)
    dist.all_reduce(sumsq)
    return sumsq.sqrt()


def global_max_abs(tensors: Sequence[torch.Tensor], sharded: bool = False) -> torch.Tensor:
    """max |x| over every tensor, in f32; 0 for an empty list. ``sharded``: over
    every rank's tensors as well."""
    if not tensors:
        return torch.zeros(())
    out = torch.stack(torch._foreach_norm([t.float() for t in tensors], float("inf"))).max()
    if sharded:
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


def param_norm(module: nn.Module) -> torch.Tensor:
    """The f32 global norm of ``module``'s parameters (the JAX ``nnx.Param`` state)."""
    return global_norm(list(module.parameters()))
