"""Gradient-health telemetry: f32 global norm and max |x| over a list of tensors.

Counterpart of the JAX package's ``utils/debug.py`` (``global_norm``,
``global_max_abs``, ``param_norm``). Each stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32; 0 for an empty list."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def global_max_abs(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """max |x| over every tensor, in f32; 0 for an empty list."""
    if not tensors:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm([t.float() for t in tensors], float("inf"))).max()


def param_norm(module: nn.Module) -> torch.Tensor:
    """The f32 global norm of ``module``'s parameters (the JAX ``nnx.Param`` state)."""
    return global_norm(list(module.parameters()))
