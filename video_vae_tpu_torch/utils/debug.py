"""Gradient-health telemetry: f32 global norm and max |x| over a list of tensors.

Counterpart of the JAX package's ``utils/debug.py`` (``global_norm``,
``global_max_abs``). Both stay on the device (no host sync).
"""

from __future__ import annotations

from typing import Sequence

import torch


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
