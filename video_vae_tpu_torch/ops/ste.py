"""Straight-through estimators and the stochastic gate of the "ste" mode.

Counterpart of the JAX package's ``ops/ste.py``. The gate's uniform draw is
an argument (or comes from a ``torch.Generator``), so a caller can replay
another framework's draw.
"""

from __future__ import annotations

from typing import Optional

import torch


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Forward: round to the nearest integer (ties to even); backward: identity."""
    return _RoundSTE.apply(x)


def gumbel_sigmoid_sample(
    logits: torch.Tensor,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    train: bool = True,
) -> torch.Tensor:
    """Hard {0,1} gate with straight-through gradients.

    Train: logistic noise log(u/(1−u)) from f32 uniforms of the logits' shape
    (``uniforms``, else drawn from ``generator``), temperature sigmoid, STE
    round. Eval: the plain sigmoid thresholded at 0.5, no draw.
    """
    if not train:
        return torch.round(torch.sigmoid(logits / temperature))
    if uniforms is None:
        dev = generator.device if generator is not None else logits.device
        uniforms = torch.rand(logits.shape, generator=generator, dtype=torch.float32, device=dev)
    eps = 1e-20
    u = uniforms.to(device=logits.device, dtype=torch.float32).clamp(eps, 1.0 - eps)
    noise = torch.log(u / (1.0 - u)).to(logits.dtype)
    return round_ste(torch.sigmoid((logits + noise) / temperature))
