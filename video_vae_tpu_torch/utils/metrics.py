"""Quality metrics. Counterpart of the JAX package's ``utils/metrics.py``."""

from __future__ import annotations

from typing import Optional

import torch


def masked_psnr(
    prediction: torch.Tensor,
    target: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    max_val: float = 1.0,
) -> torch.Tensor:
    """PSNR in dB over the valid frames of (b, t, h, w, c) videos in [0, max_val]."""
    err = (prediction - target).float().square()
    if frame_mask is None:
        mse = err.mean()
    else:
        m = frame_mask.float().reshape(*frame_mask.shape, 1, 1, 1)
        pixels = err.shape[2] * err.shape[3] * err.shape[4]
        mse = (err * m).sum() / torch.clamp(m.sum() * pixels, min=1.0)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))
