"""Quality metrics, parameter counting and a profiling helper.

Counterpart of the JAX package's ``utils/metrics.py``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


def masked_psnr(
    prediction: torch.Tensor,
    target: torch.Tensor,
    frame_mask: Optional[torch.Tensor] = None,
    max_val: float = 1.0,
) -> torch.Tensor:
    """PSNR in dB over the valid frames of (b, t, h, w, c) videos in [0, max_val]."""
    if frame_mask is not None:
        return psnr_from_sse(*masked_sse(prediction, target, frame_mask), max_val)
    mse = (prediction - target).float().square().mean()
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def masked_sse(prediction: torch.Tensor, target: torch.Tensor, frame_mask: torch.Tensor):
    """(Σ squared error over the valid frames, their element count) of (b, t, h,
    w, c) videos: :func:`masked_psnr`'s two sums, which add over batch shards."""
    err = (prediction - target).float().square()
    m = frame_mask.float().reshape(*frame_mask.shape, 1, 1, 1)
    return (err * m).sum(), m.sum() * (err.shape[2] * err.shape[3] * err.shape[4])


def psnr_from_sse(sse: torch.Tensor, count: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """:func:`masked_psnr` from the sums of :func:`masked_sse` (or their means over shards)."""
    mse = sse / torch.clamp(count, min=1.0)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def count_params(module: torch.nn.Module) -> int:
    """The number of parameter elements of ``module``."""
    return sum(p.numel() for p in module.parameters())


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, written to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``), when ``log_dir`` is set; else a no-op.

    The JAX package's counterpart dumps a ``jax.profiler`` trace. The CUDA
    activity is recorded where there is a card; the trainer's own window
    profiler (``train/trainer.py``) is separate.
    """
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
