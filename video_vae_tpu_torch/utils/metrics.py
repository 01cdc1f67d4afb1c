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
    err = (prediction - target).float().square()
    if frame_mask is None:
        mse = err.mean()
    else:
        m = frame_mask.float().reshape(*frame_mask.shape, 1, 1, 1)
        pixels = err.shape[2] * err.shape[3] * err.shape[4]
        mse = (err * m).sum() / torch.clamp(m.sum() * pixels, min=1.0)
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
