"""Metric logging: stdout, a JSONL file and optionally wandb.

The JAX package's ``train/metrics.py`` in the port. The JSONL file in
``log_dir`` is the always-on record, wandb an optional sink. Values may be
0-d tensors on the device: :meth:`MetricLogger.log` reads them to the host
(``.item()``), so the trainer calls it only on the steps it logs, and the
steps between never wait for the device. Tensors of higher rank are left
out. Only the main process (rank 0 of the process group, or the only process)
opens the file and the sink and emits; the others' calls do nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        run_name: str = "train",
        use_wandb: bool = False,
        wandb_project: str = "video-vae-tpu",
        config: Optional[dict] = None,
    ):
        self.is_main = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self._file = None
        self._wandb = None
        self._start = time.perf_counter()
        if not self.is_main:
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, config=config or {})
                self._wandb = wandb
            except ImportError:
                print("[metrics] wandb requested but not installed; using JSONL only")

    def log(self, metrics: Dict, step: int, prefix: str = "", echo: bool = True) -> None:
        if not self.is_main:
            return
        flat = {}
        for key, value in metrics.items():
            if getattr(value, "ndim", 0) > 0:
                continue  # skip tensors (e.g. reconstructions)
            if isinstance(value, torch.Tensor):
                value = value.item()
            flat[f"{prefix}{key}"] = float(np.asarray(value))
        flat["step"] = step
        flat["elapsed"] = round(time.perf_counter() - self._start, 3)
        if self._file:
            self._file.write(json.dumps(flat) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(flat, step=step)
        if echo:
            body = ", ".join(
                f"{key}={val:.5g}" for key, val in flat.items() if key not in ("step",)
            )
            print(f"[{prefix or 'train'} step {step}] {body}", flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
