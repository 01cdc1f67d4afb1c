"""Checkpoints of the port, the weight bridge from the JAX package, and SIGTERM-safe shutdown.

**The port's checkpoint format.** A checkpoint is a directory holding one
``torch.save`` file, ``state.pt``: ``{"model": model.state_dict(),
"optimizer": optimizer.state_dict()}`` (the step count and the Adam moments
of ``train/setup.py:Optimizer``). It is written under a temporary name and
renamed, so a directory holds a whole checkpoint or none, and read back
with ``weights_only=True`` onto the model's device. :class:`CheckpointManager`
keeps step directories ``<directory>/<step>`` (the newest ``max_to_keep``),
saves on a thread after a synchronous copy of the state to the host, and
restores the newest. The JAX package's orbax format is not read here: orbax
imports JAX.

**The weight bridge.** The port keeps the JAX module names and parameter
layouts (Linear kernels (in, out), DHWIO conv kernels, the (1,2,2,ci,co)
transpose-conv kernel whose spatial flip is applied at use, LN/GN scale and
bias, the (1,1,1,latent) fill token), so the mapping is one to one by path:
the JAX path ``encoder/layers/0/TemporalAttention/qkv_projection/kernel`` is
the port's parameter ``encoder.layers.0.TemporalAttention.qkv_projection.kernel``.
:func:`load_jax_params` takes the flat dict of ``nnx.state(model,
nnx.Param).flat_state()`` with the paths joined by ``/``;
:func:`load_jax_optimizer_state` takes the Adam state of an
``nnx.Optimizer`` (its count, and mu and nu keyed by the same paths).
Together they carry a JAX run's whole training state into the port. The
same bridge fills the perceptual loss's VGG (``models/vgg.py``) from the JAX
``VGG16Features``: its HWIO kernels sit under ``convs/<name>/kernel`` on
both sides.

**Shutdown.** On SIGTERM or SIGINT, :class:`GracefulShutdown` raises a flag;
the training loop saves a checkpoint and returns.
"""

from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from video_vae_tpu_torch.train.setup import Optimizer

CHECKPOINT_FILE = "state.pt"


def _state(model: nn.Module, optimizer: Optimizer) -> dict:
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict()}


def _write(state: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, CHECKPOINT_FILE)
    torch.save(state, final + ".tmp")
    os.replace(final + ".tmp", final)


def save_checkpoint(model: nn.Module, optimizer: Optimizer, path: str) -> None:
    """One synchronous save of {"model", "optimizer"} into the directory ``path``."""
    _write(_state(model, optimizer), os.path.abspath(path))


def load_checkpoint(model: nn.Module, optimizer: Optimizer, path: str) -> None:
    """Restore a checkpoint directory into an already built model and optimizer, in place."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                       map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])


class CheckpointManager:
    """Step-indexed checkpoints, written on a thread, the newest ``max_to_keep`` kept.

    A step at or below the newest saved one is not saved again (as orbax's
    manager skips it). One save runs at a time: :meth:`save` first waits for
    the one in flight. :meth:`wait` joins it and raises its error, if any.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> list[int]:
        """The steps whose checkpoint is complete, ascending."""
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, CHECKPOINT_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, model: nn.Module, optimizer: Optimizer) -> bool:
        """Copy the state to the host now and write it on a thread; False if ``step`` is not newer."""
        self.wait()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        state = _state(model, optimizer)
        host = {
            "model": {k: v.detach().to("cpu", copy=True) for k, v in state["model"].items()},
            "optimizer": {
                "count": state["optimizer"]["count"],
                "mu": [t.detach().to("cpu", copy=True) for t in state["optimizer"]["mu"]],
                "nu": [t.detach().to("cpu", copy=True) for t in state["optimizer"]["nu"]],
            },
        }
        self._thread = threading.Thread(target=self._write_and_prune, args=(step, host))
        self._thread.start()
        return True

    def _write_and_prune(self, step: int, state: dict) -> None:
        try:
            _write(state, self.step_dir(step))
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(self.step_dir(old))
        except BaseException as e:  # noqa: BLE001 — raised again by wait()
            self._error = e

    def restore_latest(self, model: nn.Module, optimizer: Optimizer) -> Optional[int]:
        """Load the newest checkpoint in place; its step, or None if there is none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        load_checkpoint(model, optimizer, self.step_dir(step))
        return step

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()


class GracefulShutdown:
    """SIGTERM/SIGINT → flag; the training loop checkpoints and exits."""

    def __init__(self, install: bool = True):
        self.should_stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not the main thread
                    pass

    def _handler(self, signum, frame):
        print(f"[checkpoint] received signal {signum}; will checkpoint and stop")
        self.should_stop = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> int:
    """Copy every parameter of ``model`` from ``params``, in place.

    Raises on a missing key, an unused key or a shape mismatch. Returns the
    number of parameters copied.
    """
    ours = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    missing = sorted(set(ours) - set(params))
    unused = sorted(set(params) - set(ours))
    if missing or unused:
        raise KeyError(f"parameter sets differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for key, p in ours.items():
            value = np.asarray(params[key])
            if value.shape != tuple(p.shape):
                raise ValueError(f"{key}: shape {value.shape}, port expects {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return len(ours)


def load_jax_optimizer_state(
    optimizer: Optimizer,
    count,
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
) -> int:
    """Set the step count and copy every Adam moment from a JAX ``nnx.Optimizer``'s state.

    ``count`` is optax's Adam count (the updates made); ``mu`` and ``nu`` are
    keyed by the parameter paths joined with ``/``, as :func:`load_jax_params`
    takes them. Raises on a missing or unused key or a shape mismatch.
    Returns the number of parameters whose moments were copied.
    """
    for label, moments in (("mu", mu), ("nu", nu)):
        missing = sorted(set(optimizer.names) - set(moments))
        unused = sorted(set(moments) - set(optimizer.names))
        if missing or unused:
            raise KeyError(f"{label}: parameter sets differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for name, m, v in zip(optimizer.names, optimizer.mu, optimizer.nu):
            for label, ours, theirs in (("mu", m, mu[name]), ("nu", v, nu[name])):
                value = np.asarray(theirs)
                if value.shape != tuple(ours.shape):
                    raise ValueError(f"{label} of {name}: shape {value.shape}, port expects {tuple(ours.shape)}")
                ours.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    optimizer.count = int(np.asarray(count))
    return len(optimizer.names)
