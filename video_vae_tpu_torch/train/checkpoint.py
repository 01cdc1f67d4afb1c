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

**Under a mesh** (a model from ``train/setup.py:create_sharded_model``) the
file keeps the same format: every rank takes part in gathering the full
tensors, rank 0 writes them, and :meth:`CheckpointManager.wait` ends in a
barrier, so no rank reads a directory rank 0 is still writing. Every rank
reads the file and keeps its own pieces, so a checkpoint saved under one
mesh restores under another, as orbax's does. The ranks share the
checkpoint directory's file system.

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
:func:`load_jax_batch_stats` takes ``nnx.state(model, nnx.BatchStat)``'s the
same way into the port's buffers (the discriminator's spectral-norm ``u``).
Together they carry a JAX run's whole training state into the port. The
same bridge fills the perceptual loss's VGG (``models/vgg.py``) from the JAX
``VGG16Features``: its HWIO kernels sit under ``convs/<name>/kernel`` on
both sides.

**The reference import.** :func:`import_reference_state` loads the model
subtree of a checkpoint of the reference repository (floatingtrees/video-VAE),
whose module names the JAX package kept, by the same paths: nested mappings,
block stacks as lists, leaves wrapped in ``.value``, and the reference's RoPE
cos/sin caches (``ROPE`` segments), which the port recomputes and drops. It
checks every entry before it writes any, so a failed import leaves the model
as it was (the JAX package's writes each entry as it walks).

**Shutdown.** On SIGTERM or SIGINT, :class:`GracefulShutdown` raises a flag;
the training loop saves a checkpoint and returns.
"""

from __future__ import annotations

import os
import shutil
import signal
import threading
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from video_vae_tpu_torch.parallel.sharding import model_sharding
from video_vae_tpu_torch.train.setup import Optimizer

CHECKPOINT_FILE = "state.pt"


def _state(model: nn.Module, optimizer: Optimizer) -> dict:
    """The model's and the optimizer's state, with full tensors under a mesh
    (a collective there: every rank calls it)."""
    sharding = model_sharding(model)
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    names = {n.replace("/", "."): n for n in sharding.names}
    for k, v in state["model"].items():
        if k in names:
            state["model"][k] = sharding.full(names[k], v)
    for key in ("mu", "nu"):
        state["optimizer"][key] = [sharding.full(n, t, shard=True)
                                   for n, t in zip(sharding.names, state["optimizer"][key])]
    return state


def _load_state(model: nn.Module, optimizer: Optional[Optimizer], state: dict) -> None:
    """Load a full state (:func:`_state`'s) into the model and the optimizer,
    each rank keeping its pieces under a mesh."""
    sharding = model_sharding(model)
    names = {n.replace("/", "."): n for n in sharding.names}
    for k, v in state["model"].items():
        if k in names:
            if tuple(v.shape) != sharding.full_shapes[names[k]]:
                raise ValueError(f"{k}: shape {tuple(v.shape)}, expected {sharding.full_shapes[names[k]]}")
            state["model"][k] = sharding.compute_view(names[k], v)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        state["optimizer"] = dict(state["optimizer"])
        for key in ("mu", "nu"):
            state["optimizer"][key] = [sharding.shard(n, sharding.compute_view(n, t))
                                       for n, t in zip(sharding.names, state["optimizer"][key])]
        optimizer.load_state_dict(state["optimizer"])


def _is_main() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _write(state: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, CHECKPOINT_FILE)
    torch.save(state, final + ".tmp")
    os.replace(final + ".tmp", final)


def save_checkpoint(model: nn.Module, optimizer: Optimizer, path: str) -> None:
    """One synchronous save of {"model", "optimizer"} into the directory ``path``
    (under a mesh every rank calls it and rank 0 writes)."""
    state = _state(model, optimizer)
    if _is_main():
        _write(state, os.path.abspath(path))
    if model_sharding(model).ranks > 1:
        dist.barrier()


def load_checkpoint(model: nn.Module, optimizer: Optimizer, path: str) -> None:
    """Restore a checkpoint directory into an already built model and optimizer, in place."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                       map_location=device, weights_only=True)
    _load_state(model, optimizer, state)


def load_model_state(model: nn.Module, path: str) -> None:
    """Restore only the model's weights from the checkpoint directory ``path``
    (its ``state.pt`` entry ``"model"``), in place, onto the model's device."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                       map_location=device, weights_only=True)
    _load_state(model, None, state)


class CheckpointManager:
    """Step-indexed checkpoints, written on a thread, the newest ``max_to_keep`` kept.

    A step at or below the newest saved one is not saved again (as orbax's
    manager skips it). One save runs at a time: :meth:`save` first waits for
    the one in flight. :meth:`wait` joins it and raises its error, if any.
    With ``distributed`` every rank calls :meth:`save` and :meth:`wait` at
    the same steps: all gather, rank 0 writes, and :meth:`wait` ends in a
    barrier of the process group. Rank 0 alone reads the directory to decide
    which step is the newest, and tells the others.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, *, distributed: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.distributed = distributed
        self.is_main = _is_main()
        if self.is_main:
            os.makedirs(self.directory, exist_ok=True)
        if distributed:
            dist.barrier()
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
        latest = self._agreed_latest()
        if latest is not None and step <= latest:
            return False
        state = _state(model, optimizer)
        if not self.is_main:
            return True
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

    def _agreed_latest(self) -> Optional[int]:
        """Rank 0's :meth:`latest_step`, on every rank."""
        latest = self.latest_step() if self.is_main else None
        if self.distributed:
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        return latest

    def restore_latest(self, model: nn.Module, optimizer: Optimizer) -> Optional[int]:
        """Load the newest checkpoint in place; its step, or None if there is none."""
        self.wait()
        step = self._agreed_latest()
        if step is None:
            return None
        load_checkpoint(model, optimizer, self.step_dir(step))
        return step

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.distributed:
            dist.barrier()
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


def _jax_paths(model: nn.Module) -> dict:
    """The model's parameters keyed by their JAX path: the nnx path joined with ``/``."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def _copy_full(model: nn.Module, values: Mapping[str, Any]) -> None:
    """Copy each full value of ``values`` (keyed by JAX path, shapes already
    checked) into the model's parameter, in place; on a sharded model each
    rank keeps its pieces."""
    sharding = model_sharding(model)
    ours = _jax_paths(model)
    with torch.no_grad():
        for key, value in values.items():
            full = torch.from_numpy(np.array(value, dtype=np.float32))
            ours[key].copy_(sharding.compute_view(key, full))


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> int:
    """Copy every parameter of ``model`` from ``params``, in place.

    Raises on a missing key, an unused key or a shape mismatch, before it
    writes anything. Returns the number of parameters copied. On a sharded
    model the values are the full tensors and each rank keeps its pieces.
    """
    sharding = model_sharding(model)
    ours = _jax_paths(model)
    missing = sorted(set(ours) - set(params))
    unused = sorted(set(params) - set(ours))
    if missing or unused:
        raise KeyError(f"parameter sets differ: missing {missing}, unused {unused}")
    values = {key: np.asarray(params[key]) for key in ours}
    for key, value in values.items():
        full = sharding.full_shapes[key]
        if value.shape != full:
            raise ValueError(f"{key}: shape {value.shape}, port expects {full}")
    _copy_full(model, values)
    return len(ours)


def _flatten(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """(path, leaf) of every leaf of a reference state tree: mappings (an
    ``nnx.State`` too) and lists or tuples (index ``i`` is the segment
    ``str(i)``) nest; a leaf is its ``.value`` where it has one; None is skipped."""
    if hasattr(tree, "items"):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, prefix + (str(i),))
    else:
        value = getattr(tree, "value", tree)
        if value is not None:
            yield prefix, value


def import_reference_state(model: nn.Module, ref_model_state) -> int:
    """Load a reference-repository VideoVAE state tree into the port's VideoVAE, in place.

    ``ref_model_state`` is the ``{"model": ...}`` subtree of a reference
    checkpoint, restored to host values: nested mappings, lists and tuples
    whose leaves are arrays or objects with a ``.value``. The match is one to
    one by path (``encoder/layers/0/SpatialAttention/qkv_projection/kernel``
    is the parameter ``encoder.layers.0.SpatialAttention.qkv_projection.kernel``);
    entries under a ``ROPE`` segment, the reference's cos/sin caches, are
    dropped. Raises ``ValueError`` at the first shape mismatch, then
    ``KeyError`` for reference entries with no counterpart, then
    ``ValueError`` for parameters of the port the tree leaves unwritten
    (paths with a segment holding ``rng`` are exempt), in that order and
    before anything is written. Values take the model's parameter dtype on
    its device; a sharded model takes the full tensors and each rank keeps
    its pieces. Returns the number of parameters copied.
    """
    sharding = model_sharding(model)
    ref = {path: np.asarray(value) for path, value in _flatten(ref_model_state) if "ROPE" not in path}
    ours = dict.fromkeys(tuple(key.split("/")) for key in _jax_paths(model))
    missing = []
    for path, value in ref.items():
        if path not in ours:
            missing.append(path)
            continue
        full = sharding.full_shapes["/".join(path)]
        if tuple(value.shape) != full:
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}: ours {full} vs reference {tuple(value.shape)}"
            )
    if missing:
        raise KeyError(f"reference params with no counterpart: {missing[:5]}")
    # a parameter the tree does not hold would silently keep its random init
    untouched = [p for p in ours if p not in ref and not any("rng" in seg.lower() for seg in p)]
    if untouched:
        raise ValueError(
            f"{len(untouched)} of our params were not present in the reference "
            f"checkpoint (would keep random init): {untouched[:5]}"
        )
    _copy_full(model, {"/".join(path): value for path, value in ref.items()})
    return len(ref)


def load_jax_batch_stats(model: nn.Module, stats: Mapping[str, np.ndarray]) -> int:
    """Copy every buffer of ``model`` from the JAX ``BatchStat`` values in ``stats``
    (the spectral norms' ``u`` of ``models/classifier.py``), in place.

    ``stats`` is the flat dict of ``nnx.state(model, nnx.BatchStat).flat_state()``
    with the paths joined by ``/``, as :func:`load_jax_params` takes the
    parameters. Raises on a missing key, an unused key or a shape mismatch.
    Returns the number of buffers copied.
    """
    ours = {name.replace(".", "/"): b for name, b in model.named_buffers()}
    missing = sorted(set(ours) - set(stats))
    unused = sorted(set(stats) - set(ours))
    if missing or unused:
        raise KeyError(f"buffer sets differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for key, b in ours.items():
            value = np.asarray(stats[key])
            if value.shape != tuple(b.shape):
                raise ValueError(f"{key}: shape {value.shape}, port expects {tuple(b.shape)}")
            b.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
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
    Returns the number of parameters whose moments were copied. Under a
    mesh each rank keeps its shard of each full moment.
    """
    sharding = optimizer.sharding
    for label, moments in (("mu", mu), ("nu", nu)):
        missing = sorted(set(optimizer.names) - set(moments))
        unused = sorted(set(moments) - set(optimizer.names))
        if missing or unused:
            raise KeyError(f"{label}: parameter sets differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for name, m, v in zip(optimizer.names, optimizer.mu, optimizer.nu):
            for label, ours, theirs in (("mu", m, mu[name]), ("nu", v, nu[name])):
                value = np.asarray(theirs)
                full = sharding.full_shapes[name]
                if value.shape != full:
                    raise ValueError(f"{label} of {name}: shape {value.shape}, port expects {full}")
                value = torch.from_numpy(np.array(value, dtype=np.float32))
                ours.copy_(sharding.shard(name, sharding.compute_view(name, value)))
    optimizer.count = int(np.asarray(count))
    return len(optimizer.names)
