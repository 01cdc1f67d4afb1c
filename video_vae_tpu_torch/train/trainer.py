"""The trainer: curriculum, schedules, checkpoints, logging — one loop on every rank.

The JAX package's ``train/trainer.py`` in the port, batch for batch and step
for step:

* the curriculum halves the batch and doubles the frames each epoch, up to
  caps (:func:`curriculum_plan`);
* the compression-rate target ramps 2 → 10000 after
  ``negative_penalty_training_steps``, 100000 in a resumed run
  (:meth:`Trainer.hparams_for_step`);
* metrics go to the JSONL logger every ``log_every`` steps, a deterministic
  reconstruction (its masked PSNR as ``dump_psnr_det``, and two mp4s) every
  ``video_every`` steps, a checkpoint every ``checkpoint_every_steps`` steps
  and at the end of each epoch;
* SIGTERM/SIGINT saves a checkpoint and stops.

The model is ``VideoVAE(cfg.model, seed=cfg.train.model_seed)`` on the
trainer's device; every random draw of the rollouts comes from one
``torch.Generator`` on that device seeded with ``cfg.train.seed``, passed to
``train_step`` and ``eval_step``. On a CUDA device the next batch is copied
from pinned host memory on a side stream while the step runs; the step's
stream waits on the copy's event, and the batch is recorded on that stream
so the caching allocator cannot hand its memory out while the step reads it.
``VVT_H2D_OVERLAP=0`` (read at every epoch) copies each batch on the compute
stream just before its step. A ``torch.profiler`` trace of the steps after
``profile_start_step`` is written to ``profile_dir``.

**Several ranks.** Launched by ``torch.distributed.run`` (its ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the
environment), the trainer joins the process group (NCCL on CUDA, gloo on the
CPU or when ``dist_backend`` asks), runs on ``cuda:LOCAL_RANK`` (several
ranks may share a card under gloo) and trains over the ``cfg.mesh``
(data, fsdp, tensor) mesh of every rank (``parallel/``). Each rank's loader
reads its (data, fsdp) coordinate's share of each global batch of
``batch_size`` clips (the whole batch where data·fsdp does not divide it);
tensor ranks of one coordinate read the same clips. Every rank draws the
global batch's noise and uniforms from the shared generator and keeps its
rows, so a sharded step takes the draws one process takes for the same
batch. The logged metrics are the global batch's; rank 0 alone logs, dumps
videos (its own rows), writes checkpoints and mirrors them. A gloo group on
the host agrees each step on whether every rank has a batch and none was
asked to stop. Without that environment the trainer is one process, as
before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from video_vae_tpu_torch.core.config import DynamicHParams, VAEConfig
from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.data.pipeline import create_dataloader
from video_vae_tpu_torch.data.video_io import write_video
from video_vae_tpu_torch.models.vae import VideoVAE
from video_vae_tpu_torch.parallel.mesh import batch_ranks, mesh_from_config
from video_vae_tpu_torch.parallel.sharding import activate_mesh, batch_slice, local_rows, model_sharding
from video_vae_tpu_torch.train.checkpoint import CheckpointManager, GracefulShutdown, load_checkpoint
from video_vae_tpu_torch.train.metrics import MetricLogger
from video_vae_tpu_torch.train.setup import create_optimizer, create_sharded_model
from video_vae_tpu_torch.train.step import build_perceptual, eval_step, reconstruct, train_step
from video_vae_tpu_torch.utils.metrics import masked_sse, psnr_from_sse


@dataclass
class EpochPlan:
    batch_size: int
    max_frames: int


def curriculum_plan(cfg: VAEConfig, epoch: int) -> EpochPlan:
    """Halve batch / double frames each epoch up to caps."""
    t = cfg.train
    d = cfg.data
    if not t.curriculum:
        return EpochPlan(d.batch_size, d.max_frames)
    max_mult = min(
        int(math.log2(max(1, d.batch_size // t.curriculum_min_batch))),
        max(0, int(math.log2(max(1, t.curriculum_max_frames // d.max_frames))) - 1),
    )
    mult = min(epoch, max(0, max_mult))
    return EpochPlan(
        batch_size=max(t.curriculum_min_batch, d.batch_size // (2**mult)),
        max_frames=min(t.curriculum_max_frames, d.max_frames * (2**mult)),
    )


def maybe_init_distributed(device: torch.device, backend: Optional[str] = None) -> torch.device:
    """Join the process group ``torch.distributed.run`` describes in the
    environment (the JAX package's ``maybe_init_distributed``), once; returns
    the rank's device. Without ``WORLD_SIZE`` in the environment nothing
    happens and ``device`` is returned: one process.

    ``backend`` defaults to NCCL for CUDA and gloo for the CPU. A CUDA rank
    runs on ``cuda:LOCAL_RANK`` (modulo the cards there are, so that ranks
    can share a card under gloo).
    """
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://")
    return device


class Trainer:
    def __init__(
        self,
        cfg: VAEConfig,
        *,
        vgg_weights: Optional[str] = None,
        use_wandb: bool = False,
        restore_from: Optional[str] = None,
        install_signal_handlers: bool = True,
        device: str | torch.device = "cuda",
        dist_backend: Optional[str] = None,
    ):
        self.cfg = cfg
        self.device = maybe_init_distributed(resolve_device(device), dist_backend)
        self.distributed = dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.mesh = mesh_from_config(
            cfg.mesh, world_size=dist.get_world_size() if self.distributed else 1, device_type=self.device.type
        )
        # the host-side group that agrees each step on whether to go on
        self._control = dist.new_group(backend="gloo") if self.distributed and dist.get_world_size() > 1 else None
        self.model = create_sharded_model(
            lambda: VideoVAE(cfg.model, device=self.device, seed=cfg.train.model_seed), self.mesh
        )
        self.optimizer = create_optimizer(self.model, cfg.optim, self.mesh)
        self.perceptual_fn = build_perceptual(cfg.loss, vgg_weights, device=self.device)
        self.train_step = functools.partial(train_step, loss_cfg=cfg.loss, perceptual_fn=self.perceptual_fn)
        self.eval_step = functools.partial(eval_step, loss_cfg=cfg.loss, perceptual_fn=self.perceptual_fn)
        self.generator = torch.Generator(self.device).manual_seed(cfg.train.seed)
        self.global_step = 0
        # host seconds spent waiting for the loader's next batch, over every epoch
        self.data_wait_s = 0.0
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir, distributed=self.distributed)
        self.shutdown = GracefulShutdown(install=install_signal_handlers)
        num_params = sum(math.prod(s) for s in model_sharding(self.model).full_shapes.values())
        self.logger = MetricLogger(
            log_dir=cfg.train.checkpoint_dir,
            use_wandb=use_wandb,
            config={**dataclasses.asdict(cfg), "num_params": num_params},
        )
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._profiler = None

        self._resumed = False
        if restore_from:
            load_checkpoint(self.model, self.optimizer, restore_from)
            self._resumed = True
        else:
            step = self.ckpt.restore_latest(self.model, self.optimizer)
            if step is not None:
                self.global_step = step
                self._resumed = True

    # ------------------------------------------------------------------

    def _maybe_profile(self) -> None:
        """Trace the configured step window with ``torch.profiler``."""
        t = self.cfg.train
        if not t.profile_dir or self.rank != 0:
            return
        if self._profiler is None and self.global_step == t.profile_start_step:
            os.makedirs(t.profile_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self._profiler is not None and self.global_step >= t.profile_start_step + t.profile_num_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        self._profiler.stop()
        path = os.path.join(self.cfg.train.profile_dir, f"trace_step{self.global_step}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"[trainer] profile trace written to {path}")

    def _upload_artifact(self, path: str) -> None:
        """Mirror an artifact to GCS (process 0, in the background).

        A failed upload is printed from a watcher thread, never raised: uploads
        must not kill training, and a misconfigured bucket still shows in the log.
        """
        prefix = self.cfg.train.gcs_upload_prefix
        if not prefix or self.rank != 0:
            return
        import shutil as _shutil
        import subprocess as _subprocess
        import threading as _threading

        if not _shutil.which("gcloud"):
            return
        try:
            proc = _subprocess.Popen(
                ["gcloud", "storage", "cp", "-r", path, prefix.rstrip("/") + "/"],
                stdout=_subprocess.DEVNULL,
                stderr=_subprocess.PIPE,
            )

            def _watch(p=proc, src=path):
                _, err = p.communicate()
                if p.returncode != 0:
                    msg = (err or b"").decode(errors="replace").strip()[-500:]
                    print(f"[trainer] GCS upload of {src} failed (rc={p.returncode}): {msg}")

            _threading.Thread(target=_watch, daemon=True).start()
        except Exception as e:  # uploads must never kill training
            print(f"[trainer] GCS upload failed: {e}")

    def hparams_for_step(self, step: int) -> DynamicHParams:
        t = self.cfg.train
        if self._resumed:
            rate = t.resume_max_compression_rate  # fine-tune relaxation
        elif step > t.negative_penalty_training_steps:
            rate = t.relaxed_max_compression_rate
        else:
            rate = t.initial_max_compression_rate
        return DynamicHParams.default(max_compression_rate=rate)

    def _shard(self, global_batch: int):
        """(this rank's rows of a global batch, the loader's process index and
        count, the loader's batch size): its (data, fsdp) share, or the whole
        batch where data·fsdp does not divide it."""
        rows = batch_slice(global_batch, self.mesh)
        local = rows.stop - rows.start
        if local == global_batch:
            return rows, 0, 1, global_batch
        return rows, rows.start // local, batch_ranks(self.mesh), local

    def _go_on(self, has_batch: bool) -> tuple[bool, bool]:
        """(every rank has a batch, a rank was asked to stop), agreed by all ranks."""
        if self._control is None:
            return has_batch, self.shutdown.should_stop
        flags = torch.tensor([int(has_batch), int(not self.shutdown.should_stop)])
        dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=self._control)
        return bool(flags[0]), not bool(flags[1])

    @contextlib.contextmanager
    def _mesh_and_rows(self, rows: slice, global_batch: int):
        """The context of a step: the active mesh, and this rank's rows for the draws."""
        with activate_mesh(self.mesh), local_rows(rows, global_batch):
            yield

    def _put(self, host_batch: dict, overlap: bool):
        """(the batch as tensors on the device, the event its copy records or None).

        With ``overlap`` on a CUDA device the copy runs from pinned memory on
        the side stream; otherwise on the current stream.
        """
        if self.device.type != "cuda" or not overlap:
            return {k: torch.from_numpy(v).to(self.device) for k, v in host_batch.items()}, None
        with torch.cuda.stream(self._copy_stream):
            batch = {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                     for k, v in host_batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return batch, ready

    def _ready(self, batch: dict, ready) -> dict:
        """The batch, once the current stream waits for its copy and owns its memory."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for tensor in batch.values():
                tensor.record_stream(stream)
        return batch

    def _dump_videos(self, batch, device_batch, tag: str, step: int) -> None:
        """Periodic qualitative dump: the deterministic reconstruction of the batch,
        its masked PSNR as ``dump_psnr_det`` (the global batch's), and the two
        mp4s (rank 0's rows)."""
        t = self.cfg.train
        with activate_mesh(self.mesh):
            recon = reconstruct(self.model, device_batch["video"], device_batch["mask"], device=self.device)
        sums = masked_sse(recon.float(), device_batch["video"].float(), device_batch["mask"])
        psnr = psnr_from_sse(*model_sharding(self.model).reduce_mean(list(sums)))
        self.logger.log({"dump_psnr_det": psnr}, step)
        if self.rank != 0:
            return
        recon_np = recon.float().cpu().numpy()
        out_dir = os.path.join(t.video_save_dir, tag)
        os.makedirs(out_dir, exist_ok=True)
        try:
            write_video(
                {"video": recon_np, "mask": batch["mask"]},
                os.path.join(out_dir, f"step{step}_recon.mp4"),
            )
            write_video(
                {"video": batch["video"], "mask": batch["mask"]},
                os.path.join(out_dir, f"step{step}_original.mp4"),
            )
        except Exception as e:  # video IO must never kill training
            print(f"[trainer] video dump failed: {e}")
            return
        self._upload_artifact(out_dir)

    # ------------------------------------------------------------------

    def run_epoch(self, epoch: int) -> bool:
        """One training epoch. Returns False if a shutdown was requested."""
        cfg = self.cfg
        plan = curriculum_plan(cfg, epoch)
        rows, index, count, local = self._shard(plan.batch_size)
        data_cfg = cfg.data.replace(batch_size=local, max_frames=plan.max_frames)
        loader = create_dataloader(
            data_cfg,
            seed=cfg.data.seed + epoch,
            process_index=index,
            process_count=count,
        )
        # the next batch is fetched and its copy issued once the step is enqueued
        overlap = os.environ.get("VVT_H2D_OVERLAP", "1") != "0"
        batches = iter(loader)

        def fetch_next(to_device: bool = True):
            started = time.perf_counter()
            host_batch = next(batches, None)
            self.data_wait_s += time.perf_counter() - started
            has_batch, stop = self._go_on(host_batch is not None)
            self.shutdown.should_stop = stop
            if not has_batch:
                return None
            if not to_device:
                return host_batch, None
            return host_batch, self._put(host_batch, overlap=True)

        pending = fetch_next(to_device=overlap)
        while pending is not None:
            host_batch, put = pending
            if put is None:  # serialized mode: copy right before the step
                put = self._put(host_batch, overlap=False)
            batch = self._ready(*put)
            hp = self.hparams_for_step(self.global_step)
            with self._mesh_and_rows(rows, plan.batch_size):
                metrics = self.train_step(
                    self.model, self.optimizer, batch["video"], batch["mask"], hp, generator=self.generator
                )
            pending = fetch_next(to_device=overlap)
            self.global_step += 1
            self._maybe_profile()
            if self.global_step % cfg.train.log_every == 0:
                self.logger.log(metrics, self.global_step)
            if cfg.train.video_every and self.global_step % cfg.train.video_every == 0:
                self._dump_videos(host_batch, batch, f"train/epoch{epoch}", self.global_step)
            if (
                cfg.train.checkpoint_every_steps
                and self.global_step % cfg.train.checkpoint_every_steps == 0
            ):
                self.ckpt.save(self.global_step, self.model, self.optimizer)
                # the save runs on a thread: finish it before mirroring the step dir
                self.ckpt.wait()
                self._upload_artifact(self.ckpt.step_dir(self.global_step))
            if self.shutdown.should_stop:
                self.ckpt.save(self.global_step, self.model, self.optimizer)
                self.ckpt.wait()
                return False
        self.ckpt.save(self.global_step, self.model, self.optimizer)
        self.ckpt.wait()
        return True

    def run_eval(self, epoch: int) -> Optional[dict]:
        cfg = self.cfg
        if not cfg.data.eval_dir and not cfg.data.synthetic:
            return None
        plan = curriculum_plan(cfg, epoch)
        rows, index, shards, local = self._shard(plan.batch_size)
        data_cfg = cfg.data.replace(batch_size=local, max_frames=plan.max_frames)
        loader = iter(create_dataloader(
            data_cfg,
            seed=cfg.data.seed + 10_000 + epoch,
            base_dir=cfg.data.eval_dir,
            process_index=index,
            process_count=shards,
        ))
        totals, count = {}, 0
        while True:
            host_batch = next(loader, None)
            if not self._go_on(host_batch is not None)[0]:
                break
            batch = self._ready(*self._put(host_batch, overlap=False))
            hp = self.hparams_for_step(self.global_step)
            with self._mesh_and_rows(rows, plan.batch_size):
                metrics = self.eval_step(self.model, batch["video"], batch["mask"], hp, generator=self.generator)
            for key, val in metrics.items():
                if getattr(val, "ndim", 1) == 0:
                    totals[key] = totals.get(key, 0.0) + float(val)
            count += 1
        if count == 0:
            return None
        avg = {key: val / count for key, val in totals.items()}
        self.logger.log(avg, self.global_step, prefix="eval_")
        return avg

    def fit(self) -> None:
        try:
            for epoch in range(self.cfg.train.num_epochs):
                if not self.run_epoch(epoch):
                    print("[trainer] graceful shutdown complete")
                    return
                self.run_eval(epoch)
        finally:
            # an unfinished save thread would be cut at interpreter exit
            self.ckpt.wait()
            if self._profiler is not None:  # the window crossed the end of the run
                self._stop_profile()
