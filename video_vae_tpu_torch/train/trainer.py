"""Training driver: curriculum, schedules, checkpoints, logging — one loop on one device.

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

The port trains on one device: a mesh other than one data-parallel device
raises ``NotImplementedError`` (ROADMAP Queue 1 item 6); the process index
is 0 and the process count 1.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from video_vae_tpu_torch.core.config import DynamicHParams, MeshConfig, VAEConfig
from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.data.pipeline import create_dataloader
from video_vae_tpu_torch.data.video_io import write_video
from video_vae_tpu_torch.models.vae import VideoVAE
from video_vae_tpu_torch.train.checkpoint import CheckpointManager, GracefulShutdown, load_checkpoint
from video_vae_tpu_torch.train.metrics import MetricLogger
from video_vae_tpu_torch.train.setup import create_optimizer
from video_vae_tpu_torch.train.step import build_perceptual, eval_step, reconstruct, train_step
from video_vae_tpu_torch.utils.metrics import count_params, masked_psnr


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


def check_single_device(mesh: MeshConfig) -> None:
    """Raise unless ``mesh`` is one data-parallel device, the only mesh the port trains on."""
    if mesh.data not in (-1, 1) or mesh.fsdp != 1 or mesh.tensor != 1:
        raise NotImplementedError(
            f"the port trains on one device; data={mesh.data}, fsdp={mesh.fsdp}, "
            f"tensor={mesh.tensor} needs the parallel slice (ROADMAP Queue 1 item 6)"
        )


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
    ):
        check_single_device(cfg.mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.process_index, self.process_count = 0, 1
        self.model = VideoVAE(cfg.model, device=self.device, seed=cfg.train.model_seed)
        self.optimizer = create_optimizer(self.model, cfg.optim)
        self.perceptual_fn = build_perceptual(cfg.loss, vgg_weights, device=self.device)
        self.train_step = functools.partial(train_step, loss_cfg=cfg.loss, perceptual_fn=self.perceptual_fn)
        self.eval_step = functools.partial(eval_step, loss_cfg=cfg.loss, perceptual_fn=self.perceptual_fn)
        self.generator = torch.Generator(self.device).manual_seed(cfg.train.seed)
        self.global_step = 0
        # host seconds spent waiting for the loader's next batch, over every epoch
        self.data_wait_s = 0.0
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        self.shutdown = GracefulShutdown(install=install_signal_handlers)
        self.logger = MetricLogger(
            log_dir=cfg.train.checkpoint_dir,
            use_wandb=use_wandb,
            config={**dataclasses.asdict(cfg), "num_params": count_params(self.model)},
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
        if not t.profile_dir or self.process_index != 0:
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
        if not prefix or self.process_index != 0:
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
        its masked PSNR as ``dump_psnr_det``, and the two mp4s."""
        t = self.cfg.train
        recon = reconstruct(self.model, device_batch["video"], device_batch["mask"], device=self.device)
        psnr = masked_psnr(recon.float(), device_batch["video"].float(), device_batch["mask"])
        self.logger.log({"dump_psnr_det": psnr}, step)
        recon_np = recon.float().cpu().numpy()
        if self.process_index != 0:
            return
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
        data_cfg = cfg.data.replace(batch_size=plan.batch_size, max_frames=plan.max_frames)
        loader = create_dataloader(
            data_cfg,
            seed=cfg.data.seed + epoch,
            process_index=self.process_index,
            process_count=self.process_count,
        )
        # the next batch is fetched and its copy issued once the step is enqueued
        overlap = os.environ.get("VVT_H2D_OVERLAP", "1") != "0"
        batches = iter(loader)

        def fetch_next(to_device: bool = True):
            started = time.perf_counter()
            host_batch = next(batches, None)
            self.data_wait_s += time.perf_counter() - started
            if host_batch is None:
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
        data_cfg = cfg.data.replace(batch_size=plan.batch_size, max_frames=plan.max_frames)
        loader = create_dataloader(
            data_cfg,
            seed=cfg.data.seed + 10_000 + epoch,
            base_dir=cfg.data.eval_dir,
            process_index=self.process_index,
            process_count=self.process_count,
        )
        totals, count = {}, 0
        for host_batch in loader:
            batch = self._ready(*self._put(host_batch, overlap=False))
            hp = self.hparams_for_step(self.global_step)
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
