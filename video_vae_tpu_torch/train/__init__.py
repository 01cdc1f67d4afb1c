from video_vae_tpu_torch.train.adversarial import make_adversarial_train_step
from video_vae_tpu_torch.train.checkpoint import (
    CheckpointManager,
    GracefulShutdown,
    load_checkpoint,
    load_jax_batch_stats,
    load_jax_optimizer_state,
    load_jax_params,
    save_checkpoint,
)
from video_vae_tpu_torch.train.metrics import MetricLogger
from video_vae_tpu_torch.train.setup import Optimizer, create_optimizer, make_lr_schedule
from video_vae_tpu_torch.train.step import build_perceptual, eval_step, reconstruct, train_step
from video_vae_tpu_torch.train.trainer import EpochPlan, Trainer, curriculum_plan

__all__ = [
    "CheckpointManager",
    "EpochPlan",
    "GracefulShutdown",
    "MetricLogger",
    "Optimizer",
    "Trainer",
    "build_perceptual",
    "create_optimizer",
    "curriculum_plan",
    "eval_step",
    "load_checkpoint",
    "load_jax_batch_stats",
    "load_jax_optimizer_state",
    "load_jax_params",
    "make_adversarial_train_step",
    "make_lr_schedule",
    "reconstruct",
    "save_checkpoint",
    "train_step",
]
