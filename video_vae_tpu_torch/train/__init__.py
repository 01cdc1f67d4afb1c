from video_vae_tpu_torch.train.checkpoint import load_jax_params
from video_vae_tpu_torch.train.setup import Optimizer, create_optimizer, make_lr_schedule
from video_vae_tpu_torch.train.step import build_perceptual, reconstruct, train_step

__all__ = [
    "Optimizer",
    "build_perceptual",
    "create_optimizer",
    "load_jax_params",
    "make_lr_schedule",
    "reconstruct",
    "train_step",
]
