from video_vae_tpu_torch.losses.losses import (
    LossMetrics,
    discriminator_loss,
    generator_adversarial_loss,
    vae_loss,
)
from video_vae_tpu_torch.losses.perceptual import make_perceptual_loss_fn

__all__ = [
    "LossMetrics",
    "discriminator_loss",
    "generator_adversarial_loss",
    "make_perceptual_loss_fn",
    "vae_loss",
]
