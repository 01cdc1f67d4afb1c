from video_vae_tpu_torch.losses.losses import vae_loss
from video_vae_tpu_torch.losses.perceptual import make_perceptual_loss_fn

__all__ = ["make_perceptual_loss_fn", "vae_loss"]
