from video_vae_tpu_torch.models.classifier import Discriminator
from video_vae_tpu_torch.models.vae import Decoder, Encoder, VideoVAE
from video_vae_tpu_torch.models.video_mae import MAEOutput, VideoMAE, mae_loss

__all__ = ["Decoder", "Discriminator", "Encoder", "MAEOutput", "VideoMAE", "VideoVAE", "mae_loss"]
