from video_vae_tpu_torch.utils.debug import global_max_abs, global_norm
from video_vae_tpu_torch.utils.metrics import masked_psnr

__all__ = ["global_max_abs", "global_norm", "masked_psnr"]
