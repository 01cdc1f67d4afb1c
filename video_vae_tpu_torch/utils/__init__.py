from video_vae_tpu_torch.utils.debug import global_max_abs, global_norm
from video_vae_tpu_torch.utils.metrics import count_params, masked_psnr

__all__ = ["count_params", "global_max_abs", "global_norm", "masked_psnr"]
