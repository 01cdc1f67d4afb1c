from video_vae_tpu_torch.utils.debug import global_max_abs, global_norm, param_norm
from video_vae_tpu_torch.utils.metrics import count_params, masked_psnr, profile_trace
from video_vae_tpu_torch.utils.timing import SlopeEstimate, robust_slope

__all__ = [
    "SlopeEstimate", "count_params", "global_max_abs", "global_norm", "masked_psnr", "param_norm", "profile_trace",
    "robust_slope",
]
