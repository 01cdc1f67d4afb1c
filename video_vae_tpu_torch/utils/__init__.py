from video_vae_tpu_torch.utils.debug import global_max_abs, global_norm

__all__ = ["global_max_abs", "global_norm"]
