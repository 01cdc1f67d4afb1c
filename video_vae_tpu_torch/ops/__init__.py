"""Kernels and plain tensor functions of the port.

``KERNELS`` lists every CUDA kernel of the serving and training paths with
its launch count.
"""

from video_vae_tpu_torch.ops.conv3d import CONV3D, CONV3D_WGRAD, conv3d_cf, conv3d_cf_cat2
from video_vae_tpu_torch.ops.flash_attention import (
    FUSED_ATTENTION,
    FUSED_ATTENTION_BWD,
    fused_qkv_attention,
)

KERNELS = (FUSED_ATTENTION, CONV3D, FUSED_ATTENTION_BWD, CONV3D_WGRAD)

__all__ = [
    "CONV3D",
    "CONV3D_WGRAD",
    "FUSED_ATTENTION",
    "FUSED_ATTENTION_BWD",
    "KERNELS",
    "conv3d_cf",
    "conv3d_cf_cat2",
    "fused_qkv_attention",
]
