"""Kernels and plain tensor functions of the port.

``KERNELS`` lists the port's nine CUDA kernels, one per Pallas kernel of the
JAX package, each with its launch count. (``flash_attention`` the function
is not re-exported here: the name is the submodule's.)
"""

from video_vae_tpu_torch.ops.attention import masked_attention
from video_vae_tpu_torch.ops.conv3d import (
    CONV3D,
    CONV3D_TAPDOT,
    CONV3D_WGRAD,
    conv3d_cf,
    conv3d_cf_cat2,
    conv3d_cf_pooled,
)
from video_vae_tpu_torch.ops.flash_attention import (
    ATTENTION_SUBLAYER,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    FUSED_ATTENTION,
    FUSED_ATTENTION_BWD,
    fused_attention_sublayer,
    fused_qkv_attention,
)
from video_vae_tpu_torch.ops.fused_block import FUSED_MLP, fused_mlp_sublayer

KERNELS = (
    FUSED_ATTENTION, CONV3D, FUSED_ATTENTION_BWD, CONV3D_WGRAD,
    FLASH_ATTENTION, FLASH_ATTENTION_BWD, ATTENTION_SUBLAYER,
    FUSED_MLP, CONV3D_TAPDOT,
)

__all__ = [
    "ATTENTION_SUBLAYER",
    "CONV3D",
    "CONV3D_TAPDOT",
    "CONV3D_WGRAD",
    "FLASH_ATTENTION",
    "FLASH_ATTENTION_BWD",
    "FUSED_ATTENTION",
    "FUSED_ATTENTION_BWD",
    "FUSED_MLP",
    "KERNELS",
    "conv3d_cf",
    "conv3d_cf_cat2",
    "conv3d_cf_pooled",
    "fused_attention_sublayer",
    "fused_mlp_sublayer",
    "fused_qkv_attention",
    "masked_attention",
]
