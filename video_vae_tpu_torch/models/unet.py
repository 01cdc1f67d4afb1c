"""Shape-preserving 3-D-conv UNet decoder head, channels-first, unpacked.

Counterpart of the JAX package's ``models/unet.py`` in its ``layout="cf"``
form: a (kt,7,7) patch-mixer conv, ``num_levels`` down blocks (2 × conv +
GroupNorm + SiLU, then a spatial 2×2 max pool), two bottleneck conv blocks,
up blocks (spatial 2× transpose conv, skip concat, 2 × conv block) and a
zero-initialised 1×1×1 final conv. Every 3-D conv goes through
:func:`conv3d_cf` (the UpBlock's first one through :func:`conv3d_cf_cat2`, so
the skip concat is never built); the final 1×1×1 conv is an einsum. The JAX
package's space-to-depth phase packing is the same math and is not carried
over. Parameters keep the JAX names and layouts (DHWIO conv kernels). With
``remat`` each down and up block runs under activation checkpointing in
training, as the JAX blocks do under ``nnx.remat``.
"""

from __future__ import annotations

import torch
from torch import nn

from video_vae_tpu_torch.models.layers import maybe_remat, variance_scaling
from video_vae_tpu_torch.ops.conv3d import conv3d_cf, conv3d_cf_cat2
from video_vae_tpu_torch.ops.norm import group_norm_cf, max_pool_2x_cf


class Conv3D(nn.Module):
    """Stride-1 SAME conv3d: kernel (kt, kh, kw, cin, cout), bias (cout,)."""

    def __init__(self, in_features: int, out_features: int, kernel_size, gen: torch.Generator,
                 *, dtype: torch.dtype, zero_init: bool = False):
        super().__init__()
        shape = (*kernel_size, in_features, out_features)
        self.kernel = nn.Parameter(
            torch.zeros(shape) if zero_init else variance_scaling(shape, gen)
        )
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def conv_args(self):
        """(kernel in the compute dtype, f32 bias), as the kernel takes them."""
        return self.kernel.to(self.dtype).contiguous(), self.bias.float().contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(b, t, cin, h, w) → (b, t, cout, h, w)."""
        return conv3d_cf(x.to(self.dtype).contiguous(), *self.conv_args())


class ConvTranspose2x(nn.Module):
    """Spatial 2× transpose conv, kernel = strides = (1,2,2), as one matmul.

    y[t, 2i+a, 2j+b] = Σ_ci W̃[a,b,ci,co] · x[t,i,j,ci] with W̃ the spatially
    flipped kernel (the conv-transpose convention of the JAX module).
    """

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator, *,
                 dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(variance_scaling((1, 2, 2, in_features, out_features), gen))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, cin, h, w = x.shape
        cout = self.kernel.shape[-1]
        wk = self.kernel[0].flip(0, 1).to(self.dtype)  # (2, 2, ci, co), flipped
        wmat = wk.permute(2, 0, 1, 3).reshape(cin, 4 * cout)  # (ci, (a, b, co))
        y = torch.einsum("btchw,ck->btkhw", x.to(self.dtype), wmat)
        y = y.reshape(b, t, 2, 2, cout, h, w).permute(0, 1, 4, 5, 2, 6, 3)
        y = y.reshape(b, t, cout, 2 * h, 2 * w)
        return y + self.bias.to(self.dtype)[None, None, :, None, None]


class GroupNorm(nn.Module):
    """nnx.GroupNorm parameters (scale, bias) and its group count."""

    def __init__(self, num_groups: int, num_features: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))


class ConvBlock3D(nn.Module):
    """Conv3D (kt, k, k) SAME → GroupNorm(≤ 8 groups) → SiLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 gen: torch.Generator, *, temporal_kernel: int = 3, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv3D(
            in_channels, out_channels, (temporal_kernel, kernel_size, kernel_size), gen, dtype=dtype
        )
        self.norm = GroupNorm(min(8, out_channels), out_channels)

    def _norm_silu(self, y: torch.Tensor) -> torch.Tensor:
        return group_norm_cf(y, self.norm.scale, self.norm.bias, self.norm.num_groups, silu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm_silu(self.conv(x))

    def call_cat2(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """The block over the channel concat [x; skip], without building it."""
        dt = self.conv.dtype
        y = conv3d_cf_cat2(
            x.to(dt).contiguous(), skip.to(dt).contiguous(), *self.conv.conv_args()
        )
        return self._norm_silu(y)


class DownBlock3D(nn.Module):
    """2 × ConvBlock3D; returns (spatially pooled, pre-pool skip)."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator, *,
                 temporal_kernel: int = 3, remat: bool = False, dtype: torch.dtype):
        super().__init__()
        kw = dict(temporal_kernel=temporal_kernel, dtype=dtype)
        self.conv1 = ConvBlock3D(in_channels, out_channels, 3, gen, **kw)
        self.conv2 = ConvBlock3D(out_channels, out_channels, 3, gen, **kw)
        self.remat = remat

    def forward(self, x: torch.Tensor):
        return maybe_remat(self.remat, self._forward, x)

    def _forward(self, x: torch.Tensor):
        skip = self.conv2(self.conv1(x))
        return max_pool_2x_cf(skip), skip


class UpBlock3D(nn.Module):
    """Spatial 2× transpose conv, skip concat, 2 × ConvBlock3D."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator, *,
                 temporal_kernel: int = 3, remat: bool = False, dtype: torch.dtype):
        super().__init__()
        kw = dict(temporal_kernel=temporal_kernel, dtype=dtype)
        self.upsample = ConvTranspose2x(in_channels, out_channels, gen, dtype=dtype)
        self.conv1 = ConvBlock3D(out_channels * 2, out_channels, 3, gen, **kw)
        self.conv2 = ConvBlock3D(out_channels, out_channels, 3, gen, **kw)
        self.remat = remat

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return maybe_remat(self.remat, self._forward, x, skip)

    def _forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1.call_cat2(self.upsample(x), skip))


class UNet3D(nn.Module):
    """(b, t, c_in, h, w) → (b, t, c_out, h, w), zero-initialised output."""

    def __init__(self, channels: int, base_features: int, num_levels: int, out_features: int,
                 gen: torch.Generator, *, temporal_kernel: int = 3, remat: bool = False,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        kw = dict(temporal_kernel=temporal_kernel, dtype=dtype)
        blocks = dict(kw, remat=remat)
        self.patch_mixer = Conv3D(channels, channels, (temporal_kernel, 7, 7), gen, dtype=dtype)
        self.encoders = nn.ModuleList()
        in_ch = channels
        for i in range(num_levels):
            out_ch = base_features * 2**i
            self.encoders.append(DownBlock3D(in_ch, out_ch, gen, **blocks))
            in_ch = out_ch
        bottleneck_ch = base_features * 2**num_levels
        self.bottleneck1 = ConvBlock3D(in_ch, bottleneck_ch, 3, gen, **kw)
        self.bottleneck2 = ConvBlock3D(bottleneck_ch, bottleneck_ch, 3, gen, **kw)
        self.decoders = nn.ModuleList()
        in_ch = bottleneck_ch
        for i in range(num_levels - 1, -1, -1):
            out_ch = base_features * 2**i
            self.decoders.append(UpBlock3D(in_ch, out_ch, gen, **blocks))
            in_ch = out_ch
        self.final_conv = Conv3D(
            base_features, out_features, (1, 1, 1), gen, dtype=dtype, zero_init=True
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_mixer(x.to(self.dtype))
        skips = []
        for encoder in self.encoders:
            x, skip = encoder(x)
            skips.append(skip)
        x = self.bottleneck2(self.bottleneck1(x))
        for decoder, skip in zip(self.decoders, reversed(skips)):
            x = decoder(x, skip)
        fc = self.final_conv
        w = fc.kernel[0, 0, 0].to(fc.dtype)  # (cin, cout)
        return torch.einsum("btchw,cd->btdhw", x.to(fc.dtype), w) + fc.bias.to(fc.dtype)[
            None, None, :, None, None
        ]
