"""3-D CNN real/fake discriminator with spectral-normalised convolutions.

Counterpart of the JAX package's ``models/classifier.py``: the same modules,
names and parameter layouts (conv kernels (kt, kh, kw, in, out), Linear
kernels (in, out), the ``u`` vector of each spectral norm (1, out)), so the
weight bridge maps them one to one (``u``, a ``BatchStat`` in JAX, is a
buffer here: ``train/checkpoint.py:load_jax_batch_stats``).

* **Spectral norm scales the output.** One step of the Miyato power iteration
  on ``kernel.reshape(-1, out)`` in f32 gives σ (no gradient); the layer's
  output becomes ``(out − b)/σ + b``, with σ and b in the output's dtype, as
  JAX computes it. Every call moves ``u`` once (JAX's discriminator never
  passes ``update_stats=False``).
* **Remat.** ``SNDownBlock3D`` runs under activation checkpointing in
  training, as JAX runs it under ``nnx.remat``. JAX's recompute does not write
  ``u`` again; ``torch.utils.checkpoint`` re-runs the Python forward, so the
  block takes both σ (and moves both ``u``) before the checkpointed region
  and hands them in.
* **GroupNorm is flax's** (``nnx.GroupNorm``): epsilon 1e-6, statistics in
  f32 with the fast variance E[x²] − E[x]² clipped at 0, the input, scale
  and bias first cast to the compute dtype, the result cast back to it. It
  is not ``torch.nn.GroupNorm``, nor the UNet's ``ops/norm.py`` form.

The convs are ``F.conv3d`` on channels-first maps (cuDNN on the card): the
JAX package computes them with ``nnx.Conv`` outside any Pallas kernel. The
input is pixels-last (b, t, h, w, c), the output one logit per clip (b, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.models.layers import Linear, maybe_remat, variance_scaling

GN_EPS = 1e-6  # flax nnx.GroupNorm's default


class Conv3d(nn.Module):
    """nnx.Conv with SAME padding on channels-first (b, c, t, h, w) maps.

    kernel (kt, kh, kw, in, out), odd sizes; bias (out,). Input and kernel
    are cast to ``dtype``, the bias is added after the convolution in
    ``dtype``, as flax adds it.
    """

    def __init__(self, in_features: int, out_features: int, kernel_size: tuple[int, int, int],
                 gen: torch.Generator, *, dtype: torch.dtype):
        super().__init__()
        if any(k % 2 == 0 for k in kernel_size):
            raise ValueError(f"SAME padding here takes odd kernel sizes, got {kernel_size}")
        self.kernel = nn.Parameter(variance_scaling((*kernel_size, in_features, out_features), gen))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype).permute(4, 3, 0, 1, 2)
        y = F.conv3d(x.to(self.dtype), w, padding=tuple(k // 2 for k in self.kernel.shape[:3]))
        return y + self.bias.to(self.dtype)[:, None, None, None]


class SpectralNorm(nn.Module):
    """Wrap a layer that has ``kernel`` (..., out) and ``bias``; divide its output
    by the kernel's spectral norm, estimated by ``n_steps`` power steps a call."""

    def __init__(self, layer: nn.Module, gen: torch.Generator, n_steps: int = 1):
        super().__init__()
        self.layer = layer
        self.n_steps = n_steps
        self.register_buffer("u", torch.randn((1, layer.kernel.shape[-1]), generator=gen))

    @torch.no_grad()
    def sigma(self, update_stats: bool = True) -> torch.Tensor:
        """σ in f32; with ``update_stats`` after ``n_steps`` power steps that move ``u``."""
        w = self.layer.kernel.detach().reshape(-1, self.layer.kernel.shape[-1]).float()
        u = self.u.float()
        v = None
        if update_stats:
            for _ in range(self.n_steps):
                v = u @ w.T
                v = v / torch.linalg.norm(v)
                u = v @ w
                u = u / torch.linalg.norm(u)
            self.u.copy_(u)
        if v is None:
            v = u @ w.T
            v = v / torch.linalg.norm(v)
        return (v @ w @ u.T)[0, 0]

    def forward(self, x: torch.Tensor, sigma: Optional[torch.Tensor] = None,
                update_stats: bool = True) -> torch.Tensor:
        """``sigma``: one the caller took already with :meth:`sigma` (``u`` is then left alone)."""
        if sigma is None:
            sigma = self.sigma(update_stats)
        out = self.layer(x)
        b = self.layer.bias.to(out.dtype)
        b = b[:, None, None, None] if out.dim() == 5 else b  # a conv's channels-first output
        return (out - b) / sigma.to(out.dtype) + b


class GroupNorm(nn.Module):
    """flax ``nnx.GroupNorm`` on channels-first maps (see the module docstring)."""

    def __init__(self, num_features: int, num_groups: int, *, dtype: torch.dtype):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {num_features} channels")
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.to(self.dtype).float()
        groups = xf.reshape(b, self.num_groups, -1)
        mean = groups.mean(dim=2)
        var = torch.clamp(groups.square().mean(dim=2) - mean.square(), min=0.0)
        per_channel = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // self.num_groups, dim=1).reshape(per_channel)
        var = var.repeat_interleave(c // self.num_groups, dim=1).reshape(per_channel)
        feature = (c,) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + GN_EPS) * self.scale.to(self.dtype).float().reshape(feature)
        y = (xf - mean) * mul + self.bias.to(self.dtype).float().reshape(feature)
        return y.to(self.dtype)


class SNConvBlock3D(nn.Module):
    """Spectral-normed Conv3D → GroupNorm → SiLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, gen: torch.Generator, *,
                 temporal_kernel: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = SpectralNorm(
            Conv3d(in_channels, out_channels, (temporal_kernel, kernel_size, kernel_size), gen, dtype=dtype), gen
        )
        self.norm = GroupNorm(out_channels, min(8, out_channels), dtype=dtype)

    def forward(self, x: torch.Tensor, sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.silu(self.norm(self.conv(x, sigma)))


class SNDownBlock3D(nn.Module):
    """Two SNConvBlock3Ds, then a spatial-only 2×2 max pool."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator, *, temporal_kernel: int = 3,
                 remat: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(temporal_kernel=temporal_kernel, dtype=dtype)
        self.conv1 = SNConvBlock3D(in_channels, out_channels, 3, gen, **kw)
        self.conv2 = SNConvBlock3D(out_channels, out_channels, 3, gen, **kw)
        self.remat = remat

    def _forward(self, x: torch.Tensor, sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x, sigma1), sigma2)
        return F.max_pool3d(x, kernel_size=(1, 2, 2), stride=(1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # σ depends on the kernels and u only: both are taken (and both u moved once)
        # here, so that a recompute under checkpointing does not move them again
        sigmas = self.conv1.conv.sigma(), self.conv2.conv.sigma()
        return maybe_remat(self.remat, self._forward, x, *sigmas)


class Discriminator(nn.Module):
    """(b, t, h, w, c) video → (b, 1) real/fake logits.

    An initial 7×7 (× ``temporal_kernel``) SN conv block of ``base_features``
    channels, ``num_levels`` down blocks doubling the channels, a mean over
    (t, h, w), then a Linear to one logit. Parameters in f32, computed in
    ``dtype``; drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device`` defaults to CUDA and raises where there is none.
    """

    def __init__(self, channels: int = 3, base_features: int = 32, num_levels: int = 4, *,
                 temporal_kernel: int = 3, remat: bool = True, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(temporal_kernel=temporal_kernel, dtype=dtype)
        self.dtype = dtype
        self.initial_conv = SNConvBlock3D(channels, base_features, 7, gen, **kw)
        self.encoders = nn.ModuleList()
        in_ch = base_features
        for i in range(num_levels):
            out_ch = base_features * 2 ** (i + 1)
            self.encoders.append(SNDownBlock3D(in_ch, out_ch, gen, remat=remat, **kw))
            in_ch = out_ch
        self.classifier = Linear(in_ch, 1, gen, dtype=dtype)
        self.to(device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.initial_conv(x.permute(0, 4, 1, 2, 3))  # channels-first
        for encoder in self.encoders:
            x = encoder(x)
        x = x.float().mean(dim=(2, 3, 4)).to(self.dtype)  # jnp.mean: an f32 sum, cast back
        return self.classifier(x)
