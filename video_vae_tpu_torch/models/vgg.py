"""VGG16 feature extractor for the perceptual loss, truncated after relu2_1.

Counterpart of the JAX package's ``models/vgg.py`` (``VGG16Features`` on its
default NHWC path): ImageNet normalisation, conv1_1, conv1_2, a 2×2 max pool,
conv2_1, each conv followed by ReLU, in bf16 with f32 parameters. Only the
three activations the loss reads (relu1_1, relu1_2, relu2_1) are computed.

Kernels stay HWIO under ``convs.<name>.kernel``, as in the JAX params, so
``load_jax_params`` fills them by path. These convs are XLA convolutions in
the JAX package, not Pallas kernels, so ``F.conv2d`` computes them here.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.models.layers import variance_scaling

# (name, cin, cout) up to relu2_1 (torchvision features 0, 2, then 5 after the pool)
TRUNCATED_PLAN = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PERCEPTUAL_LAYERS = ("relu1_1", "relu1_2", "relu2_1")


class Conv2D(nn.Module):
    """nnx.Conv (3×3, SAME): kernel (kh, kw, cin, cout), bias (cout,)."""

    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(variance_scaling((3, 3, cin, cout), gen))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, cin, h, w) → (N, cout, h, w) in x's dtype.

        The bias is added after the conv's rounding to x's dtype, as flax does.
        """
        w = self.kernel.to(x.dtype).permute(3, 2, 0, 1)  # HWIO → OIHW
        return F.conv2d(x, w, padding=1) + self.bias.to(x.dtype)[:, None, None]


class VGG16Features(nn.Module):
    """Truncated VGG16: {reluX_Y: (N, C, h, w) activation} of NHWC [0, 1] images."""

    def __init__(self, gen: torch.Generator, *, normalize: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.normalize = normalize
        self.dtype = dtype
        self.convs = nn.ModuleDict({name: Conv2D(cin, cout, gen) for name, cin, cout in TRUNCATED_PLAN})

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        if self.normalize:  # in self.dtype, constants too, as the JAX model computes it
            mean = torch.tensor(IMAGENET_MEAN, dtype=self.dtype, device=x.device)
            std = torch.tensor(IMAGENET_STD, dtype=self.dtype, device=x.device)
            x = (x - mean) / std
        x = x.permute(0, 3, 1, 2)
        acts = {}
        x = F.relu(self.convs["conv1_1"](x))
        acts["relu1_1"] = x
        x = F.relu(self.convs["conv1_2"](x))
        acts["relu1_2"] = x
        x = F.relu(self.convs["conv2_1"](F.max_pool2d(x, 2)))
        acts["relu2_1"] = x
        return acts


def load_vgg(
    weights_path: Optional[str] = None,
    *,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> VGG16Features:
    """The feature extractor with frozen parameters on ``device``.

    Without ``weights_path`` the filters are random (fan-in truncated normal)
    and a warning says so: a random VGG is a materially different objective
    from the ImageNet-pretrained one. Loading converted ``.npz`` weights is
    not ported yet; fill a model from the JAX package's VGG with
    ``load_jax_params`` instead.
    """
    dev = resolve_device(device)
    if weights_path:
        raise NotImplementedError(
            "loading VGG weights from .npz is not ported yet; use load_jax_params"
        )
    warnings.warn(
        "Perceptual loss is using RANDOM VGG filters: no weights_path was given. "
        "This is a materially different training objective from an "
        "ImageNet-pretrained VGG16.",
        stacklevel=2,
    )
    model = VGG16Features(torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    return model.to(dev)
