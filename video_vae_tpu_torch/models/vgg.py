"""VGG16 feature extractor for the perceptual loss, truncated after relu2_1.

Counterpart of the JAX package's ``models/vgg.py`` (``VGG16Features`` on its
default NHWC path): ImageNet normalisation, conv1_1, conv1_2, a 2×2 max pool,
conv2_1, each conv followed by ReLU, in bf16 with f32 parameters. Only the
three activations the loss reads (relu1_1, relu1_2, relu2_1) are computed.

Kernels stay HWIO under ``convs.<name>.kernel``, as in the JAX params, so
``load_jax_params`` fills them by path. These convs are XLA convolutions in
the JAX package, not Pallas kernels, so ``F.conv2d`` computes them here.

Pretrained weights come as the ``.npz`` that the JAX package's converter
writes (``conv1_1.kernel`` HWIO, ``conv1_1.bias``, …):
``python -m video_vae_tpu_torch.cli.convert_vgg vgg16.pth vgg16.npz`` makes
the same file from a torchvision VGG16 state dict, and
``load_vgg(weights_path)`` reads it.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
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
    normalize: bool = True,
    layout: str = "nhwc",
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> VGG16Features:
    """The feature extractor with frozen parameters on ``device``.

    With ``weights_path`` the filters come from that ``.npz`` (HWIO kernels
    under ``<conv>.kernel``, biases under ``<conv>.bias``). Without it they
    are random (fan-in truncated normal from ``seed``) and a warning says
    so: a random VGG is a materially different objective from the
    ImageNet-pretrained one. ``layout="cf"`` (the JAX package's
    channels-first VGG on the direct conv kernel) is not ported yet.
    """
    dev = resolve_device(device)
    if layout != "nhwc":
        raise NotImplementedError(f"vgg layout {layout!r} is not ported yet")
    model = VGG16Features(torch.Generator().manual_seed(seed), normalize=normalize, dtype=dtype)
    if weights_path:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(weights_path)
        data = np.load(weights_path)
        with torch.no_grad():
            for name, _, _ in TRUNCATED_PLAN:
                conv = model.convs[name]
                kernel, bias = data[f"{name}.kernel"], data[f"{name}.bias"]
                if kernel.shape != tuple(conv.kernel.shape) or bias.shape != tuple(conv.bias.shape):
                    raise ValueError(f"{name}: kernel {kernel.shape}, bias {bias.shape} in {weights_path}, "
                                     f"expected {tuple(conv.kernel.shape)}, {tuple(conv.bias.shape)}")
                conv.kernel.copy_(torch.from_numpy(np.asarray(kernel, np.float32)))
                conv.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
    else:
        warnings.warn(
            "Perceptual loss is using RANDOM VGG filters: no weights_path was given. "
            "This is a materially different training objective from an "
            "ImageNet-pretrained VGG16. Convert weights with `python -m "
            "video_vae_tpu_torch.cli.convert_vgg vgg16.pth vgg16.npz` and pass "
            "--vgg_weights / weights_path.",
            stacklevel=2,
        )
    model.requires_grad_(False)
    return model.to(dev)


# torchvision's vgg16 ``features`` index of each conv this model keeps
TORCHVISION_INDEX = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5}


def convert_torchvision_state_dict(state_dict: Mapping[str, np.ndarray], out_path: str) -> None:
    """torchvision vgg16 state dict (OIHW weights) → ``.npz`` with HWIO kernels."""
    arrays = {}
    for name, idx in TORCHVISION_INDEX.items():
        w = np.asarray(state_dict[f"features.{idx}.weight"])  # (out, in, kh, kw)
        arrays[f"{name}.kernel"] = np.transpose(w, (2, 3, 1, 0))  # → (kh, kw, in, out)
        arrays[f"{name}.bias"] = np.asarray(state_dict[f"features.{idx}.bias"])
    np.savez(out_path, **arrays)
