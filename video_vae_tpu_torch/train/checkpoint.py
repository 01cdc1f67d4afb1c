"""Weight bridge from the JAX package's parameters to the port's modules.

The port keeps the JAX module names and parameter layouts (Linear kernels
(in, out), DHWIO conv kernels, the (1,2,2,ci,co) transpose-conv kernel whose
spatial flip is applied at use, LN/GN scale and bias, the (1,1,1,latent)
fill token), so the mapping is one to one by path: the JAX path
``encoder/layers/0/TemporalAttention/qkv_projection/kernel`` is the port's
parameter ``encoder.layers.0.TemporalAttention.qkv_projection.kernel``.
The flat dict comes from ``nnx.state(model, nnx.Param).flat_state()`` on
the JAX side, paths joined with ``/``. The same bridge fills the perceptual
loss's VGG (``models/vgg.py``) from the JAX ``VGG16Features``: its HWIO
kernels sit under ``convs/<name>/kernel`` on both sides.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_jax_params(model: nn.Module, params: Mapping[str, np.ndarray]) -> int:
    """Copy every parameter of ``model`` from ``params``, in place.

    Raises on a missing key, an unused key or a shape mismatch. Returns the
    number of parameters copied.
    """
    ours = {name.replace(".", "/"): p for name, p in model.named_parameters()}
    missing = sorted(set(ours) - set(params))
    unused = sorted(set(params) - set(ours))
    if missing or unused:
        raise KeyError(f"parameter sets differ: missing {missing}, unused {unused}")
    with torch.no_grad():
        for key, p in ours.items():
            value = np.asarray(params[key])
            if value.shape != tuple(p.shape):
                raise ValueError(f"{key}: shape {value.shape}, port expects {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return len(ours)
