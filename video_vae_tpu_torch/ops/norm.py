"""LayerNorm and GroupNorm(+SiLU) with the JAX package's numerics.

Not ``nn.LayerNorm``/``nn.GroupNorm``: those use eps 1e-5, a two-pass
variance for LayerNorm and f32 arithmetic throughout. Here:

* token LayerNorm: f32 statistics, variance E[x²]−mean² clamped at 0,
  eps 1e-6, affine in f32, one cast to the input dtype at the end;
* channels-first GroupNorm: statistics per (batch, group) over t, h, w and
  the group's channels (so across every frame of the clip), two-pass f32
  variance, then subtract, scale and affine in the compute dtype.

Both carry the JAX package's hand-derived backward (``ops/norm.py``
``_ln_bwd`` and ``_gn_silu_bwd``) as ``torch.autograd.Function``s: the
forward saves (x, mean, r) and the backward recomputes the normalised xn
from them, so autograd never stores the elementwise chain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
GN_EPS = 1e-6


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        r = torch.rsqrt(var + eps)
        y = (xf - mean) * (r * scale.float())
        if bias is not None:
            y = y + bias.float()
        ctx.save_for_backward(x, scale, bias, mean, r)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        """dx = r·(dxn − mean(dxn) − xn·mean(dxn·xn)); dscale, dbias as f32 sums."""
        x, scale, bias, mean, r = ctx.saved_tensors
        xn = (x.float() - mean) * r
        dyf = dy.float()
        lead = tuple(range(x.dim() - 1))
        dscale = (dyf * xn).sum(dim=lead).to(scale.dtype)
        dbias = None if bias is None else dyf.sum(dim=lead).to(bias.dtype)
        dxn = dyf * scale.float()
        m1 = dxn.mean(dim=-1, keepdim=True)
        m2 = (dxn * xn).mean(dim=-1, keepdim=True)
        dx = (r * (dxn - m1 - xn * m2)).to(x.dtype)
        return dx, dscale, dbias, None


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float = LN_EPS,
) -> torch.Tensor:
    """Last-axis LayerNorm; ``bias`` may be None (the q/k norms have none)."""
    return _LayerNorm.apply(x, scale, bias, eps)


def _gn_stats(x: torch.Tensor, num_groups: int, eps: float):
    """(grouped view, f32 mean, f32 rsqrt factor), two-pass variance."""
    b, t, c, h, w = x.shape
    xg = x.reshape(b, t, num_groups, c // num_groups, h, w)
    dims = (1, 3, 4, 5)
    xf = xg.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return xg, mean, torch.rsqrt(var + eps)


def _gn_affine(x, xg, mean, r, scale, bias):
    """Subtract, scale and affine in the compute dtype, as the JAX forward."""
    dt = x.dtype
    y = ((xg - mean.to(dt)) * r.to(dt)).reshape(x.shape)
    y = y * scale.to(dt)[None, None, :, None, None]
    return y + bias.to(dt)[None, None, :, None, None]


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        xg, mean, r = _gn_stats(x, num_groups, eps)
        ctx.save_for_backward(x, scale, bias, mean, r)
        ctx.num_groups = num_groups
        return F.silu(_gn_affine(x, xg, mean, r, scale, bias))

    @staticmethod
    def backward(ctx, dz):
        """silu' → dscale/dbias (f32 sums per channel) → the grouped norm backward."""
        x, scale, bias, mean, r = ctx.saved_tensors
        b, t, c, h, w = x.shape
        g = ctx.num_groups
        xg = x.reshape(b, t, g, c // g, h, w)
        xn = ((xg - mean.to(x.dtype)) * r.to(x.dtype)).reshape(b, t, c, h, w).float()
        per_channel = lambda v: v.float()[None, None, :, None, None]  # noqa: E731
        yf = xn * per_channel(scale) + per_channel(bias)
        sig = torch.sigmoid(yf)
        dy = dz.float() * sig * (1.0 + yf * (1.0 - sig))
        dscale = (dy * xn).sum(dim=(0, 1, 3, 4)).to(scale.dtype)
        dbias = dy.sum(dim=(0, 1, 3, 4)).to(bias.dtype)
        dxng = (dy * per_channel(scale)).reshape(b, t, g, c // g, h, w)
        xng = xn.reshape(b, t, g, c // g, h, w)
        dims = (1, 3, 4, 5)
        m1 = dxng.mean(dim=dims, keepdim=True)
        m2 = (dxng * xng).mean(dim=dims, keepdim=True)
        dx = r * (dxng - m1 - xng * m2)
        return dx.reshape(b, t, c, h, w).to(x.dtype), dscale, dbias, None, None


def group_norm_cf(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    *,
    eps: float = GN_EPS,
    silu: bool = False,
) -> torch.Tensor:
    """x: (b, t, c, h, w); scale/bias: (c,). Returns x.dtype."""
    if silu:
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps)
    xg, mean, r = _gn_stats(x, num_groups, eps)
    return _gn_affine(x, xg, mean, r, scale, bias)


def max_pool_2x_cf(x: torch.Tensor) -> torch.Tensor:
    """Spatial-only (1,2,2) max pool on (b, t, c, h, w)."""
    a = torch.maximum(x[..., 0::2], x[..., 1::2])
    return torch.maximum(a[..., 0::2, :], a[..., 1::2, :])
