"""Transformer building blocks of the factored space/time video model.

Counterparts of the JAX package's ``models/layers.py``, with the same module
and parameter names so that weight paths match one to one. Parameters keep
the JAX layouts: a Linear kernel is (in, out) and the port multiplies
``x @ kernel``. Each module computes in the config's compute dtype and holds
its parameters in the param dtype, as the JAX modules do. Under a tensor > 1
mesh (``parallel/tensor_parallel.py``) an ``Attention`` or ``MLP`` whose
``tensor_parallel`` is set runs on the rank's heads or hidden columns through
the module chain, and the sublayer kernels give way to it, as in JAX.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_vae_tpu_torch.ops.attention import masked_attention
from video_vae_tpu_torch.ops.flash_attention import fused_attention_sublayer, fused_qkv_attention
from video_vae_tpu_torch.ops.fused_block import fused_mlp_sublayer
from video_vae_tpu_torch.ops.norm import LN_EPS, layer_norm
from video_vae_tpu_torch.ops.rope import apply_rope
from video_vae_tpu_torch.parallel import sharding, tensor_parallel

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling(shape, gen: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init (flax ``lecun_normal`` at scale 1).

    fan_in is the product of every dim but the last, as for flax's Linear
    (in, out) and conv (..., in, out) kernels.
    """
    fan_in = math.prod(shape[:-1])
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(math.sqrt(scale / fan_in) / _TRUNC_STD)


# 100x-reduced init scale on residual-branch output projections (small_init)
SMALL_INIT_SCALE = 1e-2


class Linear(nn.Module):
    """nnx.Linear: kernel (in, out), bias (out,), computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator, *,
                 dtype: torch.dtype, kernel_scale: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(variance_scaling((in_features, out_features), gen, kernel_scale))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, tp: Optional[tensor_parallel.TensorGroup] = None) -> torch.Tensor:
        """``x @ kernel + bias``; with ``tp`` a row-parallel product, whose partial
        sums are summed over the tensor ranks before the bias is added."""
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return tensor_parallel.reduce_from_tensor_region(y, tp) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """nnx.LayerNorm parameters (scale, optional bias) on the port's layer_norm."""

    def __init__(self, dim: int, *, use_bias: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class PatchEmbedding(nn.Module):
    """(b,t,H,W,C) → (b,t,hw,p²c): patches, LayerNorm in pixel space, Linear.

    The per-token LayerNorm statistics are taken in f32 on the patch blocks of
    the un-patchified video; subtract and scale run in the compute dtype, and
    the LN affine is folded into the Linear: y = xn @ (γ⊙K) + (β @ K + b).
    """

    def __init__(self, channels: int, patch_size: int, gen: torch.Generator, *,
                 dtype: torch.dtype):
        super().__init__()
        dim = channels * patch_size * patch_size
        self.patch_size = patch_size
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.linear = Linear(dim, dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        x = x.to(self.dtype)
        b, t, hh, ww, c = x.shape
        xb = x.reshape(b, t, hh // p, p, ww // p, p, c)
        xf = xb.float()
        dims = (3, 5, 6)
        mean = xf.mean(dim=dims, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=dims, keepdim=True) - mean.square(), min=0.0)
        xn = (xb - mean.to(self.dtype)) * torch.rsqrt(var + LN_EPS).to(self.dtype)
        tokens = rearrange(xn, "b t h p1 w p2 c -> b t (h w) (p1 p2 c)")
        kern = self.linear.kernel
        wk = (self.norm.scale[:, None] * kern).to(self.dtype)
        bias = (self.norm.bias @ kern + self.linear.bias).to(self.dtype)
        return tokens @ wk + bias


class PatchUnEmbedding(nn.Module):
    """Tokens → (channels-first upsampled conv features, direct reconstruction).

    Both outputs are channels-first: conv_features (b,t,c·up,H,W) feed the
    UNet, direct (b,t,c,H,W) is the path the UNet output is added to.
    """

    def __init__(self, height: int, width: int, channels: int, patch_size: int,
                 upsample_rate: int, gen: torch.Generator, *, dtype: torch.dtype):
        super().__init__()
        dim = channels * patch_size * patch_size
        self.patch_size = patch_size
        self.height = height
        self.width = width
        self.dtype = dtype
        self.linear = Linear(dim, dim, gen, dtype=dtype)
        self.upsample = Linear(dim, dim * upsample_rate, gen, dtype=dtype)
        self.downsample = Linear(channels * upsample_rate, channels, gen, dtype=dtype)

    def forward(self, x: torch.Tensor):
        p = self.patch_size
        x = self.upsample(self.linear(x))
        conv_features = rearrange(
            x, "b t (h w) (p1 p2 c) -> b t c (h p1) (w p2)",
            p1=p, p2=p, h=self.height // p, w=self.width // p,
        )
        direct = torch.einsum(
            "btchw,cd->btdhw", conv_features, self.downsample.kernel.to(self.dtype)
        ) + self.downsample.bias.to(self.dtype)[None, None, :, None, None]
        return conv_features, direct


class Attention(nn.Module):
    """Pre-LN multi-head attention: fused QKV, per-head QK-norm, RoPE.

    ``attention_impl`` picks the chain after the QKV projection, as in the
    JAX module: ``"fused"`` is one kernel off the fused projection (f32
    statistics and rotation, one rounding); ``"xla"`` and ``"pallas"`` split,
    apply the per-head LayerNorm and the RoPE in the compute dtype, and call
    :func:`masked_attention` with that implementation.
    """

    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 gen: torch.Generator, *, rope_base: float = 10000.0,
                 rope_alpha: float = 1.0, attention_impl: str = "xla", dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.rope_base = rope_base
        self.rope_alpha = rope_alpha
        self.attention_impl = attention_impl
        head_dim = qkv_features // num_heads
        self.input_norm = LayerNorm(in_features)
        self.qkv_projection = Linear(in_features, qkv_features * 3, gen, dtype=dtype)
        self.out_projection = Linear(
            qkv_features, in_features, gen, dtype=dtype, kernel_scale=SMALL_INIT_SCALE
        )
        self.q_norm = LayerNorm(head_dim, use_bias=False)
        self.k_norm = LayerNorm(head_dim, use_bias=False)
        # set by train/setup.py:create_sharded_model under a tensor > 1 mesh
        self.tensor_parallel: Optional[tensor_parallel.TensorGroup] = None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = self.tensor_parallel
        if self.attention_impl == "fused" and tp is None:
            qkv = self.qkv_projection(self.input_norm(x))
            out = fused_qkv_attention(
                qkv, self.q_norm.scale, self.k_norm.scale, mask,
                self.num_heads, self.rope_base, self.rope_alpha,
            )
            return self.out_projection(out)
        impl = self.attention_impl
        if impl == "fused":  # under tensor > 1 the kernel gives way to the chain (JAX layers.py:303)
            sharding.log_chain("fused_attention")
            impl = "xla"
        qkv = self.qkv_projection(tensor_parallel.copy_to_tensor_region(self.input_norm(x), tp))
        b, s, _ = qkv.shape
        heads = tensor_parallel.local_heads(self.num_heads, tp)
        q, k, v = (t.reshape(b, s, heads, -1) for t in qkv.chunk(3, dim=-1))
        q_scale, k_scale = (tensor_parallel.copy_to_tensor_region(n.scale, tp) for n in (self.q_norm, self.k_norm))
        q, k = apply_rope(
            layer_norm(q, q_scale, None), layer_norm(k, k_scale, None), base=self.rope_base, alpha=self.rope_alpha
        )
        out = masked_attention(q, k, v, mask, impl=impl)
        return self.out_projection(out.reshape(b, s, -1), tp)


def apply_attention(attn: Attention, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Residual attention sublayer: x + Attention(x).

    With ``attention_impl="fused"`` and ``VVT_ATTN_SUBLAYER=1`` in the
    environment (read at every call, the JAX package's knob) the whole
    sublayer (input LN, QKV projection, attention, out projection, residual)
    goes through :func:`fused_attention_sublayer`, except under a tensor > 1
    mesh, where the module chain runs on the rank's heads.
    """
    if attn.attention_impl == "fused" and os.environ.get("VVT_ATTN_SUBLAYER", "0") == "1":
        if attn.tensor_parallel is not None or sharding.takes_chain():
            sharding.log_chain("fused_attention_sublayer")
            return x + attn(x, mask)
        return fused_attention_sublayer(
            x,
            attn.input_norm.scale, attn.input_norm.bias,
            attn.qkv_projection.kernel, attn.qkv_projection.bias,
            attn.q_norm.scale, attn.k_norm.scale,
            attn.out_projection.kernel, attn.out_projection.bias,
            mask, attn.num_heads, attn.rope_base, attn.rope_alpha,
        )
    return x + attn(x, mask)


class MLP(nn.Module):
    """Pre-LN → Linear → SiLU → Linear (small-init out)."""

    def __init__(self, in_features: int, mlp_dim: int, gen: torch.Generator, *,
                 dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(in_features)
        self.linear1 = Linear(in_features, mlp_dim, gen, dtype=dtype)
        self.linear2 = Linear(mlp_dim, in_features, gen, dtype=dtype, kernel_scale=SMALL_INIT_SCALE)
        # set by train/setup.py:create_sharded_model under a tensor > 1 mesh
        self.tensor_parallel: Optional[tensor_parallel.TensorGroup] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tensor_parallel
        return self.linear2(F.silu(self.linear1(tensor_parallel.copy_to_tensor_region(self.norm(x), tp))), tp)


def apply_mlp(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """Residual MLP sublayer: x + MLP(x).

    With ``VVT_MLP_FUSED=1`` in the environment (read at every call, the JAX
    package's knob) the whole sublayer (LN, both products, SiLU, residual)
    goes through :func:`fused_mlp_sublayer`, whose products run on bf16
    operands whatever the compute dtype. Under a tensor > 1 mesh the module
    chain runs instead (JAX ``ops/fused_block.py:224-229``).
    """
    if os.environ.get("VVT_MLP_FUSED", "0") == "1":
        if mlp.tensor_parallel is not None or sharding.takes_chain():
            sharding.log_chain("fused_mlp")
            return x + mlp(x)
        return fused_mlp_sublayer(
            x,
            mlp.norm.scale, mlp.norm.bias,
            mlp.linear1.kernel, mlp.linear1.bias,
            mlp.linear2.kernel, mlp.linear2.bias,
        )
    return x + mlp(x)


def maybe_remat(enabled: bool, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``enabled`` and autograd
    records (the JAX package's ``nnx.remat``): the block's activations are
    dropped after the forward and recomputed in the backward."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class FactoredAttention(nn.Module):
    """Axial block: temporal attention+MLP over (b·hw, t), then spatial over (b·t, hw).

    The (b, t) temporal key mask is expanded to the (b·hw) batch here; the
    spatial pass is unmasked (padded frames are masked in the loss). With
    ``remat`` the block runs under activation checkpointing in training.
    """

    def __init__(self, in_features: int, mlp_dim: int, num_heads: int, qkv_features: int,
                 gen: torch.Generator, *, rope_base: float = 10000.0,
                 rope_alpha: float = 1.0, attention_impl: str = "xla", remat: bool = False,
                 dtype: torch.dtype):
        super().__init__()
        kw = dict(rope_base=rope_base, rope_alpha=rope_alpha, attention_impl=attention_impl,
                  dtype=dtype)
        self.TemporalAttention = Attention(in_features, num_heads, qkv_features, gen, **kw)
        self.TemporalMLP = MLP(in_features, mlp_dim, gen, dtype=dtype)
        self.SpatialAttention = Attention(in_features, num_heads, qkv_features, gen, **kw)
        self.SpatialMLP = MLP(in_features, mlp_dim, gen, dtype=dtype)
        self.remat = remat

    def forward(self, x: torch.Tensor, temporal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b, t, hw, c); temporal_mask: (b, t) bool key mask or None."""
        return maybe_remat(self.remat, self._forward, x, temporal_mask)

    def _forward(self, x: torch.Tensor, temporal_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, hw, _ = x.shape
        tx = rearrange(x, "b t hw c -> (b hw) t c")
        mask = None
        if temporal_mask is not None:
            mask = temporal_mask[:, None, :].expand(b, hw, t).reshape(b * hw, t)
        tx = apply_attention(self.TemporalAttention, tx, mask)
        tx = apply_mlp(self.TemporalMLP, tx)
        x = rearrange(tx, "(b hw) t c -> b t hw c", b=b, hw=hw)

        sx = rearrange(x, "b t hw c -> (b t) hw c")
        sx = apply_attention(self.SpatialAttention, sx, None)
        sx = apply_mlp(self.SpatialMLP, sx)
        return rearrange(sx, "(b t) hw c -> b t hw c", b=b, t=t)
