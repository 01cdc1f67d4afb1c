"""Fused QK-norm + RoPE + attention, straight off the fused QKV projection.

Counterpart of the JAX package's ``ops/flash_attention.py:fused_qkv_attention``
(the Pallas ``_fused_kernel`` forward and ``_fused_bwd_kernel`` backward).
Layout (B, S, 3·H·D) → (B, S, H·D).

:func:`fused_qkv_attention` is a ``torch.autograd.Function``. Forward and
backward each dispatch by the tensor's device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor takes the CUDA kernel
(``csrc/fused_attention.cu`` forward, ``csrc/fused_attention_bwd.cu``
backward) or the call raises. The backward recomputes the LN, RoPE and
softmax chain from the saved qkv, as the JAX kernel does, and returns
(dqkv, dq_scale, dk_scale).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from video_vae_tpu_torch.ops._build import CudaKernel
from video_vae_tpu_torch.ops.norm import LN_EPS
from video_vae_tpu_torch.ops.rope import rope_tables, rotate_half

NEG_INF = -1e30  # the masked score of the JAX kernels
KERNEL_HEAD_DIM = 64
KERNEL_MAX_SEQ = 256

FUSED_ATTENTION = CudaKernel(
    "fused_attention.cu",
    "vvt_fused_attention_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
FUSED_ATTENTION_BWD = CudaKernel(
    "fused_attention_bwd.cu",
    "vvt_fused_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# rows of the LN/RoPE backward per block: its dscale partials are (blocks, D)
BWD_ROWS_PER_BLOCK = 64


def key_mask(mask: Optional[torch.Tensor], batch: int, seq: int) -> Optional[torch.Tensor]:
    """A (B,1,1,S) or (B,S) key-padding mask as a (B,S) bool tensor."""
    if mask is None:
        return None
    if mask.numel() != batch * seq:
        raise ValueError(f"mask of shape {tuple(mask.shape)} is not a ({batch},{seq}) key mask")
    return mask.reshape(batch, seq).bool()


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, q_scale, k_scale, mask, num_heads, rope_base, rope_alpha):
        args = (qkv, q_scale, k_scale, mask, num_heads, rope_base, rope_alpha)
        ctx.save_for_backward(qkv, q_scale, k_scale, mask)
        ctx.rope = (num_heads, rope_base, rope_alpha)
        if qkv.device.type == "cpu":
            return fused_qkv_attention_plain(*args)
        if qkv.device.type == "cuda":
            return fused_qkv_attention_cuda(*args)
        raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")

    @staticmethod
    def backward(ctx, g):
        qkv, q_scale, k_scale, mask = ctx.saved_tensors
        args = (qkv, q_scale, k_scale, mask, g.contiguous(), *ctx.rope)
        if qkv.device.type == "cpu":
            dqkv, dqs, dks = fused_qkv_attention_bwd_plain(*args)
        elif qkv.device.type == "cuda":
            dqkv, dqs, dks = fused_qkv_attention_bwd_cuda(*args)
        else:
            raise ValueError(f"fused_qkv_attention: unsupported device {qkv.device}")
        return dqkv, dqs.to(q_scale.dtype), dks.to(k_scale.dtype), None, None, None, None


def fused_qkv_attention(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
) -> torch.Tensor:
    """(B, S, 3·H·D) fused QKV → attention output (B, S, H·D).

    mask: (B,1,1,S) or (B,S) key-padding mask (True keeps a key), or None.
    Scales are the (D,) LayerNorm scale params of q_norm/k_norm.
    """
    b, s, _ = qkv.shape
    m = key_mask(mask, b, s)
    return _FusedQKVAttention.apply(qkv, q_scale, k_scale, m, num_heads, rope_base, rope_alpha)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """f32 q, k, v as (B, H, S, D) each."""
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    return (
        t.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)
        for t in qkv.float().split(hd, dim=-1)
    )


def _ln_unscaled(x: torch.Tensor):
    """(xn, r): per-row LN without the scale (E[x²]−mean² clamped at 0)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp(x.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
    r = torch.rsqrt(var + LN_EPS)
    return (x - mean) * r, r


def _exp_scores(qr, kr, mask, d):
    """exp(S − rowmax S) of the masked scores S = q̃k̃ᵀ/√D, not yet normalised."""
    scores = torch.matmul(qr, kr.transpose(-1, -2)) * (1.0 / d**0.5)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    return torch.exp(scores - scores.amax(dim=-1, keepdim=True))


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 throughout, one rounding.

    ``mask`` is a (B, S) bool key mask or None.
    """
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // num_heads
    cos, sin = rope_tables(s, d, rope_base, rope_alpha, str(qkv.device))
    q, k, v = _split_heads(qkv, num_heads)

    def norm_rope(x, scale):
        xn = _ln_unscaled(x)[0] * scale.float()
        return xn * cos + rotate_half(xn) * sin

    p = _exp_scores(norm_rope(q, q_scale), norm_rope(k, k_scale), mask, d)
    out = torch.matmul(p, v) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(b, s, hd).to(qkv.dtype)


def _rope_bwd(u: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Transpose of x·cos + rotate_half(x)·sin: u·cos + rotᵀ(u·sin)."""
    a, b = (u * sin).chunk(2, dim=-1)
    return u * cos + torch.cat((b, -a), dim=-1)


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    g: torch.Tensor,
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
):
    """The backward kernel's arithmetic in plain PyTorch, all in f32.

    Recomputes q̃, k̃ (LN, scale, RoPE) and P, then dv = Pᵀ·dO, dP = dO·vᵀ,
    row = Σ_j P∘dP, dS = P∘(dP − row)·scale, dq̃ = dS·k̃, dk̃ = dSᵀ·q̃, and back
    through RoPE, the scale and the LN. Returns (dqkv in qkv's dtype, f32
    dq_scale (D,), f32 dk_scale (D,)).
    """
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // num_heads
    cos, sin = rope_tables(s, d, rope_base, rope_alpha, str(qkv.device))
    q, k, v = _split_heads(qkv, num_heads)
    xn_q, r_q = _ln_unscaled(q)
    xn_k, r_k = _ln_unscaled(k)
    qs, ks = q_scale.float(), k_scale.float()

    def rope(x):
        return x * cos + rotate_half(x) * sin

    qr, kr = rope(xn_q * qs), rope(xn_k * ks)
    p = _exp_scores(qr, kr, mask, d)
    p = p / p.sum(dim=-1, keepdim=True)
    do = g.float().reshape(b, s, num_heads, d).transpose(1, 2)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    row = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - row) * (1.0 / d**0.5)
    dqr = torch.matmul(ds, kr)
    dkr = torch.matmul(ds.transpose(-1, -2), qr)

    def ln_scale_bwd(dr, xn, r, scale):
        dln = _rope_bwd(dr, cos, sin)
        dscale = (dln * xn).sum(dim=(0, 1, 2))
        dxn = dln * scale
        dx = r * (dxn - dxn.mean(dim=-1, keepdim=True) - xn * (dxn * xn).mean(dim=-1, keepdim=True))
        return dx, dscale

    dq, dqs = ln_scale_bwd(dqr, xn_q, r_q, qs)
    dk, dks = ln_scale_bwd(dkr, xn_k, r_k, ks)
    dqkv = torch.cat([t.transpose(1, 2).reshape(b, s, hd) for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype), dqs, dks


def _check_kernel_args(name, qkv, q_scale, k_scale, mask, num_heads):
    """Shared checks of both CUDA wrappers; returns (B, S, D)."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused attention kernels take float32 or bfloat16, not {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, S, 3*H*D) tensor")
    b, s, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} is not 3 * num_heads * head_dim")
    d = three_hd // (3 * num_heads)
    if d != KERNEL_HEAD_DIM or not 1 <= s <= KERNEL_MAX_SEQ:
        raise ValueError(
            f"kernel takes head_dim {KERNEL_HEAD_DIM} and 1 <= S <= {KERNEL_MAX_SEQ}, got {d}, {s}"
        )
    if q_scale.shape != (d,) or k_scale.shape != (d,):
        raise ValueError("q_scale and k_scale must have shape (head_dim,)")
    if mask is not None and mask.shape != (b, s):
        raise ValueError("mask must be a (B, S) key mask")
    return b, s, d


def _kernel_operands(qkv, q_scale, k_scale, mask, s, d, rope_base, rope_alpha):
    device = qkv.device
    qs = q_scale.to(device=device, dtype=torch.float32).contiguous()
    ks = k_scale.to(device=device, dtype=torch.float32).contiguous()
    cos, sin = rope_tables(s, d, rope_base, rope_alpha, str(device))
    if mask is not None:
        mask = mask.to(device=device, dtype=torch.uint8).contiguous()
    return qs, ks, cos, sin, mask


def fused_qkv_attention_cuda(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
) -> torch.Tensor:
    """Launch the forward kernel. ``mask`` is a (B, S) bool key mask or None."""
    b, s, d = _check_kernel_args("fused_qkv_attention_cuda", qkv, q_scale, k_scale, mask, num_heads)
    device = qkv.device
    qs, ks, cos, sin, mask = _kernel_operands(qkv, q_scale, k_scale, mask, s, d, rope_base, rope_alpha)
    out = torch.empty((b, s, num_heads * d), dtype=qkv.dtype, device=device)
    with torch.cuda.device(device):
        FUSED_ATTENTION.launch(
            qkv.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, s, num_heads, d, _DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    return out


def fused_qkv_attention_bwd_cuda(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    g: torch.Tensor,
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
):
    """Launch the backward kernel: (dqkv, f32 dq_scale (D,), f32 dk_scale (D,)).

    The kernel writes per-block f32 partials of the two scale gradients;
    they are summed here in a fixed order, so every run gives the same bits.
    """
    b, s, d = _check_kernel_args(
        "fused_qkv_attention_bwd_cuda", qkv, q_scale, k_scale, mask, num_heads
    )
    if g.shape != (b, s, num_heads * d) or g.dtype != qkv.dtype or not g.is_contiguous():
        raise ValueError("g must be a contiguous (B, S, H*D) tensor in qkv's dtype")
    if g.device != qkv.device:
        raise ValueError("g must be on qkv's device")
    device = qkv.device
    qs, ks, cos, sin, mask = _kernel_operands(qkv, q_scale, k_scale, mask, s, d, rope_base, rope_alpha)
    rows = b * num_heads * s
    f32 = dict(dtype=torch.float32, device=device)
    # q̃, k̃, v, dO, dq̃, dk̃ as f32 (pair, S, D) rows, then m, l, row per query
    work = torch.empty(6 * rows * d + 3 * rows, **f32)
    n_blocks = -(-rows // BWD_ROWS_PER_BLOCK)
    partials = torch.empty((2, n_blocks, d), **f32)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(device):
        FUSED_ATTENTION_BWD.launch(
            qkv.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(), work.data_ptr(),
            b, s, num_heads, d, n_blocks, _DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
    dqs, dks = partials.sum(dim=1)
    return dqkv, dqs, dks
