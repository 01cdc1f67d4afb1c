"""Masked scaled-dot-product attention dispatch.

Counterpart of the JAX package's ``ops/attention.py``: one entry point for
the attention of the unfused chain (separate q, k, v after the per-head
LayerNorm and RoPE). ``impl="pallas"`` takes the flash-attention kernel of
:mod:`video_vae_tpu_torch.ops.flash_attention`; ``impl="xla"`` is the chain
``jax.nn.dot_product_attention`` computes, written out in plain PyTorch and
differentiated by autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_vae_tpu_torch.ops.flash_attention import flash_attention, key_mask
from video_vae_tpu_torch.parallel.sharding import log_chain, takes_chain

# jax.nn.dot_product_attention's masked score: 0.7 of the most negative f32
_LARGE_NEGATIVE = -0.7 * torch.finfo(torch.float32).max


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``jax.nn.dot_product_attention`` with its roundings, over (B, S, H, D).

    Scores accumulate in f32, the softmax runs in f32, the probabilities are
    cast to v's dtype, and P·V is a product in that dtype (f32 accumulation,
    one rounding). ``mask`` is a (B, S) bool key mask or None.
    """
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * (1.0 / q.shape[-1] ** 0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], _LARGE_NEGATIVE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", probs, v)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    impl: str = "xla",
) -> torch.Tensor:
    """Attention over (batch, seq, heads, head_dim) with an optional key mask.

    mask: (B,1,1,S) or (B,S), True = attend. ``impl`` is ``"pallas"`` (the
    flash-attention kernel; its plain version on the CPU) or ``"xla"``.
    Under a tensor > 1 mesh ``"pallas"`` gives way to ``"xla"``, as in JAX.
    """
    if impl == "pallas":
        if not takes_chain():
            return flash_attention(q, k, v, mask)
        log_chain("flash_attention")
        impl = "xla"
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    b, s = q.shape[:2]
    return dot_product_attention(q, k, v, key_mask(mask, b, s))
