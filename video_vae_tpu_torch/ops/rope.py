"""NTK-scaled rotary position embeddings (rotate-half form).

ntk_base = base · alpha^(d/(d−2)); positions are 0..S−1 of whichever axis
attends (frames in the temporal pass, the row-major patch index in the
spatial pass). Counterpart of the JAX package's ``ops/rope.py``.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=32)
def rope_tables(
    seq_len: int,
    head_dim: int,
    base: float = 10000.0,
    alpha: float = 1.0,
    device: str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape (seq_len, head_dim), float32, on ``device``.

    Cached per shape and device: the attention wrappers ask for the same few
    tables on every call. Callers must not write into them. They are made
    outside inference mode even when the first caller is inside it (the
    serving pass): an inference tensor could not enter a later training
    step's autograd graph.
    """
    with torch.inference_mode(False):
        ntk_base = base * (alpha ** (head_dim / (head_dim - 2)))
        exponents = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        inv_freq = 1.0 / torch.pow(torch.tensor(ntk_base, dtype=torch.float32), exponents)
        t = torch.arange(seq_len, dtype=torch.float32)
        freqs = torch.outer(t, inv_freq)
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos().to(device), emb.sin().to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    base: float = 10000.0,
    alpha: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k of shape (batch, seq, heads, head_dim) in their own dtype.

    The f32 tables are cast to q's dtype first, so in bf16 the rotation
    rounds where the JAX package's ``apply_rope`` does.
    """
    seq_len, head_dim = q.shape[1], q.shape[-1]
    cos, sin = rope_tables(seq_len, head_dim, base, alpha, str(q.device))
    cos = cos[None, :, None, :].to(q.dtype)
    sin = sin[None, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
