"""Positional embedding utilities.

Counterpart of the JAX package's ``ops/embeddings.py``:
:func:`create_sinusoidal_embeddings` is the classic sin/cos table, provided
for completeness and ablations (the models use RoPE, ``ops/rope.py``, and
never call it), with the interleaved (sin, cos) layout per frequency.
"""

from __future__ import annotations

import torch


def create_sinusoidal_embeddings(seq_len: int, embed_dim: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """(1, seq_len, embed_dim) f32 sinusoidal position table: column 2 i holds
    sin(p · f_i) and column 2 i + 1 cos(p · f_i), f_i = max_timescale^(−2 i / embed_dim).

    Computed in f32 throughout, log(max_timescale) included, as the JAX table is.
    """
    position = torch.arange(seq_len, dtype=torch.float32)[:, None]
    log_timescale = torch.log(torch.tensor(max_timescale, dtype=torch.float32))
    div_term = torch.exp(torch.arange(0, embed_dim, 2, dtype=torch.float32) * -(log_timescale / embed_dim))
    scaled = position * div_term[None, :]
    return torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-1).reshape(seq_len, embed_dim)[None]
