"""Megatron tensor parallelism of each block's attention and MLP.

Under a tensor > 1 mesh a block's ``Attention`` runs on the rank's heads and
its ``MLP`` on the rank's hidden columns (``models/layers.py``, the module
chain with the hooks below; each is the identity where ``tp`` is None):

* the QKV projection and ``linear1`` are column-parallel: the rank holds the
  columns of its heads of each of q, k and v (``sharding.BY_HEADS``), and of
  its block of the hidden units, with their biases;
* ``out_projection`` and ``linear2`` are row-parallel: the rank's rows, whose
  partial products are summed over the tensor ranks before the (replicated)
  bias is added.

Two autograd functions carry the collectives (Megatron's f and g): the
sublayer's input enters through :func:`copy_to_tensor_region` (identity
forward, all-reduce backward), its output leaves through
:func:`reduce_from_tensor_region` (all-reduce forward, identity backward). The
per-head q/k LayerNorm scales are shared by every head, so they enter through
the copy as well and their gradient is summed over the tensor ranks.

The chain is the JAX module chain (``"xla"``): JAX sends the fused attention
and both sublayer kernels back to it under tensor > 1 (``models/layers.py``,
``ops/fused_block.py``), and so does the port. The port's ``Linear`` keeps the
(in, out) kernel, which torch's ``ColwiseParallel``/``RowwiseParallel`` do not
expect, hence these few lines of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TensorGroup:
    """The process group of one (data, fsdp) coordinate's tensor ranks."""

    group: object
    size: int


class _CopyToTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorGroup):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _ReduceFromTensorRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp: TensorGroup):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=tp.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor_region(x: torch.Tensor, tp: Optional[TensorGroup]) -> torch.Tensor:
    """Identity forward; the gradient summed over the tensor ranks."""
    return x if tp is None else _CopyToTensorRegion.apply(x, tp)


def reduce_from_tensor_region(x: torch.Tensor, tp: Optional[TensorGroup]) -> torch.Tensor:
    """The sum over the tensor ranks forward; identity backward."""
    return x if tp is None else _ReduceFromTensorRegion.apply(x, tp)


def local_heads(num_heads: int, tp: Optional[TensorGroup]) -> int:
    """The heads one tensor rank computes."""
    return num_heads if tp is None else num_heads // tp.size
