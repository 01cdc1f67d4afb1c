"""The attention kernels: fused QK-norm + RoPE + attention, plain masked
attention, and the whole attention sublayer.

Counterparts of the JAX package's ``ops/flash_attention.py``:

* :func:`fused_qkv_attention` (the Pallas ``_fused_kernel`` forward and
  ``_fused_bwd_kernel`` backward): split + per-head LayerNorm + RoPE + masked
  softmax attention straight off the fused QKV projection, layout
  (B, S, 3·H·D) → (B, S, H·D). The backward recomputes the LN, RoPE and
  softmax chain from the saved qkv and returns (dqkv, dq_scale, dk_scale).
* :func:`flash_attention` (``_fwd_kernel`` / ``_bwd_kernel``): masked softmax
  attention over separate q, k, v of layout (B, S, H, D); the probabilities
  are normalised and rounded to v's dtype before P·V. The backward recomputes
  them in f32 (exact row max and sum); its plain version stays f32
  throughout.
* :func:`fused_attention_sublayer` (``_sublayer_kernel``): y = x +
  out_proj(attention(qk-LN + RoPE(LN(x)·Wqkv + b))) behind one kernel entry
  point; its backward is GEMMs in plain PyTorch around the fused attention
  backward kernel.

Each is a ``torch.autograd.Function`` whose forward and backward dispatch by
the tensor's device: a CPU tensor takes the plain PyTorch version
(``*_plain``), a CUDA tensor takes the CUDA kernel (``*_cuda``, sources in
``csrc/``) or the call raises.

The kernels are instantiated at head dims ``KERNEL_HEAD_DIMS`` (16, 32, 64
and 128: ``tiny_config`` and the ``--small`` preset at 16, the flagship at
64, its width in 4 heads at 128) and take every even head dim
(``check_head_dim``) and any sequence length. A call at another even D up to
128 pads each head to the next instantiation Dp (:func:`padded_head_dim`)
with zeros (:func:`pad_heads`: the two halves of a head stay RoPE partners)
and hands the kernel the true D beside Dp: its LN statistics take 1/D (zero
columns add nothing to Σx and Σx²) and its scores 1/√D; the outputs and
gradients are unpadded. D = 96 (``ModelConfig(qkv_features=768)``) runs at
128, D = 48 at 64, D = 8 and 24 at 16 and 32. Past 128 a head is padded the
same way to the next multiple of ``WIDE_CHUNK`` = 128 (192 → 256, 258 →
384; ``ModelConfig(num_heads=2)``'s 256 as it is) and every call, in bf16
and f32, at every S, takes the "wide" variant (``csrc/attention_wide.cuh``):
a block owns its rows and one 128-column chunk of the output and sums every
product over the head dim chunk by chunk as the chunks stream through shared
memory (:func:`wide_grid`); its launches count in ``WIDE_LAUNCHES``. An odd
D, or 0, raises on a CUDA tensor, with no fallback. Up to
``TILE_MAX_SEQ`` = 256 tokens the bf16 kernels take their "slab" or "tile"
variant, whose block holds a whole sequence's keys, as the JAX kernels hold
it in VMEM. Longer sequences (the flagship at ``--resize 512``: spatial
S = 1024) take the "split" variant (``csrc/attention_split.cuh``): a block
owns some rows of one (sequence, head) pair and streams the other side's
rows through shared memory, so nothing there grows with S; its forward is
one walk over the keys with a running max (#1, and #7's attention) or two,
for the exact row max and sum first (#5), and its backward (#3, #6) is a
query-major launch (statistics and dq) and a key-major one (dv and dk),
with no atomics, through an f32 workspace that the wrapper allocates. At
head dims 64 and 128 every split launch runs on wgmma fed by TMA rings
(``csrc/attention_split_fwd.cuh``, ``csrc/attention_split_bwd.cuh``: 128
own rows a block, two consumer warpgroups and a producer); at 16 and 32 on
mma.sync (64 rows a block, double-buffered tiles of 64 rows). #1 and #3
first write q̃ and k̃ (LN and RoPE, rounded to bf16) to a workspace with the
same LN and RoPE code as the tile variant.
#3's tile variant at head dims 64 and 128 (64 < S ≤ 256) is ``"tile_wg"``
(``csrc/fused_attention_bwd_wg.cuh``): one block a (sequence, head) pair on
wgmma fed by TMA, two consumer warpgroups dealt its 64-row tiles and a
producer; #6's, and #3's at 16 and 32, stay on mma.sync.
At 128 the bf16 slab and tile blocks cap at 8 warps (255 registers a thread
for a warp's 16 × 128 f32 accumulators), and #6's tile blocks keep three of
a pair's four row arrays in shared memory (``csrc``:
``bwd::wide_tile_bwd``); the f32 kernels give a row four lanes and stage the
other side's rows in chunks (``csrc/attention_f32_wide.cuh``), as they do
at every head dim past 256 tokens.

Roundings of the fused forward, by dtype. The plain version computes in f32
throughout and rounds once, to qkv's dtype. On the card, bf16 qkv takes the
tensor-core kernel, which rounds as the JAX package does: q̃ and k̃ (after LN
and RoPE) to bf16 before q̃k̃ᵀ, P to bf16 before P·V (normalised first where
JAX takes its packed small-S path, ``S < 128`` and ``S·H % 128 == 0``;
otherwise unnormalised, with 1/l on the f32 output), the output once; its
block layout comes from :func:`fused_attention_plan`. f32 qkv takes the
CUDA-core kernel, f32 throughout with one rounding, as the plain version.
The split variant (S > 256) rounds as the tile variant at those lengths: q̃
and k̃ to bf16, P = exp(s − running max) to bf16 unnormalised (JAX's
unpacked path), 1/l on the f32 output, one rounding of the output.

Roundings of the fused backward, by dtype. The plain version is f32
throughout with one rounding of dqkv. On the card, bf16 takes the
tensor-core kernel, one launch with no workspace: q̃ and k̃ rounded to bf16
as the forward rounds them, P normalised (exact row max and sum) and then
rounded to bf16 for dv = Pᵀ·dO, dS computed in f32 and rounded to bf16 for
dq̃ = dS·k̃ and dk̃ = dSᵀ·q̃, everything else f32, dqkv rounded once; its block
layout comes from :func:`fused_attention_bwd_plan`. Its split variant
(S > 256) keeps these roundings, with dq̃ and dk̃ in f32 until the LN and
RoPE backward, which the f32 path's fourth pass runs, per-block scale
partials and all. f32 keeps the four-pass CUDA-core kernel through an f32
workspace, f32 throughout with one rounding.

Roundings of the plain attention forward, by dtype. The plain version and
both kernels round as the JAX package's ``_fwd_kernel``: f32 scores and
softmax with the exact row max and sum, P normalised and then rounded to v's
dtype, P·V accumulated in f32, one rounding of o. On the card, bf16 takes the
tensor-core kernel, the fused forward's softmax without its LN and RoPE
(walking the keys twice past 64 of them, for the exact max and sum first; so
does its split variant); its block layout comes from
:func:`flash_attention_plan`. f32 keeps the CUDA-core kernel.

Roundings of the plain attention backward, by dtype. The plain version is
f32 throughout, each gradient rounded once. On the card, bf16 takes the
tensor-core kernel, the fused backward's softmax backward without its LN and
RoPE, one launch with no workspace: P normalised (exact row max and sum) and
then rounded to bf16 for dv = Pᵀ·dO, dS computed in f32 and rounded to bf16
for dq = dS·k and dk = dSᵀ·q, q, k, v and dO bf16 already, everything else
f32, each gradient rounded once (as the JAX package's non-TPU backward and
SDPA's backward round); its block layout comes from
:func:`flash_attention_bwd_plan`. f32 keeps the two-pass CUDA-core kernel
through an f32 workspace, f32 throughout with one rounding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING, Optional

import torch

from video_vae_tpu_torch.ops._build import DTYPE_CODES, CudaKernel
from video_vae_tpu_torch.ops.norm import LN_EPS
from video_vae_tpu_torch.ops.rope import rope_tables, rotate_half
from video_vae_tpu_torch.parallel.sharding import log_kernel

if TYPE_CHECKING:
    from video_vae_tpu_torch.ops.fused_block import GemmPlan

NEG_INF = -1e30  # the masked score of the JAX kernels
KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # the C entry points' instantiations (csrc: with_head_dim)
TILE_MAX_SEQ = 256  # the longest sequence of the slab and tile variants; "split" takes longer ones

# Each entry point takes the instantiated head dim and, after it, the true one
# and its softmax scale (f32): the kernels' 1/D and 1/√D (see padded_head_dim).
HEAD_DIM_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_float]

FUSED_ATTENTION = CudaKernel(
    "fused_attention.cu",
    "vvt_fused_attention_fwd",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + HEAD_DIM_ARGS + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)
FUSED_ATTENTION_BWD = CudaKernel(
    "fused_attention_bwd.cu",
    "vvt_fused_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + HEAD_DIM_ARGS + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)

FLASH_ATTENTION = CudaKernel(
    "flash_attention.cu",
    "vvt_flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + HEAD_DIM_ARGS + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
)
FLASH_ATTENTION_BWD = CudaKernel(
    "flash_attention_bwd.cu",
    "vvt_flash_attention_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3 + HEAD_DIM_ARGS + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
)
ATTENTION_SUBLAYER = CudaKernel(
    "attention_sublayer.cu",
    "vvt_attention_sublayer",
    [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + HEAD_DIM_ARGS + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)

# rows of the f32 backward's LN/RoPE pass per block: its dscale partials are (blocks, D)
BWD_ROWS_PER_BLOCK = 64

# The bf16 forward kernel (csrc/fused_attention_mma.cuh): a warp owns 16 query rows.
MMA_SLAB_WARPS = 8  # warps of a slab block at most
MMA_SLAB_MAX_SEQ = 64  # the longest sequence a block stages whole, all heads
MMA_SLAB_MAX_SMEM = 100 * 1024  # a slab block at most this, so that two fit an SM
# as csrc/fused_attention_mma_common.cuh numbers them; "tile_wg" is #3's alone (fused_attention_bwd_plan);
# "wide" takes every head dim past 128 in both dtypes
MMA_VARIANTS = ("slab", "tile", "split", "tile_wg", "wide")

# The split variant of the bf16 kernels at head dims 16 and 32 (csrc/attention_split.cuh),
# S > TILE_MAX_SEQ: a block owns this many rows of a pair, a warp each 16, and streams
# the other side in tiles of 64 rows through two shared-memory buffers (12-32 KB a block
# at any S).
SPLIT_ROWS = 64
SPLIT_WARPS = SPLIT_ROWS // 16


# The split forward and backward at head dims 64 and 128 (csrc/attention_split_fwd.cuh,
# csrc/attention_split_bwd.cuh): wgmma fed by TMA rings, a block owns SPLIT_BWD_ROWS rows
# of a pair (64 for each of two consumer warpgroups) beside a producer warpgroup; head
# dims 16 and 32 keep the geometry above (mma.sync), as their rows are below the
# 128-byte swizzle span the wgmma tiles are laid out on.
SPLIT_BWD_ROWS = 128
SPLIT_BWD_WARPS = 12
WGMMA_HEAD_DIMS = (64, 128)

# The wide variant (csrc/attention_wide.cuh), every head dim past 128 padded to a multiple
# of WIDE_CHUNK: a block owns WIDE_ROWS rows of a pair (a warp each 16) and one chunk of
# WIDE_CHUNK columns of the output, and streams chunks of the other side's rows; the #3
# LN + RoPE backward writes a (Dp,) scale partial for every WIDE_LN_ROWS head rows.
WIDE_CHUNK = 128
WIDE_ROWS = 64
WIDE_WARPS = WIDE_ROWS // 16
WIDE_LN_ROWS = 8


def wide_grid(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """Blocks of the wide forward and of each side of its backward: one per
    (sequence, head) pair, tile of ``WIDE_ROWS`` own rows and chunk of
    ``WIDE_CHUNK`` columns; the backward's statistics launch has one chunk."""
    return batch * heads * -(-seq // WIDE_ROWS) * (head_dim // WIDE_CHUNK)


def split_grid(batch: int, seq: int, heads: int) -> int:
    """Blocks of each split launch but the LN + RoPE pass: one per (sequence,
    head) pair and tile of ``SPLIT_ROWS`` of its rows, a pair's tiles adjacent."""
    return batch * heads * -(-seq // SPLIT_ROWS)


def split_bwd_grid(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """Blocks of each of the split backward's two launches: :func:`split_grid`
    at head dims 16 and 32; one per pair and tile of ``SPLIT_BWD_ROWS`` rows at
    64 and 128 (a pair's tiles adjacent either way)."""
    if head_dim in WGMMA_HEAD_DIMS:
        return batch * heads * -(-seq // SPLIT_BWD_ROWS)
    return split_grid(batch, seq, heads)


def split_bwd_warps(head_dim: int) -> int:
    """Warps of a split backward block, by head dim alone: ``SPLIT_BWD_WARPS``
    (two consumer warpgroups and a producer) at 64 and 128, ``SPLIT_WARPS`` at
    16 and 32."""
    return SPLIT_BWD_WARPS if head_dim in WGMMA_HEAD_DIMS else SPLIT_WARPS


def split_fwd_grid(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """Blocks of the split forward's launch (after #1's LN + RoPE pass): at head
    dims 64 and 128 the wgmma launch of ``csrc/attention_split_fwd.cuh``, one
    block per pair and tile of ``SPLIT_BWD_ROWS`` query rows (two consumer
    warpgroups of 64), as the backward's; at 16 and 32 the mma.sync launch's
    :func:`split_grid`. A pair's tiles are adjacent either way."""
    return split_bwd_grid(batch, seq, heads, head_dim)


def split_fwd_warps(head_dim: int) -> int:
    """Warps of a split forward block, by head dim alone: those of the
    backward's (:func:`split_bwd_warps`): 12 at 64 and 128, 4 at 16 and 32."""
    return split_bwd_warps(head_dim)


def mma_max_warps(head_dim: int) -> int:
    """Warps of a bf16 forward block at most (csrc: ``FWD_WARPS``): 16, but 8 at
    head_dim 128, whose tile blocks then give each warp two 16-row query tiles
    at S = 256."""
    return 8 if head_dim == 128 else 16


def mma_row_bytes(head_dim: int) -> int:
    """Shared memory of one q, k or v head row in the bf16 kernels: head_dim
    bf16 padded by 8 (144 bytes at 64), so that ldmatrix has no bank conflicts."""
    return 2 * (head_dim + 8)


def check_head_dim(head_dim: int) -> None:
    """Raise unless the kernels take ``head_dim``: an even number of at least 2
    (RoPE rotates a head's two halves)."""
    if not (head_dim >= 2 and head_dim % 2 == 0):
        raise ValueError(
            f"the attention kernels take an even head_dim of at least 2 (padded to the next of "
            f"{KERNEL_HEAD_DIMS}, past {KERNEL_HEAD_DIMS[-1]} to a multiple of {WIDE_CHUNK}), got {head_dim}"
        )


def is_wide(head_dim: int) -> bool:
    """Whether a padded head dim runs the wide variant: past 128, a multiple of ``WIDE_CHUNK``."""
    return head_dim > KERNEL_HEAD_DIMS[-1] and head_dim % WIDE_CHUNK == 0


def _check_instantiated(head_dim: int) -> None:
    """Raise unless the kernels run ``head_dim`` as it is: the plans take a padded head dim."""
    if head_dim not in KERNEL_HEAD_DIMS and not is_wide(head_dim):
        raise ValueError(f"the kernels are instantiated at head_dim in {KERNEL_HEAD_DIMS} and run multiples of "
                         f"{WIDE_CHUNK} past them, got {head_dim}")


def padded_head_dim(head_dim: int) -> int:
    """The head dim a call at ``head_dim`` runs: up to 128 the least of ``KERNEL_HEAD_DIMS``
    at or above it (96 → 128, 48 → 64, 24 → 32, 8 → 16), past it the next multiple of
    ``WIDE_CHUNK`` (130 and 192 → 256, 258 → 384, 256 and 512 as they are). Raises where
    :func:`check_head_dim` does."""
    check_head_dim(head_dim)
    if head_dim > KERNEL_HEAD_DIMS[-1]:
        return -(-head_dim // WIDE_CHUNK) * WIDE_CHUNK
    return next(dp for dp in KERNEL_HEAD_DIMS if dp >= head_dim)


def pad_heads(t: torch.Tensor, heads: int, d: int, dp: int) -> torch.Tensor:
    """The last dim of ``t``, ``heads`` heads of ``d``, as heads of ``dp`` ≥ d, by halves.

    A head's columns [0, d/2) stay where they are and [d/2, d) move to
    [dp/2, dp/2 + d/2); every other column is zero. rotate_half's partner of
    column i, i + dp/2, is then its partner at d, so a RoPE table padded the
    same way rotates the real columns as at d. ``t`` itself where dp == d.
    """
    if dp == d:
        return t
    return torch.nn.functional.pad(t.unflatten(-1, (heads, 2, d // 2)), (0, (dp - d) // 2)).flatten(-3)


def unpad_heads(t: torch.Tensor, heads: int, d: int, dp: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: the real columns of ``heads`` heads of ``dp``, contiguous."""
    if dp == d:
        return t
    return t.unflatten(-1, (heads, 2, dp // 2))[..., : d // 2].flatten(-3).contiguous()


def softmax_scale(head_dim: int) -> float:
    """1/√head_dim as the JAX wrappers compute it (a Python float, which the C
    entry points take rounded to f32): 1/4, 1/8 and the f32 roundings of 1/√32 and
    1/√128 at the instantiations, the values the kernels held as constants."""
    return 1.0 / head_dim**0.5


@functools.lru_cache(maxsize=64)
def fused_attention_plan(batch: int, seq: int, heads: int, head_dim: int) -> tuple[str, int]:
    """(variant, sequences a block) of the bf16 fused attention kernel.

    ``"split"`` past ``TILE_MAX_SEQ`` = 256 tokens (unit 1): a block takes
    some query rows of one (sequence, head) pair and streams its keys
    (:func:`split_fwd_grid` blocks of :func:`split_fwd_warps` warps: at head
    dims 64 and 128 128 rows and a TMA ring of 128 or 64 keys a stage, at 16
    and 32 ``SPLIT_ROWS`` rows and double-buffered tiles of 64 keys).
    Up to 256:
    ``"slab"`` where the sequence is at most 64 long and one sequence's q, k
    and v rows (``mma_row_bytes(head_dim)`` each) fit ``MMA_SLAB_MAX_SMEM``:
    a block stages whole sequences, all
    heads, as many as give it up to 8 warps of 16-row query tiles, and its
    warps take those tiles in turn. Otherwise ``"tile"``, one sequence a
    block: a block stages one (sequence, head) pair, all its rows, and has a
    warp for each 16 of them (16 warps at S = 256; at most
    :func:`mma_max_warps`, 8 at head_dim 128, each warp then taking the tiles
    in turn), so that the pair's keys are staged and normalised once (205 KB
    at S = 256 and head_dim 128). The C entry point derives the warps, the
    shared memory and P's rounding rule from these and the shape. A head dim
    past 128 (a multiple of ``WIDE_CHUNK``) takes ``"wide"`` at every S, in both
    dtypes (:func:`wide_grid` blocks of ``WIDE_WARPS`` warps).
    """
    _check_instantiated(head_dim)
    if is_wide(head_dim):
        return "wide", 1
    if seq > TILE_MAX_SEQ:
        return "split", 1
    rows16 = -(-seq // 16) * 16
    seq_smem = 3 * heads * rows16 * mma_row_bytes(head_dim) + 8 * -(-seq // 64)  # q, k, v rows and key bits
    if seq <= MMA_SLAB_MAX_SEQ and seq_smem <= MMA_SLAB_MAX_SMEM:
        tiles = heads * rows16 // 16  # query tiles of one sequence
        return "slab", max(1, min(MMA_SLAB_WARPS // tiles, MMA_SLAB_MAX_SMEM // seq_smem, batch))
    return "tile", 1


def flash_attention_plan(batch: int, seq: int, heads: int, head_dim: int) -> tuple[str, int]:
    """(variant, sequences a block) of the bf16 plain attention forward kernel
    (``csrc/flash_attention_mma.cuh``): those of :func:`fused_attention_plan`.

    ``"slab"`` where the sequence is at most 64 long and one sequence's q, k
    and v rows fit ``MMA_SLAB_MAX_SMEM``: a block stages whole sequences, all
    heads, and its warps (up to 8) take the 16-row query tiles in turn.
    Otherwise ``"tile"``: a block stages one (sequence, head) pair with a warp
    for each 16 query rows; past 64 keys each warp walks the keys twice, for
    the exact row max and sum first; ``"split"`` past 256 tokens, whose
    blocks (:func:`split_fwd_grid`, :func:`split_fwd_warps`) walk the key
    tiles twice, k alone on the first walk (at head dims 64 and 128 as two
    launches, the first parking each row's max and 1/l in its own output
    row). The C entry point derives the warps and the shared memory from
    these and the shape.
    """
    return fused_attention_plan(batch, seq, heads, head_dim)


# The bf16 backward kernel (csrc/fused_attention_bwd_mma.cuh), in the forward's
# row layout; its variants are numbered as MMA_VARIANTS.
BWD_SLAB_MAX_SEQ = 64  # the longest sequence whose P and dS a block keeps
BWD_SLAB_WARPS = 4  # warps of a slab block at most: four blocks or more an SM
BWD_TILE_WARPS = 16  # warps of a tile block at most
BWD_WIDE_TILE_WARPS = 8  # ... at head_dim 128 (csrc: bwd::WIDE_TILE_WARPS)
# #3's wgmma tile block (csrc/fused_attention_bwd_wg.cuh): two consumer warpgroups and a producer
BWD_TILE_WG_WARPS = SPLIT_BWD_WARPS


def mma_bwd_plan(batch: int, seq: int, heads: int, head_dim: int) -> tuple[str, int, int]:
    """(variant, (sequence, head) pairs a block, warps a block) of the
    mma.sync backward blocks that #3 (at head dims 16 and 32) and #6 (at every
    head dim) run up to ``TILE_MAX_SEQ`` = 256 tokens, and past it ``"split"``:
    the variant and the pairs are the same at every head dim the kernels take
    (a slab pair's rows with its P and dS, 55 KB at S = 64 and D = 64, 88 KB
    at D = 128, fit a block at each).

    ``"slab"`` where the sequence is at most 64 long: a block stages
    consecutive pairs (the heads of a sequence, side by side in memory) with
    their P and dS, as many as give it up to 4 warps of 16-row tiles: small
    blocks, so that several share an SM and one block's copies overlap
    another's products. Otherwise ``"tile"``: a block stages one pair, all
    its rows (147 KB at S = 256 and D = 64), with a warp for each 16 of them
    up to ``BWD_TILE_WARPS``. At head_dim 128 a pair's four row arrays (278
    KB) do not fit: the block keeps q̃, k̃ and v (then dO) and reads the other
    operand rows straight from device memory, with up to
    ``BWD_WIDE_TILE_WARPS`` warps. Either way a block's warps take its query
    tiles in turn, then its key tiles, and the grid is ceil(B·H / pairs a
    block). The C entry point derives the shared memory from these and the
    shape. Past ``TILE_MAX_SEQ`` = 256 tokens, ``"split"``: a query-major
    launch and a key-major one of :func:`split_bwd_grid` blocks,
    :func:`split_bwd_warps` warps each (one pair each, unit 1): wgmma at head
    dims 64 and 128, mma.sync at 16 and 32. A head dim past 128: ``("wide", 1,
    WIDE_WARPS)`` at every S, in both dtypes (three launches: statistics, query
    side, key side).
    """
    _check_instantiated(head_dim)
    if is_wide(head_dim):
        return "wide", 1, WIDE_WARPS
    if seq > TILE_MAX_SEQ:
        return "split", 1, split_bwd_warps(head_dim)
    tiles = -(-seq // 16)
    if seq <= BWD_SLAB_MAX_SEQ:
        unit = max(1, min(BWD_SLAB_WARPS // tiles, batch * heads))
        return "slab", unit, min(BWD_SLAB_WARPS, unit * tiles)
    return "tile", 1, min(BWD_WIDE_TILE_WARPS if head_dim == 128 else BWD_TILE_WARPS, tiles)


@functools.lru_cache(maxsize=64)
def fused_attention_bwd_plan(batch: int, seq: int, heads: int, head_dim: int) -> tuple[str, int, int]:
    """(variant, (sequence, head) pairs a block, warps a block) of the bf16
    fused attention backward kernel: :func:`mma_bwd_plan`, but at head dims 64
    and 128 (``WGMMA_HEAD_DIMS``) with 64 < S <= ``TILE_MAX_SEQ`` the tile
    variant on Hopper's warpgroup tensor cores, ``("tile_wg", 1,
    BWD_TILE_WG_WARPS)`` (``csrc/fused_attention_bwd_wg.cuh``): one block a
    pair, grid B·H, two consumer warpgroups dealt the 64-row query tiles and
    then the key tiles in turns and a producer warpgroup loading with TMA
    (216 KB at S = 256 and D = 64: every row array of the pair resident and
    each warpgroup's epilogue rows staged; 220 KB at D = 128: q̃ and k̃
    resident, v and dO streamed).
    """
    if BWD_SLAB_MAX_SEQ < seq <= TILE_MAX_SEQ and head_dim in WGMMA_HEAD_DIMS:
        return "tile_wg", 1, BWD_TILE_WG_WARPS
    return mma_bwd_plan(batch, seq, heads, head_dim)


# The bf16 plain attention backward (csrc/flash_attention_bwd_mma.cuh) takes
# mma_bwd_plan; a tile block exchanges dS in rounds of this many queries.
FLASH_BWD_ROUND = 64


def flash_attention_bwd_plan(batch: int, seq: int, heads: int, head_dim: int) -> tuple[str, int, int]:
    """(variant, (sequence, head) pairs a block, warps a block) of the bf16
    plain attention backward kernel: those of :func:`mma_bwd_plan`.

    ``"slab"`` for S ≤ 64: a block stages consecutive pairs with their P and
    dS, and its warps (up to 4) take the query tiles in turn, then the key
    tiles. Otherwise ``"tile"``: a pair a block with a warp for each 16 rows
    (16 at S = 256); each warp takes its query rows' statistics, then, in
    rounds of ``FLASH_BWD_ROUND`` queries, its key rows' share of dv and dk,
    and the round's 16 × 16 tiles of dq in turn. At head_dim 128 the tile
    block is the fused backward's (up to ``BWD_WIDE_TILE_WARPS`` warps taking
    the query tiles, then the key tiles, in turn) without LN or RoPE. The grid
    is ceil(B·H / pairs a block); the C entry point derives the shared memory
    from these and the shape. Past 256 tokens, ``"split"``: the fused
    backward's two launches on q, k, v and dO as they are.
    """
    return mma_bwd_plan(batch, seq, heads, head_dim)


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
        log_kernel("fused_attention_bwd", qkv)
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
    log_kernel("fused_attention", qkv)
    return _FusedQKVAttention.apply(qkv, q_scale, k_scale, m, num_heads, rope_base, rope_alpha)


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """f32 q, k, v as (B, H, S, D) each."""
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    return (
        t.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)
        for t in qkv.float().split(hd, dim=-1)
    )


def _row_mean(x: torch.Tensor, d: Optional[int] = None) -> torch.Tensor:
    """The mean over the last dim: over its width, or over ``d`` columns, the
    true head dim of a row zero-padded past it (:func:`pad_heads`), whose zeros
    add nothing to the sum."""
    return x.mean(dim=-1, keepdim=True) if d is None else x.sum(dim=-1, keepdim=True) / d


def _ln_unscaled(x: torch.Tensor, d: Optional[int] = None):
    """(xn, r): per-row LN without the scale (E[x²]−mean² clamped at 0), its
    statistics over ``d`` columns (:func:`_row_mean`)."""
    mean = _row_mean(x, d)
    var = torch.clamp(_row_mean(x.square(), d) - mean.square(), min=0.0)
    r = torch.rsqrt(var + LN_EPS)
    return (x - mean) * r, r


def _exp_scores(qr, kr, mask, d):
    """exp(S − rowmax S) of the masked scores S = q̃k̃ᵀ/√D, not yet normalised."""
    scores = torch.matmul(qr, kr.transpose(-1, -2)) * softmax_scale(d)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    return torch.exp(scores - scores.amax(dim=-1, keepdim=True))


def _padded_tables(s, d, dp, rope_base, rope_alpha, device):
    """The cos/sin tables of head dim ``d`` on the columns :func:`pad_heads` gives a head of ``dp``."""
    return tuple(pad_heads(t, 1, d, dp) for t in rope_tables(s, d, rope_base, rope_alpha, str(device)))


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
    head_dim: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 throughout, one rounding.

    ``mask`` is a (B, S) bool key mask or None. ``head_dim``: the padded
    contract the kernels run at a head dim they are not instantiated for, in
    plain form. qkv and the scales then hold heads of some Dp ≥ head_dim
    padded by :func:`pad_heads`; the LN takes its statistics over head_dim
    columns, RoPE the tables of head_dim on the padded columns, the scores
    1/√head_dim; the output is padded as qkv (:func:`unpad_heads` undoes it).
    """
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    dp = hd // num_heads
    d = head_dim or dp
    cos, sin = _padded_tables(s, d, dp, rope_base, rope_alpha, qkv.device)
    q, k, v = _split_heads(qkv, num_heads)

    def norm_rope(x, scale):
        xn = _ln_unscaled(x, head_dim)[0] * scale.float()
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
    head_dim: Optional[int] = None,
):
    """The backward kernel's arithmetic in plain PyTorch, all in f32.

    Recomputes q̃, k̃ (LN, scale, RoPE) and P, then dv = Pᵀ·dO, dP = dO·vᵀ,
    row = Σ_j P∘dP, dS = P∘(dP − row)·scale, dq̃ = dS·k̃, dk̃ = dSᵀ·q̃, and back
    through RoPE, the scale and the LN. Returns (dqkv in qkv's dtype, f32
    dq_scale (D,), f32 dk_scale (D,)). ``head_dim``: the padded contract, as
    :func:`fused_qkv_attention_plain`'s (g padded as the output); where the
    padded scales are 0 the padded columns add nothing to the LN backward's
    means, and the gradients come back padded.
    """
    b, s, three_hd = qkv.shape
    hd = three_hd // 3
    dp = hd // num_heads
    d = head_dim or dp
    cos, sin = _padded_tables(s, d, dp, rope_base, rope_alpha, qkv.device)
    q, k, v = _split_heads(qkv, num_heads)
    xn_q, r_q = _ln_unscaled(q, head_dim)
    xn_k, r_k = _ln_unscaled(k, head_dim)
    qs, ks = q_scale.float(), k_scale.float()

    def rope(x):
        return x * cos + rotate_half(x) * sin

    qr, kr = rope(xn_q * qs), rope(xn_k * ks)
    p = _exp_scores(qr, kr, mask, d)
    p = p / p.sum(dim=-1, keepdim=True)
    do = g.float().reshape(b, s, num_heads, dp).transpose(1, 2)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dprob = torch.matmul(do, v.transpose(-1, -2))
    row = (p * dprob).sum(dim=-1, keepdim=True)
    ds = p * (dprob - row) * softmax_scale(d)
    dqr = torch.matmul(ds, kr)
    dkr = torch.matmul(ds.transpose(-1, -2), qr)

    def ln_scale_bwd(dr, xn, r, scale):
        dln = _rope_bwd(dr, cos, sin)
        dscale = (dln * xn).sum(dim=(0, 1, 2))
        dxn = dln * scale
        dx = r * (dxn - _row_mean(dxn, head_dim) - xn * _row_mean(dxn * xn, head_dim))
        return dx, dscale

    dq, dqs = ln_scale_bwd(dqr, xn_q, r_q, qs)
    dk, dks = ln_scale_bwd(dkr, xn_k, r_k, ks)
    dqkv = torch.cat([t.transpose(1, 2).reshape(b, s, hd) for t in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype), dqs, dks


def _check_kernel_args(name, qkv, q_scale, k_scale, mask, num_heads):
    """Shared checks of both CUDA wrappers; returns (B, S, D). D even and at
    least 2 (:func:`check_head_dim`), S >= 1."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if qkv.dtype not in DTYPE_CODES:
        raise TypeError(f"fused attention kernels take float32 or bfloat16, not {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError("qkv must be a contiguous (B, S, 3*H*D) tensor")
    b, s, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} is not 3 * num_heads * head_dim")
    d = three_hd // (3 * num_heads)
    check_head_dim(d)
    if s < 1:
        raise ValueError(f"kernel takes S >= 1, got {s}")
    if q_scale.shape != (d,) or k_scale.shape != (d,):
        raise ValueError("q_scale and k_scale must have shape (head_dim,)")
    if mask is not None and mask.shape != (b, s):
        raise ValueError("mask must be a (B, S) key mask")
    return b, s, d


def _kernel_operands(qkv, q_scale, k_scale, mask, s, d, dp, rope_base, rope_alpha):
    """The f32 scales and RoPE tables at ``dp``, padded as :func:`pad_heads` pads
    the heads (a padded column's scale 0), and the mask as bytes."""
    device = qkv.device
    qs, ks = (pad_heads(t.to(device=device, dtype=torch.float32), 1, d, dp).contiguous() for t in (q_scale, k_scale))
    cos, sin = _padded_tables(s, d, dp, rope_base, rope_alpha, device)
    if mask is not None:  # a bool mask is read as its bytes (0 or 1), as a uint8 one
        if mask.dtype != torch.bool:
            mask = mask.to(torch.uint8)
        mask = mask.to(device).contiguous()
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
    """Launch the forward kernel. ``mask`` is a (B, S) bool key mask or None.

    bf16 qkv takes the tensor-core kernel with the geometry of
    :func:`fused_attention_plan` (its split variant with a bf16 workspace for
    k̃, and q̃ at head dims 16 and 32), f32 qkv the CUDA-core kernel; a head
    dim past 128 the wide variant in either dtype, with a workspace of q̃ and
    k̃ in qkv's dtype. A head dim D outside ``KERNEL_HEAD_DIMS`` runs at
    :func:`padded_head_dim`, its heads padded and the output unpadded here.
    Each launch counts in ``FWD_VARIANT_LAUNCHES`` (and a wide one in
    ``WIDE_LAUNCHES``). D even and at least 2, S >= 1, or it raises.
    """
    b, s, d = _check_kernel_args("fused_qkv_attention_cuda", qkv, q_scale, k_scale, mask, num_heads)
    dp = padded_head_dim(d)
    device = qkv.device
    qkv = pad_heads(qkv, 3 * num_heads, d, dp)
    qs, ks, cos, sin, mask = _kernel_operands(qkv, q_scale, k_scale, mask, s, d, dp, rope_base, rope_alpha)
    out = torch.empty((b, s, num_heads * dp), dtype=qkv.dtype, device=device)
    variant, unit, work = 0, 1, None  # the f32 kernel takes its geometry from the shape
    name = "f32"
    if qkv.dtype == torch.bfloat16 or is_wide(dp):
        name, unit = fused_attention_plan(b, s, num_heads, dp)
        variant = MMA_VARIANTS.index(name)
        work = _split_qk_work(name, b, s, num_heads, dp, device, qkv.dtype)
        if qkv.data_ptr() % 16:  # the kernel copies 16 bytes at a time
            qkv = qkv.clone()
    with torch.cuda.device(device):
        FUSED_ATTENTION.launch(
            qkv.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), None if work is None else work.data_ptr(),
            b, s, num_heads, dp, d, softmax_scale(d), DTYPE_CODES[qkv.dtype], variant, unit,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _count(FWD_VARIANT_LAUNCHES, name, FUSED_ATTENTION)
    return unpad_heads(out, num_heads, d, dp)


def _split_qk_work(variant: str, b: int, s: int, heads: int, d: int, device,
                   dtype: torch.dtype = torch.bfloat16) -> Optional[torch.Tensor]:
    """The forward's workspace of q̃ and k̃, (B, S, H, D) a part: for the split
    variant in bf16, k̃ at head dims 64 and 128 (the wgmma forward normalises its
    own q rows), q̃ | k̃ at 16 and 32; for the wide variant q̃ | k̃ in ``dtype``
    (qkv's); None for another variant."""
    if variant == "wide":
        return torch.empty(2 * b * s * heads * d, dtype=dtype, device=device)
    if variant != "split":
        return None
    parts = 1 if d in WGMMA_HEAD_DIMS else 2
    return torch.empty(parts * b * s * heads * d, dtype=torch.bfloat16, device=device)


# #1's and #3's launches by what they ran: the f32 kernel or a variant of their plan (a wide
# launch counts under "wide" in either dtype)
FWD_VARIANT_LAUNCHES = dict.fromkeys(("f32", *MMA_VARIANTS), 0)
BWD_VARIANT_LAUNCHES = dict.fromkeys(("f32", *MMA_VARIANTS), 0)
# the five attention kernels' launches of their wide variant (a head dim past 128)
WIDE_LAUNCHES = dict.fromkeys(
    ("vvt_fused_attention_fwd", "vvt_fused_attention_bwd", "vvt_flash_attention_fwd", "vvt_flash_attention_bwd",
     "vvt_attention_sublayer"), 0)


def _count(variants: Optional[dict], name: str, kernel: CudaKernel) -> None:
    """Count one launch of ``kernel`` under its variant ``name``."""
    if variants is not None:
        variants[name] += 1
    if name == "wide":
        WIDE_LAUNCHES[kernel.symbol] += 1


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

    bf16 takes the tensor-core kernel with the geometry of
    :func:`fused_attention_bwd_plan` (its split variant through an f32
    workspace), f32 the four-pass CUDA-core kernel and its workspace; each
    launch counts in ``BWD_VARIANT_LAUNCHES``; a head dim past 128 takes the
    wide variant in either dtype, through a workspace of dq̃ and dk̃ (f32), q̃
    and k̃ (qkv's dtype) and the rows' statistics. Each
    writes per-block f32 partials of the two scale gradients; they are summed
    here in a fixed order, so every run gives the same bits. A head dim D
    outside ``KERNEL_HEAD_DIMS`` runs at :func:`padded_head_dim` as the
    forward does, qkv and g padded, dqkv and the scale gradients unpadded. D
    even and at least 2, S >= 1, or it raises.
    """
    b, s, d = _check_kernel_args(
        "fused_qkv_attention_bwd_cuda", qkv, q_scale, k_scale, mask, num_heads
    )
    if g.shape != (b, s, num_heads * d) or g.dtype != qkv.dtype or not g.is_contiguous():
        raise ValueError("g must be a contiguous (B, S, H*D) tensor in qkv's dtype")
    if g.device != qkv.device:
        raise ValueError("g must be on qkv's device")
    dp = padded_head_dim(d)
    device = qkv.device
    qkv, g = pad_heads(qkv, 3 * num_heads, d, dp), pad_heads(g, num_heads, d, dp)
    qs, ks, cos, sin, mask = _kernel_operands(qkv, q_scale, k_scale, mask, s, d, dp, rope_base, rope_alpha)
    f32 = dict(dtype=torch.float32, device=device)
    work = None
    variant, unit, warps = 0, 1, 1  # the f32 kernel takes its geometry from the shape
    rows = b * num_heads * s
    name = "f32"
    if is_wide(dp):
        name, unit, warps = fused_attention_bwd_plan(b, s, num_heads, dp)
        variant = MMA_VARIANTS.index(name)
        # dq̃, dk̃ (f32), q̃, k̃ (qkv's dtype), then m, 1/l, row per query
        work = torch.empty(2 * rows * dp + 2 * rows * dp * qkv.element_size() // 4 + 3 * rows, **f32)
        n_blocks = -(-rows // WIDE_LN_ROWS)
        qkv, g = (t.clone() if t.data_ptr() % 16 else t for t in (qkv, g))
    elif qkv.dtype == torch.bfloat16:
        name, unit, warps = fused_attention_bwd_plan(b, s, num_heads, dp)
        variant = MMA_VARIANTS.index(name)
        if name == "split":
            # dq̃, dk̃ (f32), q̃, k̃ (bf16, one f32 word a pair of them), then m, 1/l, row per query;
            # the LN and RoPE backward's scale partials, a row each BWD_ROWS_PER_BLOCK rows
            work = torch.empty(3 * rows * dp + 3 * rows, **f32)
            n_blocks = -(-rows // BWD_ROWS_PER_BLOCK)
        else:
            n_blocks = -(-b * num_heads // unit)
        # the kernel copies 16 bytes at a time
        qkv, g = (t.clone() if t.data_ptr() % 16 else t for t in (qkv, g))
    else:
        # q̃, k̃, v, dO, dq̃, dk̃ as f32 (pair, S, D) rows, then m, l, row per query
        work = torch.empty(6 * rows * dp + 3 * rows, **f32)
        n_blocks = -(-rows // BWD_ROWS_PER_BLOCK)
    partials = torch.empty((2, n_blocks, dp), **f32)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(device):
        FUSED_ATTENTION_BWD.launch(
            qkv.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            partials[0].data_ptr(), partials[1].data_ptr(), None if work is None else work.data_ptr(),
            b, s, num_heads, dp, d, softmax_scale(d), n_blocks, DTYPE_CODES[qkv.dtype], variant, unit, warps,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _count(BWD_VARIANT_LAUNCHES, name, FUSED_ATTENTION_BWD)
    dqs, dks = unpad_heads(partials.sum(dim=1), 1, d, dp)
    return unpad_heads(dqkv, 3 * num_heads, d, dp), dqs, dks


# ---------------------------------------------------------------------------
# Plain masked attention over separate q, k, v of layout (B, S, H, D).
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, mask)
        if q.device.type == "cuda":
            return flash_attention_cuda(q, k, v, mask)
        raise ValueError(f"flash_attention: unsupported device {q.device}")

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        log_kernel("flash_attention_bwd", q)
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, mask, g)
        elif q.device.type == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, mask, g)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ/√D + key mask)·v over (B, S, H, D); returns (B, S, H, D).

    mask: (B,1,1,S) or (B,S) key-padding mask (True keeps a key), or None. A
    row whose keys are all masked attends uniformly (masked scores are −1e30,
    not −inf).
    """
    b, s = q.shape[:2]
    log_kernel("flash_attention", q)
    return _FlashAttention.apply(q, k, v, key_mask(mask, b, s))


def _masked_probs(q, k, mask, head_dim=None):
    """f32 softmax of the masked scores q·kᵀ/√D as (B, H, S, S); D is ``head_dim``
    where q and k are zero-padded past it, else their last dim."""
    scores = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * softmax_scale(head_dim or q.shape[-1])
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def flash_attention_plain(q, k, v, mask, head_dim=None):
    """The forward kernel's arithmetic in plain PyTorch.

    f32 scores and softmax, the normalised probabilities rounded to v's dtype,
    P·V accumulated in f32, one rounding to q's dtype. ``mask`` is a (B, S)
    bool key mask or None. ``head_dim``: the padded contract in plain form, q,
    k and v of a head dim Dp zero-padded past head_dim, whose scale the scores
    take.
    """
    p = _masked_probs(q, k, mask, head_dim).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", p.float(), v.float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, mask, g, head_dim=None):
    """The backward kernel's arithmetic in plain PyTorch, all in f32.

    Recomputes P (not rounded), then dv = Pᵀ·dO, dP = dO·vᵀ, row = Σ_j P∘dP,
    dS = P∘(dP − row)/√D, dq = dS·k, dk = dSᵀ·q; each in its input's dtype.
    ``head_dim``: the padded contract, as :func:`flash_attention_plain`'s.
    """
    p = _masked_probs(q, k, mask, head_dim)
    do = g.float()
    dv = torch.einsum("bhij,bihd->bjhd", p, do)
    dp = torch.einsum("bihd,bjhd->bhij", do, v.float())
    row = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - row) * softmax_scale(head_dim or q.shape[-1])
    dq = torch.einsum("bhij,bjhd->bihd", ds, k.float())
    dk = torch.einsum("bhij,bihd->bjhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rows_of_heads(t: torch.Tensor):
    """(tensor, row stride) the kernels can address as base + row·stride + h·D + d.

    A (B, S, H, D) tensor whose heads are dense and whose rows (b, i) are
    evenly spaced and 16-byte aligned (the kernels load 8 elements at a time)
    is taken as it is (v as a view into the fused QKV projection); anything
    else is copied, a contiguous view at a base off 16 bytes too.
    """
    b, s, h, d = t.shape
    st = t.stride()
    dense_heads = st[3] == 1 and st[2] == d and st[1] >= h * d
    aligned = st[1] % 8 == 0 and t.data_ptr() % 16 == 0
    if not (dense_heads and aligned and (b == 1 or st[0] == s * st[1])):
        t = t.clone(memory_format=torch.contiguous_format)
    return t, t.stride(1)


def _check_flash_args(name, q, k, v, mask):
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, not {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one (B, S, H, D) shape")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must share one dtype and device")
    b, s, h, d = q.shape
    check_head_dim(d)
    if s < 1:
        raise ValueError(f"kernel takes S >= 1, got {s}")
    if mask is not None and mask.shape != (b, s):
        raise ValueError("mask must be a (B, S) key mask")
    return b, s, h, d


def _mask_bytes(mask, device):
    return None if mask is None else mask.to(device=device, dtype=torch.uint8).contiguous()


def flash_attention_cuda(q, k, v, mask):
    """Launch the forward kernel. ``mask`` is a (B, S) bool key mask or None.

    bf16 takes the tensor-core kernel with the geometry of
    :func:`flash_attention_plan`: one launch, no workspace, no atomics, the
    roundings of :func:`flash_attention_plain` (P normalised with the exact
    row max and sum, then rounded to bf16; P·V in f32; one rounding of o),
    split past 256 tokens. f32 takes the CUDA-core kernel, f32 throughout; a
    head dim past 128 the wide variant in either dtype (``WIDE_LAUNCHES``).
    A head dim D outside ``KERNEL_HEAD_DIMS`` runs at :func:`padded_head_dim`,
    q, k and v zero-padded and o unpadded. D even and at least 2, S >= 1, or
    it raises.
    """
    b, s, h, d = _check_flash_args("flash_attention_cuda", q, k, v, mask)
    dp = padded_head_dim(d)
    device = q.device
    (q, qs), (k, ks), (v, vs) = (_rows_of_heads(pad_heads(t, 1, d, dp)) for t in (q, k, v))
    mask = _mask_bytes(mask, device)
    out = torch.empty((b, s, h, dp), dtype=q.dtype, device=device)
    variant, unit = 0, 1  # the f32 kernel takes its geometry from the shape
    name = "f32"
    if q.dtype == torch.bfloat16 or is_wide(dp):
        name, unit = flash_attention_plan(b, s, h, dp)
        variant = MMA_VARIANTS.index(name)
    with torch.cuda.device(device):
        FLASH_ATTENTION.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            qs, ks, vs, b, s, h, dp, d, softmax_scale(d), DTYPE_CODES[q.dtype], variant, unit,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _count(None, name, FLASH_ATTENTION)
    return unpad_heads(out, 1, d, dp)


def flash_attention_bwd_cuda(q, k, v, mask, g):
    """Launch the backward kernel: (dq, dk, dv), contiguous, in the inputs' dtype.

    bf16 takes the tensor-core kernel with the geometry of
    :func:`flash_attention_bwd_plan`: one launch, no workspace, no atomics.
    Its roundings: P normalised (exact row max and sum, f32) and then rounded
    to bf16 for dv = Pᵀ·dO; dS computed in f32 from f32 P and rounded to bf16
    for dq = dS·k and dk = dSᵀ·q; scores, softmax, dP, row and the sums in
    f32; each gradient rounded once. Its split variant (past 256 tokens) keeps
    these roundings in two launches through an f32 workspace of m, 1/l and
    row per query, still with no atomics. f32 takes the two-pass CUDA-core
    kernel through an f32 workspace of m, l and row per query, f32
    throughout. A head dim past 128 takes the wide variant in either dtype
    (three launches, the workspace as the split variant's; ``WIDE_LAUNCHES``).
    A head dim D outside ``KERNEL_HEAD_DIMS`` runs at
    :func:`padded_head_dim` as the forward does, the gradients unpadded. D
    even and at least 2, S >= 1, or it raises.
    """
    b, s, h, d = _check_flash_args("flash_attention_bwd_cuda", q, k, v, mask)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("g must have q's shape, dtype and device")
    dp = padded_head_dim(d)
    device = q.device
    (q, qs), (k, ks), (v, vs), (g, gs) = (_rows_of_heads(pad_heads(t, 1, d, dp)) for t in (q, k, v, g))
    mask = _mask_bytes(mask, device)
    dq, dk, dv = (torch.empty((b, s, h, dp), dtype=q.dtype, device=device) for _ in range(3))
    work = None
    variant, unit, warps, n_blocks = 0, 1, 1, 0  # the f32 kernel takes its geometry from the shape
    name = "f32"
    if is_wide(dp):
        name, unit, warps = flash_attention_bwd_plan(b, s, h, dp)
        variant = MMA_VARIANTS.index(name)
        work = torch.empty(3 * b * h * s, dtype=torch.float32, device=device)  # m, 1/l (f32: l), row per query
        n_blocks = wide_grid(b, s, h, dp)
    elif q.dtype == torch.bfloat16:
        name, unit, warps = flash_attention_bwd_plan(b, s, h, dp)
        variant = MMA_VARIANTS.index(name)
        if name == "split":
            work = torch.empty(3 * b * h * s, dtype=torch.float32, device=device)  # m, 1/l, row per query
            n_blocks = split_bwd_grid(b, s, h, dp)
        else:
            n_blocks = -(-b * h // unit)
    else:
        work = torch.empty(3 * b * h * s, dtype=torch.float32, device=device)  # m, l, row per query
    with torch.cuda.device(device):
        FLASH_ATTENTION_BWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if mask is None else mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if work is None else work.data_ptr(),
            qs, ks, vs, gs, b, s, h, dp, d, softmax_scale(d), DTYPE_CODES[q.dtype], variant, unit, warps,
            n_blocks, torch.cuda.current_stream(device).cuda_stream,
        )
    _count(None, name, FLASH_ATTENTION_BWD)
    return tuple(unpad_heads(t, 1, d, dp) for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# The whole attention sublayer: y = x + out_proj(attention(LN(x)·Wqkv + b)).
# ---------------------------------------------------------------------------


def ln_affine(x, ln_scale, ln_bias):
    """Token LN + affine as the sublayer kernel computes it: (bf16 xa, f32 xn, f32 r)."""
    xn, r = _ln_unscaled(x.float())
    xa = (xn * ln_scale.float() + ln_bias.float()).to(torch.bfloat16)
    return xa, xn, r


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for 2-D bf16 operands with f32 accumulation and an f32 result.

    On the card one cuBLAS call on the bf16 operands with an f32 output; on
    the CPU, where ``mm`` has no ``out_dtype``, the same sums on upcast
    operands (a bf16 product is exact in f32).
    """
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


@dataclasses.dataclass(frozen=True)
class SublayerPlan:
    """The attention sublayer kernel's geometry: its two products on the GEMM
    of ``csrc/gemm_sm90.cuh`` and its bf16 attention's plan."""

    qkv: GemmPlan  # xa · Wqkv: (N, C) · (C, 3·H·D)
    out: GemmPlan  # o · Wout: (N, H·D) · (H·D, C)
    attention: tuple[str, int]  # fused_attention_plan's (variant, sequences a block)

    @property
    def args(self) -> tuple[int, ...]:
        """The fields the C entry point takes, in its order."""
        variant, unit = self.attention
        return (*self.qkv.args, *self.out.args, MMA_VARIANTS.index(variant), unit)


@functools.lru_cache(maxsize=64)
def sublayer_plan(
    batch: int, seq: int, width: int, heads: int, head_dim: int, sms: Optional[int] = None
) -> SublayerPlan:
    """The geometry of the sublayer kernel for ``batch`` sequences of ``seq``
    tokens of width ``width`` and ``heads`` heads of ``head_dim`` (an
    instantiation: :func:`padded_head_dim` of the model's head dim): each
    product's ``fused_block.gemm_plan`` (for ``sms`` SMs, the H100's 132 by
    default) and the attention's :func:`fused_attention_plan`. The f32
    attention kernel takes its geometry from the shape and ignores the latter.

    The products run at hd = heads·head_dim, 32 for ``tiny_config``: o·Wout's
    K is then under one 64-column slab, and the TMA box reads zeros past K
    (``csrc/gemm_sm90.cuh``), so a ragged K needs no other plan."""
    from video_vae_tpu_torch.ops.fused_block import H100_SMS, gemm_plan  # fused_block imports this module

    n, hd = batch * seq, heads * head_dim
    sms = sms or H100_SMS
    return SublayerPlan(
        qkv=gemm_plan(n, width, 3 * hd, sms),
        out=gemm_plan(n, hd, width, sms),
        attention=fused_attention_plan(batch, seq, heads, head_dim),
    )


class _AttentionSublayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, q_scale, k_scale, wout, bout, mask,
                num_heads, rope_base, rope_alpha):
        args = (x, ln_scale, ln_bias, wqkv, bqkv, q_scale, k_scale, wout, bout, mask,
                num_heads, rope_base, rope_alpha)
        if x.device.type == "cpu":
            y, qkv, o = fused_attention_sublayer_plain(*args)
        elif x.device.type == "cuda":
            y, qkv, o = fused_attention_sublayer_cuda(*args)
        else:
            raise ValueError(f"fused_attention_sublayer: unsupported device {x.device}")
        if any(ctx.needs_input_grad):  # the training variant keeps qkv and o
            ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, q_scale, k_scale, wout, mask, qkv, o)
            ctx.rope = (num_heads, rope_base, rope_alpha)
        return y

    @staticmethod
    def backward(ctx, dy):
        """Out-projection GEMMs, the fused attention backward on the saved qkv,
        the qkv-projection GEMMs, then the token LN backward; GEMM operands in
        bf16 with f32 accumulation, as the forward."""
        x, ln_scale, ln_bias, wqkv, q_scale, k_scale, wout, mask, qkv, o = ctx.saved_tensors
        b, s, c = x.shape
        hd = wout.shape[0]
        n = b * s
        bf16 = torch.bfloat16
        dyf = dy.float()
        dy16 = dy.to(bf16).reshape(n, c)
        xa, xn, r = ln_affine(x, ln_scale, ln_bias)
        xa = xa.reshape(n, c)

        do = matmul_f32(dy16, wout.to(bf16).t())  # (N, HD)
        dwout = matmul_f32(o.to(bf16).reshape(n, hd).t(), dy16)  # (HD, C)
        dbout = dyf.reshape(n, c).sum(dim=0)

        g = do.reshape(b, s, hd).to(qkv.dtype)
        bwd = fused_qkv_attention_bwd_plain if x.device.type == "cpu" else fused_qkv_attention_bwd_cuda
        dqkv, dqs, dks = bwd(qkv, q_scale, k_scale, mask, g, *ctx.rope)

        dqkv16 = dqkv.to(bf16).reshape(n, 3 * hd)
        dwqkv = matmul_f32(xa.t(), dqkv16)  # (C, 3HD)
        dbqkv = dqkv.float().reshape(n, 3 * hd).sum(dim=0)
        dxa = matmul_f32(dqkv16, wqkv.to(bf16).t()).reshape(b, s, c)

        dscale = (dxa * xn).reshape(n, c).sum(dim=0)
        dbias = dxa.reshape(n, c).sum(dim=0)
        du = dxa * ln_scale.float()
        dx_ln = r * (du - du.mean(dim=-1, keepdim=True) - xn * (du * xn).mean(dim=-1, keepdim=True))
        return (
            (dyf + dx_ln).to(x.dtype),
            dscale.to(ln_scale.dtype), dbias.to(ln_bias.dtype),
            dwqkv.to(wqkv.dtype), dbqkv.to(wqkv.dtype),
            dqs.to(q_scale.dtype), dks.to(k_scale.dtype),
            dwout.to(wout.dtype), dbout.to(wout.dtype),
            None, None, None, None,
        )


def fused_attention_sublayer(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    q_scale: torch.Tensor,
    k_scale: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    rope_base: float = 10000.0,
    rope_alpha: float = 1.0,
) -> torch.Tensor:
    """y = x + out_proj(attention(qk-LN + RoPE(LN(x)·Wqkv + bqkv))) for x (B, S, C).

    Parameters arrive in their stored dtype; both projections run on bf16
    operands with f32 accumulation whatever x's dtype is. mask: (B,1,1,S) or
    (B,S) key-padding mask, or None.
    """
    b, s, _ = x.shape
    log_kernel("fused_attention_sublayer", x)
    return _AttentionSublayer.apply(
        x, ln_scale, ln_bias, wqkv, bqkv, q_scale, k_scale, wout, bout, key_mask(mask, b, s),
        num_heads, rope_base, rope_alpha,
    )


def fused_attention_sublayer_plain(
    x, ln_scale, ln_bias, wqkv, bqkv, q_scale, k_scale, wout, bout, mask,
    num_heads, rope_base=10000.0, rope_alpha=1.0, head_dim=None,
):
    """The sublayer kernel's arithmetic in plain PyTorch: (y, qkv, o).

    xa = LN(x) rounded to bf16, qkv = xa·Wqkv (bf16 operands, f32
    accumulation) + bqkv rounded to x's dtype, o = the fused attention on that
    qkv in x's dtype, y = f32(x) + (o·Wout + bout in f32) with one rounding.
    ``mask`` is a (B, S) bool key mask or None. ``head_dim``: the padded
    contract in plain form (:func:`fused_qkv_attention_plain`), Wqkv's and
    bqkv's columns and Wout's rows padded by heads with zeros, so that qkv and
    o come out padded and y as at head_dim.
    """
    bf16 = torch.bfloat16
    b, s, c = x.shape
    xa, _, _ = ln_affine(x, ln_scale, ln_bias)
    qkv = matmul_f32(xa.reshape(b * s, c), wqkv.to(bf16)) + bqkv.float()
    qkv = qkv.reshape(b, s, -1).to(x.dtype)
    o = fused_qkv_attention_plain(qkv, q_scale, k_scale, mask, num_heads, rope_base, rope_alpha, head_dim)
    y = matmul_f32(o.to(bf16).reshape(b * s, -1), wout.to(bf16)) + bout.float()
    return (x.float() + y.reshape(b, s, c)).to(x.dtype), qkv, o


def fused_attention_sublayer_cuda(
    x, ln_scale, ln_bias, wqkv, bqkv, q_scale, k_scale, wout, bout, mask,
    num_heads, rope_base=10000.0, rope_alpha=1.0,
):
    """Launch the sublayer kernel: (y, qkv, o), the last two in x's dtype.

    ``mask`` is a (B, S) bool key mask or None. The weights are cast to bf16
    here, outside the kernel, as the JAX wrapper does; the geometry is
    :func:`sublayer_plan`'s for this card's SMs. bf16 x takes the fused
    attention's tensor-core kernel, f32 x its CUDA-core kernel, whose o the
    kernel casts to a bf16 scratch for the second product; past 256 tokens
    bf16 x takes the attention's split variant with a bf16 workspace of q̃
    and k̃; a head dim past 128 takes the wide variant in either dtype, with a
    workspace of q̃ and k̃ in x's dtype (``WIDE_LAUNCHES``). A head dim D
    outside ``KERNEL_HEAD_DIMS`` runs at
    :func:`padded_head_dim`: Wqkv's and bqkv's columns, Wout's rows and the
    scales padded by heads with zeros, so that the padded columns of qkv and o
    are zero and add nothing to y; qkv and o come back unpadded. D even and at
    least 2, S >= 1 and C % 8 == 0, or it raises.
    """
    if not x.is_cuda:
        raise ValueError("fused_attention_sublayer_cuda needs a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"the sublayer kernel takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 3:
        raise ValueError("x must be (B, S, C)")
    b, s, c = x.shape
    hd = wout.shape[0]
    if wqkv.shape != (c, 3 * hd) or wout.shape != (hd, c) or hd % num_heads:
        raise ValueError("wqkv must be (C, 3*H*D) and wout (H*D, C)")
    d = hd // num_heads
    check_head_dim(d)
    if s < 1 or c % 8:
        raise ValueError(f"kernel takes S >= 1 and C % 8 == 0, got {s}, {c}")
    if ln_scale.shape != (c,) or ln_bias.shape != (c,) or bqkv.shape != (3 * hd,) or bout.shape != (c,):
        raise ValueError("ln_scale, ln_bias, bout must be (C,) and bqkv (3*H*D,)")
    if q_scale.shape != (d,) or k_scale.shape != (d,):
        raise ValueError("q_scale and k_scale must have shape (head_dim,)")
    if mask is not None and mask.shape != (b, s):
        raise ValueError("mask must be a (B, S) key mask")
    dp = padded_head_dim(d)
    device = x.device
    x = x.contiguous()

    def f32(t):
        return t.to(device=device, dtype=torch.float32).contiguous()

    def weight(t):
        return t.to(device=device, dtype=torch.bfloat16).contiguous()

    lng, lnb, bo = f32(ln_scale), f32(ln_bias), f32(bout)
    bq = f32(pad_heads(bqkv, 3 * num_heads, d, dp))
    wq = weight(pad_heads(wqkv, 3 * num_heads, d, dp))
    wo = weight(pad_heads(wout.t(), num_heads, d, dp).t())
    qs, ks, cos, sin, mask = _kernel_operands(x, q_scale, k_scale, mask, s, d, dp, rope_base, rope_alpha)
    hd = num_heads * dp
    y = torch.empty_like(x)
    qkv = torch.empty((b, s, 3 * hd), dtype=x.dtype, device=device)
    o = torch.empty((b, s, hd), dtype=x.dtype, device=device)
    xa = torch.empty((b, s, c), dtype=torch.bfloat16, device=device)
    o16 = torch.empty((b, s, hd), dtype=torch.bfloat16, device=device) if x.dtype == torch.float32 else None
    plan = sublayer_plan(b, s, c, num_heads, dp, torch.cuda.get_device_properties(device).multi_processor_count)
    name = plan.attention[0]
    work = (_split_qk_work(name, b, s, num_heads, dp, device, x.dtype)
            if x.dtype == torch.bfloat16 or name == "wide" else None)
    tensors = (x, wq, wo, y, qkv, o, xa) + tuple(t for t in (o16, work) if t is not None)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the sublayer kernel needs 16-byte aligned tensors")
    if b * s >= 2**31:
        raise ValueError(f"the sublayer kernel takes fewer than 2^31 tokens, got {b * s}")
    with torch.cuda.device(device):
        ATTENTION_SUBLAYER.launch(
            x.data_ptr(), None if mask is None else mask.data_ptr(), lng.data_ptr(), lnb.data_ptr(),
            wq.data_ptr(), bq.data_ptr(), qs.data_ptr(), ks.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), qkv.data_ptr(), o.data_ptr(), xa.data_ptr(),
            None if o16 is None else o16.data_ptr(), None if work is None else work.data_ptr(),
            b, s, c, num_heads, dp, d, softmax_scale(d), DTYPE_CODES[x.dtype], *plan.args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _count(None, name, ATTENTION_SUBLAYER)
    return y, unpad_heads(qkv, 3 * num_heads, d, dp), unpad_heads(o, num_heads, d, dp)
