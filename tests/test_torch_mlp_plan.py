"""Launch geometry of the MLP sublayer kernel (``ops/fused_block.py:mlp_plan``).

At every row count and width ``chip_smoke.py:phase_mlp_kernel`` and the card
tests give the kernel (b2 × 16 frames, b1 × 16 frames, ragged row counts; the
flagship's widths, the card tests' 136/264 and ``tiny_config``'s), for both
products: the persistent blocks take every tile once, every output element
is owned by exactly one accumulator of one consumer warpgroup of one block,
the shared memory and the grid stay within CUDA's limits, and the TMA boxes
keep TMA's rules.

The loops below mirror ``csrc/gemm_sm90.cuh``: block b takes tiles b, b +
blocks, … (column tile fastest); consumer warpgroup w owns rows 64·w … 64·w +
63 of the block's GEMM_BM × bn tile; accumulator i of
thread (warp, lane) of a warpgroup is row 16·warp + lane // 4 + 8·((i // 2)
% 2), column 8·(i // 4) + 2·(lane % 4) + i % 2 (wgmma's m64nN f32 layout).
"""

import numpy as np
import pytest

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.core.config import tiny_config
from video_vae_tpu_torch.ops.fused_block import (
    GEMM_BK,
    GEMM_BM,
    GEMM_CONSUMER_WARPGROUPS,
    GEMM_EPI_BYTES,
    GEMM_PANEL,
    GEMM_WIDTHS,
    H100_SMS,
    MAX_SMEM,
    gemm_smem,
    mlp_plan,
)

FLAGSHIP = ModelConfig()
TOKENS = chip_smoke.FRAMES * FLAGSHIP.num_patches
ROWS = [
    chip_smoke.BATCH * TOKENS,  # a b2 x 16f serving pass; the train step's decoder
    chip_smoke.TRAIN_BATCH * TOKENS,  # the train step's encoder
    13,  # chip_smoke's and the card tests' ragged row count
    150,  # the card tests' (3, 50) rows
    512,  # the card tests' (32, 16) rows
    96,  # the card backward test's (6, 16) rows
]
TINY = tiny_config().model
WIDTHS = [(FLAGSHIP.embed_dim, FLAGSHIP.mlp_dim), (136, 264), (TINY.embed_dim, TINY.mlp_dim)]
CUDA_MAX_GRID_X = 2**31 - 1
TMA_MAX_BOX = 256
SWIZZLE_SPAN = 128  # bytes: the inner box dimension under the 128-byte swizzle


def _fragment(bn):
    """(row, col) in a warpgroup's 64 x bn of each (thread, accumulator)."""
    thread = np.arange(128)[:, None]
    i = np.arange(bn // 2)[None, :]
    warp, lane = thread // 32, thread % 32
    row = 16 * warp + lane // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return np.broadcast_to(row, (128, bn // 2)), np.broadcast_to(col, (128, bn // 2))


@pytest.mark.parametrize("bn", GEMM_WIDTHS)
def test_accumulator_layout_covers_the_warpgroup_tile_once(bn):
    row, col = _fragment(bn)
    owners = np.bincount((row * bn + col).ravel(), minlength=64 * bn)
    assert owners.min() == owners.max() == 1


def _check_gemm(plan, n, k, m):
    assert (plan.n, plan.k, plan.m) == (n, k, m)
    assert plan.bn in GEMM_WIDTHS and plan.bn % GEMM_PANEL == 0
    assert 2 <= plan.stages and plan.smem == gemm_smem(plan.bn, plan.stages) <= MAX_SMEM
    assert 1 <= plan.blocks <= min(plan.tiles, H100_SMS, CUDA_MAX_GRID_X)
    # TMA: A's box is GEMM_BK columns x GEMM_BM rows, W's GEMM_PANEL x GEMM_BK, both
    # bf16 under the 128-byte swizzle; rows 16-byte aligned; slabs on 1024-byte lines
    for inner, outer in ((GEMM_BK, GEMM_BM), (GEMM_PANEL, GEMM_BK)):
        assert inner * 2 <= SWIZZLE_SPAN and inner <= TMA_MAX_BOX and outer <= TMA_MAX_BOX
    assert (k * 2) % 16 == 0 and (m * 2) % 16 == 0
    assert (GEMM_BM * GEMM_BK * 2) % 1024 == 0 and (GEMM_BK * plan.bn * 2) % 1024 == 0
    assert GEMM_BK % 16 == 0 and GEMM_BM == 64 * GEMM_CONSUMER_WARPGROUPS

    row_tiles = -(-n // GEMM_BM)
    owners = np.zeros((row_tiles * GEMM_BM, plan.col_tiles * plan.bn), dtype=np.int32)
    frow, fcol = _fragment(plan.bn)
    dealt = []
    for block in range(plan.blocks):  # block b's tiles b, b + blocks, ...
        for tile in range(block, plan.tiles, plan.blocks):
            dealt.append(tile)
            row_tile, col_tile = divmod(tile, plan.col_tiles)
            for wg in range(GEMM_CONSUMER_WARPGROUPS):  # one (row, col) per accumulator
                owners[row_tile * GEMM_BM + 64 * wg + frow, col_tile * plan.bn + fcol] += 1
    assert np.array_equal(np.sort(dealt), np.arange(plan.tiles))  # every tile once
    assert owners.max() == 1  # nothing owned twice, the padding included
    assert (owners[:n, :m] == 1).all()  # every output once


@pytest.mark.parametrize("C,F", WIDTHS)
@pytest.mark.parametrize("n", ROWS)
def test_mlp_plan_at_the_kernel_shapes(n, C, F):
    plan = mlp_plan(n, C, F)
    _check_gemm(plan.up, n, C, F)
    _check_gemm(plan.down, n, F, C)


def test_mlp_plan_shares_the_card():
    """At N = 8192 the up product takes 128 x 256 tiles and the down product
    128 x 128, 384 tiles each over 132 persistent blocks; at N = 4096 the up
    product takes 128 x 128 tiles (2 waves of 256-wide tiles would leave one
    part empty); a ragged row count keeps one block a tile."""
    big = mlp_plan(8192, 768, 1536)
    assert (big.up.bn, big.up.tiles, big.up.blocks) == (256, 384, 132)
    assert (big.down.bn, big.down.tiles, big.down.blocks) == (128, 384, 132)
    assert mlp_plan(4096, 768, 1536).up.bn == 128
    small = mlp_plan(13, 768, 1536)
    assert small.up.blocks == small.up.tiles == 12


def test_gemm_smem_counts_ring_staging_and_barriers():
    """The 256-wide tile keeps 4 stages, the 128-wide 5, beside the epilogue's
    f32 staging (8 warps x 16 rows x 64 columns)."""
    assert GEMM_EPI_BYTES == 8 * 16 * 64 * 4
    assert gemm_smem(256, 4) == 1024 + 4 * (16384 + 32768) + GEMM_EPI_BYTES + 4 * 16 <= MAX_SMEM
    assert gemm_smem(256, 5) > MAX_SMEM
    assert mlp_plan(8192, 768, 1536).down.stages == 5
