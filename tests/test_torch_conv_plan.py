"""Launch geometry of the bf16 direct conv kernel (``ops/conv3d.py:conv_plan``).

At every conv of the flagship UNet and of the tap-dot model's (b2 × 16 frames,
the shapes ``chip_smoke.py`` holds the kernel at), at their input gradients
(cin and cout swapped), at ``tiny_config``'s UNet, at the ``cf`` VGG's six
shapes (three convs and three input gradients on one 32-frame pass) and at
the ragged shapes of the card tests: the
persistent blocks take every work item once, every output (frame, channel,
pixel) is owned by exactly one accumulator fragment of one warp of one block,
the pool's row pairs stay inside a warp, and the shared memory and the grid
stay within CUDA's limits.

The loops below mirror ``csrc/conv3d_mma.cuh``: block i takes items i, i +
blocks, …; an item is (frame, tile, channel block), channel block fastest;
consumer warp w is M group w // wgn (rows 2·mg and 2·mg + 1 of the tile, 32
columns: M tiles m = 0..3 at row 2·mg + m // 2, columns 16·(m % 2) .. + 15)
and N group w % wgn (wn 8-channel tiles).
"""

import numpy as np
import pytest

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.conv3d import (
    CONV_MMA_MAX_SMEM,
    CONV_MMA_TILE_W,
    CONV_MMA_WARPS,
    CUDA_MAX_GRID_Y,
    conv_plan,
)

MODEL_CASES = [
    (f"{model}-{name}{' dgrad' if dgrad else ''}", (chip_smoke.BATCH, chip_smoke.FRAMES, h, w),
     cout if dgrad else sum(cins), sum(cins) if dgrad else cout, k)
    for model, cfg in (("flagship", ModelConfig()), ("tapdot", chip_smoke.tapdot_model_config()))
    for name, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(cfg)
    if dtype == "bfloat16"
    for dgrad in (False, True)
]
# the trainer's step (cli/train.py's b2 x 32 frames): the UNet runs on the 2 rollouts of each clip
TRAINER_SHAPE = (2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES)
TRAINER_CASES = [
    (f"trainer-{name}{' dgrad' if dgrad else ''}", (*TRAINER_SHAPE, h, w),
     cout if dgrad else sum(cins), sum(cins) if dgrad else cout, k)
    for name, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(ModelConfig())
    if dtype == "bfloat16"
    for dgrad in (False, True)
]
# tiny_config's UNet on the 2 rollouts of cli/train.py --tiny's 2 clips of 8 frames
TINY = chip_smoke.cli_config(chip_smoke.TINY_ARGS)
TINY_CASES = [
    (f"tiny-{name}{' dgrad' if dgrad else ''}", (2 * TINY.data.batch_size, TINY.data.max_frames, h, w),
     cout if dgrad else sum(cins), sum(cins) if dgrad else cout, k)
    for name, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(TINY.model)
    if dtype == "bfloat16"
    for dgrad in (False, True)
]
# the cf VGG's convs and input gradients, (1, 3, 3) kernels on one pass of 32 frames
VGG_CASES = [(f"vgg-{name}", (1, chip_smoke.VGG_FRAMES, side, side), cin, cout, (1, 3, 3))
             for name, side, cin, cout, _ in chip_smoke.VGG_CONV_CASES]
RAGGED_CASES = [  # (b, t, h, w), cin, cout, k of tests/test_torch_cuda.py
    ((2, 3, 20, 40), 12, 12, (3, 7, 7)),
    ((1, 4, 33, 65), 32, 16, (3, 3, 3)),
    ((2, 2, 16, 32), 64, 128, (3, 3, 3)),
    ((1, 3, 9, 11), 5, 3, (1, 5, 1)),
    ((1, 3, 9, 11), 3, 5, (1, 5, 1)),
    ((2, 2, 20, 48), 12, 12, (1, 7, 7)),
    ((1, 3, 17, 40), 24, 40, (3, 5, 3)),
    ((2, 3, 1, 37), 8, 24, (3, 3, 5)),
    ((1, 2, 32, 32), 512, 512, (1, 3, 3)),
    ((1, 3, 12, 24), 32, 24, (3, 3, 3)),
    ((1, 2, 64, 64), 12, 16, (3, 3, 3)),
    ((2, 2, 18, 44), 5, 19, (1, 3, 5)),
    ((1, 1, 1, 1), 1, 1, (3, 1, 1)),
]


def _dealt_items(plan):
    """The items in the order the blocks take them: block i's i, i + blocks, …"""
    return np.concatenate([np.arange(blk, plan.items, plan.blocks) for blk in range(plan.blocks)])


def _check_plan(shape, cin, cout, k):
    b, t, h, w = shape
    kt, kh, kw = k
    plan = conv_plan(cin, cout, b, t, h, w, kt, kh, kw)
    assert plan.smem <= CONV_MMA_MAX_SMEM
    assert 1 <= plan.blocks <= min(plan.items, 2**31 - 1) and b * t <= CUDA_MAX_GRID_Y
    assert plan.tile_h % 2 == 0  # the pool's row pairs start on even rows

    items = _dealt_items(plan)
    assert np.array_equal(np.sort(items), np.arange(plan.items))  # every item once

    # the fragments of every item, warp, M tile and N tile
    co_tile = items % plan.co_tiles
    tile = (items // plan.co_tiles) % (plan.tiles_h * plan.tiles_w)
    frame = items // (plan.co_tiles * plan.tiles_h * plan.tiles_w)
    y0 = (tile // plan.tiles_w) * plan.tile_h
    x0 = (tile % plan.tiles_w) * CONV_MMA_TILE_W
    co0 = co_tile * plan.n_block
    warp = np.arange(CONV_MMA_WARPS)
    mg, ng = warp // plan.wgn, warp % plan.wgn
    assert mg.max() * 2 + 2 == plan.tile_h  # the M groups cover the tile's rows
    m, j = np.arange(4), np.arange(plan.wn)
    shape5 = (len(items), CONV_MMA_WARPS, 4, plan.wn)
    row = np.broadcast_to(y0[:, None, None, None] + 2 * mg[None, :, None, None] + (m // 2)[None, None, :, None], shape5)
    col = np.broadcast_to(x0[:, None, None, None] + (16 * (m % 2))[None, None, :, None], shape5)
    ch = np.broadcast_to(co0[:, None, None, None] + (8 * plan.wn * ng)[None, :, None, None]
                         + (8 * j)[None, None, None, :], shape5)
    fr = np.broadcast_to(frame[:, None, None, None], shape5)

    # ownership at fragment granularity: one output row x 16 columns x 8 channels
    grid = (b * t, plan.tiles_h * plan.tile_h, 2 * plan.tiles_w, plan.co_tiles * plan.n_block // 8)
    flat = np.ravel_multi_index((fr.ravel(), row.ravel(), col.ravel() // 16, ch.ravel() // 8), grid)
    owners = np.bincount(flat, minlength=int(np.prod(grid))).reshape(grid)
    assert owners.max() == 1  # no fragment is written twice, padding included
    assert (owners[:, :h, : -(-w // 16), : -(-cout // 8)] == 1).all()  # every output once


@pytest.mark.parametrize("name,shape,cin,cout,k", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_conv_plan_at_model_shapes(name, shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


def test_conv_plan_covers_every_model_conv():
    assert len(MODEL_CASES) == 60


@pytest.mark.parametrize("name,shape,cin,cout,k", TRAINER_CASES, ids=[c[0] for c in TRAINER_CASES])
def test_conv_plan_at_trainer_shapes(name, shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


def test_conv_plan_covers_every_trainer_conv():
    assert len(TRAINER_CASES) == 30 and TRAINER_CASES[0][1] == (4, 32, 256, 256)


@pytest.mark.parametrize("shape,cin,cout,k", RAGGED_CASES)
def test_conv_plan_at_ragged_shapes(shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


@pytest.mark.parametrize("k,widest", [((1, 7, 7), 32), ((3, 7, 7), 32), ((3, 7, 5), 64), ((1, 5, 5), 64), ((3, 1, 7), 64)])
def test_conv_plan_fits_every_channel_count(k, widest):
    """The widest kernels fit their buffers at any cout: the weights of a kernel 7
    high take the output-channel block down to 32 or 16."""
    widths = {}
    for cout in (1, 3, 8, 12, 16, 24, 32, 48, 64, 100, 512):
        plan = conv_plan(12, cout, 1, 1, 16, 32, *k)
        assert plan.smem <= CONV_MMA_MAX_SMEM and plan.n_block * plan.co_tiles >= cout
        widths[cout] = plan.n_block
    assert widths[12] == 16 and widths[3] == 8
    assert widths[512] == widest


@pytest.mark.parametrize("name,shape,cin,cout,k", TINY_CASES, ids=[c[0] for c in TINY_CASES])
def test_conv_plan_at_tiny_shapes(name, shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


@pytest.mark.parametrize("name,shape,cin,cout,k", VGG_CASES, ids=[c[0] for c in VGG_CASES])
def test_conv_plan_at_vgg_shapes(name, shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


def test_conv_plan_covers_the_vgg_and_tiny():
    """Six VGG shapes (3 -> 64, 64 -> 64, 64 -> 128 and back, 64 -> 3 the
    gradient into the reconstruction) and tiny's 7 convs and their input
    gradients; conv1_1's gradient takes an 8-wide channel block, conv2_1's
    forward two blocks of 64."""
    assert [(cin, cout) for _, _, cin, cout, _ in VGG_CASES] == [(3, 64), (64, 64), (64, 128), (128, 64), (64, 64),
                                                               (64, 3)]
    assert len(TINY_CASES) == 14 and TINY_CASES[0][1] == (4, 8, 32, 32)
    assert conv_plan(64, 3, 1, 32, 256, 256, 1, 3, 3).n_block == 8
    plan = conv_plan(64, 128, 1, 32, 128, 128, 1, 3, 3)
    assert (plan.n_block, plan.co_tiles) == (64, 2)
