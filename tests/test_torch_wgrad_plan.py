"""Launch geometry of the bf16 filter-gradient kernel (``ops/conv3d.py:wgrad_plan``).

At every conv of the flagship UNet and of the tap-dot model's (b2 × 16 frames,
the shapes ``chip_smoke.py`` holds the kernel at) and at the ragged shapes of
the card tests: every element of dW is owned by exactly one accumulator
fragment, no warp holds more fragments than it has registers for, the pixel
tiles of every temporal tap are split into disjoint ranges that cover them,
the grid stays within CUDA's limits and the workspace within its bound.
"""

import numpy as np
import pytest

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.conv3d import (
    CUDA_MAX_GRID_Y,
    WGRAD_MMA_MAX_FRAGS,
    WGRAD_MMA_MAX_WORKSPACE,
    WGRAD_MMA_TILE,
    WGRAD_MMA_WARPS,
    wgrad_plan,
)

MODEL_CASES = [
    (model, name, (chip_smoke.BATCH, chip_smoke.FRAMES, h, w), sum(cins), cout, k)
    for model, cfg in (("flagship", ModelConfig()), ("tapdot", chip_smoke.tapdot_model_config()))
    for name, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(cfg)
    if dtype == "bfloat16"
]
RAGGED_CASES = [  # (b, t, h, w), cin, cout, k of tests/test_torch_cuda.py
    ((2, 3, 20, 40), 12, 12, (3, 7, 7)),
    ((1, 4, 33, 65), 32, 16, (3, 3, 3)),
    ((1, 3, 9, 11), 5, 3, (1, 5, 1)),
    ((1, 2, 16, 32), 64, 256, (3, 3, 3)),
    ((1, 2, 6, 12), 16, 16, (1, 7, 7)),
    ((1, 1, 1, 1), 1, 1, (3, 1, 1)),
]


def _check_plan(shape, cin, cout, k):
    b, t, h, w = shape
    kt, kh, kw = k
    plan = wgrad_plan(cin, cout, b, t, h, w, kt, kh, kw)
    grid_x, splits = plan.grid
    assert 1 <= grid_x <= 2**31 - 1 and 1 <= splits <= CUDA_MAX_GRID_Y
    assert splits <= plan.pixel_tiles
    assert plan.workspace <= WGRAD_MMA_MAX_WORKSPACE
    assert WGRAD_MMA_TILE[0] % plan.row_groups == 0 and WGRAD_MMA_WARPS % plan.row_groups == 0
    # the fragments of a warp share one output-channel block, so one B operand
    assert (WGRAD_MMA_WARPS // plan.row_groups) % plan.nj == 0

    # every (dt, tap, ci, co) of the padded gradient owned by one fragment of one split
    owners = np.zeros((kt, kh * kw, plan.cin_pad, plan.cout_pad), dtype=np.int32)
    per_warp = {}
    for bx, warp, dt, tap, ci0, co0 in plan.fragments():
        assert bx < grid_x and 0 <= dt < kt and 0 <= tap < kh * kw
        assert ci0 + 16 <= plan.cin_pad and co0 + 16 <= plan.cout_pad
        owners[dt, tap, ci0 : ci0 + 16, co0 : co0 + 16] += 1
        per_warp[bx, warp] = per_warp.get((bx, warp), 0) + 1
    # each row group of the block's warps deals out all of the block's fragments once
    assert (owners == plan.row_groups).all()
    assert max(per_warp.values()) <= WGRAD_MMA_MAX_FRAGS

    # the pixel tiles of each dt: those of the frames whose tap lands in the clip
    tiles_hw = -(-h // WGRAD_MMA_TILE[0]) * -(-w // WGRAD_MMA_TILE[1])
    for dt in range(kt):
        tiles = b * (t - abs(dt - kt // 2)) * tiles_hw if t > abs(dt - kt // 2) else 0
        bounds = [tiles * y // splits for y in range(splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == tiles
        assert all(lo <= hi for lo, hi in zip(bounds, bounds[1:]))
    assert plan.pixel_tiles == b * t * tiles_hw


@pytest.mark.parametrize("model,name,shape,cin,cout,k", MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in MODEL_CASES])
def test_wgrad_plan_at_model_shapes(model, name, shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


def test_wgrad_plan_covers_every_model_conv():
    assert len(MODEL_CASES) == 30


@pytest.mark.parametrize("shape,cin,cout,k", RAGGED_CASES)
def test_wgrad_plan_at_ragged_shapes(shape, cin, cout, k):
    _check_plan(shape, cin, cout, k)


def test_wgrad_plan_fills_the_card_at_the_top_level():
    """The 12 → 12 (3,7,7) patch mixer, one chunk and one channel tile: the pixel
    split alone fills the grid, and its 49 fragments fit 8 warps of 7."""
    plan = wgrad_plan(12, 12, 2, 16, 256, 256, 3, 7, 7)
    assert (plan.nj, plan.row_groups) == (1, 1)
    assert plan.grid[0] * plan.grid[1] >= 4 * 132
