"""Launch geometry of the wgmma filter-gradient kernel (``ops/conv3d.py:wgrad_wg_plan``).

At every bf16 conv of the flagship's UNet (the default train step's b2 × 16
frames: the UNet runs on the step's 2 rollouts), the tap-dot model's, the
trainer's (b4 × 32 frames), the flagship's at 512², ``tiny_config``'s (b4 ×
8 frames), ``--small``'s (b4 × 32 frames at 256²) and at every shape of the
card tests: each dW element is owned by one (M-tile row, N column) of one
block, the blocks' pixel splits are disjoint and cover every pixel of every
frame once (a tap whose frame lies outside the clip reads TMA's zero fill),
the shared memory and the workspace stay within their bounds and every
tensor map is legal (strides multiples of 16 bytes, a 16-byte aligned
innermost coordinate, boxes of at most 256 a dimension, at most 5 dims, the
inner box the swizzle's width). Exactly the frames whose width is not a
multiple of 8 keep PR 6's wmma kernel. Then the kernel's dataflow (the g
copy, each A box and B box at the plan's coordinates with TMA's zero fill,
the M-tiles' bands and row offsets, the two consumer warpgroups' partials,
the reduce's mapping back to (tap, ci, co)) is replayed in torch on small
integers, so every sum is exact, and held to ``conv3d_wgrad_plain`` bit for
bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.core.config import tiny_config
from video_vae_tpu_torch.ops.conv3d import (
    CONV_MMA_MAX_SMEM,
    CUDA_MAX_GRID_Y,
    WGRAD_WG_KB,
    WGRAD_WG_MAX_NB,
    WGRAD_WG_MAX_STAGES,
    WGRAD_WG_MAX_WORKSPACE,
    conv3d_wgrad_plain,
    wgrad_variant,
    wgrad_wg_plan,
    wgrad_wg_smem,
)

SETS = {  # name: (model config, clips the UNet runs on, frames)
    "flagship": (ModelConfig(), chip_smoke.BATCH, chip_smoke.FRAMES),
    "tapdot": (chip_smoke.tapdot_model_config(), chip_smoke.BATCH, chip_smoke.FRAMES),
    "trainer": (ModelConfig(), 2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES),
    "512": (ModelConfig(height=512, width=512), chip_smoke.BATCH, chip_smoke.FRAMES),
    "tiny": (tiny_config().model, 2 * tiny_config().data.batch_size, tiny_config().data.max_frames),
    "small": (ModelConfig(encoder_depth=2, decoder_depth=2), 2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES),
}
MODEL_CASES = [  # (set, conv), (b, t, h, w), source channels, cout, k
    ((name, conv), (b, t, h, w), cins, cout, k)
    for name, (cfg, b, t) in SETS.items()
    for conv, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(cfg)
    if dtype == "bfloat16"
]
CARD_CASES = [  # tests/test_torch_cuda.py:test_conv3d_wgrad_kernel_matches_plain
    ((2, 3, 20, 40), (12,), 12, (3, 7, 7)),
    ((1, 4, 33, 65), (16, 16), 16, (3, 3, 3)),
    ((2, 2, 16, 32), (64,), 128, (3, 3, 3)),
    ((1, 3, 9, 11), (5,), 3, (1, 5, 1)),
    ((1, 5, 24, 72), (12,), 12, (3, 7, 7)),
    ((1, 3, 16, 48), (32,), 256, (3, 3, 3)),
    ((2, 2, 20, 48), (12,), 12, (1, 7, 7)),
    ((1, 2, 8, 16), (256, 256), 256, (1, 3, 3)),
    ((2, 2, 12, 6), (16,), 32, (3, 3, 3)),
    ((1, 2, 256, 256), (16,), 16, (3, 3, 3)),
    ((1, 3, 16, 64), (24, 40), 32, (3, 3, 3)),
    ((2, 3, 16, 32), (16,), 12, (3, 3, 3)),
]
# the frames a tensor map cannot describe (w % 8 != 0): PR 6's wmma kernel
WMMA_SHAPES = {(1, 4, 33, 65), (1, 3, 9, 11), (2, 2, 12, 6)}


def _plan(shape, cins, cout, k):
    b, t, h, w = shape
    return wgrad_wg_plan(cins[0], cins[1] if len(cins) == 2 else 0, cout, b, t, h, w, *k)


def _owners(plan):
    """(m-tile, n, row) of every dW element, (dt, dh, dw, ci, co)-major, as the reduce maps it."""
    dt, dh, dw, ci, co = np.meshgrid(np.arange(plan.kt), np.arange(plan.kh), np.arange(plan.kw),
                                     np.arange(plan.c1 + plan.c2), np.arange(plan.cout), indexing="ij")
    box = (dt * plan.kw + dw) * plan.co_bands + co // plan.band
    mt = box // plan.bpm * plan.kh + dh
    row = box % plan.bpm * plan.band + co % plan.band
    n = np.where(ci < plan.c1, ci, plan.n2 + ci - plan.c1)
    return box, mt.ravel(), n.ravel(), row.ravel(), (dt.ravel(), dh.ravel(), dw.ravel(), co.ravel())


def _check(shape, cins, cout, k):
    b, t, h, w = shape
    assert wgrad_variant(torch.bfloat16, w) == ("wmma" if w % 8 else "wgmma")
    assert wgrad_variant(torch.float32, w) == "cuda_core"
    if w % 8:
        with pytest.raises(ValueError):
            _plan(shape, cins, cout, k)
        return
    plan = _plan(shape, cins, cout, k)
    kt, kh, kw = k

    # fits: shared memory, registers (an instantiated nb for the kh), rows, grid, workspace
    assert plan.smem == wgrad_wg_smem(plan.nb, kh, plan.bw, plan.rows, plan.stages) <= CONV_MMA_MAX_SMEM
    assert 2 <= plan.stages <= WGRAD_WG_MAX_STAGES and plan.nb <= WGRAD_WG_MAX_NB[kh]
    assert plan.band * plan.bpm == 64 and plan.cp % 8 == 0 and plan.cp >= cout
    assert (plan.rows * plan.bw) % WGRAD_WG_KB == 0 and plan.kblocks >= 1
    assert plan.bw == (w if w < 64 and 64 % w == 0 else 64)
    assert 1 <= plan.splits <= min(CUDA_MAX_GRID_Y, max(1, plan.tiles // 2))
    assert plan.grid[0] * plan.grid[1] <= 2**31 - 1 and plan.workspace <= WGRAD_WG_MAX_WORKSPACE

    # every dW element owned once: by one (m-tile, n, row) of one block, (group, N tile),
    # whose producer loads the element's (dt, dw, band) box at the row's band
    box, mt, n, row, (dt, dh, dw, co) = _owners(plan)
    keys = (mt * plan.cin_pad + n) * 64 + row
    assert len(np.unique(keys)) == keys.size
    assert (row < 64).all() and (n < plan.cin_pad).all() and (mt < plan.mtiles).all()
    group, nt = mt // kh, n // plan.nb
    assert (group < plan.groups).all() and (nt < plan.n_tiles).all() and (mt % kh == dh).all()
    loaded = np.array([plan.box(j) for j in range(plan.boxes)])
    slot_box = group * plan.bpm + row // plan.band
    assert (slot_box == box.ravel()).all()
    np.testing.assert_array_equal(loaded[slot_box], np.stack([dt, dw, co - co % plan.band], 1))
    # the N tiles: x1's channels, then x2's, each source's from its own tile start, or
    # both in one joint tile where their channels rounded up to 8 fit it
    c1p, c2p = (-(-c // 8) * 8 for c in (cins[0], cins[1] if len(cins) == 2 else 0))
    assert plan.joint == (len(cins) == 2 and c1p + c2p <= plan.nb)
    assert (plan.nt1, plan.n_tiles, plan.n2) == ((1, 1, c1p) if plan.joint else
                                                (-(-cins[0] // plan.nb), plan.n_tiles, plan.nt1 * plan.nb))
    assert plan.cin_pad == plan.nb * plan.n_tiles

    # the splits: disjoint ranges that cover every tile once; the tiles cover every pixel of every frame once
    ranges = [plan.split_tiles(s) for s in range(plan.splits)]
    assert ranges[0].start == 0 and ranges[-1].stop == plan.tiles
    assert all(a.stop == c.start and len(a) >= 1 for a, c in zip(ranges, ranges[1:]))
    per_frame = plan.tiles // (b * t)
    assert plan.tile(per_frame)[0] == 1 and plan.tile(per_frame - 1)[0] == 0
    covered = np.zeros((h, w), np.int32)
    for i in range(per_frame):
        _, y0, x0 = plan.tile(i)
        covered[y0:y0 + plan.rows, x0:x0 + plan.bw] += 1
        # B's innermost coordinate: 64-pixel aligned (128 bytes), as a box x0 or a flat pixel index
        assert x0 % WGRAD_WG_KB == 0 if not plan.flat else all(
            ((y0 + j * (WGRAD_WG_KB // w)) * w) % WGRAD_WG_KB == 0 for j in range(plan.kblocks))
    assert (covered == 1).all()
    # a tap's g box: the tile's pixels less the tap's offset, in the tile's clip (the
    # frame coordinate outside 0 .. t - 1 where the tap's term is missing: TMA's zeros)
    for i in (0, plan.tiles // 2, plan.tiles - 1):
        frame, y0, x0 = plan.tile(i)
        for j in range(plan.boxes):
            co0, x, y, tt, bb = plan.a_coords(i, j)
            d_t, d_w, c0 = plan.box(j)
            assert (bb, tt, x, y, co0) == (frame // t, frame % t - d_t + kt // 2, x0 - d_w + kw // 2,
                                           y0 - kh // 2, c0)
            assert (2 * co0) % 16 == 0  # A's innermost coordinate

    # tensor maps: rank, strides, boxes, inner box = swizzle width (A) or within it (B)
    maps = plan.maps()
    assert [m["name"] for m in maps] == ["g", "x1"] + (["x2"] if len(cins) == 2 else [])
    for m in maps:
        assert len(m["dims"]) == len(m["box"]) <= 5 and len(m["strides"]) == len(m["dims"]) - 1
        assert all(s % 16 == 0 and s < 2**40 for s in m["strides"])
        assert all(1 <= d <= 256 for d in m["box"]) and all(d >= 1 for d in m["dims"])
        assert 2 * m["box"][0] <= m["swizzle"] and m["swizzle"] in (32, 64, 128)
    assert 2 * maps[0]["box"][0] == maps[0]["swizzle"]


@pytest.mark.parametrize("key,shape,cins,cout,k", MODEL_CASES, ids=[f"{c[0][0]}-{c[0][1]}" for c in MODEL_CASES])
def test_wgrad_wg_plan_at_model_shapes(key, shape, cins, cout, k):
    _check(shape, cins, cout, k)


@pytest.mark.parametrize("shape,cins,cout,k", CARD_CASES)
def test_wgrad_wg_plan_at_card_shapes(shape, cins, cout, k):
    _check(shape, cins, cout, k)


def test_wgrad_wg_plan_covers_every_train_path():
    """Every conv of each set (15 on a 3-level UNet, 7 on tiny's 1-level one)
    takes the wgmma kernel; of the card shapes, exactly those whose width is not
    a multiple of 8 keep PR 6's."""
    assert len(MODEL_CASES) == sum(3 + 4 * cfg.unet_levels for cfg, _, _ in SETS.values()) == 15 * 5 + 7
    assert all(wgrad_variant(torch.bfloat16, shape[3]) == "wgmma" for _, shape, _, _, _ in MODEL_CASES)
    assert {shape for shape, _, _, _ in CARD_CASES if wgrad_variant(torch.bfloat16, shape[3]) == "wmma"} == WMMA_SHAPES


def test_wgrad_wg_plan_by_shape():
    """Four 16-channel taps an M-tile at the flagship's top level, two 32-channel
    ones a level down, one 64-channel tap below; 128-wide N tiles on the tap-dot
    model's wide convs; 7 x 7 kernels' 32 accumulators a thread; the 16-channel
    bands in about three waves of blocks."""
    plans = {key: _plan(shape, cins, cout, k) for key, shape, cins, cout, k in MODEL_CASES}
    top = plans["flagship", "encoders.0.conv2"]
    assert (top.band, top.bpm, top.groups, top.nb, top.rows, top.flat) == (16, 4, 3, 16, 8, False)
    assert 3 * 132 * 0.9 <= top.grid[0] * top.grid[1] <= 3 * 132
    assert plans["flagship", "encoders.1.conv2"].bpm == 2 and plans["flagship", "encoders.2.conv2"].bpm == 1
    mixer = plans["flagship", "patch_mixer"]
    assert (mixer.boxes, mixer.groups, mixer.mtiles, mixer.nb) == (21, 6, 42, 16)
    wide = plans["tapdot", "decoders.0.conv1"]
    assert (wide.nb, wide.nt1, wide.n_tiles, wide.co_bands, wide.joint) == (128, 2, 4, 4, False)
    # the flagship's decoder convs: both sources in one N tile
    assert [(p.nb, p.joint) for p in (plans["flagship", f"decoders.{i}.conv1"] for i in range(3))] == [
        (128, True), (64, True), (32, True)]
    assert plans["flagship", "bottleneck2"].flat and plans["flagship", "bottleneck2"].bw == 32


def _zero_padded_box(t, starts, sizes):
    """t[starts : starts + sizes] with zeros wherever the box leaves t (TMA's fill)."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for s, n, d in zip(starts, sizes, t.shape):
        lo, hi = max(s, 0), min(s + n, d)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _replay(plan, x1, x2, g):
    """dW from the kernel's dataflow on the plan's coordinates: the channels-last
    copy of g, for every block (group, N tile, split) and tile of its split the
    consumer warpgroup that takes it (the tile's parity), the group's A boxes
    and the tile's B box, each K block's kh M-tiles (the bands side by side, dh's
    rows kh − 1 − dh into each box) against the B block, into that warpgroup's
    partial; then the reduce's fixed-order sum, mapped back to (tap, ci, co)."""
    b, t, _, h, w = x1.shape
    gt = torch.zeros(b, t, h, w, plan.cp, dtype=torch.float64)
    gt[..., :plan.cout] = g.permute(0, 1, 3, 4, 2)
    frames_x = [x.reshape(b * t, -1, h, w) for x in (x1, x2) if x is not None]
    if plan.joint:  # one N tile: x1's c1p rows, then x2's, each source's channels rounded up to 8
        joint = torch.zeros(b * t, plan.nb, h, w, dtype=torch.float64)
        joint[:, :plan.c1] = frames_x[0]
        joint[:, plan.c1p:plan.c1p + plan.c2] = frames_x[1]
        frames_x = [joint]
    partials = torch.zeros(plan.splits * 2, plan.mtiles, plan.cin_pad, 64, dtype=torch.float64)
    rk = WGRAD_WG_KB // plan.bw
    box_rows = plan.rows + plan.kh - 1
    for bx in range(plan.grid[0]):
        group, nt = bx % plan.groups, bx // plan.groups
        src, ci0 = (0, nt * plan.nb) if nt < plan.nt1 else (1, (nt - plan.nt1) * plan.nb)
        boxes = range(group * plan.bpm, min(plan.boxes, group * plan.bpm + plan.bpm))
        for split in range(plan.splits):
            for local, i in enumerate(plan.split_tiles(split)):
                frame, y0, x0 = plan.tile(i)
                a = torch.zeros(plan.bpm, box_rows, plan.bw, plan.band, dtype=torch.float64)
                for j, box in enumerate(boxes):
                    co0, x, y, tt, bb = plan.a_coords(i, box)
                    a[j] = _zero_padded_box(gt, (bb, tt, y, x, co0), (1, 1, box_rows, plan.bw, plan.band))[0, 0]
                xb = _zero_padded_box(frames_x[src], (frame, ci0, y0, x0), (1, plan.nb, plan.rows, plan.bw))[0]
                for jb in range(plan.kblocks):
                    bk = xb[:, jb * rk:(jb + 1) * rk].reshape(plan.nb, WGRAD_WG_KB)  # n x 64 pixels
                    for dh in range(plan.kh):
                        r0 = jb * rk + plan.kh - 1 - dh
                        am = a[:, r0:r0 + rk].reshape(plan.bpm, WGRAD_WG_KB, plan.band)
                        am = am.permute(1, 0, 2).reshape(WGRAD_WG_KB, 64)  # 64 pixels x (band j, channel)
                        partials[split * 2 + local % 2, group * plan.kh + dh, nt * plan.nb:(nt + 1) * plan.nb] += (
                            bk @ am)
    _, mt, n, row, _ = _owners(plan)
    dw = torch.zeros(mt.size, dtype=torch.float64)
    for z in range(plan.splits * 2):  # the reduce: slots in order
        dw += partials[z][torch.from_numpy(mt), torch.from_numpy(n), torch.from_numpy(row)]
    return dw.reshape(plan.kt, plan.kh, plan.kw, plan.c1 + plan.c2, plan.cout)


@pytest.mark.parametrize(
    "shape,cins,cout,k,over",
    [
        ((2, 4, 10, 16), (20, 8), 12, (3, 3, 3), {}),  # a flat frame (16 wide), two sources in one N tile
        ((1, 3, 8, 16), (24, 40), 12, (3, 3, 3), {"nb": 32}),  # two sources, N tiles of their own
        ((2, 3, 6, 72), (16,), 40, (3, 5, 3), {"rows": 2}),  # a ragged 64-pixel column tile, kh = 5
        ((1, 3, 9, 24), (12,), 12, (3, 7, 7), {"rows": 4, "splits": 2}),  # a 7 x 7 mixer, 24 wide (zero fill)
    ],
)
def test_replayed_dataflow_is_the_filter_gradient(shape, cins, cout, k, over):
    b, t, h, w = shape
    plan = dataclasses.replace(_plan(shape, cins, cout, k), **over)
    assert plan.splits * 2 <= plan.tiles
    gen = torch.Generator().manual_seed(sum(cins) + cout + w)
    small = lambda *s: torch.randint(-2, 3, s, generator=gen).double()  # noqa: E731
    xs = [small(b, t, c, h, w) for c in cins]
    g = small(b, t, cout, h, w)
    x2 = xs[1] if len(xs) == 2 else None
    got = _replay(plan, xs[0], x2, g)
    ref = conv3d_wgrad_plain(xs[0].float(), None if x2 is None else x2.float(), g.float(), *k).double()
    assert torch.equal(got, ref)
