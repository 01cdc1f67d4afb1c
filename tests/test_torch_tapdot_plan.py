"""Launch geometry of the tap-dot conv kernel (``ops/conv3d.py:tapdot_plan``).

At every conv the gate sends to the kernel on the tap-dot model (b2 × 16
frames, forward convs and input gradients, the shapes ``chip_smoke.py`` holds
the kernel at) and at every shape of the card tests: the persistent blocks
take every tile once, the tiles' stored outputs cover every (frame, channel,
pixel) once, the slabs cover both sources' channels once with the weights' K
columns of the concat, the TMA boxes are legal (16-byte strides, a 16-byte
aligned innermost coordinate, a 128-byte inner box) and the shared memory
fits. Then the kernel's dataflow is replayed in numpy on the plan's own
coordinates for the tiles at the frame's edges and middle (the channels-last
copy, each TMA box with its zero fill, a B group for each column shift and
slab, one product for each of its taps from the group's panels, the epilogue's
masked stores and 2 × 2 pool), on small integers so that every sum is exact,
and held to ``conv3d_tapdot_plain`` bit for bit: the box coordinates are the
tap's shift.

The loops mirror ``csrc/conv3d_tapdot.cu``: block i takes tiles i, i +
blocks, …; a tile is (frame, row tile, column tile, output-channel tile),
channel tile fastest; a tile's B groups are dw-major, x1's slabs before x2's,
and each group's taps run dh = 0 … kh − 1.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from video_vae_tpu_torch.ops.conv3d import (
    CONV_MMA_BLOCKS,
    CONV_MMA_MAX_SMEM,
    TAPDOT_BK,
    TAPDOT_PANEL,
    conv3d_tapdot_plain,
    tapdot_plan,
    tapdot_smem,
)

_FORWARD, _DGRAD = chip_smoke.tapdot_launches(chip_smoke.tapdot_model_config())
MODEL_CASES = [  # (b, t, h, w), source channels, cout, (kh, kw)
    ((chip_smoke.BATCH, chip_smoke.FRAMES, h, w), cins, cout, k[1:])
    for cins, cout, k, h, w in dict.fromkeys([*_FORWARD, *_DGRAD])
]
CARD_CASES = [  # tests/test_torch_cuda.py
    ((1, 2, 128, 128), (128,), 128, (3, 3)),
    ((1, 2, 128, 128), (128, 64), 128, (3, 3)),
    ((1, 1, 128, 128), (128,), 256, (3, 3)),
    ((1, 2, 128, 128), (128,), 64, (3, 3)),
    ((2, 1, 22, 136), (136, 8), 72, (5, 3)),
    ((1, 1, 9, 130), (128,), 8, (1, 7)),
    ((1, 2, 16, 128), (128,), 16, (3, 3)),
    *[((1, 1, h, w), cins, cout, k) for (_, _, h, w), cins, cout, k in MODEL_CASES],
]


def _plan(shape, cins, cout, k):
    b, t, h, w = shape
    return tapdot_plan(cins[0], cins[1] if len(cins) == 2 else 0, cout, b, t, h, w, *k)


def _stored(plan, tiles):
    """(frame, channel, y, x) of every output the tiles' epilogues store."""
    out = []
    rows = np.arange(plan.bm)[:, None]
    cols = np.arange(plan.bn)[None, :]
    for t in tiles:
        frame, y0, x0, co0 = plan.tile(int(t))
        co = co0 + rows + 0 * cols
        y = y0 + cols // TAPDOT_PANEL + 0 * rows
        x = x0 + cols % TAPDOT_PANEL + 0 * rows
        keep = (co < plan.cout) & (y < plan.h) & (x < plan.w)
        out.append(np.stack([np.full(keep.sum(), frame), co[keep], y[keep], x[keep]], 1))
    return np.concatenate(out)


@pytest.mark.parametrize("shape,cins,cout,k", MODEL_CASES + CARD_CASES)
def test_plan_covers_and_fits(shape, cins, cout, k):
    plan = _plan(shape, cins, cout, k)
    b, t, h, w = shape
    assert plan.smem == tapdot_smem(plan.bm, plan.bn, plan.kh, plan.a_stages, plan.b_stages) <= CONV_MMA_MAX_SMEM
    assert plan.a_stages >= 2 and plan.b_stages >= 2 and 1 <= plan.blocks <= min(plan.tiles, CONV_MMA_BLOCKS)
    assert plan.rows % 2 == 0  # the pool's row pairs start on even rows, inside a warpgroup
    assert (plan.bm, plan.bn) in ((128, 128), (128, 256), (64, 256))

    dealt = np.concatenate([np.arange(i, plan.tiles, plan.blocks) for i in range(plan.blocks)])
    assert np.array_equal(np.sort(dealt), np.arange(plan.tiles))  # every tile once

    # the tiles of the first frame store each of its outputs once (every frame is alike)
    per_frame = plan.tiles // plan.frames
    assert plan.tile(per_frame)[0] == 1 and plan.tile(per_frame - 1)[0] == 0
    got = _stored(plan, range(per_frame))
    assert len(got) == cout * h * w
    keys = (got[:, 1] * h + got[:, 2]) * w + got[:, 3]
    assert np.array_equal(np.sort(keys), np.arange(cout * h * w))

    # slabs: each source's channels once, at the weights' K column of the concat
    c1, c2 = plan.c1, plan.c2
    seen = {0: [], 1: []}
    for s in range(plan.slabs):
        src, ci0, k0 = plan.slab(s)
        chans = np.arange(ci0, min(ci0 + TAPDOT_BK, (c1, c2)[src]))
        seen[src].append(chans)
        assert k0 == ci0 + (c1 if src else 0)
        assert (2 * ci0) % 16 == 0 and (2 * k0) % 16 == 0  # TMA's innermost coordinates
    for src, c in ((0, c1), (1, c2)):
        chans = np.concatenate(seen[src]) if seen[src] else np.zeros(0, int)
        assert np.array_equal(chans, np.arange(c))

    # TMA legality: the channels-last copies' strides and the weights' row stride
    # are multiples of 16 bytes, the inner boxes 128 bytes (the swizzle's span);
    # the output's, where it is stored through TMA (a warpgroup's box: 64 pixels
    # by 64 channels by its rows)
    for c in (c1, c2):
        if c:
            assert all(stride % 16 == 0 for stride in (2 * c, 2 * c * w, 2 * c * w * h))
    assert (2 * (c1 + c2)) % 16 == 0 and 2 * TAPDOT_BK == 128 and plan.bm <= 256 and TAPDOT_PANEL <= 256
    assert plan.tma_store == (w % 8 == 0)
    if plan.tma_store:
        assert all(stride % 16 == 0 for stride in (2 * w, 2 * w * h, 2 * w * h * cout))


def _sampled_tiles(plan):
    """Tiles of frame 0 the replay runs: the first, middle and last row tile by the
    first, middle and last column tile, every output-channel tile (the frame's
    edges, where the taps reach into the zero fill, and its inside)."""
    per_frame = plan.tiles // plan.frames
    picked = []
    for t in range(per_frame):
        _, y0, x0, _ = plan.tile(t)
        ty, tx = y0 // plan.rows, x0 // TAPDOT_PANEL
        if ty in (0, plan.tiles_h // 2, plan.tiles_h - 1) and tx in (0, plan.tiles_w // 2, plan.tiles_w - 1):
            picked.append(t)
    return picked


def _replay(plan, x1, x2, kernel, bias, tiles):
    """The kernel's dataflow on the plan's coordinates for ``tiles``: (y, pooled)
    of frame 0, NaN where those tiles store nothing. Inputs are small integers
    in float32, so every sum is exact whatever its order."""
    kh, kw, cin, cout = kernel.shape
    h, w = plan.h, plan.w
    pad = TAPDOT_PANEL + kw
    # the channels-last copies, zero-padded so that a box may start before 0 or run past the end
    xts = [None if x is None else np.pad(x[0].transpose(1, 2, 0), ((pad, pad), (pad, pad), (0, TAPDOT_BK)))
           for x in (x1, x2)]
    wmat = kernel.transpose(0, 1, 3, 2).reshape(kh * kw * cout, cin)
    wpad = np.pad(wmat, ((0, plan.bm), (0, TAPDOT_BK)))
    y = np.full((cout, h, w), np.nan, np.float32)
    pooled = np.full((cout, h // 2, w // 2), np.nan, np.float32)
    n = plan.bn
    for t in tiles:
        _, y0, x0, co0 = plan.tile(t)
        a, b = [], []
        for grp in range(plan.groups):  # a B group, then each of its kh taps
            dw, s = divmod(grp, plan.slabs)
            group = np.concatenate([
                xts[plan.slab(s)[0]][yy + pad, xx + pad:xx + pad + TAPDOT_PANEL, ci:ci + TAPDOT_BK]
                for ci, xx, yy, _ in (plan.b_box(t, dw, s, q) for q in range(plan.panels))
            ])
            for dh in range(kh):
                k0, row = plan.a_box(t, dh * kw + dw, s)
                a.append(wpad[row:row + plan.bm, k0:k0 + TAPDOT_BK])
                b.append(group[dh * TAPDOT_PANEL:dh * TAPDOT_PANEL + n])
        d = np.matmul(np.stack(a), np.stack(b).transpose(0, 2, 1)).sum(axis=0)
        d += np.pad(bias, (0, plan.bm))[co0:co0 + plan.bm, None]
        rows = min(plan.bm, cout - co0)
        cols = min(TAPDOT_PANEL, w - x0)
        for p in range(plan.rows):
            yy = y0 + p
            if yy >= h:
                continue
            y[co0:co0 + rows, yy, x0:x0 + cols] = d[:rows, p * TAPDOT_PANEL:p * TAPDOT_PANEL + cols]
            if p % 2 == 0 and h % 2 == 0 and w % 2 == 0:
                pair = np.maximum(d[:rows, p * TAPDOT_PANEL:p * TAPDOT_PANEL + cols],
                                  d[:rows, (p + 1) * TAPDOT_PANEL:(p + 1) * TAPDOT_PANEL + cols])
                pooled[co0:co0 + rows, yy // 2, x0 // 2:(x0 + cols) // 2] = np.maximum(pair[:, 0::2], pair[:, 1::2])
    return y, pooled


@pytest.mark.parametrize("shape,cins,cout,k", MODEL_CASES + CARD_CASES)
def test_replayed_dataflow_is_the_conv(shape, cins, cout, k):
    """The replay of the sampled tiles equals the plain version bit for bit."""
    _, _, h, w = shape
    plan = _plan(shape, cins, cout, k)
    rng = np.random.default_rng(sum(cins) + cout + h)
    small = lambda *s: rng.integers(-2, 3, s).astype(np.float32)  # noqa: E731
    xs = [small(1, c, h, w) for c in cins]
    kernel = small(*k, sum(cins), cout)
    bias = small(cout)
    tiles = _sampled_tiles(plan)
    y, pooled = _replay(plan, xs[0], xs[1] if len(xs) == 2 else None, kernel, bias, tiles)
    stored = _stored(plan, tiles)
    assert np.isnan(y).sum() == y.size - len(stored)  # the sampled tiles' outputs, each written

    pool = h % 2 == 0 and w % 2 == 0
    ref = conv3d_tapdot_plain(
        *[torch.from_numpy(x)[None] for x in xs[:1]], torch.from_numpy(xs[1])[None] if len(xs) == 2 else None,
        torch.from_numpy(kernel)[None], torch.from_numpy(bias), pool=pool,
    )
    ref_y, ref_pool = (r[0, 0].numpy() for r in ref) if pool else (ref[0, 0].numpy(), None)
    written = ~np.isnan(y)
    np.testing.assert_array_equal(y[written], ref_y[written])
    if pool:
        written = ~np.isnan(pooled)
        assert written.any()
        np.testing.assert_array_equal(pooled[written], ref_pool[written])


def test_plan_tiles_by_shape():
    """4 rows of 64 pixels where 4-row tiles fill every SM, 2 where they would not;
    64 output channels a tile at cout <= 64; three B group slots beside four or
    more weight slots, else two."""
    model = {(cins, cout): _plan(shape, cins, cout, k) for shape, cins, cout, k in MODEL_CASES}
    assert all(p.bn == 256 and p.panels == 6 and p.tma_store for p in model.values())
    assert {key: (p.bm, p.a_stages, p.b_stages) for key, p in model.items()} == {
        ((128,), 128): (128, 4, 2), ((128, 128), 128): (128, 4, 2), ((64, 64), 64): (64, 6, 3),
        ((128,), 64): (64, 6, 3), ((128,), 256): (128, 4, 2),
    }
    small = _plan((1, 1, 128, 128), (128,), 128, (3, 3))
    assert (small.bm, small.bn, small.a_stages, small.b_stages, small.tiles) == (128, 128, 6, 3, 128)
    # the largest kernel the gate admits: 4-row tiles' rings would not fit beside their staging
    widest = _plan((2, 16, 128, 128), (128,), 128, (7, 7))
    assert (widest.bn, widest.panels, widest.a_stages, widest.b_stages) == (128, 8, 4, 2)
    # the second route, stores from registers: only where TMA cannot describe the output
    assert [shape for shape, cins, cout, k in MODEL_CASES + CARD_CASES
            if not _plan(shape, cins, cout, k).tma_store] == [(1, 1, 9, 130)]
