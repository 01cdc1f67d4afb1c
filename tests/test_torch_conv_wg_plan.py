"""Launch geometry of the wgmma direct conv (``ops/conv3d.py:conv_wg_plan``).

At every bf16 conv and input gradient of the flagship's UNet (b2 × 16
frames), the tap-dot model's, the trainer's (b4 × 32 frames), the flagship's
at 512², ``tiny_config``'s (b4 × 8 frames), ``--small``'s (b4 × 32 frames at
256²), the ``cf`` VGG's (b1 × 32 frames) and at every shape of the card tests:
each output (pixel, channel) is owned by exactly one (tile, consumer
warpgroup, M-tile row, N column), the tiles' stages are the temporal taps
inside the clip times the chunks, the shared memory stays within the block's
and every tensor map is legal (strides multiples of 16 bytes, at most 5 dims,
boxes of at most 256 a dimension, the inner box the swizzle's width); the
7 × 7 patch mixer, which ``conv_variant`` never sends the kernel, has no
plan (two slots of its weight box at 64 channels overflow the block).
``conv_variant`` sends the kernel only the convs it was measured faster at
(the rest keep the mma.sync kernel, f32 the CUDA-core one). Then the kernel's dataflow (the channels-last
copies, the weights' K-major re-layout, each input box and weight box at the
plan's coordinates with TMA's zero fill, each step's fragment at its box row
and column shift feeding the M-tiles whose row tap it is, the epilogue's
pixel mapping, the pool from the rounded outputs) is replayed in torch on
small integers, so every sum is exact, and held to ``conv3d_cf_plain`` bit
for bit: one source, two sources, an input gradient through the flipped
kernel, and the pooled output.
"""

import dataclasses

import numpy as np
import pytest
import torch
from helpers.threads import one_thread  # noqa: F401

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.core.config import tiny_config
from video_vae_tpu_torch.ops.conv3d import (
    CONV_MMA_BLOCKS,
    CONV_MMA_MAX_SMEM,
    CONV_WG_MAX_STAGES,
    CONV_WG_MTILE,
    conv3d_cf_plain,
    conv_variant,
    conv_wg_max_mtw,
    conv_wg_plan,
    conv_wg_smem,
)

SETS = {  # name: (model config, clips the UNet runs on, frames)
    "flagship": (ModelConfig(), chip_smoke.BATCH, chip_smoke.FRAMES),
    "tapdot": (chip_smoke.tapdot_model_config(), chip_smoke.BATCH, chip_smoke.FRAMES),
    "trainer": (ModelConfig(), 2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES),
    "512": (ModelConfig(height=512, width=512), chip_smoke.BATCH, chip_smoke.FRAMES),
    "tiny": (tiny_config().model, 2 * tiny_config().data.batch_size, tiny_config().data.max_frames),
    "small": (ModelConfig(encoder_depth=2, decoder_depth=2), 2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES),
}
MODEL_CASES = [  # (set, conv), (b, t, h, w), source channels, cout, k: each conv, then its input gradient
    case
    for name, (cfg, b, t) in SETS.items()
    for conv, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(cfg)
    if dtype == "bfloat16"
    for case in (((name, conv), (b, t, h, w), cins, cout, k),
                 ((name, conv + " dgrad"), (b, t, h, w), (cout,), sum(cins), k))
] + [
    (("vgg-cf", name), (1, chip_smoke.VGG_FRAMES, side, side), (cin,), cout, (1, 3, 3))
    for name, side, cin, cout, _ in chip_smoke.VGG_CONV_CASES
]
CARD_CASES = [  # tests/test_torch_cuda.py's direct-conv shapes: (shape, sources, cout, k, pooled)
    ((2, 3, 20, 40), (12,), 12, (3, 7, 7), False),
    ((1, 4, 33, 65), (16, 16), 16, (3, 3, 3), False),
    ((2, 2, 16, 32), (64,), 128, (3, 3, 3), False),
    ((1, 3, 9, 11), (5,), 3, (1, 5, 1), False),
    ((2, 2, 20, 48), (12,), 12, (1, 7, 7), False),
    ((1, 3, 17, 40), (24,), 40, (3, 5, 3), False),
    ((2, 3, 1, 37), (8,), 24, (3, 3, 5), False),
    ((1, 2, 32, 32), (512,), 512, (1, 3, 3), False),
    ((1, 3, 12, 24), (20, 12), 24, (3, 3, 3), False),
    ((1, 4, 24, 40), (48,), 32, (3, 3, 3), False),
    ((1, 3, 16, 48), (24, 24), 16, (3, 3, 3), False),
    ((2, 2, 64, 64), (12,), 12, (3, 7, 7), False),
    ((2, 2, 64, 64), (12,), 16, (3, 3, 3), False),
    ((2, 2, 64, 64), (16, 16), 16, (3, 3, 3), False),
    ((1, 2, 64, 64), (3,), 64, (1, 3, 3), False),
    ((1, 2, 64, 64), (64,), 3, (1, 3, 3), False),
    ((1, 2, 64, 64), (12,), 16, (3, 3, 3), True),
    ((2, 2, 18, 44), (5,), 19, (1, 3, 5), True),
    ((1, 3, 64, 64), (64,), 64, (3, 3, 3), False),
    ((1, 3, 32, 32), (64,), 128, (3, 3, 3), False),
    ((1, 2, 64, 64), (64, 64), 64, (3, 3, 3), False),
    ((1, 2, 64, 64), (64,), 64, (3, 3, 3), True),
    ((1, 2, 32, 32), (64,), 128, (3, 3, 3), True),
]
# the card shapes on the wgmma kernel: one source, two, and the pool of each M-tile height
WGMMA_CARD_CASES = {((1, 3, 64, 64), (64,), 64, False), ((1, 3, 32, 32), (64,), 128, False),
                    ((2, 2, 16, 32), (64,), 128, False), ((1, 2, 64, 64), (64, 64), 64, False),
                    ((1, 2, 32, 32), (512,), 512, False), ((1, 2, 64, 64), (3,), 64, False),
                    ((1, 2, 64, 64), (64,), 64, True), ((1, 2, 32, 32), (64,), 128, True)}
# the card shapes whose frame a tensor map cannot describe (w % 8 != 0): the mma.sync kernel
MMA_WIDTHS = {65, 11, 37, 44}


def _plan(shape, cins, cout, k, pool=False):
    b, t, h, w = shape
    return conv_wg_plan(cins[0], cins[1] if len(cins) == 2 else 0, cout, b, t, h, w, *k, pool=pool)


def _pixels(plan, i):
    """(row, column) of every (consumer warpgroup, M-tile, pixel) of tile i, as the
    epilogue maps them: (2, mtw, 64) arrays each."""
    _, _, y0, x0, _ = plan.tile(i)
    wg, r, p = np.meshgrid(np.arange(2), np.arange(plan.mtw), np.arange(CONV_WG_MTILE), indexing="ij")
    return y0 + (wg * plan.mtw + r) * plan.rpm + p // plan.bw, x0 + p % plan.bw


def _check(shape, cins, cout, k, pool=False):
    b, t, h, w = shape
    faster = w % 8 == 0 and max(k[1:]) <= 3 and cout >= 64 and (cout >= 128 or h * w >= 64 * 64)
    assert conv_variant(torch.bfloat16, h, w, k, cout) == ("wgmma" if faster else "mma")
    assert conv_variant(torch.float32, h, w, k, cout) == "cuda_core"
    if w % 8:
        with pytest.raises(ValueError):
            _plan(shape, cins, cout, k, pool)
        return
    if not faster and k[1] * k[2] > 25:  # two slots of a 7 x 7 weight box at 64 channels overflow the block
        with pytest.raises(ValueError):
            _plan(shape, cins, cout, k, pool)
        return
    plan = _plan(shape, cins, cout, k, pool)
    kt, kh, kw = k
    c2 = cins[1] if len(cins) == 2 else 0

    # fits: shared memory, registers (mtw · nb / 2 accumulators), the ring, the boxes, the grid
    assert plan.smem == conv_wg_smem(plan.kc, plan.nb, plan.bx, plan.rx, kh * kw, plan.stages) <= CONV_MMA_MAX_SMEM
    assert 2 <= plan.stages <= CONV_WG_MAX_STAGES and 1 <= plan.mtw <= conv_wg_max_mtw(plan.nb)
    assert plan.mtw * plan.nb // 2 <= 128 and plan.nb >= min(cout, 128) and plan.nb % 8 == 0
    assert plan.bw * plan.rpm == CONV_WG_MTILE and plan.bw <= w and (w >= 64) == (plan.bw == 64)
    assert plan.cp1 >= cins[0] and plan.cp2 >= c2 and plan.cp1 % plan.kc == 0 and plan.cp2 % plan.kc == 0
    assert plan.kc == 16 or max(cins) > plan.kc // 2  # no chunk wider than the widest source needs
    assert 1 <= plan.blocks == min(plan.tiles, CONV_MMA_BLOCKS) and plan.tiles <= 2**31 - 1
    if pool and plan.rpm == 1:
        assert plan.mtw % 2 == 0  # the pool's row pairs lie in one warpgroup's pair of M-tiles

    # every output pixel of a frame owned once, by one (tile, warpgroup, M-tile, pixel);
    # every output channel by one N tile's column
    per_frame = plan.tiles // (b * t)
    assert plan.tile(per_frame)[:2] == ((1, 0) if t == 1 else (0, 1)) and plan.tile(per_frame - 1)[:2] == (0, 0)
    owned = np.zeros((h, w), np.int64)
    for i in range(0, per_frame, plan.n_tiles):
        rows, cols = _pixels(plan, i)
        inside = (rows < h) & (cols < w)
        np.add.at(owned, (rows[inside], cols[inside]), 1)
    assert (owned == 1).all()
    channels = np.concatenate([plan.tile(i)[4] + np.arange(plan.nb) for i in range(plan.n_tiles)])
    assert np.array_equal(np.sort(channels[channels < cout]), np.arange(cout))

    # a tile's stages: the temporal taps inside the clip, each over x1's chunks then x2's; the
    # input box at the tile's corner less the taps' half widths, the weight box at the
    # stage's taps, K column and N tile
    for i in sorted({0, per_frame - 1, plan.tiles // 2, plan.tiles - 1}):
        bb, tt, y0, x0, n0 = plan.tile(i)
        stages = plan.stages_of(i)
        dts = [dt for dt in range(kt) if 0 <= tt + dt - kt // 2 < t]
        assert stages == [(dt, c) for dt in dts for c in range(plan.chunks)]
        for dt, chunk in stages:
            src, c0, coords = plan.a_coords(i, dt, chunk)
            assert coords == (c0, x0 - kw // 2, y0 - kh // 2, tt + dt - kt // 2, bb)
            assert (src, c0) == ((0, chunk * plan.kc) if chunk < plan.chunks1 else
                                 (1, (chunk - plan.chunks1) * plan.kc))
            assert c0 < (cins[src]) and (2 * c0) % 16 == 0  # the innermost coordinate: 16-byte aligned
            assert plan.b_coords(i, dt, chunk) == (c0 + (plan.cp1 if src else 0), n0, dt * kh * kw)

    # tensor maps: rank, strides, boxes, the inner box the swizzle's width (or 16 bytes unswizzled)
    maps = plan.maps()
    assert [m["name"] for m in maps] == ["x1"] + (["x2"] if c2 else []) + ["w", "y"]
    for m in maps:
        assert len(m["dims"]) == len(m["box"]) <= 5 and len(m["strides"]) == len(m["dims"]) - 1
        assert all(s % 16 == 0 and s < 2**40 for s in m["strides"])
        assert all(1 <= d <= 256 for d in m["box"]) and all(d >= 1 for d in m["dims"])
        assert 2 * m["box"][0] == (m["swizzle"] or 16) and m["swizzle"] in (0, 32, 64, 128)
    assert maps[-1]["box"] == (plan.bw, plan.nb, plan.rpm, 1)


@pytest.mark.parametrize("key,shape,cins,cout,k", MODEL_CASES, ids=[f"{c[0][0]}-{c[0][1]}" for c in MODEL_CASES])
def test_conv_wg_plan_at_model_shapes(key, shape, cins, cout, k):
    _check(shape, cins, cout, k)


@pytest.mark.parametrize("shape,cins,cout,k,pool", CARD_CASES)
def test_conv_wg_plan_at_card_shapes(shape, cins, cout, k, pool):
    _check(shape, cins, cout, k, pool)


def test_conv_wg_plan_covers_every_model_conv():
    """Every conv and input gradient of each set (15 + 15 on a 3-level UNet, 7 +
    7 on tiny's 1-level one) and the cf VGG's six has a plan; the wgmma kernel
    takes those it was measured faster at: on the flagship the 64- and
    128-channel levels' 6 forwards and 5 input gradients (bottleneck1's 128 ->
    64 on 32 x 32 and encoders.2.conv1's 64 -> 32 keep the mma.sync kernel), on the kt = 1
    tap-dot model every conv but the 7 x 7 mixer's two and the 64 -> 12 input
    gradient, the cf VGG's five of 64 or more output channels, none of tiny's;
    of the card shapes, those whose width is not a multiple of 8 keep the mma.sync kernel,
    and so does a 7 x 7 kernel at any width."""
    assert len(MODEL_CASES) == sum(2 * (3 + 4 * cfg.unet_levels) for cfg, _, _ in SETS.values()) + 6 == 2 * 82 + 6
    taken = {(name, conv) for (name, conv), shape, _, cout, k in MODEL_CASES
             if conv_variant(torch.bfloat16, shape[2], shape[3], k, cout) == "wgmma"}
    flagship = ["encoders.2.conv1", "encoders.2.conv2", "bottleneck1", "bottleneck2", "decoders.0.conv1",
                "decoders.0.conv2", "encoders.2.conv2 dgrad", "bottleneck2 dgrad", "decoders.0.conv1 dgrad",
                "decoders.0.conv2 dgrad", "decoders.1.conv1 dgrad"]
    assert {conv for name, conv in taken if name == "flagship"} == set(flagship)
    tapdot = {conv for (name, conv), *_ in MODEL_CASES if name == "tapdot"}
    assert {conv for name, conv in taken if name == "tapdot"} == tapdot - {
        "patch_mixer", "patch_mixer dgrad", "encoders.0.conv1 dgrad"}
    assert {conv for name, conv in taken if name == "vgg-cf"} == {
        "conv1_1", "conv1_2", "conv2_1", "conv2_1 dgrad", "conv1_2 dgrad"}
    assert not {name for name, _ in taken} & {"tiny"}
    assert conv_variant(torch.bfloat16, 64, 64, (1, 7, 7), 64) == conv_variant(torch.bfloat16, 64, 64, (3, 3, 5), 128) == "mma"
    assert {s[3] for s, _, _, _, _ in CARD_CASES if s[3] % 8} == MMA_WIDTHS
    assert {(s, cins, cout, pool) for s, cins, cout, k, pool in CARD_CASES
            if conv_variant(torch.bfloat16, s[2], s[3], k, cout) == "wgmma"} == WGMMA_CARD_CASES


def test_conv_wg_plan_by_shape():
    """From the flagship's top level to its 64-channel level: 16-channel chunks,
    the 64-channel N tile, 4 M-tiles a warpgroup (an 8-row tile), four slots;
    the bottleneck's 128-channel tile 2 M-tiles and three slots, its 32-wide
    frame two rows an M-tile; no plan for the 7 × 7 mixer (two slots of its
    weight box overflow the block); one block an SM."""
    plans = {key: _plan(shape, cins, cout, k) for key, shape, cins, cout, k in MODEL_CASES if k[1] * k[2] <= 25}
    for conv in ("encoders.0.conv2", "encoders.2.conv2", "decoders.0.conv1"):
        top = plans["flagship", conv]
        assert (top.kc, top.nb, top.mtw, top.rows, top.stages, top.bw) == (16, 64, 4, 8, 4, 64)
    with pytest.raises(ValueError):
        _plan(*next(case[1:] for case in MODEL_CASES if case[0] == ("flagship", "patch_mixer")))
    bottom = plans["flagship", "bottleneck2"]
    assert (bottom.nb, bottom.mtw, bottom.bw, bottom.rpm, bottom.rows, bottom.stages) == (128, 2, 32, 2, 8, 3)
    assert plans["flagship", "decoders.2.conv1"].chunks == 2  # 16 + 16: one chunk a source
    assert all(p.blocks == CONV_MMA_BLOCKS for (name, _), p in plans.items() if name in ("flagship", "512")
               and p.tiles >= CONV_MMA_BLOCKS)


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


def _replay(plan, x1, x2, kernel, bias, pool):
    """The conv from the kernel's dataflow on the plan's coordinates: the
    channels-last copies and the weights' [tap][cout][k] re-layout; for every
    tile its stages' input and weight boxes with TMA's zero fill; each consumer
    warpgroup's steps (box row a, column shift dw, k16 step), the fragment of its
    64 pixels at that row and shift feeding every M-tile r whose row tap dh = a
    − r · rpm is a tap; the epilogue's pixel mapping (rows and columns past the
    frame, channels past cout clipped), the bias; the pool as the 2 × 2 max of
    the outputs."""
    b, t, _, h, w = x1.shape
    kt, kh, kw, cin, cout = kernel.shape
    copies = []
    for x, cp in ((x1, plan.cp1), (x2, plan.cp2)):
        xt = None
        if x is not None:
            xt = torch.zeros(b, t, h, w, cp, dtype=torch.float64)
            xt[..., :x.shape[2]] = x.permute(0, 1, 3, 4, 2)
        copies.append(xt)
    taps = kt * kh * kw
    wf = kernel.double().reshape(taps, cin, cout)
    wt = torch.zeros(taps, cout, plan.cp1 + plan.cp2, dtype=torch.float64)
    wt[:, :, :plan.c1] = wf[:, :plan.c1].transpose(1, 2)
    wt[:, :, plan.cp1:plan.cp1 + plan.c2] = wf[:, plan.c1:].transpose(1, 2)
    y = torch.full((b, t, cout, h, w), float("nan"), dtype=torch.float64)
    p = torch.arange(CONV_WG_MTILE)
    prow, pcol = p // plan.bw, p % plan.bw
    for i in range(plan.tiles):
        bb, tt, y0, x0, n0 = plan.tile(i)
        acc = torch.zeros(2, plan.mtw, CONV_WG_MTILE, plan.nb, dtype=torch.float64)
        for dt, chunk in plan.stages_of(i):
            src, _, (c0, x, yy, t_in, b_in) = plan.a_coords(i, dt, chunk)
            box = _zero_padded_box(copies[src], (b_in, t_in, yy, x, c0), (1, 1, plan.rx, plan.bx, plan.kc))[0, 0]
            k0, nn0, tap0 = plan.b_coords(i, dt, chunk)
            wb = _zero_padded_box(wt, (tap0, nn0, k0), (kh * kw, plan.nb, plan.kc))
            for wg in range(2):
                first_row = wg * plan.mtw * plan.rpm
                for a in range((plan.mtw - 1) * plan.rpm + kh):
                    for dw in range(kw):
                        for ks in range(plan.kc // 16):
                            frag = box[first_row + prow + a, pcol + dw, 16 * ks:16 * ks + 16]
                            for r in range(plan.mtw):
                                dh = a - r * plan.rpm
                                if 0 <= dh < kh:
                                    acc[wg, r] += frag @ wb[dh * kw + dw, :, 16 * ks:16 * ks + 16].T
        for wg in range(2):
            for r in range(plan.mtw):
                rows = y0 + (wg * plan.mtw + r) * plan.rpm + prow
                cols = x0 + pcol
                n = torch.arange(n0, min(n0 + plan.nb, cout))
                inside = (rows < h) & (cols < w)
                out = acc[wg, r][inside][:, : n.numel()] + bias.double()[n]
                y[bb, tt][n[None, :], rows[inside][:, None], cols[inside][:, None]] = out
    assert not y.isnan().any()  # every output written
    if pool:
        return y, y.reshape(b, t, cout, h // 2, 2, w // 2, 2).amax(dim=(4, 6))
    return y


@pytest.mark.parametrize(
    "shape,cins,cout,k,pool,over",
    [
        ((1, 2, 6, 72), (12,), 12, (3, 3, 3), True, {}),  # a ragged 64-pixel column tile, the pool
        ((2, 3, 8, 16), (20, 12), 24, (3, 3, 3), False, {}),  # two sources, 32-channel chunks, a 16-wide frame
        ((1, 3, 9, 24), (40,), 12, (3, 5, 3), False, {"mtw": 1}),  # the input gradient below, kh = 5
        ((1, 2, 9, 40), (12,), 12, (3, 5, 5), False, {"mtw": 1}),  # a 5 x 5 kernel, 2 rows an M-tile
        ((1, 2, 8, 8), (3,), 8, (1, 3, 3), True, {}),  # 8 rows an M-tile, the pool inside one
    ],
)
def test_replayed_dataflow_is_the_conv(shape, cins, cout, k, pool, over):
    b, t, h, w = shape
    plan = dataclasses.replace(_plan(shape, cins, cout, k, pool), **over)
    gen = torch.Generator().manual_seed(sum(cins) + cout + w)
    small = lambda *s: torch.randint(-2, 3, s, generator=gen).float()  # noqa: E731
    xs = [small(b, t, c, h, w) for c in cins]
    kernel, bias = small(*k, sum(cins), cout), small(cout)
    x2 = xs[1] if len(xs) == 2 else None
    if cins == (40,):  # an input gradient: g through the spatially flipped, IO-swapped kernel
        kernel = small(*k, cout, cins[0]).flip(0, 1, 2).transpose(3, 4).contiguous()
    got = _replay(plan, xs[0], x2, kernel, bias, pool)
    ref = conv3d_cf_plain(xs[0], x2, kernel, bias, pool=pool)
    for g_, r_ in zip(got if pool else [got], ref if pool else [ref]):
        assert torch.equal(g_, r_.double())
