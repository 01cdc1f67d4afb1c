"""Launch geometry of the bf16 fused attention backward kernel
(``ops/flash_attention.py:fused_attention_bwd_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at), of the ``--tiny`` and ``--small``
presets and at the same shapes with head_dim 32, and at ragged shapes at every
head dim the kernel takes: on each side,
query and key, every (sequence, head, row) is computed by exactly one warp of
one block, which staged the pair; each warp's chunks walk every key (query
side) or query (key side) j < S and no row past the staged ones, and a query
chunk's keys lie in one word of key bits; shared memory, warps and grid stay
within what the kernel and the H100 accept. :class:`Geometry` derives the
rest of the launch from the plan as ``launch_attention_bwd_mma`` in
``csrc/fused_attention_bwd_mma.cuh`` does, and deals out the tiles and chunks
as ``attention_bwd_kernel`` walks them.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.flash_attention import (
    BWD_SLAB_MAX_SEQ,
    BWD_SLAB_WARPS,
    BWD_TILE_WARPS,
    BWD_WIDE_TILE_WARPS,
    KERNEL_HEAD_DIMS,
    fused_attention_bwd_plan,
    mma_row_bytes,
)
from test_torch_attention_plan import D128_BATCHES, H4_CASES, LATENT_CASES, MAE_CASES

# what the H100 accepts of one block and one grid; the kernel's __launch_bounds__ per variant
# (the tile's at head_dim 128: attention_bwd_wide_kernel's)
MAX_SMEM, MAX_GRID_X = 232448, 2**31 - 1
LAUNCH_BOUND_WARPS = {"slab": 4, "tile": 16, "wide tile": 8}

MODEL_CASES = sorted({
    (model, name, B, S, cfg.num_heads)
    for model, cfg in (("flagship", ModelConfig()), ("tapdot", chip_smoke.tapdot_model_config()))
    for name, B, S, _, _, _ in chip_smoke.attention_cases(cfg)
})
# the trainer's step (cli/train.py's b2 x 32 frames): the encoder's calls on the clips,
# the decoder's on their 2 rollouts
TRAINER_CASES = [(name, B, S, ModelConfig().num_heads)
                 for name, B, S, _, _, _ in chip_smoke.trainer_attention_cases(ModelConfig())]
# B = 1, and B = 3 and 5, which no pairs-per-block count of these shapes divides
RAGGED_CASES = [
    (B, S, H)
    for S in (1, 15, 16, 17, 37, 64, 65, 255, 256)
    for B, H in ((1, 8), (3, 8), (5, 2))
]
# the presets' calls at head_dim 16 and the same shapes at 32 (chip_smoke.head_dim_configs)
PRESET_CASES = sorted({
    (label, name, B, S, cfg.num_heads, cfg.head_dim)
    for label, cfg, clips, frames in chip_smoke.head_dim_configs()
    for name, B, S, _, _, _ in chip_smoke.preset_attention_cases(label, cfg, clips, frames)
})
RAGGED_HEAD_DIM_CASES = [(B, S, H, D) for B, S, H in RAGGED_CASES for D in KERNEL_HEAD_DIMS if D != 64]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of the kernel: the plan and what the C entry point derives from it."""

    batch: int
    seq: int
    heads: int
    head_dim: int = 64

    @property
    def plan(self) -> tuple[str, int, int]:
        return fused_attention_bwd_plan(self.batch, self.seq, self.heads, self.head_dim)

    @property
    def rows16(self) -> int:
        return -(-self.seq // 16) * 16

    @property
    def tiles(self) -> int:
        return self.rows16 // 16

    @property
    def pairs(self) -> int:
        return self.batch * self.heads

    @property
    def grid(self) -> int:
        variant, unit, _ = self.plan
        return -(-self.pairs // unit) if variant == "slab" else self.pairs

    @property
    def kt(self) -> int:
        """16-key steps of a query-side chunk: the whole row in a slab block
        (``chunk_steps``), ``TILE_KT`` in a tile block."""
        if self.plan[0] == "tile":
            return 2
        return 1 if self.rows16 <= 16 else 2 if self.rows16 <= 32 else 4

    @property
    def variant(self) -> str:
        """The kernel the plan launches: the tile's at head_dim 128 is the wide tile."""
        variant = self.plan[0]
        return "wide tile" if variant == "tile" and self.head_dim == 128 else variant

    @property
    def smem(self) -> int:
        """``bwd_smem_bytes``: rows, P and dS (slab) or the row statistics (tile),
        key bits, and each warp's (2, D) f32 dscale partials and 8 f32 staging
        rows of D + 8; the wide tile's (``wide_tile_smem_bytes``): three D-row
        arrays, the row statistics, key bits and each warp's (2, D) partials."""
        variant, unit, warps = self.plan
        D, row = self.head_dim, mma_row_bytes(self.head_dim)
        words = 8 * -(-self.seq // 64)
        if self.variant == "wide tile":
            return 3 * self.rows16 * row + 3 * self.rows16 * 4 + words + warps * 2 * D * 4
        red = warps * (2 * D + 8 * (D + 8)) * 4
        if variant == "slab":
            pair = 4 * self.rows16 * row + 2 * self.rows16 * (self.rows16 + 8) * 2
            return unit * (pair + words) + red
        return 4 * self.rows16 * row + 3 * self.rows16 * 4 + words + red

    def block_pairs(self, block: int) -> list[int]:
        """The (sequence, head) pairs, as b·H + h, whose rows the block stages."""
        _, unit, _ = self.plan
        return [p for p in range(block * unit, (block + 1) * unit) if p < self.pairs]

    def tiles_dealt(self):
        """(block, warp, pair, first row) of every 16-row tile a warp takes, on
        either side: the query side and the key side deal the same items."""
        _, unit, warps = self.plan
        for block in range(self.grid):
            for item in range(unit * self.tiles):
                pair = block * unit + item // self.tiles
                if pair < self.pairs:
                    yield block, item % warps, pair, 16 * (item % self.tiles)

    def query_chunks(self) -> list[tuple[int, int]]:
        """(first key, 16-key steps) of every chunk a query tile walks."""
        ch = 16 * self.kt
        return [(c0, min(self.kt, -(-(self.seq - c0) // 16))) for c0 in range(0, self.seq, ch)]

    def key_steps(self) -> list[int]:
        """First query of every 16-query step a key tile walks."""
        return list(range(0, self.seq, 16))


def _check_plan(B, S, H, D=64):
    geo = Geometry(B, S, H, D)
    variant, unit, warps = geo.plan
    assert variant in ("slab", "tile") and unit >= 1
    assert variant == "tile" or S <= BWD_SLAB_MAX_SEQ
    assert variant == "slab" or unit == 1
    assert 1 <= warps <= min(LAUNCH_BOUND_WARPS[geo.variant],
                             BWD_SLAB_WARPS if variant == "slab" else BWD_TILE_WARPS)
    assert geo.smem <= MAX_SMEM
    assert 1 <= geo.grid <= MAX_GRID_X

    owners = np.zeros((B * H, S), dtype=np.int32)
    for block, warp, pair, row0 in geo.tiles_dealt():
        assert 0 <= block < geo.grid and 0 <= warp < warps
        assert row0 % 16 == 0 and 0 <= row0 < S
        assert pair in geo.block_pairs(block)  # the block staged the pair's rows
        owners[pair, row0 : row0 + 16] += 1
    assert (owners == 1).all()

    # query side: every key j < S once, no staged row past rows16, each chunk in one word of key bits
    seen = np.zeros(S, dtype=np.int32)
    for c0, steps in geo.query_chunks():
        assert 1 <= steps <= geo.kt and c0 % 16 == 0
        assert c0 + 16 * steps <= geo.rows16
        assert c0 % 64 + 16 * geo.kt <= 64
        seen[c0 : c0 + 16 * steps] += 1
    assert (seen == 1).all()
    if variant == "slab":  # one chunk, so P and dS of every key column reach shared memory
        assert len(geo.query_chunks()) == 1 and 16 * geo.query_chunks()[0][1] == geo.rows16

    # key side: every query i < S once, no staged row past rows16
    seen = np.zeros(S, dtype=np.int32)
    for q0 in geo.key_steps():
        assert q0 + 16 <= geo.rows16
        seen[q0 : q0 + 16] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("model,name,B,S,H", MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in MODEL_CASES])
def test_attention_bwd_plan_at_model_shapes(model, name, B, S, H):
    _check_plan(B, S, H)


def test_attention_bwd_plan_covers_every_model_call():
    # temporal and spatial at b2 and b1, for each model
    assert len(MODEL_CASES) == 8


@pytest.mark.parametrize("name,B,S,H", TRAINER_CASES, ids=[c[0] for c in TRAINER_CASES])
def test_attention_bwd_plan_at_trainer_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_attention_bwd_plan_covers_every_trainer_call():
    assert [(B, S) for _, B, S, _ in TRAINER_CASES] == [(512, 32), (64, 256), (1024, 32), (128, 256)]


@pytest.mark.parametrize("B,S,H", RAGGED_CASES)
def test_attention_bwd_plan_at_ragged_shapes(B, S, H):
    _check_plan(B, S, H)


def test_attention_bwd_plan_at_the_models_shapes_is_as_designed():
    """Temporal S = 16, 8 heads: a slab block of half a sequence's pairs, a
    warp a pair, four blocks an SM; spatial S = 256: one block a pair, 16
    warps of 16 rows on each side, 32-key chunks walked twice."""
    temporal = Geometry(512, 16, 8)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 1024, 1)
    assert 4 * temporal.smem <= MAX_SMEM
    spatial = Geometry(32, 256, 8)
    assert (spatial.plan, spatial.grid, spatial.kt) == (("tile", 1, 16), 256, 2)
    assert len(spatial.query_chunks()) == 8 and len(spatial.key_steps()) == 16


@pytest.mark.parametrize("label,name,B,S,H,D", PRESET_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRESET_CASES])
def test_attention_bwd_plan_at_preset_shapes(label, name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("B,S,H,D", RAGGED_HEAD_DIM_CASES)
def test_attention_bwd_plan_at_ragged_shapes_other_head_dims(B, S, H, D):
    _check_plan(B, S, H, D)


def test_attention_bwd_plan_is_the_same_at_every_head_dim():
    """The variant and pairs do not depend on head_dim, nor the warps but at
    head_dim 128's tile blocks (at most ``BWD_WIDE_TILE_WARPS``); the shared
    memory grows with it and fits at each; other head dims are refused."""
    for B, S, H in RAGGED_CASES:
        plans = {fused_attention_bwd_plan(B, S, H, D) for D in KERNEL_HEAD_DIMS if D != 128}
        assert len(plans) == 1
        (variant, unit, warps), = plans
        wide = fused_attention_bwd_plan(B, S, H, 128)
        assert wide == (variant, unit, warps if variant == "slab" else min(warps, BWD_WIDE_TILE_WARPS))
        smem = [Geometry(B, S, H, D).smem for D in KERNEL_HEAD_DIMS]
        assert smem == sorted(smem) and smem[-1] <= MAX_SMEM
    for bad in (8, 48, 96, 256):
        with pytest.raises(ValueError, match="head_dim"):
            fused_attention_bwd_plan(4, 16, 8, bad)


@pytest.mark.parametrize("name,B,S,H,D", H4_CASES, ids=[c[0] for c in H4_CASES])
def test_attention_bwd_plan_at_h4_shapes(name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("S", range(1, 257))
def test_attention_bwd_plan_at_head_dim_128(S):
    for B, H in D128_BATCHES:
        _check_plan(B, S, H, 128)


def test_attention_bwd_plan_at_head_dim_128_is_as_designed():
    """ModelConfig(num_heads=4): temporal S = 16, slab blocks of 4 pairs (76 KB
    with the warps' staging rows); spatial S = 256, a wide tile block a pair: 8
    warps taking two 16-row tiles on each side, q~ | k~ | v rows (dO's after
    the query side) in 220 KB, where four arrays would take 278 KB."""
    temporal = Geometry(256, 16, 4, 128)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 256, 1)
    assert temporal.smem == 4 * (4 * 16 * 272 + 2 * 16 * 24 * 2 + 8) + 4 * (256 + 8 * 136) * 4
    spatial = Geometry(16, 256, 4, 128)
    assert (spatial.plan, spatial.variant, spatial.grid, spatial.kt) == (("tile", 1, 8), "wide tile", 64, 2)
    assert spatial.smem == 3 * 256 * 272 + 3 * 256 * 4 + 32 + 8 * 256 * 4 == 220192
    assert 4 * 256 * 272 > MAX_SMEM
    assert {warp for _, warp, _, _ in spatial.tiles_dealt()} == set(range(8))


@pytest.mark.parametrize("name,B,S,H", LATENT_CASES, ids=[c[0] for c in LATENT_CASES])
def test_attention_bwd_plan_at_latent_cli_shapes(name, B, S, H):
    _check_plan(B, S, H)


@pytest.mark.parametrize("name,B,S,H", MAE_CASES, ids=[c[0] for c in MAE_CASES])
def test_attention_bwd_plan_at_mae_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_attention_bwd_plan_at_mae_shapes_is_as_designed():
    """The MAE at 224²: spatial S = 196 takes a tile block a pair with 13 warps of
    16 rows on each side (the last tile 4 real rows), 32-key query chunks with a
    last one of 16 (keys 192-207, of which 196-207 are padding); temporal S = 16
    the flagship's slab of 4 pairs a block."""
    spatial = Geometry(64, 196, 8)
    assert (spatial.plan, spatial.grid, spatial.kt) == (("tile", 1, 13), 512, 2)
    assert spatial.query_chunks()[-1] == (192, 1) and len(spatial.query_chunks()) == 7
    assert len(spatial.key_steps()) == 13 and spatial.key_steps()[-1] == 192
    assert spatial.smem <= MAX_SMEM
    temporal = Geometry(784, 16, 8)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 1568, 1)
