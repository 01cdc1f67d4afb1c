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
as ``attention_bwd_kernel`` walks them. Past 256 tokens the plan is
``"split"`` (#1's LN + RoPE pass, a query-major and a key-major launch, then
the f32 path's LN + RoPE backward), walked by ``helpers/split_geometry.py``;
every S <= 256 keeps the plan it had before. At head dims 64 and 128 with
64 < S <= 256 the plan is ``"tile_wg"`` (one wgmma block a pair, TMA loads,
two consumer warpgroups dealt 64-row tiles), walked by
``helpers/tile_wg_geometry.py``; :func:`mma_bwd_plan` keeps the mma.sync tile there,
and #6 takes it.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from helpers.split_geometry import check_split
from helpers.tile_wg_geometry import TileWgGeometry, check_tile_wg
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.flash_attention import (
    BWD_ROWS_PER_BLOCK,
    BWD_SLAB_MAX_SEQ,
    BWD_SLAB_WARPS,
    BWD_TILE_WARPS,
    BWD_TILE_WG_WARPS,
    BWD_WIDE_TILE_WARPS,
    KERNEL_HEAD_DIMS,
    TILE_MAX_SEQ,
    WGMMA_HEAD_DIMS,
    fused_attention_bwd_plan,
    mma_bwd_plan,
    mma_row_bytes,
    split_bwd_warps,
)
from test_torch_attention_plan import D128_BATCHES, H4_CASES, LATENT_CASES, LONG_CASES, LONG_IDS, MAE_CASES, PINNED_BATCHES

# what the H100 accepts of one block and one grid; the kernel's __launch_bounds__ per variant
# (the tile's at head_dim 128: the wide tile, bwd::wide_tile_bwd, which #6 runs)
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
    if variant == "tile_wg":  # the wgmma tile: its own geometry
        assert D in WGMMA_HEAD_DIMS and BWD_SLAB_MAX_SEQ < S <= TILE_MAX_SEQ
        check_tile_wg(B, S, H, D)
        return
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
    warp a pair, four blocks an SM; spatial S = 256: one wgmma block a pair,
    two consumer warpgroups taking two 64-row tiles on each side, the query
    side's 128-key tiles walked twice, every row array resident (128 KB) beside
    each warpgroup's 40 KB epilogue staging (216 KB in all).
    The mma.sync tile block (16 warps of 16 rows, 32-key chunks walked twice) is
    :func:`mma_bwd_plan`'s there."""
    temporal = Geometry(512, 16, 8)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 1024, 1)
    assert 4 * temporal.smem <= MAX_SMEM
    spatial = check_tile_wg(32, 256, 8, 64)
    assert Geometry(32, 256, 8).plan == ("tile_wg", 1, 12)
    assert (spatial.grid, spatial.tiles, spatial.rounds, spatial.key_tiles) == (256, 4, 2, 2)
    assert len(spatial.query_steps()) == 4 and not spatial.stream and spatial.epi_bytes == 40960
    assert spatial.smem == 1024 + 4 * 32768 + 2 * 40960 + 3 * 256 * 4 + 8 * 2 * 64 * 4 + 6 * 8 == 221232
    assert mma_bwd_plan(32, 256, 8, 64) == ("tile", 1, 16)


@pytest.mark.parametrize("label,name,B,S,H,D", PRESET_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRESET_CASES])
def test_attention_bwd_plan_at_preset_shapes(label, name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("B,S,H,D", RAGGED_HEAD_DIM_CASES)
def test_attention_bwd_plan_at_ragged_shapes_other_head_dims(B, S, H, D):
    _check_plan(B, S, H, D)


def test_attention_bwd_plan_is_the_same_at_every_head_dim():
    """The mma.sync plan's variant and pairs do not depend on head_dim, nor its
    warps but at head_dim 128's tile blocks (at most ``BWD_WIDE_TILE_WARPS``);
    #3 takes it but at head dims 64 and 128 past 64 tokens, where it takes the
    wgmma tile; the shared memory grows with the head dim within each kernel
    and fits at each; a multiple of 128 past 128 takes the wide variant; other
    head dims (the wrappers pad them first) are refused."""
    for B, S, H in RAGGED_CASES:
        plans = {mma_bwd_plan(B, S, H, D) for D in KERNEL_HEAD_DIMS if D != 128}
        assert len(plans) == 1
        (variant, unit, warps), = plans
        wide = mma_bwd_plan(B, S, H, 128)
        assert wide == (variant, unit, warps if variant == "slab" else min(warps, BWD_WIDE_TILE_WARPS))
        for D in KERNEL_HEAD_DIMS:
            wg = variant == "tile" and D in WGMMA_HEAD_DIMS
            want = ("tile_wg", 1, BWD_TILE_WG_WARPS) if wg else mma_bwd_plan(B, S, H, D)
            assert fused_attention_bwd_plan(B, S, H, D) == want
        smem = [Geometry(B, S, H, D).smem for D in KERNEL_HEAD_DIMS if Geometry(B, S, H, D).plan[0] != "tile_wg"]
        assert smem == sorted(smem) and smem[-1] <= MAX_SMEM
        smem = [TileWgGeometry(B, S, H, D).smem for D in WGMMA_HEAD_DIMS if variant == "tile"]
        assert smem == sorted(smem) and all(m <= MAX_SMEM for m in smem)
    assert fused_attention_bwd_plan(4, 16, 8, 256) == mma_bwd_plan(4, 300, 8, 512) == ("wide", 1, 4)
    for bad in (8, 48, 96, 130, 192):
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
    with the warps' staging rows); spatial S = 256, a wgmma tile block a pair:
    q~ and k~ resident (128 KB), each consumer warpgroup's own dO (query side)
    or v (key side) tile in a 16 KB buffer, the walked v, then dO, through a
    ring of three 16 KB stages, 64-key tiles: 220 KB, where four row arrays
    would take 256 KB. The mma.sync wide tile block (8 warps, q~ | k~ | v rows in 220
    KB, where four arrays of 272-byte rows would take 278 KB) is
    :func:`mma_bwd_plan`'s there."""
    temporal = Geometry(256, 16, 4, 128)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 256, 1)
    assert temporal.smem == 4 * (4 * 16 * 272 + 2 * 16 * 24 * 2 + 8) + 4 * (256 + 8 * 136) * 4
    spatial = check_tile_wg(16, 256, 4, 128)
    assert Geometry(16, 256, 4, 128).plan == ("tile_wg", 1, 12)
    assert (spatial.grid, spatial.stream, spatial.key_tile, spatial.boxes) == (64, True, 64, 2)
    assert spatial.smem == 1024 + 2 * 65536 + 2 * 16384 + 3 * 16384 + 3 * 256 * 4 + 8 * 256 * 4 + 11 * 8 == 225368
    assert 4 * 256 * 256 > MAX_SMEM and 4 * 256 * 272 > MAX_SMEM
    assert mma_bwd_plan(16, 256, 4, 128) == ("tile", 1, 8)


@pytest.mark.parametrize("name,B,S,H", LATENT_CASES, ids=[c[0] for c in LATENT_CASES])
def test_attention_bwd_plan_at_latent_cli_shapes(name, B, S, H):
    _check_plan(B, S, H)


@pytest.mark.parametrize("name,B,S,H", MAE_CASES, ids=[c[0] for c in MAE_CASES])
def test_attention_bwd_plan_at_mae_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_attention_bwd_plan_at_mae_shapes_is_as_designed():
    """The MAE at 224²: spatial S = 196 takes a wgmma tile block a pair, four
    64-row tiles (the last 4 real rows, the rest zeros from TMA) in two rounds
    of the two consumer warpgroups, two 128-key tiles a walk (keys 128-255, of
    which 196-255 are padding); temporal S = 16 the flagship's slab of 4 pairs
    a block. The mma.sync tile block (13 warps of 16 rows, 32-key chunks with a last
    one of 16) is :func:`mma_bwd_plan`'s there."""
    spatial = check_tile_wg(64, 196, 8, 64)
    assert Geometry(64, 196, 8).plan == ("tile_wg", 1, 12)
    assert (spatial.grid, spatial.tiles, spatial.key_tiles, spatial.resident_rows) == (512, 4, 2, 256)
    assert spatial.query_steps()[-1] == (3, 128) and spatial.smem <= MAX_SMEM
    assert mma_bwd_plan(64, 196, 8, 64) == ("tile", 1, 13)
    temporal = Geometry(784, 16, 8)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 1568, 1)



def _bwd_plan_before_split(B, S, H, D):
    """fused_attention_bwd_plan as it stood before the split variant, for S <= 256,
    written out with its constants (slab to 64 keys, 4 slab warps, 16 tile warps,
    8 at head_dim 128)."""
    tiles = -(-S // 16)
    if S <= 64:
        unit = max(1, min(4 // tiles, B * H))
        return "slab", unit, min(4, unit * tiles)
    return "tile", 1, min(8 if D == 128 else 16, tiles)


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_attention_bwd_plan_keeps_every_short_sequence(D):
    """Every S <= 256 keeps its variant, pairs and warps a block in the mma.sync
    plan (which #6 takes, and #3 at head dims 16 and 32 and up to 64 tokens);
    #3 at head dims 64 and 128 past 64 tokens takes the wgmma tile; 257 splits."""
    for B, H in PINNED_BATCHES:
        for S in range(1, TILE_MAX_SEQ + 1):
            assert mma_bwd_plan(B, S, H, D) == _bwd_plan_before_split(B, S, H, D), (B, S, H)
            wg = D in WGMMA_HEAD_DIMS and S > BWD_SLAB_MAX_SEQ
            want = ("tile_wg", 1, BWD_TILE_WG_WARPS) if wg else _bwd_plan_before_split(B, S, H, D)
            assert fused_attention_bwd_plan(B, S, H, D) == want, (B, S, H)
        assert fused_attention_bwd_plan(B, TILE_MAX_SEQ + 1, H, D) == ("split", 1, split_bwd_warps(D))


@pytest.mark.parametrize("label,B,S,H,D", LONG_CASES, ids=LONG_IDS)
def test_attention_bwd_plan_splits_long_sequences(label, B, S, H, D):
    """#1's LN + RoPE pass, the query side (two walks over k~ and v), the key side
    (one over q~, dO and the statistics): wgmma launches of 12 warps at head dims
    64 and 128, mma.sync ones of 4 at 16 and 32; the LN + RoPE backward's partials
    a row each BWD_ROWS_PER_BLOCK (sequence, head, position) rows, as the f32 path's."""
    assert fused_attention_bwd_plan(B, S, H, D) == ("split", 1, split_bwd_warps(D))
    check_split("fused_bwd", B, S, H, D)
    assert BWD_ROWS_PER_BLOCK == 64


def test_attention_bwd_split_at_512_is_as_designed():
    """The flagship's 512² spatial call (b2: 32 sequences x 8 heads of 64, S = 1024)
    and its width in 4 heads of 128: wgmma launches of 128 own rows a block (8
    blocks a pair), three warpgroups, rings of 3 stages (128 keys a query-side
    stage at head dim 64, 64 at 128; 64 queries a key-side stage), one block an SM;
    head dims 16 and 32 keep the mma.sync launches of 64 rows."""
    flagship = check_split("fused_bwd", 32, 1024, 8, 64)
    assert (flagship.grid, flagship.threads, flagship.boxes) == (2048, 384, 1)
    assert (flagship.tiles("query"), flagship.tiles("key")) == (8, 16)  # 128 keys, 64 queries a stage
    assert flagship.smem == {"query_side": 132152, "key_side": 85304}
    h4 = check_split("fused_bwd", 16, 1024, 4, 128)
    assert (h4.grid, h4.boxes, h4.stage_bytes("query"), h4.stage_bytes("key")) == (512, 2, 32768, 32768)
    assert h4.smem == {"query_side": 164920, "key_side": 167224}
    for D in (16, 32):
        assert check_split("fused_bwd", 16, 576, 8, D).grid == 16 * 8 * 9
        assert fused_attention_bwd_plan(16, 576, 8, D) == ("split", 1, 4)



# the lengths the plan test names (one past the slab, 2 x 64, the MAE's 196, one short of
# and at the tile's edge) at every head dim the kernels take
TILE_EDGE_CASES = [(S, D) for S in (65, 128, 196, 255, 256) for D in KERNEL_HEAD_DIMS]


@pytest.mark.parametrize("S,D", TILE_EDGE_CASES)
def test_attention_bwd_plan_at_the_tile_lengths(S, D):
    """Which kernel takes each: the wgmma tile (12 warps, one block a pair) at head
    dims 64 and 128, the mma.sync tile (a warp each 16 rows) at 16 and 32; shared memory
    within the H100's 227 KB at each."""
    for B, H in ((1, 8), (32, 8), (16, 4)):
        plan = fused_attention_bwd_plan(B, S, H, D)
        if D in WGMMA_HEAD_DIMS:
            assert plan == ("tile_wg", 1, 12)
            assert check_tile_wg(B, S, H, D).smem <= MAX_SMEM
        else:
            assert plan == ("tile", 1, -(-S // 16))
            assert Geometry(B, S, H, D).smem <= MAX_SMEM
        _check_plan(B, S, H, D)


@pytest.mark.parametrize("D", WGMMA_HEAD_DIMS)
def test_attention_bwd_tile_wg_at_every_length(D):
    """Every S in 65..256 at both head dims and batches of 1, 3 and 5 sequences:
    the launch, its boxes, rows, walks and (D = 128) ring hold."""
    for S in range(BWD_SLAB_MAX_SEQ + 1, TILE_MAX_SEQ + 1):
        for B, H in ((1, 8), (3, 4), (5, 2)):
            check_tile_wg(B, S, H, D)


def test_attention_bwd_tile_wg_is_as_designed():
    """Shared memory a block by length: at head dim 64 every row array resident in
    S rounded up to 128 rows (so 129-192 keeps a zeroed fourth tile) beside the two
    epilogue stagings, at 128 q~ and k~ in S rounded up to 64 beside the own
    buffers and the ring; the tiles dealt in rounds of two, one warpgroup idle in
    the last round of an odd count."""
    sizes = {S: TileWgGeometry(1, S, 8, 64).smem for S in (65, 128, 129, 192, 193, 256)}
    assert sizes[65] == sizes[128] == 1024 + 4 * 16384 + 2 * 40960 + 3 * 128 * 4 + 4096 + 48
    assert sizes[129] == sizes[192] == sizes[193] == sizes[256] == 221232
    geo = check_tile_wg(2, 150, 4, 128)
    assert (geo.tiles, geo.rounds, geo.resident_rows, len(geo.ring_steps()) // 2) == (3, 2, 192, 2 * (2 * 3 + 3))
    assert [(r, w) for r, w, _ in geo.dealt("query")] == [(0, 0), (0, 1), (1, 0)]
    assert TileWgGeometry(1, 65, 4, 128).smem == 1024 + 2 * 32768 + 2 * 16384 + 3 * 16384 + 3 * 128 * 4 + 8192 + 88
