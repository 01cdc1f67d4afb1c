"""Launch geometry of the bf16 fused attention kernel (``ops/flash_attention.py:fused_attention_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at), of the ``--tiny`` and ``--small``
presets (head_dim 16) and at the same shapes with head_dim 32, of a
``ModelConfig(num_heads=4)`` train step (head_dim 128) and of the latent
CLIs (b1 × 64 frames), at every S at head_dim 128, and at ragged shapes at
every head dim the kernel takes (all of them S <= 256): every (sequence,
head, query row) is computed by exactly one warp, that warp's block stages the
(sequence, head) pair's keys and its chunks walk every key j < S and no row
past the staged ones, and shared memory, warps and grid stay within CUDA's
limits. :class:`Geometry` derives the rest of the launch from the plan as
``launch_attention_mma`` in ``csrc/fused_attention_mma.cuh`` does, and deals
out the query tiles and key chunks as ``attention_mma_kernel`` walks them.
Past 256 tokens the plan is ``"split"``, whose launches
``helpers/split_geometry.py`` walks at the long sequences (the wgmma forward
at head dims 64 and 128, the mma.sync one at 16 and 32); every S <= 256
keeps the plan it had before the split variant.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from helpers.split_geometry import LONG_BATCHES, LONG_SEQS, SplitGeometry, check_split, loads, tma_operands
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MMA_SLAB_MAX_SEQ,
    MMA_SLAB_WARPS,
    TILE_MAX_SEQ,
    fused_attention_plan,
    mma_max_warps,
    mma_row_bytes,
    split_fwd_grid,
    split_fwd_warps,
)

# what the H100 accepts of one block and one grid (the kernel's __launch_bounds__ is mma_max_warps)
MAX_SMEM, MAX_GRID_X = 232448, 2**31 - 1

MODEL_CASES = sorted({
    (model, name, B, S, cfg.num_heads)
    for model, cfg in (("flagship", ModelConfig()), ("tapdot", chip_smoke.tapdot_model_config()))
    for name, B, S, _, _, _ in chip_smoke.attention_cases(cfg)
})
# the trainer's step (cli/train.py's b2 x 32 frames): the encoder's calls on the clips,
# the decoder's on their 2 rollouts
TRAINER_CASES = [(name, B, S, ModelConfig().num_heads)
                 for name, B, S, _, _, _ in chip_smoke.trainer_attention_cases(ModelConfig())]
# B = 1, and B = 3 and 5, which no sequences-per-block count of these shapes divides
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
# the ragged shapes at the head dims other than the flagship's
RAGGED_HEAD_DIM_CASES = [(B, S, H, D) for B, S, H in RAGGED_CASES for D in KERNEL_HEAD_DIMS if D != 64]
# head_dim 128: the calls of a ModelConfig(num_heads=4) train step (chip_smoke.h4_config), and
# every S the kernels take at the batches and heads below
H4 = chip_smoke.h4_config()
H4_CASES = [(name, B, S, H4.num_heads, H4.head_dim)
            for name, B, S, _, _, _ in chip_smoke.preset_attention_cases("h4", H4, chip_smoke.H4_CLIPS,
                                                                        chip_smoke.H4_FRAMES)]
D128_BATCHES = [(1, 4), (3, 4), (5, 1), (2, 6)]  # (B, H)
# the VideoMAE's calls at 224² (chip_smoke.mae_attention_cases): spatial S = 196, temporal S = 16
MAE_CASES = [(name, B, S, chip_smoke.mae_config().num_heads)
             for name, B, S, _, _, _ in chip_smoke.mae_attention_cases(chip_smoke.mae_config())]
# the latent CLIs' calls at their defaults (b1 x 64 frames, the flagship's head_dim 64)
LATENT_CASES = [(name, B, S, ModelConfig().num_heads)
                for name, B, S, _, _, _ in chip_smoke.latent_attention_cases(ModelConfig())]
# head dims the kernels pad, at their instantiation: the calls of ModelConfig(qkv_features=768)'s
# serving pass and train step (8 heads of 96, at 128) and of the same model at 384 (8 of 48, at 64)
D96 = chip_smoke.d96_config()
PADDED_MODEL_CASES = [(qkv, name, B, S, cfg.num_heads, cfg.head_dim)
                      for qkv, cfg in ((768, D96), (384, ModelConfig(qkv_features=384)))
                      for name, B, S, _, _, _ in chip_smoke.attention_cases(cfg)]
# chip_smoke's padded kernel checks: D = 8, 24, 48, 96 up to S = 1024
PADDED_CHECK_CASES = [(chip_smoke.PADDED_TOKENS // S, S, chip_smoke.PADDED_HEADS, D)
                      for D, seqs in chip_smoke.PADDED_CASES for S in seqs]
# sequences past TILE_MAX_SEQ at every head dim, at the flagship's, h4's and the MAE's batches
LONG_CASES = [(label, B, S, H, D) for label, B, H in LONG_BATCHES for S in LONG_SEQS for D in KERNEL_HEAD_DIMS]
LONG_IDS = [f"{c[0]}-S{c[2]}-D{c[4]}" for c in LONG_CASES]
# (B, H) at which every S <= 256 is pinned to the plan it had before the split variant
PINNED_BATCHES = [(1, 8), (3, 8), (5, 2), (32, 8), (512, 8), (16, 4), (64, 8), (784, 8), (2, 6)]


def _plan_before_split(B, S, H, D):
    """fused_attention_plan as it stood before the split variant, for S <= 256,
    written out with its constants (8 slab warps, 64 keys, 100 KB)."""
    rows16 = -(-S // 16) * 16
    seq_smem = 3 * H * rows16 * 2 * (D + 8) + 8 * -(-S // 64)
    if S <= 64 and seq_smem <= 100 * 1024:
        return "slab", max(1, min(8 // (H * rows16 // 16), 100 * 1024 // seq_smem, B))
    return "tile", 1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of the kernel: the plan and what the C entry point derives from it."""

    batch: int
    seq: int
    heads: int
    head_dim: int = 64

    @property
    def plan(self) -> tuple[str, int]:
        return fused_attention_plan(self.batch, self.seq, self.heads, self.head_dim)

    @property
    def rows16(self) -> int:
        return -(-self.seq // 16) * 16

    @property
    def kt(self) -> int:
        """16-key steps a chunk (``chunk_steps``)."""
        return 1 if self.rows16 <= 16 else 2 if self.rows16 <= 32 else 4

    @property
    def normalize_first(self) -> bool:
        return self.seq < 128 and self.seq * self.heads % 128 == 0

    @property
    def grid(self) -> int:
        variant, unit = self.plan
        return -(-self.batch // unit) if variant == "slab" else self.batch * self.heads

    @property
    def warps(self) -> int:
        variant, unit = self.plan
        tiles = self.rows16 // 16
        return min(MMA_SLAB_WARPS, unit * self.heads * tiles) if variant == "slab" else min(
            tiles, mma_max_warps(self.head_dim))

    @property
    def smem(self) -> int:
        """``smem_bytes``: the q, k, v rows and the key bits of a block."""
        variant, unit = self.plan
        words = 8 * -(-self.seq // 64)
        row = mma_row_bytes(self.head_dim)
        if variant == "slab":
            return unit * (3 * self.heads * self.rows16 * row + words)
        return 3 * self.rows16 * row + words

    def block_pairs(self, block: int) -> list[tuple[int, int]]:
        """The (sequence, head) pairs whose keys (all S of them) the block stages."""
        variant, unit = self.plan
        if variant == "slab":
            seqs = range(block * unit, min(self.batch, (block + 1) * unit))
            return [(b, h) for b in seqs for h in range(self.heads)]
        return [(block // self.heads, block % self.heads)]

    def row_tiles(self):
        """(block, warp, sequence, head, first query row) of every 16-row query
        tile a warp computes, as the kernel deals them out."""
        variant, unit = self.plan
        tiles = self.rows16 // 16
        for block in range(self.grid):
            if variant == "slab":
                for item in range(unit * self.heads * tiles):
                    b = block * unit + item // (tiles * self.heads)
                    if b < self.batch:
                        yield block, item % self.warps, b, item // tiles % self.heads, 16 * (item % tiles)
            else:  # each warp takes the tiles in turn
                for warp in range(self.warps):
                    for mt in range(warp, tiles, self.warps):
                        if 16 * mt < self.seq:
                            yield block, warp, block // self.heads, block % self.heads, 16 * mt

    def key_steps(self) -> list[tuple[int, int]]:
        """(first key, 16-key steps) of every chunk a warp walks."""
        ch = 16 * self.kt
        return [(c0, min(self.kt, -(-(self.seq - c0) // 16))) for c0 in range(0, self.seq, ch)]


def _check_plan(B, S, H, D=64):
    geo = Geometry(B, S, H, D)
    variant, unit = geo.plan
    assert variant in ("slab", "tile") and unit >= 1
    assert variant == "tile" or S <= MMA_SLAB_MAX_SEQ
    assert variant == "slab" or unit == 1
    assert geo.smem <= MAX_SMEM
    assert 1 <= geo.grid <= MAX_GRID_X
    assert 1 <= geo.warps <= mma_max_warps(D)

    owners = np.zeros((B, H, S), dtype=np.int32)
    for block, warp, b, h, row0 in geo.row_tiles():
        assert 0 <= block < geo.grid and 0 <= warp < geo.warps
        assert row0 % 16 == 0 and 0 <= row0 < S
        # the block that computes the tile staged the pair's q, k and v
        assert (b, h) in geo.block_pairs(block)
        owners[b, h, row0 : row0 + 16] += 1
    assert (owners == 1).all()

    # every key j < S, no key twice, no staged row past rows16
    seen = np.zeros(S, dtype=np.int32)
    for c0, steps in geo.key_steps():
        assert 1 <= steps <= geo.kt and c0 % 16 == 0
        assert c0 + 16 * steps <= geo.rows16
        seen[c0 : c0 + 16 * steps] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("model,name,B,S,H", MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in MODEL_CASES])
def test_attention_plan_at_model_shapes(model, name, B, S, H):
    _check_plan(B, S, H)


def test_attention_plan_covers_every_model_call():
    # temporal and spatial at b2 and b1, for each model
    assert len(MODEL_CASES) == 8


@pytest.mark.parametrize("name,B,S,H", TRAINER_CASES, ids=[c[0] for c in TRAINER_CASES])
def test_attention_plan_at_trainer_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_attention_plan_covers_every_trainer_call():
    assert [(B, S) for _, B, S, _ in TRAINER_CASES] == [(512, 32), (64, 256), (1024, 32), (128, 256)]


@pytest.mark.parametrize("B,S,H", RAGGED_CASES)
def test_attention_plan_at_ragged_shapes(B, S, H):
    _check_plan(B, S, H)


def test_attention_plan_at_the_models_shapes_is_as_designed():
    """Temporal S = 16, 8 heads: one sequence a slab block, a warp a head, P
    normalised before its rounding (JAX's packed path); spatial S = 256: one
    block a (sequence, head) pair, 16 warps of 16 query rows, P rounded
    unnormalised."""
    temporal = Geometry(512, 16, 8)
    assert (temporal.plan, temporal.warps, temporal.grid) == (("slab", 1), 8, 512)
    assert temporal.normalize_first and temporal.kt == 1
    spatial = Geometry(32, 256, 8)
    assert (spatial.plan, spatial.warps, spatial.grid) == (("tile", 1), 16, 256)
    assert not spatial.normalize_first and spatial.kt == 4


@pytest.mark.parametrize("label,name,B,S,H,D", PRESET_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRESET_CASES])
def test_attention_plan_at_preset_shapes(label, name, B, S, H, D):
    _check_plan(B, S, H, D)


def test_attention_plan_covers_the_presets_at_16_and_32():
    assert {D for *_, D in PRESET_CASES} == {16, 32}
    assert {(label.split("-")[0], S) for label, _, _, S, _, _ in PRESET_CASES} == {
        ("tiny", 8), ("tiny", 16), ("small", 32), ("small", 256)}


@pytest.mark.parametrize("B,S,H,D", RAGGED_HEAD_DIM_CASES)
def test_attention_plan_at_ragged_shapes_other_head_dims(B, S, H, D):
    _check_plan(B, S, H, D)


def test_attention_plan_follows_the_head_dim():
    """A head row takes head_dim + 8 bf16: at S = 64 with 8 heads one sequence's
    rows (3 x 8 x 64 rows) are over a slab block's 100 KB at head_dim 64 (a tile
    block a pair) and fit at 16 (a slab block a sequence); a multiple of 128 past
    128 takes the wide variant; heads the kernels do not run as they are (the
    wrappers pad them first) are refused."""
    assert [mma_row_bytes(d) for d in KERNEL_HEAD_DIMS] == [48, 80, 144, 272]
    assert fused_attention_plan(4, 64, 8, 64) == ("tile", 1)
    assert fused_attention_plan(4, 64, 8, 16) == ("slab", 1)
    assert Geometry(4, 64, 8, 16).smem == 3 * 8 * 64 * 48 + 8
    tiny = Geometry(32, 8, 2, 16)  # tiny_config's temporal call: 4 sequences a block, a warp a head
    assert (tiny.plan, tiny.warps, tiny.grid) == (("slab", 4), 8, 8)
    assert fused_attention_plan(4, 16, 8, 256) == fused_attention_plan(4, 1024, 8, 512) == ("wide", 1)
    for bad in (8, 48, 96, 130, 192):
        with pytest.raises(ValueError, match="head_dim"):
            fused_attention_plan(4, 16, 8, bad)


@pytest.mark.parametrize("name,B,S,H,D", H4_CASES, ids=[c[0] for c in H4_CASES])
def test_attention_plan_at_h4_shapes(name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("S", range(1, 257))
def test_attention_plan_at_head_dim_128(S):
    for B, H in D128_BATCHES:
        _check_plan(B, S, H, 128)


def test_attention_plan_at_head_dim_128_is_as_designed():
    """ModelConfig(num_heads=4): temporal S = 16 has 4 heads of 128 (52 KB a
    sequence), one sequence a slab block with a warp a head; spatial S = 256
    takes a tile block of 205 KB, 8 warps of two 16-row tiles each (255
    registers a thread for a 16 x 128 f32 output)."""
    assert [c[1:4] for c in H4_CASES] == [(256, 16, 4), (16, 256, 4), (512, 16, 4), (32, 256, 4), (256, 16, 4),
                                          (16, 256, 4)]
    temporal = Geometry(256, 16, 4, 128)
    assert (temporal.plan, temporal.warps, temporal.grid, temporal.smem) == (("slab", 1), 4, 256, 3 * 4 * 16 * 272 + 8)
    spatial = Geometry(16, 256, 4, 128)
    assert (spatial.plan, spatial.warps, spatial.grid) == (("tile", 1), 8, 64)
    assert spatial.smem == 3 * 256 * 272 + 4 * 8 == 208928
    assert {warp for _, warp, _, _, _ in spatial.row_tiles()} == set(range(8))
    assert mma_max_warps(64) == 16 and Geometry(16, 256, 4, 64).warps == 16


@pytest.mark.parametrize("name,B,S,H", LATENT_CASES, ids=[c[0] for c in LATENT_CASES])
def test_attention_plan_at_latent_cli_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_check_head_dim_takes_the_four():
    """The kernels are instantiated at head_dim 16, 32, 64 and 128 and take every
    even head_dim: up to 128 padded to the next of the four, past it (the wide
    variant) to a multiple of 128; 0 and an odd head_dim raise, naming the range
    and the four."""
    from video_vae_tpu_torch.ops.flash_attention import check_head_dim

    assert KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    for d in (*range(2, 1026, 2), 2048, 4098):
        check_head_dim(d)
    for bad in (0, 1, 3, 15, 33, 95, 127, 129, 131, 193, 257, 511):
        with pytest.raises(ValueError, match=r"an even head_dim of at least 2 \(padded to the next of "
                                             r"\(16, 32, 64, 128\), past 128 to a multiple of 128\), got "
                           + str(bad)):
            check_head_dim(bad)


@pytest.mark.parametrize("qkv,name,B,S,H,D", PADDED_MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in PADDED_MODEL_CASES])
def test_attention_plan_at_padded_model_shapes(qkv, name, B, S, H, D):
    """A padded call's plan is the instantiation's: ``padded_head_dim(D)``."""
    from video_vae_tpu_torch.ops.flash_attention import padded_head_dim

    _check_plan(B, S, H, padded_head_dim(D))


@pytest.mark.parametrize("B,S,H,D", PADDED_CHECK_CASES)
def test_attention_plan_at_padded_kernel_checks(B, S, H, D):
    from video_vae_tpu_torch.ops.flash_attention import padded_head_dim

    if S > TILE_MAX_SEQ:
        assert fused_attention_plan(B, S, H, padded_head_dim(D)) == ("split", 1)
        check_split("fused", B, S, H, padded_head_dim(D))
    else:
        _check_plan(B, S, H, padded_head_dim(D))


def test_attention_plan_at_head_dim_96_is_as_designed():
    """ModelConfig(qkv_features=768): 8 heads of 96, run at 128. A temporal call's
    sequence (S = 16) is then 3 x 8 x 16 rows of 272 bytes, 104,448 bytes with its
    key bits over MMA_SLAB_MAX_SMEM (102,400; h4's 4 heads took 52 KB), so #1
    takes the tile variant there: a block a (sequence, head) pair and one warp,
    4096 blocks at b2 x 16f. The spatial call (S = 256) is h4's tile block at 8
    heads: 8 warps of two 16-row tiles each. At 384 features (8 heads of 48, run
    at 64) every call has the flagship's plan."""
    from video_vae_tpu_torch.ops.flash_attention import MMA_SLAB_MAX_SMEM, padded_head_dim

    assert (D96.num_heads, D96.head_dim, padded_head_dim(D96.head_dim)) == (8, 96, 128)
    assert 3 * 8 * 16 * mma_row_bytes(128) + 8 == 104456 > MMA_SLAB_MAX_SMEM == 102400
    temporal = Geometry(512, 16, 8, 128)
    assert (temporal.plan, temporal.warps, temporal.grid, temporal.smem) == (("tile", 1), 1, 4096, 3 * 16 * 272 + 8)
    assert temporal.normalize_first  # S * H = 128: JAX's packed path, P normalised before its rounding
    spatial = Geometry(32, 256, 8, 128)
    assert (spatial.plan, spatial.warps, spatial.grid, spatial.smem) == (("tile", 1), 8, 256, 208928)
    for B, S in ((512, 16), (32, 256), (256, 16), (16, 256)):
        assert fused_attention_plan(B, S, 8, padded_head_dim(48)) == fused_attention_plan(B, S, 8, 64)


@pytest.mark.parametrize("name,B,S,H", MAE_CASES, ids=[c[0] for c in MAE_CASES])
def test_attention_plan_at_mae_shapes(name, B, S, H):
    _check_plan(B, S, H)


def test_attention_plan_at_mae_shapes_is_as_designed():
    """The MAE at 224²: spatial S = 196 = 12·16 + 4 takes a tile block a (sequence,
    head) pair, 13 warps of one 16-row tile each, the last tile holding 4 real
    rows, and 4 key chunks of 64 staged rows over 208 (keys 196-207 staged as
    padding); temporal S = 16 is the flagship's slab plan, a sequence a block."""
    assert [(B, S) for _, B, S, _ in MAE_CASES] == [(784, 16), (64, 196)]
    spatial = Geometry(64, 196, 8)
    assert (spatial.plan, spatial.rows16, spatial.warps, spatial.grid) == (("tile", 1), 208, 13, 512)
    assert spatial.key_steps() == [(0, 4), (64, 4), (128, 4), (192, 1)]
    assert sorted(row0 for _, _, b, h, row0 in spatial.row_tiles() if (b, h) == (0, 0))[-1] == 192
    temporal = Geometry(784, 16, 8)
    assert (temporal.plan, temporal.grid) == (("slab", 1), 784)


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_attention_plan_keeps_every_short_sequence(D):
    """Every S <= 256 keeps its variant and sequences a block; 257 splits."""
    assert TILE_MAX_SEQ == 256
    for B, H in PINNED_BATCHES:
        for S in range(1, TILE_MAX_SEQ + 1):
            assert fused_attention_plan(B, S, H, D) == _plan_before_split(B, S, H, D), (B, S, H)
        assert fused_attention_plan(B, TILE_MAX_SEQ + 1, H, D) == ("split", 1)


@pytest.mark.parametrize("label,B,S,H,D", LONG_CASES, ids=LONG_IDS)
def test_attention_plan_splits_long_sequences(label, B, S, H, D):
    assert fused_attention_plan(B, S, H, D) == ("split", 1)
    check_split("fused", B, S, H, D)


def test_attention_plan_at_512_is_as_designed():
    """The flagship at 512² (a 32 x 32 patch grid): spatial S = 1024 splits; the
    wgmma forward takes 128 query rows a block, 8 a (sequence, head) pair, 2048
    blocks of 12 warps at b2 x 16f, each walking 8 key tiles of 128; 113 KB a
    block at head_dim 64, 129 KB at 128 (64 keys a tile). Head dims 16 and 32
    keep the mma.sync forward of 64 rows a block. The temporal calls (S = 16)
    keep the slab plan."""
    cfg = ModelConfig(height=512, width=512)
    assert cfg.num_patches == 1024 and cfg.head_dim == 64
    assert fused_attention_plan(32, 1024, 8, 64) == ("split", 1)
    spatial = check_split("fused", 32, 1024, 8, 64)
    assert (spatial.row_tiles, spatial.grid, spatial.tiles, spatial.threads) == (8, 2048, 8, 384)
    assert spatial.smem == 115768
    h4 = check_split("fused", 16, 1024, 4, 128)
    assert (h4.grid, h4.tiles, h4.boxes, h4.smem) == (512, 16, 2, 132152)
    small = check_split("fused", 16, 576, 8, 16)
    assert (small.grid, small.smem["forward"]) == (16 * 8 * 9, 320 * 48)
    assert fused_attention_plan(2 * 1024, 16, 8, 64) == ("slab", 1)


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_split_fwd_grid_and_warps_follow_the_head_dim(D):
    """The split forward's launch by head dim alone: the wgmma launch's 12 warps
    (two consumer warpgroups and a producer) and a block a pair's 128 query rows
    at 64 and 128, the mma.sync launch's 4 warps and 64 rows at 16 and 32; the
    plan's unit stays 1 (the C entry points refuse another)."""
    wgmma = D in (64, 128)
    assert split_fwd_warps(D) == (12 if wgmma else 4)
    for B, S, H in ((32, 1024, 8), (16, 257, 8), (3, 576, 2), (1, 4096, 4)):
        assert split_fwd_grid(B, S, H, D) == B * H * -(-S // (128 if wgmma else 64))
        assert fused_attention_plan(B, S, H, D) == ("split", 1)


def test_attention_split_fwd_at_512_is_as_designed():
    """#1's split forward at the 512² calls: the serving pass's b2 (32 x 8 pairs)
    and the train step's b1 (16 x 8) at head dim 64, and the flagship's width in
    4 heads of 128: 15.5, 7.8 and 3.9 waves of one block an SM on 132 SMs; one
    walk, every stage k and v (32 KB); both warpgroups live in every block, so
    each takes its turns in alternation (a step each and one for the last P.V)."""
    for B, H, D, grid, tiles in ((32, 8, 64, 2048, 8), (16, 8, 64, 1024, 8), (16, 4, 128, 512, 16)):
        geo = check_split("fused", B, 1024, H, D)
        assert (geo.grid, geo.tiles, geo.launches) == (grid, tiles, ("online",))
        assert {expect for *_, expect in geo.steps("online")} == {32768}
        assert all(geo.live(row0) == 2 for row0 in range(0, 1024, 128))
        assert len(geo.turns(2, "online")) == 2 * (tiles + 1)
    assert [round(g / 132, 1) for g in (2048, 1024, 512)] == [15.5, 7.8, 3.9]
    # S = 257: the last block's second warpgroup has no rows and the first takes no turns
    ragged = check_split("fused", 16, 257, 8, 64)
    assert (ragged.row_tiles, ragged.live(256), ragged.turns(ragged.live(256), "online")) == (3, 1, [])


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_attention_split_operands_meet_tma_alignment(D):
    """#1's and #7's split operands at every head dim: at 64 and 128 the raw q
    rows and v, views into the fused qkv (rows 3 H D apart, at 0 and 2 H D),
    and k~ in the bf16 workspace (B S H D: the blocks normalise their own q
    rows); at 16 and 32 the workspace holds q~ | k~ for the mma.sync forward;
    the output contiguous: every row stride and base a multiple of 16 bytes,
    TMA's rule (and the mma.sync forward's 16-byte cp.async), at the 512² calls
    and at ragged S."""
    import torch

    from video_vae_tpu_torch.ops.flash_attention import _split_qk_work

    for B, S, H in ((32, 1024, 8), (3, 257, 2), (5, 300, 4)):
        HD = H * D
        if S < 1024:  # the wrappers' buffers, at the small shapes
            work = _split_qk_work("split", B, S, H, D, "cpu")
            assert work.numel() == (1 if D >= 64 else 2) * B * S * HD and work.data_ptr() % 16 == 0
            assert (2 * B * S * HD) % 16 == 0  # k~ after q~ at 16 and 32
            qkv = torch.zeros(B, S, 3 * HD, dtype=torch.bfloat16)
            v = qkv[..., 2 * HD:]
            assert (v.data_ptr() - qkv.data_ptr(), v.stride(1) * 2) == (4 * HD, 6 * HD)
        for kind in ("fused", "sublayer"):
            operands = tma_operands(kind, B, S, H, D)
            assert operands["v"] == (6 * HD, 4 * HD) and operands["q"] == (6 * HD, 0)
            for name, (stride, offset) in operands.items():
                assert loads(stride, offset) == "tma", (kind, name)
