"""Launch geometry of the bf16 fused attention kernel (``ops/flash_attention.py:fused_attention_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at), of the ``--tiny`` and ``--small``
presets (head_dim 16) and at the same shapes with head_dim 32, of a
``ModelConfig(num_heads=4)`` train step (head_dim 128) and of the latent
CLIs (b1 × 64 frames), at every S at head_dim 128, and at ragged shapes at
every head dim the kernel takes: every (sequence,
head, query row) is computed by exactly one warp, that warp's block stages the
(sequence, head) pair's keys and its chunks walk every key j < S and no row
past the staged ones, and shared memory, warps and grid stay within CUDA's
limits. :class:`Geometry` derives the rest of the launch from the plan as
``launch_attention_mma`` in ``csrc/fused_attention_mma.cuh`` does, and deals
out the query tiles and key chunks as ``attention_mma_kernel`` walks them.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MMA_SLAB_MAX_SEQ,
    MMA_SLAB_WARPS,
    fused_attention_plan,
    mma_max_warps,
    mma_row_bytes,
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
    block a pair) and fit at 16 (a slab block a sequence); heads the kernels do
    not take are refused."""
    assert [mma_row_bytes(d) for d in KERNEL_HEAD_DIMS] == [48, 80, 144, 272]
    assert fused_attention_plan(4, 64, 8, 64) == ("tile", 1)
    assert fused_attention_plan(4, 64, 8, 16) == ("slab", 1)
    assert Geometry(4, 64, 8, 16).smem == 3 * 8 * 64 * 48 + 8
    tiny = Geometry(32, 8, 2, 16)  # tiny_config's temporal call: 4 sequences a block, a warp a head
    assert (tiny.plan, tiny.warps, tiny.grid) == (("slab", 4), 8, 8)
    for bad in (8, 48, 96, 256):
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
    """The kernels take head_dim 16, 32, 64 and 128; another raises, naming the four."""
    from video_vae_tpu_torch.ops.flash_attention import check_head_dim

    assert KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    for d in KERNEL_HEAD_DIMS:
        check_head_dim(d)
    for bad in (0, 8, 24, 48, 96, 192, 256):
        with pytest.raises(ValueError, match=r"head_dim in \(16, 32, 64, 128\), got " + str(bad)):
            check_head_dim(bad)


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
