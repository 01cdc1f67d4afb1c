"""Launch geometry of the bf16 fused attention kernel (``ops/flash_attention.py:fused_attention_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at) and at ragged shapes: every (sequence,
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
    MMA_ROW_BYTES,
    MMA_SLAB_MAX_SEQ,
    MMA_SLAB_WARPS,
    fused_attention_plan,
)

# the warps of the kernel's __launch_bounds__; what the H100 accepts of one block and one grid
MAX_WARPS, MAX_SMEM, MAX_GRID_X = 16, 232448, 2**31 - 1

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


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of the kernel: the plan and what the C entry point derives from it."""

    batch: int
    seq: int
    heads: int

    @property
    def plan(self) -> tuple[str, int]:
        return fused_attention_plan(self.batch, self.seq, self.heads)

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
        return min(MMA_SLAB_WARPS, unit * self.heads * tiles) if variant == "slab" else tiles

    @property
    def smem(self) -> int:
        """``smem_bytes``: the q, k, v rows and the key bits of a block."""
        variant, unit = self.plan
        words = 8 * -(-self.seq // 64)
        if variant == "slab":
            return unit * (3 * self.heads * self.rows16 * MMA_ROW_BYTES + words)
        return 3 * self.rows16 * MMA_ROW_BYTES + words

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
            else:
                for warp in range(self.warps):
                    if 16 * warp < self.seq:
                        yield block, warp, block // self.heads, block % self.heads, 16 * warp

    def key_steps(self) -> list[tuple[int, int]]:
        """(first key, 16-key steps) of every chunk a warp walks."""
        ch = 16 * self.kt
        return [(c0, min(self.kt, -(-(self.seq - c0) // 16))) for c0 in range(0, self.seq, ch)]


def _check_plan(B, S, H):
    geo = Geometry(B, S, H)
    variant, unit = geo.plan
    assert variant in ("slab", "tile") and unit >= 1
    assert variant == "tile" or S <= MMA_SLAB_MAX_SEQ
    assert variant == "slab" or unit == 1
    assert geo.smem <= MAX_SMEM
    assert 1 <= geo.grid <= MAX_GRID_X
    assert 1 <= geo.warps <= MAX_WARPS

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
