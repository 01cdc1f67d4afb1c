"""Launch geometry of the bf16 plain attention backward kernel
(``ops/flash_attention.py:flash_attention_bwd_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at) and at ragged shapes, the cases of
``test_torch_attention_bwd_plan.py``: every (sequence, head, row) is computed
by exactly one warp of one block, which staged the pair, on the query side and
on the key side; no chunk walks past the staged rows; shared memory, warps and
grid stay within what the kernel and the H100 accept. Slab blocks (S ≤ 64)
deal their tiles as the fused backward's do (:class:`Geometry` of that test);
a tile block (S > 64) gives each warp 16 query rows for the statistics and 16
key rows for the rounds, and deals each round's 16 × 16 tiles of dq in turn.
:class:`FlashGeometry` derives the launch from the plan as
``launch_flash_bwd_mma`` in ``csrc/flash_attention_bwd_mma.cuh`` does, and
walks the items as ``flash_bwd_slab_kernel`` and ``flash_bwd_tile_kernel`` do.
Past 256 tokens the plan is the fused backward's ``"split"`` (its two
launches on q, k, v and dO as they are), walked by
``helpers/split_geometry.py``.
"""

import dataclasses

import numpy as np
import pytest
from helpers.split_geometry import check_split, loads, tma_operands
from test_torch_attention_bwd_plan import (
    LAUNCH_BOUND_WARPS,
    MAX_GRID_X,
    MAX_SMEM,
    MODEL_CASES,
    PRESET_CASES,
    RAGGED_CASES,
    RAGGED_HEAD_DIM_CASES,
    Geometry,
    _bwd_plan_before_split,
)
from test_torch_attention_plan import D128_BATCHES, H4_CASES, LONG_CASES, LONG_IDS, PINNED_BATCHES

from video_vae_tpu_torch.ops.flash_attention import (
    BWD_SLAB_MAX_SEQ,
    BWD_SLAB_WARPS,
    BWD_TILE_WARPS,
    FLASH_BWD_ROUND,
    KERNEL_HEAD_DIMS,
    TILE_MAX_SEQ,
    flash_attention_bwd_plan,
    mma_row_bytes,
    split_bwd_grid,
    split_bwd_warps,
)

KEY_GROUP = 64  # keys a cp.async group of a tile block brings


@dataclasses.dataclass(frozen=True)
class FlashGeometry(Geometry):
    """One launch of the kernel: the plan and what the C entry point derives from it."""

    @property
    def plan(self) -> tuple[str, int, int]:
        return flash_attention_bwd_plan(self.batch, self.seq, self.heads, self.head_dim)

    @property
    def smem(self) -> int:
        """``smem_bytes``: the rows, P and dS (slab) or a round's dS^T and the row
        statistics (tile), key bits, and each warp's 8 f32 staging rows."""
        variant, unit, warps = self.plan
        row = mma_row_bytes(self.head_dim)
        words = 8 * -(-self.seq // 64)
        if self.variant == "wide tile":  # the fused backward's wide tile without the dscale partials
            return 3 * self.rows16 * row + 3 * self.rows16 * 4 + words
        stage = warps * 8 * (self.head_dim + 8) * 4  # a warp's f32 staging rows of the epilogue
        if variant == "slab":
            pair = 4 * self.rows16 * row + 2 * self.rows16 * (self.rows16 + 8) * 2
            return unit * (pair + words) + stage
        ds_t = self.rows16 * (FLASH_BWD_ROUND + 8) * 2
        return 4 * self.rows16 * row + ds_t + 3 * self.rows16 * 4 + words + stage

    def rounds(self) -> list[tuple[int, int]]:
        """(first query, end) of each round of a tile block."""
        return [(q0, min(q0 + FLASH_BWD_ROUND, self.rows16)) for q0 in range(0, self.rows16, FLASH_BWD_ROUND)]

    def dq_tiles_dealt(self):
        """(warp, first query, first dim) of every 16 x 16 dq tile of every round."""
        warps, dims = self.plan[2], self.head_dim // 16
        for q0, q1 in self.rounds():
            for it in range((q1 - q0) // 16 * dims):
                yield it % warps, q0 + 16 * (it // dims), 16 * (it % dims)

    def stats_chunks(self) -> list[tuple[int, int]]:
        """(first key, 16-key steps) of every chunk of a tile block's statistics."""
        ch = 32  # TILE_KT 16-key steps
        return [(c0, min(2, -(-(self.seq - c0) // 16))) for c0 in range(0, self.seq, ch)]


def _check_plan(B, S, H, D=64):
    geo = FlashGeometry(B, S, H, D)
    variant, unit, warps = geo.plan
    assert variant in ("slab", "tile") and unit >= 1
    assert variant == "tile" or S <= BWD_SLAB_MAX_SEQ
    assert 1 <= warps <= min(LAUNCH_BOUND_WARPS[geo.variant],
                             BWD_SLAB_WARPS if variant == "slab" else BWD_TILE_WARPS)
    assert geo.smem <= MAX_SMEM
    assert 1 <= geo.grid <= MAX_GRID_X

    if geo.variant == "wide tile":  # the fused backward's: its Geometry walks the same items
        assert warps == min(geo.tiles, LAUNCH_BOUND_WARPS["wide tile"])
        owners = np.zeros((B * H, S), dtype=np.int32)
        for block, warp, pair, row0 in geo.tiles_dealt():
            assert 0 <= warp < warps and pair == block
            owners[pair, row0 : row0 + 16] += 1
        assert (owners == 1).all()
        return

    if variant == "slab":
        # query side, then key side: the same 16-row tiles dealt to the warps in turn
        owners = np.zeros((B * H, S), dtype=np.int32)
        for block, warp, pair, row0 in geo.tiles_dealt():
            assert 0 <= block < geo.grid and 0 <= warp < warps
            assert pair in geo.block_pairs(block)  # the block staged the pair's rows
            owners[pair, row0 : row0 + 16] += 1
        assert (owners == 1).all()
        # one chunk of every key up to rows16, so that P and dS of every key reach shared memory
        (c0, steps), = geo.query_chunks()
        assert c0 == 0 and 16 * steps == geo.rows16 and geo.kt <= 4
        assert geo.key_steps() == list(range(0, S, 16))
        return

    # tile: a block a pair, a warp each 16 rows: its query rows' statistics, its key rows' rounds
    assert unit == 1 and geo.grid == B * H and warps == geo.tiles
    rows = np.zeros(geo.rows16, dtype=np.int32)
    for warp in range(warps):
        rows[16 * warp : 16 * warp + 16] += 1
    assert (rows == 1).all()  # as query rows in the statistics and as key rows in the rounds
    # the statistics walk every key j < S once, within the staged rows and one word of key bits,
    # each chunk inside one cp.async group of 64 keys (the kernel waits for a group at its first chunk)
    seen = np.zeros(S, dtype=np.int32)
    for c0, steps in geo.stats_chunks():
        assert 1 <= steps <= 2 and c0 % 32 == 0
        assert c0 + 16 * steps <= geo.rows16
        assert c0 % 64 + 32 <= 64 and c0 // KEY_GROUP == (c0 + 16 * steps - 1) // KEY_GROUP
        seen[c0 : c0 + 16 * steps] += 1
    assert (seen == 1).all()
    # the rounds: every query row once, a multiple of 16 and at most ROUND wide (the dS^T columns)
    seen = np.zeros(geo.rows16, dtype=np.int32)
    for q0, q1 in geo.rounds():
        assert q0 % 16 == 0 and (q1 - q0) % 16 == 0 and 0 < q1 - q0 <= FLASH_BWD_ROUND
        seen[q0:q1] += 1
    assert (seen == 1).all()
    # dq: every (query row, dim) of the pair once, by a warp of the block
    dq = np.zeros((geo.rows16, D), dtype=np.int32)
    for warp, q0, d0 in geo.dq_tiles_dealt():
        assert 0 <= warp < warps
        dq[q0 : q0 + 16, d0 : d0 + 16] += 1
    assert (dq == 1).all()


@pytest.mark.parametrize("model,name,B,S,H", MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in MODEL_CASES])
def test_flash_bwd_plan_at_model_shapes(model, name, B, S, H):
    _check_plan(B, S, H)


@pytest.mark.parametrize("B,S,H", RAGGED_CASES)
def test_flash_bwd_plan_at_ragged_shapes(B, S, H):
    _check_plan(B, S, H)


def test_flash_bwd_plan_at_the_models_shapes_is_as_designed():
    """Temporal S = 16, 8 heads: a slab block of half a sequence's pairs, a
    warp a pair, four blocks an SM; spatial S = 256: one block a pair, 16
    warps, four rounds of 64 queries, within the 227 KB a block may have."""
    temporal = FlashGeometry(512, 16, 8)
    assert (temporal.plan, temporal.grid, temporal.kt) == (("slab", 4, 4), 1024, 1)
    assert 4 * temporal.smem <= MAX_SMEM
    spatial = FlashGeometry(32, 256, 8)
    assert (spatial.plan, spatial.grid) == (("tile", 1, 16), 256)
    assert len(spatial.rounds()) == 4 and len(spatial.stats_chunks()) == 8
    assert spatial.smem == 224288


@pytest.mark.parametrize("label,name,B,S,H,D", PRESET_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRESET_CASES])
def test_flash_bwd_plan_at_preset_shapes(label, name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("B,S,H,D", RAGGED_HEAD_DIM_CASES)
def test_flash_bwd_plan_at_ragged_shapes_other_head_dims(B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("name,B,S,H,D", H4_CASES, ids=[c[0] for c in H4_CASES])
def test_flash_bwd_plan_at_h4_shapes(name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("S", range(1, 257))
def test_flash_bwd_plan_at_head_dim_128(S):
    for B, H in D128_BATCHES:
        _check_plan(B, S, H, 128)


def test_flash_bwd_plan_at_head_dim_128_is_as_designed():
    """At S = 256 and head_dim 128 the exchange tile's four row arrays and a
    round's dS^T (315 KB) do not fit: the plan's tile is the fused backward's
    wide tile, 8 warps, q | k | v (then dO) rows in 212 KB."""
    spatial = FlashGeometry(16, 256, 4, 128)
    assert (spatial.plan, spatial.variant) == (("tile", 1, 8), "wide tile")
    assert spatial.smem == 3 * 256 * 272 + 3 * 256 * 4 + 32 == 212000
    assert 4 * 256 * 272 + 256 * (FLASH_BWD_ROUND + 8) * 2 > MAX_SMEM



@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_flash_bwd_plan_keeps_every_short_sequence(D):
    """Every S <= 256 keeps the fused backward's plan as it stood before the
    split variant; 257 splits."""
    for B, H in PINNED_BATCHES:
        for S in range(1, TILE_MAX_SEQ + 1):
            assert flash_attention_bwd_plan(B, S, H, D) == _bwd_plan_before_split(B, S, H, D), (B, S, H)
        assert flash_attention_bwd_plan(B, TILE_MAX_SEQ + 1, H, D) == ("split", 1, split_bwd_warps(D))


@pytest.mark.parametrize("label,B,S,H,D", LONG_CASES, ids=LONG_IDS)
def test_flash_bwd_plan_splits_long_sequences(label, B, S, H, D):
    """The query side and the key side on q, k, v and dO as they are; the wrapper
    passes split_bwd_grid as the blocks, which the C entry point checks."""
    assert flash_attention_bwd_plan(B, S, H, D) == ("split", 1, split_bwd_warps(D))
    geo = check_split("flash_bwd", B, S, H, D)
    assert geo.grid == split_bwd_grid(B, S, H, D)


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_flash_bwd_split_operands_meet_tma_alignment(D):
    """#6's strided inputs reach the split backward at 16-byte row strides and
    bases, TMA's rule: q, k and dO contiguous and v a view into the fused qkv are
    taken as they are; a view whose base or row stride is not a multiple of 16
    bytes is copied first (``_rows_of_heads``), so no operand needs another load."""
    import torch

    from video_vae_tpu_torch.ops.flash_attention import _rows_of_heads

    B, S, H = 2, 300, 4
    HD = H * D
    qkv = torch.zeros(B, S, 3 * HD, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(HD, -1))
    for name, t, stride in (("q", q.contiguous(), HD), ("k", k.contiguous(), HD), ("v", v, 3 * HD)):
        out, st = _rows_of_heads(t)
        assert out.data_ptr() == t.data_ptr() and st == stride, name
        assert loads(2 * st, out.data_ptr() % 256) == "tma", name
    shifted = torch.zeros(B * S * HD + 1, dtype=torch.bfloat16)[1:].view(B, S, H, D)  # base 2 bytes off
    padded = torch.zeros(B, S, HD + 4, dtype=torch.bfloat16)[..., :HD].reshape(B, S, H, D)  # rows HD + 4 apart
    for name, t in (("shifted", shifted), ("padded", padded)):
        assert loads(2 * t.stride(1), t.data_ptr() % 256) != "tma", name
        out, st = _rows_of_heads(t)
        assert out.data_ptr() != t.data_ptr() and loads(2 * st, out.data_ptr() % 256) == "tma", name
        assert torch.equal(out, t)
    for name, (stride, offset) in tma_operands("flash_bwd", B, S, H, D).items():
        assert loads(stride, offset) == "tma", name
