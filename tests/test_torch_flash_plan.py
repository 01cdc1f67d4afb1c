"""Launch geometry of the bf16 plain attention forward kernel
(``ops/flash_attention.py:flash_attention_plan``).

At every attention call of the flagship and of the tap-dot model (the shapes
``chip_smoke.py`` holds the kernel at) and at the ragged shapes of the card
test's ``FLASH_CASES``: every (sequence, head, query row) is written by
exactly one warp of one block, which staged the pair; every cp.async copy
lands in its own staged row once, from a 16-byte aligned source, also with v a
view into a fused QKV projection (row stride 3·H·D); no key chunk walks past
the staged rows, and a chunk's keys lie in one word of key bits; shared
memory, warps and grid stay within what the kernel and the H100 accept. :class:`FlashGeometry` derives the launch
from the plan as ``launch_flash_mma`` in ``csrc/flash_attention_mma.cuh`` does,
and walks the copies, the query tiles and the key chunks as
``flash_fwd_kernel`` and ``attend`` do. Past 256 tokens the plan is the
fused forward's ``"split"``, two walks over the key tiles (k, then k and v),
walked by ``helpers/split_geometry.py`` (the wgmma launch at head dims 64 and
128, the mma.sync one at 16 and 32).
"""

import dataclasses

import numpy as np
import pytest
import torch
from helpers.split_geometry import check_split, loads, tma_operands
from test_torch_attention_plan import (
    D128_BATCHES,
    H4_CASES,
    LONG_CASES,
    LONG_IDS,
    MAX_GRID_X,
    MAX_SMEM,
    MODEL_CASES,
    PINNED_BATCHES,
    PRESET_CASES,
    Geometry,
    _plan_before_split,
)

from video_vae_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MMA_SLAB_MAX_SEQ,
    TILE_MAX_SEQ,
    _rows_of_heads,
    flash_attention_plan,
    mma_max_warps,
    split_fwd_grid,
    split_fwd_warps,
)

D = 64

# the S and H of FLASH_CASES in tests/test_torch_cuda.py, at B = 1, 3 and 5
RAGGED_CASES = [(B, S, H) for S in (1, 17, 37, 64, 65, 80, 200, 256) for H in (2, 8) for B in (1, 3, 5)]


@dataclasses.dataclass(frozen=True)
class FlashGeometry(Geometry):
    """One launch of the kernel: the plan, the launch the C entry point derives
    from it, and the copies, tiles and chunks the kernel walks."""

    @property
    def plan(self) -> tuple[str, int]:
        return flash_attention_plan(self.batch, self.seq, self.heads, self.head_dim)

    @property
    def pieces(self) -> int:
        """16-byte pieces of a head row."""
        return self.head_dim // 8

    @property
    def kt(self) -> int:
        """16-key steps a chunk (``chunk_steps``)."""
        return 1 if self.rows16 <= 16 else 2 if self.rows16 <= 32 else 4

    @property
    def two_pass(self) -> bool:
        """``attend`` with P normalised first walks the keys twice past one chunk."""
        return len(self.key_steps()) > 1

    def threads(self) -> int:
        return 32 * self.warps

    def slab_copies(self, block: int):
        """(local sequence, part, head, row, piece, sequence) of every 16-byte
        copy of a slab block: thread p takes (part, head, piece) = (p / PH,
        p / P % H, p % P), P pieces a row, and p + threads after it, at every
        position."""
        _, unit = self.plan
        H, P = self.heads, self.pieces
        for t in range(self.threads()):
            for p in range(t, 3 * H * P, self.threads()):
                piece, part, h = p % P, (p // P) // H, (p // P) % H
                for sl in range(unit):
                    for i in range(self.rows16):
                        yield sl, part, h, i, piece, block * unit + sl

    def tile_copies(self):
        """(part, row, piece) of every 16-byte copy of a tile block: thread t
        takes piece t % P of rows t / P, t / P + threads / P, ... of each input."""
        P = self.pieces
        for t in range(self.threads()):
            for part in range(3):
                for i in range(t // P, self.rows16, self.threads() // P):
                    yield part, i, t % P


def _check_plan(B, S, H, D=64):
    geo = FlashGeometry(B, S, H, D)
    variant, unit = geo.plan
    assert variant in ("slab", "tile") and unit >= 1
    assert variant == "tile" or S <= MMA_SLAB_MAX_SEQ
    assert variant == "slab" or unit == 1
    assert geo.smem <= MAX_SMEM
    assert 1 <= geo.grid <= MAX_GRID_X
    assert 1 <= geo.warps <= mma_max_warps(D)  # flash_fwd_kernel's __launch_bounds__

    # every (sequence, head, query row) by one warp of a block that staged the pair
    owners = np.zeros((B, H, S), dtype=np.int32)
    for block, warp, b, h, row0 in geo.row_tiles():
        assert 0 <= block < geo.grid and 0 <= warp < geo.warps
        assert row0 % 16 == 0 and 0 <= row0 < S
        assert (b, h) in geo.block_pairs(block)
        owners[b, h, row0 : row0 + 16] += 1
    assert (owners == 1).all()
    if variant == "tile":  # the kernel calls attend from every warp
        assert geo.warps == min(geo.rows16 // 16, mma_max_warps(D))

    # the key chunks: every key j < S once, within the staged rows, and each in
    # one word of key bits
    seen = np.zeros(S, dtype=np.int32)
    for c0, steps in geo.key_steps():
        assert 1 <= steps <= geo.kt and c0 % 16 == 0
        assert c0 + 16 * steps <= geo.rows16
        assert c0 // 64 == (c0 + 16 * steps - 1) // 64
        seen[c0 : c0 + 16 * steps] += 1
    assert (seen == 1).all()

    # the copies: every staged row of every input once (one cp.async group,
    # waited for before any warp reads it)
    if variant == "slab":
        for block in {0, geo.grid - 1}:  # a full block and the last, perhaps part empty
            staged = np.zeros((unit, 3, H, geo.rows16, geo.pieces), dtype=np.int32)
            for sl, part, h, i, piece, b in geo.slab_copies(block):
                staged[sl, part, h, i, piece] += 1
            assert (staged == 1).all()
    else:
        staged = np.zeros((3, geo.rows16, geo.pieces), dtype=np.int32)
        for part, i, piece in geo.tile_copies():
            staged[part, i, piece] += 1
        assert (staged == 1).all()


@pytest.mark.parametrize("model,name,B,S,H", MODEL_CASES, ids=[f"{c[0]}-{c[1]}" for c in MODEL_CASES])
def test_flash_plan_at_model_shapes(model, name, B, S, H):
    _check_plan(B, S, H)


@pytest.mark.parametrize("B,S,H", RAGGED_CASES)
def test_flash_plan_at_ragged_shapes(B, S, H):
    _check_plan(B, S, H)


@pytest.mark.parametrize("B,S,H", [(3, 16, 8), (1, 256, 8), (5, 37, 2), (2, 17, 8)])
def test_flash_plan_sources_are_16_byte_aligned(B, S, H):
    """q and k contiguous and v a view into a fused (B, S, 3·H·D) projection, as
    the model's "pallas" path hands them over: ``_rows_of_heads`` takes each as
    it is, and every 16-byte copy's source, base + ((b·S + i)·stride + h·D +
    8·piece)·2 bytes, is 16-byte aligned."""
    _check_sources(B, S, H, D)


@pytest.mark.parametrize("B,S,H", [(3, 16, 8), (5, 37, 2)])
@pytest.mark.parametrize("D", [d for d in KERNEL_HEAD_DIMS if d != 64])
def test_flash_plan_sources_are_16_byte_aligned_other_head_dims(B, S, H, D):
    _check_sources(B, S, H, D)


def _check_sources(B, S, H, D):
    qkv = torch.zeros(B, S, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    b, i, h, piece = np.meshgrid(np.arange(B), np.arange(S), np.arange(H), np.arange(D // 8), indexing="ij")
    for t, row_stride in ((q.contiguous(), H * D), (k.contiguous(), H * D), (v, 3 * H * D)):
        taken, stride = _rows_of_heads(t)
        assert taken is t and stride == row_stride  # no copy
        offsets = taken.data_ptr() + ((b * S + i) * stride + h * D + 8 * piece) * 2
        assert (offsets % 16 == 0).all()


def test_flash_plan_at_the_models_shapes_is_as_designed():
    """Temporal S = 16, 8 heads: one sequence a slab block, a warp a head, one
    chunk; spatial S = 256: one block a (sequence, head) pair, 16 warps, the
    keys walked twice in four chunks, 110 KB of shared memory."""
    temporal = FlashGeometry(512, 16, 8)
    assert (temporal.plan, temporal.warps, temporal.grid) == (("slab", 1), 8, 512)
    assert not temporal.two_pass and temporal.kt == 1
    spatial = FlashGeometry(32, 256, 8)
    assert (spatial.plan, spatial.warps, spatial.grid) == (("tile", 1), 16, 256)
    assert spatial.two_pass and len(spatial.key_steps()) == 4
    assert spatial.smem == 3 * 256 * 144 + 4 * 8


@pytest.mark.parametrize("label,name,B,S,H,D", PRESET_CASES, ids=[f"{c[0]}-{c[1]}" for c in PRESET_CASES])
def test_flash_plan_at_preset_shapes(label, name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("B,S,H,D", [(B, S, H, D) for B, S, H in RAGGED_CASES for D in KERNEL_HEAD_DIMS if D != 64])
def test_flash_plan_at_ragged_shapes_other_head_dims(B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("name,B,S,H,D", H4_CASES, ids=[c[0] for c in H4_CASES])
def test_flash_plan_at_h4_shapes(name, B, S, H, D):
    _check_plan(B, S, H, D)


@pytest.mark.parametrize("S", range(1, 257))
def test_flash_plan_at_head_dim_128(S):
    for B, H in D128_BATCHES:
        _check_plan(B, S, H, 128)


def test_flash_plan_at_head_dim_128_is_as_designed():
    """S = 256 at head_dim 128: a tile block of 8 warps, each taking two 16-row
    query tiles, walking the keys twice in four chunks, 205 KB of rows."""
    spatial = FlashGeometry(16, 256, 4, 128)
    assert (spatial.plan, spatial.warps, spatial.grid) == (("tile", 1), 8, 64)
    assert spatial.two_pass and spatial.smem == 3 * 256 * 272 + 4 * 8
    assert sorted(row0 for _, _, b, h, row0 in spatial.row_tiles() if (b, h) == (0, 0)) == list(range(0, 256, 16))


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
def test_flash_plan_keeps_every_short_sequence(D):
    """Every S <= 256 keeps the fused forward's plan as it stood before the
    split variant; 257 splits."""
    for B, H in PINNED_BATCHES:
        for S in range(1, TILE_MAX_SEQ + 1):
            assert flash_attention_plan(B, S, H, D) == _plan_before_split(B, S, H, D), (B, S, H)
        assert flash_attention_plan(B, TILE_MAX_SEQ + 1, H, D) == ("split", 1)


@pytest.mark.parametrize("label,B,S,H,D", LONG_CASES, ids=LONG_IDS)
def test_flash_plan_splits_long_sequences(label, B, S, H, D):
    """Two walks over the key tiles (the exact row max and sum first), v staged
    on the second only."""
    assert flash_attention_plan(B, S, H, D) == ("split", 1)
    check_split("flash", B, S, H, D)


@pytest.mark.parametrize("S", [257, 1024])
def test_flash_plan_split_sources_are_16_byte_aligned(S):
    """The split blocks copy 16 bytes at a time from the rows _rows_of_heads hands
    over, v a view into a fused QKV projection, as at the shorter sequences."""
    _check_sources(3, S, 2, D)


def test_flash_split_fwd_at_512_is_as_designed():
    """#5's split forward at the 512² calls (b2: 32 x 8 pairs, b1: 16 x 8, head
    dim 64; 16 x 4 pairs at 128): two wgmma launches of 12 warps, 128 query rows
    a block; the first streams k alone (16 KB a stage) for each row's max and
    1/l, which it parks in the row's own output (8 of its 128 or 256 bytes), the
    second k and v (32 KB); each starts its ring afresh; each live warpgroup
    takes a turn a step (and the second one more, for the last P.V)."""
    for B, H, Dh, grid, tiles in ((32, 8, 64, 2048, 8), (16, 8, 64, 1024, 8), (16, 4, 128, 512, 16)):
        assert flash_attention_plan(B, 1024, H, Dh) == ("split", 1) and split_fwd_warps(Dh) == 12
        geo = check_split("flash", B, 1024, H, Dh)
        assert (geo.grid, geo.tiles, geo.launches) == (split_fwd_grid(B, 1024, H, Dh), tiles,
                                                       ("stats", "normalized"))
        assert geo.grid == grid
        assert [expect for *_, expect in geo.steps("stats")] == [16384] * tiles
        assert [expect for *_, expect in geo.steps("normalized")] == [32768] * tiles
        assert [stage for _, _, _, stage, *_ in geo.steps("normalized")][:3] == [0, 1, 2]
        assert (len(geo.turns(2, "stats")), len(geo.turns(2, "normalized"))) == (2 * tiles, 2 * (tiles + 1))
        assert geo.stat_slot(0, 1, 0) == (H * Dh * 2, H * Dh * 2 + 8)
    small = check_split("flash", 16, 576, 8, 32)  # head dim 32: the mma.sync launch, 64 rows a block
    assert (small.grid, split_fwd_warps(32), split_fwd_grid(16, 576, 8, 32)) == (16 * 8 * 9, 4, 16 * 8 * 9)


@pytest.mark.parametrize("Dh", KERNEL_HEAD_DIMS)
def test_flash_split_operands_meet_tma_alignment(Dh):
    """#5's strided inputs reach the split forward at 16-byte row strides and
    bases at every head dim, TMA's rule: q and k contiguous and v a view into
    the fused qkv are taken as they are, the output is contiguous; a view whose
    base or row stride is not a multiple of 16 bytes is copied first
    (``_rows_of_heads``), so no operand needs another load."""
    B, S, H = 2, 300, 4
    HD = H * Dh
    qkv = torch.zeros(B, S, 3 * HD, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, Dh) for t in qkv.split(HD, -1))
    for name, t, stride in (("q", q.contiguous(), HD), ("k", k.contiguous(), HD), ("v", v, 3 * HD)):
        out, st = _rows_of_heads(t)
        assert out.data_ptr() == t.data_ptr() and st == stride, name
        assert loads(2 * st, out.data_ptr() % 256) == "tma", name
    shifted = torch.zeros(B * S * HD + 1, dtype=torch.bfloat16)[1:].view(B, S, H, Dh)  # base 2 bytes off
    out, st = _rows_of_heads(shifted)
    assert loads(2 * shifted.stride(1), shifted.data_ptr() % 256) != "tma"
    assert loads(2 * st, out.data_ptr() % 256) == "tma" and torch.equal(out, shifted)
    for name, (stride, offset) in tma_operands("flash", B, S, H, Dh).items():
        assert loads(stride, offset) == "tma", name
