"""The split variant of the bf16 attention kernels (``csrc/attention_split.cuh``),
walked on the CPU: the geometry each launch derives from the plan and the
shape, and the rows, tiles, buffers and chunks its blocks and warps take.

:class:`SplitGeometry` mirrors ``launch_fwd`` / ``launch_bwd`` /
``launch_norm_rope`` (grid, warps, shared memory) and deals out the work as
``split_fwd_kernel``, ``split_bwd_query_kernel``, ``split_bwd_key_kernel``
and ``qk_norm_rope_kernel`` do; :func:`check_split` holds one shape to it.
The plan tests of #1, #3, #5 and #6 call it at the long sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from video_vae_tpu_torch.ops.flash_attention import SPLIT_ROWS, SPLIT_WARPS, mma_max_warps, mma_row_bytes, split_grid

# what the H100 accepts of one block and one grid; an SM's shared memory and what
# the runtime keeps of it for each resident block
MAX_SMEM, MAX_GRID_X, SM_SMEM, BLOCK_RESERVED = 232448, 2**31 - 1, 233472, 1024
# the header's constants: rows of the other side staged a step (split::TILE_ROWS),
# blocks an SM the launch bounds ask for (split::MIN_BLOCKS), head rows a block of
# the LN + RoPE pass takes (split::PREP_ROWS), 16-key steps of a backward
# query-side chunk (bwd::TILE_KT)
SPLIT_TILE, MIN_BLOCKS, PREP_ROWS, BWD_KT = 64, 2, 64, 2

# the long sequences the plan tests take: past the tile variant's 256, S not a
# multiple of 16 or 64 (257, 300, 324 = 18² patches at 288², 576 = 24² at 384²),
# the flagship's 512² spatial calls (1024) and a longer one (4096)
LONG_SEQS = (257, 300, 324, 576, 1024, 4096)
# (label, B, H): the flagship's b2 x 16f spatial calls, ModelConfig(num_heads=4)'s
# b1 x 16f, and the VideoMAE's b4 x 16f
LONG_BATCHES = (("flagship", 32, 8), ("h4", 16, 4), ("mae", 64, 8))


@dataclasses.dataclass(frozen=True)
class SplitGeometry:
    batch: int
    seq: int
    heads: int
    head_dim: int

    @property
    def pairs(self) -> int:
        return self.batch * self.heads

    @property
    def row_tiles(self) -> int:
        """Tiles of SPLIT_ROWS of a pair's own side (queries, or keys on the key side)."""
        return -(-self.seq // SPLIT_ROWS)

    @property
    def tiles(self) -> int:
        """Tiles of SPLIT_TILE of the other side a block walks (``tiles_of``)."""
        return -(-self.seq // SPLIT_TILE)

    @property
    def grid(self) -> int:
        """Blocks of the forward and of each backward side: a pair's tiles adjacent."""
        return self.pairs * self.row_tiles

    @property
    def prep_grid(self) -> int:
        return -(-self.batch * self.seq * self.heads // PREP_ROWS)

    @property
    def smem(self) -> dict[str, int]:
        """Each launch's shared memory, from the layouts in the header's note."""
        row = mma_row_bytes(self.head_dim)
        return {
            "forward": SPLIT_ROWS * row + 2 * SPLIT_TILE * row * 2,  # q | k[2] | v[2]
            "query_side": 2 * SPLIT_TILE * row * 2,  # k[2] | v[2]
            "key_side": 2 * SPLIT_ROWS * row + 2 * SPLIT_TILE * row * 2 + 2 * 3 * SPLIT_TILE * 4,
            "norm_rope": 2 * PREP_ROWS * row,
        }

    def warp_rows(self):
        """(block, warp, sequence, head, first row) of every warp that has rows below S
        (a warp past S computes nothing and writes nothing), vectorised."""
        x = np.arange(self.grid)[:, None]
        warp = np.arange(SPLIT_WARPS)[None, :]
        pair, tile = np.divmod(x, self.row_tiles)
        row0 = tile * SPLIT_ROWS + 16 * warp
        live = row0 < self.seq
        shape = (self.grid, SPLIT_WARPS)
        return [np.broadcast_to(a, shape)[live] for a in (x, warp, pair // self.heads, pair % self.heads, row0)]

    def steps(self, walks: int, v_each_walk: bool):
        """(step, other-side tile, first row, buffer, v staged) of each step of a
        block's walks: the forward stages v on its last walk only, the backward's
        query side k and v on both (``issue`` in each kernel)."""
        return [(n, n % self.tiles, (n % self.tiles) * SPLIT_TILE, n & 1,
                 v_each_walk or n // self.tiles == walks - 1) for n in range(walks * self.tiles)]

    def tile_chunks(self, first: int, kt: int):
        """(first row in the tile, first row, 16-row steps) of each chunk of 16·kt
        rows a warp takes from the staged tile at row ``first``, as far as S."""
        ch = 16 * kt
        return [(lc, first + lc, min(kt, -(-(self.seq - first - lc) // 16)))
                for lc in range(0, SPLIT_TILE, ch) if first + lc < self.seq]


def _check_launch(geo: SplitGeometry):
    assert geo.grid == split_grid(geo.batch, geo.seq, geo.heads) <= MAX_GRID_X
    assert geo.prep_grid <= MAX_GRID_X
    assert SPLIT_WARPS <= mma_max_warps(geo.head_dim)
    for launch, smem in geo.smem.items():
        # none grows with S, and at least MIN_BLOCKS blocks share an SM
        assert smem <= MAX_SMEM, launch
        assert MIN_BLOCKS * (smem + BLOCK_RESERVED) <= SM_SMEM, launch


def _check_own_rows(geo: SplitGeometry):
    """Every (sequence, head, own row < S) is computed by exactly one warp of one block."""
    _, _, b, h, row0 = geo.warp_rows()
    owners = np.zeros((geo.batch, geo.heads, geo.row_tiles * SPLIT_ROWS), dtype=np.int32)
    for r in range(16):
        np.add.at(owners, (b, h, row0 + r), 1)
    assert (owners[:, :, : geo.seq] == 1).all()
    assert (owners[:, :, geo.seq :] <= 1).all()  # the last tile's rows past S: computed, not stored


def _check_walks(geo: SplitGeometry, walks: int, kt: int, v_each_walk: bool, v_read_each_walk: bool):
    """Each walk stages every tile of the other side once, alternating buffers, so
    that step n + 1's copies never land in the buffer step n reads, and v (dO on
    the key side) in every step that reads it; the chunks a warp takes cover rows
    0 .. S - 1 once a walk, each within its tile and in one 64-bit word of key bits."""
    steps = geo.steps(walks, v_each_walk)
    assert len(steps) == walks * geo.tiles
    for (n, _, _, buf, _), (m, _, _, nxt, _) in zip(steps, steps[1:]):
        assert m == n + 1 and nxt != buf
    for walk in range(walks):
        seen = np.zeros(geo.tiles * SPLIT_TILE, dtype=np.int32)
        for n, tile, first, _, with_v in steps[walk * geo.tiles : (walk + 1) * geo.tiles]:
            assert first == tile * SPLIT_TILE and first < geo.seq
            assert with_v or not (v_read_each_walk or walk == walks - 1)
            for lc, row, n16 in geo.tile_chunks(first, kt):
                assert 1 <= n16 <= kt and lc + 16 * n16 <= SPLIT_TILE
                assert row // 64 == (row + 16 * n16 - 1) // 64  # one word of key bits
                seen[row : row + 16 * n16] += 1
        # rows past S only in the last 16-row step: zero-filled, their scores -inf
        rows16 = -(-geo.seq // 16) * 16
        assert (seen[: geo.seq] == 1).all() and (seen[geo.seq : rows16] <= 1).all() and (seen[rows16:] == 0).all()


def _check_norm_rope(geo: SplitGeometry):
    """The LN + RoPE pass writes every (sequence, position, head) row of q~ and k~ once."""
    rows = geo.batch * geo.seq * geo.heads
    x = np.arange(geo.prep_grid)[:, None] * PREP_ROWS + np.arange(PREP_ROWS)[None, :]
    written = x[x < rows]
    assert written.size == rows and np.unique(written).size == rows


def check_split(kind: str, B: int, S: int, H: int, D: int):
    """Hold the split launches of one kernel at (B, S, H, D) to their design.

    kind: "fused" (#1: the LN + RoPE pass, then one walk over k and v),
    "flash" (#5: two walks, v on the second), "fused_bwd" (#3: the pass, then
    both sides), "flash_bwd" (#6: both sides)."""
    geo = SplitGeometry(B, S, H, D)
    _check_launch(geo)
    _check_own_rows(geo)
    if kind in ("fused", "fused_bwd"):
        _check_norm_rope(geo)
    if kind == "fused":  # one walk, P.V online
        _check_walks(geo, walks=1, kt=SPLIT_TILE // 16, v_each_walk=False, v_read_each_walk=True)
    elif kind == "flash":  # the statistics walk reads no v
        _check_walks(geo, walks=2, kt=SPLIT_TILE // 16, v_each_walk=False, v_read_each_walk=False)
    else:  # the query side's two walks both read v (dP); the key side reads dO, 16 queries at a time
        _check_walks(geo, walks=2, kt=BWD_KT, v_each_walk=True, v_read_each_walk=True)
        _check_walks(geo, walks=1, kt=1, v_each_walk=True, v_read_each_walk=True)
    return geo
