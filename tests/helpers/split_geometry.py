"""The split variant of the bf16 attention kernels (``csrc/attention_split.cuh``
at head dims 16 and 32; at 64 and 128 the forward of
``csrc/attention_split_fwd.cuh`` and the backward of
``csrc/attention_split_bwd.cuh``), walked on the CPU: the geometry each
launch derives from the plan and the shape, and the rows, tiles, buffers and
chunks its blocks and warps take.

:class:`SplitGeometry` mirrors ``launch_fwd`` / ``launch_bwd`` /
``launch_norm_rope`` (grid, warps, shared memory) and deals out the work as
``split_fwd_kernel``, ``split_bwd_query_kernel``, ``split_bwd_key_kernel``
and ``qk_norm_rope_kernel`` do; :class:`WgmmaFwdGeometry` mirrors
``split_wg::launch_fwd`` (grid, warpgroups, ring stages and what each
stage's `full` mbarrier expects, TMA boxes, shared memory, registers, the
warpgroups' turns) and the steps of ``split_wg_fwd_kernel``;
:class:`WgmmaBwdGeometry` mirrors ``split_wg::launch_bwd`` (grid,
warpgroups, ring stages, TMA boxes, shared memory, registers, which loads are
TMA and which cp.async) and the steps of ``split_wg_query_kernel`` and
``split_wg_key_kernel``; :func:`check_split` holds one shape to them. The
plan tests of #1, #3, #5, #6 and #7 call it at the long sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from video_vae_tpu_torch.ops.flash_attention import (
    SPLIT_BWD_ROWS,
    SPLIT_BWD_WARPS,
    SPLIT_ROWS,
    SPLIT_WARPS,
    WGMMA_HEAD_DIMS,
    mma_max_warps,
    mma_row_bytes,
    split_bwd_grid,
    split_bwd_warps,
    split_fwd_grid,
    split_fwd_warps,
    split_grid,
)

# what the H100 accepts of one block and one grid; an SM's shared memory and what
# the runtime keeps of it for each resident block
MAX_SMEM, MAX_GRID_X, SM_SMEM, BLOCK_RESERVED = 232448, 2**31 - 1, 233472, 1024
# the header's constants: rows of the other side staged a step (split::TILE_ROWS),
# blocks an SM the launch bounds ask for (split::MIN_BLOCKS), head rows a block of
# the LN + RoPE pass takes (split::PREP_ROWS), 16-key steps of a backward
# query-side chunk (bwd::TILE_KT)
SPLIT_TILE, MIN_BLOCKS, PREP_ROWS, BWD_KT = 64, 2, 64, 2

# attention_split_bwd.cuh's constants (namespace split_wg): own rows of a consumer
# warpgroup, consumer warpgroups a block, queries a key-side ring stage holds, ring
# stages, the columns of a TMA box (128 bytes, the swizzle span), the alignment a
# swizzled tile starts on, and the registers setmaxnreg gives the producer and the
# consumers; keys a query-side stage holds: key_tile(D)
WG_ROWS, CONSUMERS, QUERY_TILE, STAGES, PANEL, ALIGN = 64, 2, 64, 3, 64, 1024
PRODUCER_REGS, CONSUMER_REGS, SM_REGS, MAX_REGS = 40, 232, 65536, 255
# attention_split_fwd.cuh's: the forward's ring stages, the first of the two named
# barriers that hand the warpgroups their turns (the epilogue's are 1 + warpgroup),
# and the barriers an SM has
FWD_STAGES, TURN_BAR, NAMED_BARRIERS = 3, 3, 16

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


def key_tile(head_dim: int) -> int:
    """Keys a query-side ring stage holds (``split_wg::KEY_TILE``): 128 at head dim
    64, 64 at 128 (where a tile's f32 scores and dP beside dq fit the registers)."""
    return 128 if head_dim == 64 else 64


@dataclasses.dataclass(frozen=True)
class WgmmaBwdGeometry:
    """The split backward's two launches at head dims 64 and 128 (``split_wg``)."""

    batch: int
    seq: int
    heads: int
    head_dim: int

    @property
    def pairs(self) -> int:
        return self.batch * self.heads

    @property
    def row_tiles(self) -> int:
        """Blocks of a pair: ``split_wg::row_tiles``, BLOCK_ROWS own rows each."""
        return -(-self.seq // (WG_ROWS * CONSUMERS))

    def tiles(self, side: str) -> int:
        """Tiles of the other side a walk streams (``split_wg::tiles_of``)."""
        return -(-self.seq // self.stream_rows(side))

    def stream_rows(self, side: str) -> int:
        return key_tile(self.head_dim) if side == "query" else QUERY_TILE

    @property
    def grid(self) -> int:
        return self.pairs * self.row_tiles

    @property
    def threads(self) -> int:
        return 128 * (CONSUMERS + 1)  # the consumer warpgroups, then the producer

    @property
    def boxes(self) -> int:
        """TMA boxes of one tile of one operand: D / 64 panels of 64 columns (128 bytes)."""
        return self.head_dim // PANEL

    def tile_bytes(self, rows: int) -> int:
        return self.boxes * rows * PANEL * 2

    @property
    def smem(self) -> dict[str, int]:
        """Each launch's dynamic shared memory, from the header's layout: the
        alignment slack, own rows of two operands, the ring, (key side) the
        ring's statistics, the mbarriers (own, full and empty a stage)."""
        own = 2 * CONSUMERS * self.tile_bytes(WG_ROWS)
        bars = (1 + 2 * STAGES) * 8
        return {"query_side": ALIGN + own + STAGES * 2 * self.tile_bytes(self.stream_rows("query")) + bars,
                "key_side": ALIGN + own + STAGES * 2 * self.tile_bytes(QUERY_TILE) + STAGES * 3 * QUERY_TILE * 4
                + bars}

    def stage_bytes(self, side: str) -> int:
        """Bytes a ring stage's `full` mbarrier expects from TMA: two operand tiles."""
        return 2 * self.tile_bytes(self.stream_rows(side))

    def live(self, row0: int) -> int:
        """Consumer warpgroups with own rows below S (``Block::live``)."""
        return min(CONSUMERS, -(-(self.seq - row0) // WG_ROWS))

    def blocks(self):
        """(block, sequence, head, first own row) of every block, vectorised."""
        x = np.arange(self.grid)
        pair, tile = np.divmod(x, self.row_tiles)
        return x, pair // self.heads, pair % self.heads, tile * WG_ROWS * CONSUMERS

    def steps(self, side: str, walks: int):
        """(step, tile, first row, stage, parity the consumers wait on `full`,
        parity the producer waits on `empty`) of each step of a block's walks."""
        tiles, rows = self.tiles(side), self.stream_rows(side)
        return [(n, n % tiles, (n % tiles) * rows, n % STAGES, (n // STAGES) & 1, ((n // STAGES) & 1) ^ 1)
                for n in range(walks * tiles)]


@dataclasses.dataclass(frozen=True)
class WgmmaFwdGeometry:
    """The split forward's launches at head dims 64 and 128 (``split_wg::launch_fwd``):
    #1 and #7's attention (``normalize=False``: one launch, ONLINE) and #5 (two:
    STATS, which streams k alone and parks each row's max and 1/l in its own
    output row, then NORMALIZED)."""

    batch: int
    seq: int
    heads: int
    head_dim: int
    normalize: bool

    @property
    def pairs(self) -> int:
        return self.batch * self.heads

    @property
    def row_tiles(self) -> int:
        """Blocks of a pair: 64 query rows for each of two consumer warpgroups."""
        return -(-self.seq // (WG_ROWS * CONSUMERS))

    @property
    def grid(self) -> int:
        return self.pairs * self.row_tiles

    @property
    def threads(self) -> int:
        return 128 * (CONSUMERS + 1)

    @property
    def key_tile(self) -> int:
        return key_tile(self.head_dim)

    @property
    def tiles(self) -> int:
        """Key tiles a walk streams (``split_wg::tiles_of``)."""
        return -(-self.seq // self.key_tile)

    @property
    def launches(self) -> tuple[str, ...]:
        return ("stats", "normalized") if self.normalize else ("online",)

    @property
    def boxes(self) -> int:
        return self.head_dim // PANEL

    def tile_bytes(self, rows: int) -> int:
        return self.boxes * rows * PANEL * 2

    @property
    def smem(self) -> int:
        """The alignment slack, the own q rows (each warpgroup's output leaves
        through them), the ring of k and v tiles, the mbarriers (own, full and
        empty a stage)."""
        return (ALIGN + CONSUMERS * self.tile_bytes(WG_ROWS) + FWD_STAGES * 2 * self.tile_bytes(self.key_tile)
                + (1 + 2 * FWD_STAGES) * 8)

    def steps(self, launch: str):
        """(step, key tile, first key, stage, parity the consumers wait on `full`,
        parity the producer waits on `empty`, bytes `full` expects) of each step
        of a block of ``launch``: every launch walks the key tiles once, through
        a ring of fresh mbarriers."""
        kb = self.tile_bytes(self.key_tile) * (1 if launch == "stats" else 2)
        return [(n, n, n * self.key_tile, n % FWD_STAGES, (n // FWD_STAGES) & 1, ((n // FWD_STAGES) & 1) ^ 1, kb)
                for n in range(self.tiles)]

    def stat_slot(self, b: int, i: int, h: int) -> tuple[int, int]:
        """Bytes [first, last) of the output (B, S, H, D) bf16 where #5's first
        launch parks row (b, i, h)'s max and 1/l (two f32): the row's own output
        row, which only its own block's second launch reads and then overwrites."""
        first = ((b * self.seq + i) * self.heads + h) * self.head_dim * 2
        return first, first + 8

    def live(self, row0: int) -> int:
        return min(CONSUMERS, -(-(self.seq - row0) // WG_ROWS))

    def turns(self, live: int, launch: str) -> list[int]:
        """The order in which a block's warpgroups issue their products: with both
        live each takes one turn a step (and one for the last P.V, but in the
        statistics launch), warpgroup 0 first, each turn waited on its own named
        barrier (``TURN_BAR`` + warpgroup) and handed over on the other's; a lone
        warpgroup takes no turns. Walks the barriers: raises if a turn would wait
        on an arrival that never comes, or an arrival is left over."""
        if live < CONSUMERS:
            return []
        n_turns = self.tiles + (0 if launch == "stats" else 1)
        arrivals = {TURN_BAR: CONSUMERS - 1, TURN_BAR + 1: 0}  # warpgroup 1 lets 0 go first
        taken, order = [0, 0], []
        while min(taken) < n_turns:
            moved = False
            for wg in range(CONSUMERS):
                if taken[wg] < n_turns and arrivals[TURN_BAR + wg] > 0:
                    arrivals[TURN_BAR + wg] -= 1
                    taken[wg] += 1
                    order.append(wg)
                    if wg == 0 or taken[wg] < n_turns:  # warpgroup 1's last turn hands over nothing
                        arrivals[TURN_BAR + 1 - wg] += 1
                    moved = True
                    break
            assert moved, "a warpgroup waits on a turn that never comes"
        assert arrivals == {TURN_BAR: 0, TURN_BAR + 1: 0}, arrivals
        return order


def _check_wgmma_fwd(geo: WgmmaFwdGeometry, kind: str):
    """The forward's launch: grid, warps, boxes, shared memory, registers,
    operands; every own row in exactly one live warpgroup; the ring's steps and
    parities; the warpgroups' turns."""
    assert geo.grid == split_fwd_grid(geo.batch, geo.seq, geo.heads, geo.head_dim) <= MAX_GRID_X
    assert split_fwd_warps(geo.head_dim) == SPLIT_BWD_WARPS == geo.threads // 32
    assert PANEL * 2 == 128 and geo.boxes * PANEL == geo.head_dim
    assert geo.key_tile % 64 == 0 and geo.key_tile <= 256 and (geo.key_tile * PANEL * 2) % ALIGN == 0
    # one block an SM; the own q tile of a warpgroup holds its 64 x D bf16 output
    assert geo.smem <= MAX_SMEM and geo.smem + BLOCK_RESERVED <= SM_SMEM
    assert geo.smem == {64: 115768, 128: 132152}[geo.head_dim]
    assert geo.tile_bytes(WG_ROWS) == WG_ROWS * geo.head_dim * 2
    # a consumer's registers: the scores of a tile (f32), P of the last tile (bf16
    # fragments, in flight under the scores), O (f32) and at head dim 64 q's
    # fragments, under setmaxnreg's CONSUMER_REGS with room for the rest
    own = geo.head_dim // 4 if geo.head_dim == 64 else 0
    regs = geo.key_tile // 2 + geo.key_tile // 4 + geo.head_dim // 2 + own
    assert regs == {64: 144, 128: 112}[geo.head_dim] and regs <= 192 < CONSUMER_REGS
    # named barriers: the epilogue's 1 + warpgroup and the two turns, none of them 0
    assert TURN_BAR > CONSUMERS and TURN_BAR + CONSUMERS <= NAMED_BARRIERS
    for name, (stride, offset) in tma_operands(kind, geo.batch, geo.seq, geo.heads, geo.head_dim).items():
        assert loads(stride, offset) == "tma", name
    owners = np.zeros((geo.pairs, geo.row_tiles * WG_ROWS * CONSUMERS), dtype=np.int32)
    for x in range(geo.grid):
        pair, row0 = divmod(x, geo.row_tiles)
        row0 *= WG_ROWS * CONSUMERS
        live = geo.live(row0)
        assert 1 <= live <= CONSUMERS
        for w in range(live):
            owners[pair, row0 + w * WG_ROWS : row0 + (w + 1) * WG_ROWS] += 1
        assert all(row0 + w * WG_ROWS >= geo.seq for w in range(live, CONSUMERS))
    assert (owners[:, : geo.seq] == 1).all()
    for launch in geo.launches:
        completed = {}
        steps = geo.steps(launch)
        assert [s[1] for s in steps] == list(range(geo.tiles))
        for n, tile, first, stage, full_parity, empty_parity, expect in steps:
            assert first == tile * geo.key_tile and first < geo.seq
            uses = completed.get(stage, 0)
            assert empty_parity == (uses - 1) & 1 and full_parity == uses & 1
            completed[stage] = uses + 1
            # the statistics launch streams k alone; a P.V walk k and v
            assert expect == geo.tile_bytes(geo.key_tile) * (1 if launch == "stats" else 2)
        # the turns alternate, each warpgroup one a step and (P.V) one for the last P.V
        order = geo.turns(CONSUMERS, launch)
        assert order == [0, 1] * (geo.tiles + (0 if launch == "stats" else 1))
        assert geo.turns(1, launch) == []
    assert (geo.tiles - 1) * geo.key_tile < geo.seq <= geo.tiles * geo.key_tile
    if geo.normalize:  # every row's statistics in its own output row: disjoint, inside the output
        slots = [geo.stat_slot(b, i, h) for b in (0, geo.batch - 1) for i in (0, geo.seq - 1) for h in (0, geo.heads - 1)]
        out_bytes = geo.batch * geo.seq * geo.heads * geo.head_dim * 2
        assert all(first % 8 == 0 and last <= out_bytes for first, last in slots)
        assert len({first // (geo.head_dim * 2) for first, _ in slots}) == len(set(slots))


def tma_operands(kind: str, B: int, S: int, H: int, D: int) -> dict[str, tuple[int, int]]:
    """(row stride, offset of the base from its allocation), in bytes, of each
    operand a split launch at head dims 64 and 128 reads or writes by TMA. #3
    (``fused_attention_bwd.cu:launch_split``): q~ and k~ in the f32 workspace
    after dq~ and dk~ (B H S D floats each), k~ after q~; v a view into the
    fused qkv at 2 H D, rows 3 H D apart; dO contiguous. #6: q, k and dO (B, S,
    H, D) and v a view into the fused qkv, as the model's pallas path hands them
    over and ``_rows_of_heads`` leaves them. The forward: #1 and #7's attention
    (``launch_split_fused_fwd``) the raw q rows and v, views into the fused qkv
    (the sublayer's own qkv scratch; rows 3 H D apart, at 0 and 2 H D), k~ the
    bf16 workspace (B S H D), the output (#7: its o scratch) contiguous; #5 q,
    k, v as #6's, the output contiguous."""
    HD, rows = H * D, B * H * S
    v = (6 * HD, 4 * HD)
    if kind == "fused_bwd":
        return {"q": (2 * HD, 8 * rows * D), "k": (2 * HD, 8 * rows * D + 2 * rows * D), "v": v, "g": (2 * HD, 0)}
    if kind in ("fused", "sublayer"):
        return {"q": (6 * HD, 0), "k": (2 * HD, 0), "v": v, "o": (2 * HD, 0)}
    if kind == "flash":
        return {"q": (2 * HD, 0), "k": (2 * HD, 0), "v": v, "o": (2 * HD, 0)}
    return {"q": (2 * HD, 0), "k": (2 * HD, 0), "v": v, "g": (2 * HD, 0)}


def loads(stride: int, offset: int) -> str:
    """The load an operand takes by the entry point's rule (``encode_rows``):
    TMA where its row stride and base are 16-byte multiples (bytes); the
    wrappers copy any other operand first (``_rows_of_heads``), as the mma.sync
    kernels' 16-byte cp.async needed, so no operand reaches the kernel else."""
    return "tma" if stride % 16 == 0 and offset % 16 == 0 else "copied first"


def _check_wgmma_launch(geo: WgmmaBwdGeometry, kind: str):
    assert geo.grid == split_bwd_grid(geo.batch, geo.seq, geo.heads, geo.head_dim) <= MAX_GRID_X
    assert split_bwd_warps(geo.head_dim) == SPLIT_BWD_WARPS == geo.threads // 32
    assert SPLIT_BWD_ROWS == WG_ROWS * CONSUMERS
    # the boxes: 128 bytes a row (the 128-byte swizzle's span), D / 64 a tile, at most
    # 256 rows; every tile and panel starts on the swizzle's 1024 bytes
    assert PANEL * 2 == 128 and geo.boxes * PANEL == geo.head_dim
    for side in ("query", "key"):
        rows = geo.stream_rows(side)
        assert rows <= 256 and rows % 64 == 0 and (rows * PANEL * 2) % ALIGN == 0
        assert geo.stage_bytes(side) == 2 * geo.head_dim * rows * 2
    for launch, smem in geo.smem.items():
        # none grows with S; one block an SM (384 threads at these registers)
        assert smem <= MAX_SMEM, launch
        assert smem + BLOCK_RESERVED <= SM_SMEM, launch
    assert (geo.smem["query_side"], geo.smem["key_side"]) == {64: (132152, 85304), 128: (164920, 167224)}[geo.head_dim]
    # registers at the launch bounds (384, 1): what the compiler gives every thread at
    # the launch, and what setmaxnreg moves from the producer to the consumers: a
    # consumer's f32 accumulators (the walk's two score tiles and one or two 64 x D
    # gradients, and at head dim 64 the own rows as A fragments) fit under CONSUMER_REGS
    at_bounds = SM_REGS // geo.threads // 8 * 8
    assert at_bounds == 168 and PRODUCER_REGS < at_bounds < CONSUMER_REGS <= MAX_REGS
    assert 128 * (CONSUMERS * CONSUMER_REGS + PRODUCER_REGS) <= SM_REGS
    assert PRODUCER_REGS % 8 == 0 and CONSUMER_REGS % 8 == 0
    own = 2 * geo.head_dim // 4 if geo.head_dim == 64 else 0  # the own rows' A fragments (OWN_IN_REGS)
    query_regs = 2 * geo.stream_rows("query") // 2 + geo.head_dim // 2 + own  # s, dP, dq a thread
    key_regs = 2 * QUERY_TILE // 2 + 2 * geo.head_dim // 2 + own  # s, dP, dv, dk a thread
    assert max(query_regs, key_regs) <= 192 < CONSUMER_REGS
    # every operand by TMA: row strides and bases 16-byte multiples; the key side's
    # statistics (f32 rows pair * S + i, 4-byte aligned at any S) by 4-byte cp.async
    for name, (stride, offset) in tma_operands(kind, geo.batch, geo.seq, geo.heads, geo.head_dim).items():
        assert loads(stride, offset) == "tma", name


def _check_wgmma_rows(geo: WgmmaBwdGeometry):
    """Every (sequence, head, own row < S) belongs to exactly one live consumer
    warpgroup of one block; a warpgroup whose rows are all past S is not live, and
    the `empty` mbarriers count one arrival for each warp of the live ones."""
    _, b, h, row0 = geo.blocks()
    owners = np.zeros((geo.batch, geo.heads, geo.row_tiles * WG_ROWS * CONSUMERS), dtype=np.int32)
    for x in range(geo.grid):
        live = geo.live(int(row0[x]))
        assert 1 <= live <= CONSUMERS
        for w in range(live):
            first = int(row0[x]) + w * WG_ROWS
            assert first < geo.seq
            owners[b[x], h[x], first : first + WG_ROWS] += 1
        for w in range(live, CONSUMERS):
            assert int(row0[x]) + w * WG_ROWS >= geo.seq
    assert (owners[:, :, : geo.seq] == 1).all()


def _check_wgmma_walks(geo: WgmmaBwdGeometry, side: str, walks: int):
    """Each walk streams every tile of the other side once, its keys in whole 64-bit
    words of key bits; a stage is refilled only after the consumers freed it: step
    n + STAGES waits on `empty` for the phase that step n's release completes."""
    steps = geo.steps(side, walks)
    tiles, rows = geo.tiles(side), geo.stream_rows(side)
    assert len(steps) == walks * tiles
    completed = {}  # stage -> times its `empty` phase completed (one per release)
    for n, tile, first, stage, full_parity, empty_parity in steps:
        assert first == tile * rows and first < geo.seq and first % 64 == 0
        uses = completed.get(stage, 0)
        # the producer's wait passes once `uses` phases completed: parity (uses - 1) & 1,
        # the fresh barrier's "previous" phase (parity 1) for the first use
        assert empty_parity == (uses - 1) & 1
        assert full_parity == uses & 1  # the consumers wait on this stage's (uses + 1)-th fill
        completed[stage] = uses + 1
    for walk in range(walks):
        seen = [t for _, t, *_ in steps[walk * tiles : (walk + 1) * tiles]]
        assert seen == list(range(tiles))
    # rows past S only in the last tile, zero-filled by TMA (their keys -inf, their P 0)
    assert (tiles - 1) * rows < geo.seq <= tiles * rows


def check_split(kind: str, B: int, S: int, H: int, D: int):
    """Hold the split launches of one kernel at (B, S, H, D) to their design.

    kind: "fused" (#1: the LN + RoPE pass, then one walk over k and v),
    "sublayer" (#7's attention: #1's), "flash" (#5: two walks, v on the
    second; two launches at head dims 64 and 128), "fused_bwd" (#3: the pass, then both sides), "flash_bwd" (#6:
    both sides). At head dims 64 and 128 the wgmma launches, at 16 and 32 the
    mma.sync ones."""
    if kind in ("fused", "sublayer", "flash") and D in WGMMA_HEAD_DIMS:
        wg = WgmmaFwdGeometry(B, S, H, D, normalize=kind == "flash")
        _check_wgmma_fwd(wg, kind)
        if kind != "flash":
            _check_norm_rope(SplitGeometry(B, S, H, D))
        return wg
    if kind in ("fused_bwd", "flash_bwd") and D in WGMMA_HEAD_DIMS:
        wg = WgmmaBwdGeometry(B, S, H, D)
        _check_wgmma_launch(wg, kind)
        _check_wgmma_rows(wg)
        _check_wgmma_walks(wg, "query", walks=2)  # statistics, then dq
        _check_wgmma_walks(wg, "key", walks=1)
        if kind == "fused_bwd":
            _check_norm_rope(SplitGeometry(B, S, H, D))
        return wg
    geo = SplitGeometry(B, S, H, D)
    _check_launch(geo)
    _check_own_rows(geo)
    if kind in ("fused", "sublayer", "fused_bwd"):
        _check_norm_rope(geo)
    if kind in ("fused", "sublayer"):  # one walk, P.V online
        _check_walks(geo, walks=1, kt=SPLIT_TILE // 16, v_each_walk=False, v_read_each_walk=True)
    elif kind == "flash":  # the statistics walk reads no v
        _check_walks(geo, walks=2, kt=SPLIT_TILE // 16, v_each_walk=False, v_read_each_walk=False)
    else:  # the query side's two walks both read v (dP); the key side reads dO, 16 queries at a time
        _check_walks(geo, walks=2, kt=BWD_KT, v_each_walk=True, v_read_each_walk=True)
        _check_walks(geo, walks=1, kt=1, v_each_walk=True, v_read_each_walk=True)
    return geo
