"""The wgmma tile variant of the bf16 fused attention backward (#3 at 64 < S <=
256, head dims 64 and 128; ``csrc/fused_attention_bwd_wg.cuh``), walked on the
CPU.

:class:`TileWgGeometry` mirrors ``tile_wg::launch_bwd`` and ``tile_wg::layout``
(grid, warpgroups, shared memory, TMA boxes) and deals out the work as
``tile_wg_bwd_kernel`` does: the 64-row tiles to the consumer warpgroups in
rounds on each side, the query side's key tiles walked twice, the key side's
query tiles once, and at head dim 128 the producer's own tiles and ring steps
in the order the consumers take them. :func:`check_tile_wg` holds one shape
to it. ``tests/test_torch_attention_bwd_plan.py`` calls it at every shape the
plan gives this variant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from video_vae_tpu_torch.ops.flash_attention import (
    BWD_SLAB_MAX_SEQ,
    BWD_TILE_WG_WARPS,
    TILE_MAX_SEQ,
    WGMMA_HEAD_DIMS,
    fused_attention_bwd_plan,
)

from helpers.split_geometry import (
    ALIGN,
    CONSUMER_REGS,
    CONSUMERS,
    MAX_GRID_X,
    MAX_SMEM,
    PANEL,
    PRODUCER_REGS,
    SM_REGS,
    SM_SMEM,
    BLOCK_RESERVED,
    key_tile,
)

# the header's constants (namespace tile_wg): rows of a tile (a consumer warpgroup's),
# the ring's stages at head dim 128, the named barrier of the two consumer warpgroups,
# the f32 columns of a RoPE table's box (128 bytes), and the most bytes one mbarrier
# phase can expect (its tx-count, 20 bits)
ROWS, STAGES, CONSUMER_BAR, TABLE_COLS, MAX_TX = 64, 3, 1, 32, 2**20 - 1


@dataclasses.dataclass(frozen=True)
class TileWgGeometry:
    """One launch of ``tile_wg_bwd_kernel``: one block a (sequence, head) pair."""

    batch: int
    seq: int
    heads: int
    head_dim: int

    @property
    def stream(self) -> bool:
        """v and dO stream through the own buffers and the ring (head dim 128)."""
        return self.head_dim == 128

    @property
    def grid(self) -> int:
        return self.batch * self.heads

    @property
    def threads(self) -> int:
        return 128 * (CONSUMERS + 1)  # the consumer warpgroups, then the producer

    @property
    def tiles(self) -> int:
        """64-row tiles holding the S rows (``tiles_of``)."""
        return -(-self.seq // ROWS)

    @property
    def key_tile(self) -> int:
        return key_tile(self.head_dim)

    @property
    def key_tiles(self) -> int:
        return -(-self.seq // self.key_tile)

    @property
    def resident_rows(self) -> int:
        """Rows of each resident array: S rounded up to the query side's key tile."""
        return self.key_tiles * self.key_tile

    @property
    def rounds(self) -> int:
        return -(-self.tiles // CONSUMERS)

    @property
    def boxes(self) -> int:
        """TMA boxes of a 64-row tile: D / 64 panels of 64 columns (128 bytes)."""
        return self.head_dim // PANEL

    @property
    def tile_bytes(self) -> int:
        return self.boxes * ROWS * PANEL * 2

    @property
    def epi_bytes(self) -> int:
        """Head dim 64: a warpgroup's epilogue staging, the raw x rows of its tile
        (one bf16 tile) and their cos and sin rows (64 x D f32 each); 0 at 128."""
        return 0 if self.stream else self.tile_bytes + 2 * ROWS * self.head_dim * 4

    @property
    def layout(self) -> dict[str, tuple[int, int]]:
        """(offset, bytes) of each region from the aligned base, as ``layout``."""
        arr = self.resident_rows // ROWS * self.tile_bytes
        regions = {"q": arr, "k": arr}
        if self.stream:
            regions.update(own=CONSUMERS * self.tile_bytes, ring=STAGES * self.tile_bytes)
        else:
            regions.update(v=arr, g=arr, epi=CONSUMERS * self.epi_bytes)
        regions.update(stats=3 * self.resident_rows * 4, red=4 * CONSUMERS * 2 * self.head_dim * 4,
                       bars=8 * (1 + 2 * CONSUMERS + (2 * STAGES if self.stream else 1)))
        out, at = {}, 0
        for name, size in regions.items():
            out[name] = (at, size)
            at += size
        return out

    @property
    def smem(self) -> int:
        at, size = self.layout["bars"]
        return ALIGN + at + size

    def box(self, part: str, head: int, panel: int, row0: int, b: int) -> tuple[str, int, int, int]:
        """(map, first column, first row, sequence) of one TMA box: the fused qkv
        map's q, k and v of head h at column blocks h, H + h and 2 H + h (in heads),
        dO's map at h; the RoPE tables' (``cos``, ``sin``: the pair's own rows, any
        sequence) in boxes of 32 f32 columns."""
        H, D = self.heads, self.head_dim
        if part in ("cos", "sin"):
            return (part, panel * TABLE_COLS, row0, 0)
        block = {"q": head, "k": H + head, "v": 2 * H + head, "g": head}[part]
        return ("g" if part == "g" else "qkv", block * D + panel * PANEL, row0, b)

    def producer(self, b: int, h: int):
        """Every TMA box of pair (b, h) in issue order: (mbarrier, destination
        region and tile slot, box)."""
        out = []
        for t in range(self.tiles):
            for part in ("q", "k"):
                out += [("qk_full", (part, t), self.box(part, h, p, ROWS * t, b)) for p in range(self.boxes)]
        if not self.stream:
            for t in range(self.tiles):
                for part in ("v", "g"):
                    out += [("vg_full", (part, t), self.box(part, h, p, ROWS * t, b)) for p in range(self.boxes)]
            for side, part in ((0, "q"), (1, "k")):  # each epilogue's staging: x, cos and sin rows
                for _, w, t in self.dealt("query" if side == 0 else "key"):
                    out += [(f"epi_full{w}", ("epi", w, part), self.box(part, h, p, ROWS * t, b))
                            for p in range(self.boxes)]
                    for table in ("cos", "sin"):
                        out += [(f"epi_full{w}", ("epi", w, table), self.box(table, h, p, ROWS * t, b))
                                for p in range(self.head_dim // TABLE_COLS)]
            return out
        n = 0
        for own_part, walk_part, steps in (("g", "v", 2 * self.key_tiles), ("v", "g", self.tiles)):
            for r in range(self.rounds):
                for w in range(CONSUMERS):
                    t = CONSUMERS * r + w
                    if t < self.tiles:
                        out += [(f"own_full{w}", ("own", w), self.box(own_part, h, p, ROWS * t, b))
                                for p in range(self.boxes)]
                for s in range(steps):
                    row0 = ROWS * (s % self.tiles)
                    out += [(f"full{n % STAGES}", ("ring", n % STAGES), self.box(walk_part, h, p, row0, b))
                            for p in range(self.boxes)]
                    n += 1
        return out

    def dealt(self, side: str):
        """(round, warpgroup, tile) of every tile a consumer warpgroup takes on one side."""
        return [(r, w, CONSUMERS * r + w) for r in range(self.rounds) for w in range(CONSUMERS)
                if CONSUMERS * r + w < self.tiles]

    def query_steps(self):
        """(step, first key) of a query tile's two walks over the key tiles."""
        return [(n, (n % self.key_tiles) * self.key_tile) for n in range(2 * self.key_tiles)]

    def own_waits(self):
        """(warpgroup, side, round, parity the producer waits on the warpgroup's
        ``own_empty`` (at head dim 64 ``epi_empty``), parity the warpgroup waits on
        its ``own_full`` (``epi_full``), tiles it took before) of each own tile at
        head dim 128, each epilogue staging at 64: the producer counts a warpgroup's
        earlier loads as ``r + side * (T - w + 1) // 2``, the warpgroup counts its
        takes."""
        out = []
        for w in range(CONSUMERS):
            taken = 0
            for side in (0, 1):
                for r in range(self.rounds):
                    if CONSUMERS * r + w >= self.tiles:
                        continue
                    before = r + side * ((self.tiles - w + 1) // 2)
                    out.append((w, side, r, (before & 1) ^ 1, taken & 1, taken))
                    taken += 1
        return out

    def ring_steps(self):
        """(warpgroup, step, what it holds) of every ring step each consumer warpgroup
        takes at head dim 128, in its order; an idle warpgroup's round still takes them."""
        out = []
        for w in range(CONSUMERS):
            n = 0
            for walk_part, steps in (("v", 2 * self.key_tiles), ("g", self.tiles)):
                for _ in range(self.rounds):
                    for s in range(steps):
                        out.append((w, n, (walk_part, s % self.tiles)))
                        n += 1
        return out


def _check_launch(geo: TileWgGeometry):
    assert fused_attention_bwd_plan(geo.batch, geo.seq, geo.heads, geo.head_dim) == ("tile_wg", 1, BWD_TILE_WG_WARPS)
    assert BWD_TILE_WG_WARPS == geo.threads // 32 == 12
    assert 1 <= geo.grid <= MAX_GRID_X
    assert geo.head_dim in WGMMA_HEAD_DIMS and BWD_SLAB_MAX_SEQ < geo.seq <= TILE_MAX_SEQ
    # one block an SM: its shared memory, and registers at the launch bounds (384, 1)
    # that setmaxnreg moves from the producer to the consumers
    assert geo.smem <= MAX_SMEM and geo.smem + BLOCK_RESERVED <= SM_SMEM
    assert 128 * (CONSUMERS * CONSUMER_REGS + PRODUCER_REGS) <= SM_REGS
    layout = geo.layout
    for name, (at, size) in layout.items():  # swizzled tiles on 1024 bytes, mbarriers on 8
        assert at % (ALIGN if name in ("q", "k", "v", "g", "own", "ring") else 8) == 0, name
        assert size % (geo.tile_bytes if name in ("q", "k", "v", "g", "own", "ring") else 8) == 0, name
    ends = sorted((at, at + size) for at, size in layout.values())
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))  # no two regions overlap
    # every byte of an mbarrier phase: the q and k tiles (and at 64 v and dO) in one phase each
    assert 2 * geo.tiles * geo.tile_bytes <= MAX_TX
    # the tensor maps' rule: 16-byte row strides (bytes) at the fused qkv's and dO's
    HD = geo.heads * geo.head_dim
    assert (3 * HD * 2) % 16 == 0 and (HD * 2) % 16 == 0


def _check_boxes(geo: TileWgGeometry):
    """Every box lies inside its map's columns and sequences and starts below S;
    rows past S read as zeros (the box's tail past the map's S rows)."""
    HD = geo.heads * geo.head_dim
    cols = {"qkv": 3 * HD, "g": HD, "cos": geo.head_dim, "sin": geo.head_dim}
    for b in {0, geo.batch - 1}:
        for h in {0, geo.heads - 1}:
            loads = geo.producer(b, h)
            for _, _, (mp, col, row0, seq) in loads:
                width = TABLE_COLS if mp in ("cos", "sin") else PANEL  # 128 bytes either way
                assert 0 <= col and col + width <= cols[mp] and col % width == 0
                assert 0 <= row0 < geo.seq and row0 % ROWS == 0 and seq == (0 if mp in ("cos", "sin") else b)
            # the q and k of the pair's head, its v and dO, never a neighbour's columns
            columns = {(mp, col // geo.head_dim) for _, _, (mp, col, _, _) in loads if mp in ("qkv", "g")}
            assert columns == {("qkv", h), ("qkv", geo.heads + h), ("qkv", 2 * geo.heads + h), ("g", h)}
            per_bar = {}
            for bar, _, _ in loads:
                per_bar[bar] = per_bar.get(bar, 0) + ROWS * 128
            for w in range(CONSUMERS):  # an epilogue staging's phase: its x tile and both tables
                if f"epi_full{w}" in per_bar:
                    uses = sum(1 for ww, *_ in geo.own_waits() if ww == w)
                    assert per_bar[f"epi_full{w}"] == uses * geo.epi_bytes
            assert per_bar["qk_full"] == 2 * geo.tiles * geo.tile_bytes
            if not geo.stream:
                assert per_bar["vg_full"] == 2 * geo.tiles * geo.tile_bytes


def _check_rows(geo: TileWgGeometry):
    """On each side every row < S of the pair is in exactly one tile one warpgroup
    takes; no row at or past S is written (each writer skips i >= S)."""
    for side in ("query", "key"):
        owners = np.zeros(geo.tiles * ROWS, dtype=np.int32)
        for r, w, tile in geo.dealt(side):
            assert 0 <= w < CONSUMERS and tile == CONSUMERS * r + w
            owners[tile * ROWS : (tile + 1) * ROWS] += 1
        assert (owners == 1).all()
        written = np.zeros(geo.tiles * ROWS, dtype=np.int32)
        for _, _, tile in geo.dealt(side):
            rows = np.arange(tile * ROWS, (tile + 1) * ROWS)
            written[rows[rows < geo.seq]] += 1
        assert (written[: geo.seq] == 1).all() and (written[geo.seq :] == 0).all()


def _check_walks(geo: TileWgGeometry):
    """A query tile's walks each take every key j < S once, in key tiles that lie in
    the resident rows; the rows past the loaded tiles are the zeroed ones; the key
    side's query tiles are the loaded ones."""
    steps = geo.query_steps()
    for walk in range(2):
        seen = np.zeros(geo.resident_rows, dtype=np.int32)
        for _, j0 in steps[walk * geo.key_tiles : (walk + 1) * geo.key_tiles]:
            assert j0 % geo.key_tile == 0 and j0 + geo.key_tile <= geo.resident_rows
            seen[j0 : j0 + geo.key_tile] += 1
        assert (seen == 1).all()
    loaded = geo.tiles * ROWS
    assert geo.seq <= loaded <= geo.resident_rows and (geo.resident_rows - loaded) in (0, ROWS)
    assert loaded == geo.resident_rows or not geo.stream  # at 128 the key tile is a 64-row tile
    # the key side's query tiles and the statistics rows it reads: the loaded ones
    assert geo.tiles * ROWS <= geo.resident_rows


def _check_ring(geo: TileWgGeometry):
    """At head dim 128: both warpgroups take the ring's steps in the producer's order
    (an idle warpgroup in the last round too), so step n holds what its consumers
    expect, and the producer refills a stage only after the phase step n - STAGES's
    releases completed; each warpgroup's own tile is the one its round deals it. At
    64: each epilogue's staging holds the tile's rows of its side, filled after the
    warpgroup's release of the last one."""
    if not geo.stream:
        assert geo.layout.keys() >= {"v", "g", "epi"}
        loads = [(bar, dest, box) for bar, dest, box in geo.producer(0, 0) if bar.startswith("epi")]
        per_wg = {}
        for bar, (_, w, part), (mp, col, row0, _) in loads:
            assert bar == f"epi_full{w}" and (mp == part or (mp == "qkv" and part in "qk"))
            if mp == "qkv":
                per_wg.setdefault(w, []).append((part, row0 // ROWS))
        for w in range(CONSUMERS):
            want = [(part, t) for part, side in (("q", "query"), ("k", "key")) for _, ww, t in geo.dealt(side)
                    if ww == w]
            assert per_wg.get(w, []) == want
        for w, side, r, empty_parity, full_parity, taken in geo.own_waits():
            assert empty_parity == (taken - 1) & 1 and full_parity == taken & 1, (w, side, r)
        assert 2 * ROWS * geo.head_dim * 4 == 2 * (geo.head_dim // TABLE_COLS) * ROWS * TABLE_COLS * 4
        return
    ring = [(dest, box) for bar, dest, box in geo.producer(0, 0) if bar.startswith("full")]
    ring = ring[:: geo.boxes]  # one entry a step
    for w, n, (part, tile) in geo.ring_steps():
        dest, (mp, col, row0, _) = ring[n]
        assert dest == ("ring", n % STAGES)
        assert (part == "g") == (mp == "g") and row0 == ROWS * tile
    per_wg = {}
    for w, n, _ in geo.ring_steps():
        per_wg.setdefault(w, []).append(n)
    assert all(ns == list(range(len(ring))) for ns in per_wg.values())
    own = [(dest, box) for bar, dest, box in geo.producer(0, 0) if bar.startswith("own")][:: geo.boxes]
    want = [(("own", w), tile) for part in ("g", "v") for _, w, tile in geo.dealt("query")]
    assert [(dest, box[2] // ROWS) for dest, box in own] == want
    # the producer refills a warpgroup's own buffer only after the release of its last
    # tile (the phase its `taken`-th release completes), and the warpgroup waits for
    # the fill of its `taken + 1`-th tile
    for w, side, r, empty_parity, full_parity, taken in geo.own_waits():
        assert empty_parity == (taken - 1) & 1 and full_parity == taken & 1, (w, side, r)


def check_tile_wg(B: int, S: int, H: int, D: int) -> TileWgGeometry:
    """Hold the wgmma tile launch of #3 at (B, S, H, D) to its design."""
    geo = TileWgGeometry(B, S, H, D)
    _check_launch(geo)
    _check_boxes(geo)
    _check_rows(geo)
    _check_walks(geo)
    _check_ring(geo)
    return geo
