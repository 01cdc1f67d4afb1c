"""The wide variant of the attention kernels (``csrc/attention_wide.cuh``), walked
on the CPU: the grid, shared memory, stages and per-warp state its launches derive
from a head dim past 128 (padded to a multiple of ``CHUNK`` = 128) and the shape.

:class:`WideGeometry` mirrors ``wide::launch_fwd`` / ``launch_bwd`` /
``launch_fused_bwd`` (grids, warps, shared memory, the LN + RoPE backward's
partial rows, the workspaces the wrappers allocate) and deals out the stages of
``wide_fwd_kernel``, ``wide_stats_kernel``, ``wide_query_kernel`` and
``wide_key_kernel`` as their ``issue`` lambdas do; :func:`check_wide` holds one
shape to it.
"""

from __future__ import annotations

import dataclasses

from video_vae_tpu_torch.ops.flash_attention import (
    WIDE_CHUNK,
    WIDE_LN_ROWS,
    WIDE_ROWS,
    WIDE_WARPS,
    flash_attention_bwd_plan,
    flash_attention_plan,
    fused_attention_bwd_plan,
    fused_attention_plan,
    mma_row_bytes,
    wide_grid,
)

# what the H100 accepts of one block and one grid
MAX_SMEM, MAX_GRID_X = 232448, 2**31 - 1
# the header's constants: keys a forward or query-side stage holds, queries a
# key-side stage holds, f32 other-side rows a stage, f32 shared-memory row in floats
KEY_TILE, QUERY_TILE, F32_TILE, F32_ROW = 64, 32, 16, WIDE_CHUNK + 4
LANES = 32  # a warp's lanes, over which m16n8k16's accumulators spread (4 floats a lane a 16 x 8 tile)


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    batch: int
    seq: int
    heads: int
    head_dim: int  # Dp, a multiple of WIDE_CHUNK past 128

    @property
    def chunks(self) -> int:
        return self.head_dim // WIDE_CHUNK

    @property
    def own_tiles(self) -> int:
        return -(-self.seq // WIDE_ROWS)

    @property
    def grid(self) -> int:
        """Blocks of the forward, the query side and the key side: pairs x own tiles x chunks."""
        return self.batch * self.heads * self.own_tiles * self.chunks

    @property
    def stats_grid(self) -> int:
        return self.batch * self.heads * self.own_tiles

    @property
    def smem(self) -> int:
        """bf16: two buffers of two ROWS-row arrays of one chunk, 136-element rows."""
        return 2 * 2 * WIDE_ROWS * mma_row_bytes(WIDE_CHUNK)

    @property
    def f32_smem(self) -> int:
        """f32: two F32_TILE-row arrays of one chunk and the key side's statistics."""
        return (2 * F32_TILE * F32_ROW + 3 * F32_TILE) * 4

    @property
    def ln_partials(self) -> int:
        """Rows of #3's scale partials: one a warp of LN_ROWS head rows."""
        return -(-self.batch * self.seq * self.heads // WIDE_LN_ROWS)

    def block(self, index: int) -> tuple[int, int, int]:
        """(pair, first own row, chunk) of a block of the chunked launches."""
        item, ch = divmod(index, self.chunks)
        pair, tile = divmod(item, self.own_tiles)
        return pair, tile * WIDE_ROWS, ch

    def fwd_stages(self, normalize: bool) -> list[tuple[bool, int, object]]:
        """(statistics walk, first key, chunk of q and k, or "v") of each stage of
        the forward: with ``normalize`` a walk of the score stages alone first."""
        tiles = range(0, self.seq, KEY_TILE)
        first = [(True, j0, c) for j0 in tiles for c in range(self.chunks)] if normalize else []
        return first + [(False, j0, c) for j0 in tiles for c in (*range(self.chunks), "v")]

    def query_stages(self) -> list[tuple[int, object]]:
        """(first key, (part, chunk) or "k") of each stage of the query side: the
        statistics launch takes the same without the "k" stages."""
        return [(j0, kind) for j0 in range(0, self.seq, KEY_TILE)
                for kind in (*((p, c) for p in ("qk", "dov") for c in range(self.chunks)), "k")]

    def key_stages(self) -> list[tuple[int, object]]:
        """(first query, (part, chunk) or "q,dO") of each stage of the key side."""
        return [(i0, kind) for i0 in range(0, self.seq, QUERY_TILE)
                for kind in (*((p, c) for p in ("kq", "vdo") for c in range(self.chunks)), "q,dO")]

    @staticmethod
    def warp_registers() -> dict[str, int]:
        """f32 accumulator registers a lane holds: the forward's and the query
        side's (a 16 x 64 score tile and dP tile, a 16 x 128 output chunk) and the
        key side's (16 x 32 P^T and dS^T tiles, 16 x 128 dv and dk chunks)."""
        tile = lambda rows, cols: rows * cols // LANES  # noqa: E731
        return {
            "forward": tile(16, KEY_TILE) + tile(16, WIDE_CHUNK),
            "query": 2 * tile(16, KEY_TILE) + tile(16, WIDE_CHUNK),
            "key": 2 * tile(16, QUERY_TILE) + 2 * tile(16, WIDE_CHUNK),
        }

    def fused_bwd_work(self, elem: int) -> int:
        """Bytes of #3's workspace: dq~, dk~ (f32), q~, k~ (qkv's dtype), m | 1/l | row."""
        rows = self.batch * self.seq * self.heads
        return 2 * rows * self.head_dim * 4 + 2 * rows * self.head_dim * elem + 3 * rows * 4


def check_wide(batch: int, seq: int, heads: int, head_dim: int) -> WideGeometry:
    """Hold one shape to the wide launches: the plans, the grids, the limits of a
    block and a grid, and that the blocks and stages cover every (pair, own row,
    chunk) and every key or query exactly once."""
    geo = WideGeometry(batch, seq, heads, head_dim)
    for plan in (fused_attention_plan, flash_attention_plan):
        assert plan(batch, seq, heads, head_dim) == ("wide", 1)
    for plan in (fused_attention_bwd_plan, flash_attention_bwd_plan):
        assert plan(batch, seq, heads, head_dim) == ("wide", 1, WIDE_WARPS)
    assert geo.grid == wide_grid(batch, seq, heads, head_dim) <= MAX_GRID_X
    assert geo.smem <= MAX_SMEM and geo.f32_smem <= 48 * 1024  # f32 needs no opt-in
    assert max(geo.warp_registers().values()) <= 160  # of 255, beside fragments and addresses
    if geo.grid <= 4096:  # every own row of every pair in one chunk block each
        seen = {}
        for index in range(geo.grid):
            pair, row0, ch = geo.block(index)
            for row in range(row0, min(row0 + WIDE_ROWS, seq)):
                seen[pair, row, ch] = seen.get((pair, row, ch), 0) + 1
        assert len(seen) == batch * heads * seq * geo.chunks and set(seen.values()) == {1}
    for normalize in (False, True):
        stages = geo.fwd_stages(normalize)
        last = [s for s in stages if not s[0]]
        assert len(last) == -(-seq // KEY_TILE) * (geo.chunks + 1)
        assert sorted({j0 for _, j0, kind in last if kind == "v"}) == list(range(0, seq, KEY_TILE))
    q, k = geo.query_stages(), geo.key_stages()
    assert len(q) == -(-seq // KEY_TILE) * (2 * geo.chunks + 1)
    assert len(k) == -(-seq // QUERY_TILE) * (2 * geo.chunks + 1)
    return geo
