"""Launch geometry of the attention sublayer kernel (``ops/flash_attention.py:sublayer_plan``).

At every shape ``chip_smoke.py:phase_sublayer_kernel``, the card tests and
``tiny_config`` give the kernel (the flagship's b2 and b1 temporal and
spatial calls; (64, 16, 768, 8), (3, 256, 768, 8), the ragged (5, 37, 136,
3) and the backward test's (6, 16, 768, 8); ``tiny_config``'s calls at its
width, at head_dim 64, and at its own 16 and at 32 with the card tests'
shapes, where o · Wout's K = H · D is under one 64-column slab), both
products on the GEMM of
``csrc/gemm_sm90.cuh`` (xa · Wqkv and o · Wout) are walked as
``tests/test_torch_mlp_plan.py`` walks the MLP's: the persistent blocks take
every tile once, every output element has one owner, the shared memory and
the grid stay within CUDA's limits, and the TMA boxes and strides keep TMA's
rules. The attention's plan is :func:`fused_attention_plan`'s, and the
arguments the C entry point takes are the plan's, in its order.
"""

import pytest

import chip_smoke
from helpers.split_geometry import check_split, loads, tma_operands
from test_torch_mlp_plan import _check_gemm
from video_vae_tpu_torch import ModelConfig
from video_vae_tpu_torch.core.config import tiny_config
from video_vae_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    MMA_VARIANTS,
    fused_attention_plan,
    sublayer_plan,
)
from video_vae_tpu_torch.ops.fused_block import GEMM_BK

FLAGSHIP = ModelConfig()
TINY = tiny_config().model
TINY_FRAMES = 8  # the CPU tests' clips: (2, 8, 32, 32, 3)
CASES = sorted(
    {(B, S, FLAGSHIP.embed_dim, FLAGSHIP.num_heads) for _, B, S, _, _, _ in chip_smoke.attention_cases(FLAGSHIP)}
    | {(64, 16, 768, 8), (3, 256, 768, 8), (5, 37, 136, 3), (6, 16, 768, 8)}  # the card tests'
    | {(2 * TINY.num_patches, TINY_FRAMES, TINY.embed_dim, TINY.num_heads),
       (2 * TINY_FRAMES, TINY.num_patches, TINY.embed_dim, TINY.num_heads)}
)
TMA_MAX_DIM = 2**32  # a tensor map's global extent, each dimension
# the card tests' shapes (SUBLAYER_CASES in tests/test_torch_cuda.py) and the presets' calls
# (chip_smoke.head_dim_configs) at the head dims other than 64
HEAD_DIM_CASES = sorted(
    {(B, S, C, H, D) for B, S, C, H in ((64, 16, 768, 8), (3, 256, 768, 8), (5, 37, 136, 3), (32, 16, 192, 2))
     for D in KERNEL_HEAD_DIMS if D != 64}
    | {(B, S, cfg.embed_dim, cfg.num_heads, cfg.head_dim)
       for label, cfg, clips, frames in chip_smoke.head_dim_configs()
       for _, B, S, _, _, _ in chip_smoke.preset_attention_cases(label, cfg, clips, frames)}
    # a ModelConfig(num_heads=4) step's calls: head_dim 128, o · Wout's K = H·D = 512 as the flagship's
    | {(B, S, chip_smoke.h4_config().embed_dim, 4, 128)
       for _, B, S, _, _, _ in chip_smoke.preset_attention_cases("h4", chip_smoke.h4_config(), chip_smoke.H4_CLIPS,
                                                               chip_smoke.H4_FRAMES)}
)


def _check_sublayer_plan(B, S, C, H, D):
    n, hd = B * S, H * D
    plan = sublayer_plan(B, S, C, H, D)
    _check_gemm(plan.qkv, n, C, 3 * hd)
    _check_gemm(plan.out, n, hd, C)
    for gemm in (plan.qkv, plan.out):  # K in slabs, the last zero-filled past K
        assert -(-gemm.k // GEMM_BK) * GEMM_BK >= gemm.k and max(gemm.n, gemm.k, gemm.m) < TMA_MAX_DIM
    assert plan.attention == fused_attention_plan(B, S, H, D)
    variant, unit = plan.attention
    assert plan.args == (*plan.qkv.args, *plan.out.args, MMA_VARIANTS.index(variant), unit)


@pytest.mark.parametrize("B,S,C,H", CASES)
def test_sublayer_plan_at_the_kernel_shapes(B, S, C, H):
    _check_sublayer_plan(B, S, C, H, 64)


@pytest.mark.parametrize("B,S,C,H,D", HEAD_DIM_CASES)
def test_sublayer_plan_at_other_head_dims(B, S, C, H, D):
    _check_sublayer_plan(B, S, C, H, D)


def test_sublayer_plan_at_tiny_config():
    """tiny_config (H·D = 32): xa · Wqkv is (N, 192) · (192, 96), three slabs of K,
    the last zero past 192; o · Wout's K = 32 is half a slab, its box zero-filled
    past K; the temporal call's attention takes slab blocks of 4 sequences."""
    plan = sublayer_plan(2 * TINY.num_patches, TINY_FRAMES, TINY.embed_dim, TINY.num_heads, TINY.head_dim)
    assert (plan.qkv.k, plan.qkv.m, -(-plan.qkv.k // GEMM_BK)) == (192, 96, 3)
    assert (plan.out.k, plan.out.m, -(-plan.out.k // GEMM_BK)) == (32, 192, 1)
    assert plan.attention == ("slab", 4)


def test_sublayer_plan_shares_the_card():
    """A b2 call (N = 8192) takes 128 x 256 tiles for xa · Wqkv and 128 x 128
    for o · Wout, 384 tiles each over 132 persistent blocks; at N = 4096 the
    first takes 128 x 128 tiles and the second 96 tiles of 128 x 256 (one
    wave); the ragged (5, 37, 136, 3) has K = 136: three slabs, the last zero past K."""
    big = sublayer_plan(32, 256, 768, 8, 64)
    assert (big.qkv.bn, big.qkv.tiles, big.qkv.blocks) == (256, 384, 132)
    assert (big.out.bn, big.out.tiles, big.out.blocks) == (128, 384, 132)
    assert big.attention == ("tile", 1) and sublayer_plan(512, 16, 768, 8, 64).attention[0] == "slab"
    small = sublayer_plan(16, 256, 768, 8, 64)
    assert (small.qkv.bn, small.qkv.tiles) == (128, 384)
    assert (small.out.bn, small.out.tiles, small.out.blocks) == (256, 96, 96)
    ragged = sublayer_plan(5, 37, 136, 3, 64)
    assert (ragged.qkv.k, ragged.qkv.m, -(-ragged.qkv.k // GEMM_BK)) == (136, 576, 3)


@pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("B,S,H", [(32, 1024, 8), (16, 1024, 8), (3, 257, 2)])
def test_sublayer_split_attention_is_1s(B, S, H, D):
    """Past 256 tokens (the 512² calls at b2 and b1, a ragged S) #7's attention is
    #1's split forward on the sublayer's own buffers, between its two GEMMs: the
    plan's ("split", 1), #1's launch (the wgmma one at head dims 64 and 128, the
    mma.sync one at 16 and 32), and its q~, k~ workspace, qkv scratch (v rows 3
    H D apart) and o scratch at TMA's 16-byte rule."""
    plan = sublayer_plan(B, S, 768, H, D)
    assert plan.attention == ("split", 1) and plan.args[-2:] == (MMA_VARIANTS.index("split"), 1)
    assert check_split("sublayer", B, S, H, D).grid == check_split("fused", B, S, H, D).grid
    for name, (stride, offset) in tma_operands("sublayer", B, S, H, D).items():
        assert loads(stride, offset) == "tma", name
