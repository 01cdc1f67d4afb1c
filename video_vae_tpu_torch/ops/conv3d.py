"""Stride-1 SAME 3-D convolution on channels-first (b, t, c, h, w) activations.

Counterpart of the JAX package's ``ops/conv3d.py:conv3d_cf``,
``conv3d_cf_cat2`` and ``conv3d_cf_pooled`` (the Pallas ``_conv_kernel`` and
``_tapdot_kernel`` forwards and the ``_wgrad_kernel`` filter gradient, with
the custom VJP ``_cf_grads``). The kernel stays DHWIO (kt, kh, kw, cin, cout)
as in the JAX params; the bias is f32; accumulation is f32 and the output
takes the input dtype.

The entry points are ``torch.autograd.Function``s. Each piece dispatches by
the tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA
tensor takes the CUDA kernel or the call raises.

* forward: ``csrc/conv3d.cu``, or, with ``VVT_TAPDOT=1`` in the environment
  (read at every call, the JAX package's knob) and a conv that
  :func:`tapdot_supported` accepts (kt = 1, at least 128 input channels, a
  frame at least 128 wide, bf16), ``csrc/conv3d_tapdot.cu``: one tensor-core
  product per spatial tap, a wgmma implicit GEMM fed by TMA from a
  channels-last copy of the input (tiles, rings and store route from
  :func:`tapdot_plan`, held by ``tests/test_torch_tapdot_plan.py`` on the
  CPU). ``csrc/conv3d.cu`` takes bf16 to its tensor-core implicit GEMM
  (``csrc/conv3d_mma.cuh``: mma.sync with f32 accumulators over every tap
  and input channel, the bias, one rounding; warp-specialised, with
  the input window copied by cp.async a stage ahead and transposed in shared
  memory; launch geometry from :func:`conv_plan`, held by
  ``tests/test_torch_conv_plan.py`` on the CPU) at every shape it accepts, and
  f32 to its CUDA-core kernel in f32 (TF32 would not hold the f32 gates);
* input gradient: the forward conv of g with the spatially flipped,
  IO-swapped kernel and a zero bias, through the same dispatch;
* filter gradient, only where the filter needs one (a frozen VGG's launches
  none): ``csrc/conv3d_wgrad.cu`` over one or two sources (the
  UpBlock's skip concat is never built), its kernel by :func:`wgrad_variant`:
  bf16 inputs at a frame width that is a multiple of 8 take the wgmma
  implicit GEMM fed by TMA of ``csrc/conv3d_wgrad_wg.cuh`` (g copied
  channels-last so that a tap's shift is an outer TMA coordinate; geometry
  from :func:`wgrad_wg_plan`, held and replayed by
  ``tests/test_torch_wgrad_wg_plan.py`` on the CPU), bf16 at any other width
  PR 6's wmma kernel (the input window staged by ``csrc/conv_window.cuh``;
  geometry from :func:`wgrad_plan`), f32 inputs the CUDA-core kernel in f32;
* bias gradient, likewise only where needed: the f32 sum of g over (b, t, h, w);
* :func:`conv3d_cf_pooled` also returns the conv's 2×2 spatial max pool,
  written by the epilogue of whichever forward kernel ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from video_vae_tpu_torch.ops._build import DTYPE_CODES, CudaKernel
from video_vae_tpu_torch.ops.norm import max_pool_2x_cf
from video_vae_tpu_torch.parallel.sharding import log_kernel

CONV3D = CudaKernel(
    "conv3d.cu",
    "vvt_conv3d_cf",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12 + [ctypes.c_void_p],
)
CONV3D_TAPDOT = CudaKernel(
    "conv3d_tapdot.cu",
    "vvt_conv3d_tapdot",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 13 + [ctypes.c_void_p],
)
CONV3D_WGRAD = CudaKernel(
    "conv3d_wgrad.cu",
    "vvt_conv3d_wgrad",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 20 + [ctypes.c_void_p],
)
# The filter gradient's three kernels, as ``vvt_conv3d_wgrad`` numbers them: the
# f32 CUDA-core kernel, PR 6's bf16 wmma kernel (frames whose width is not a
# multiple of 8, which a tensor map cannot describe) and the bf16 wgmma kernel
# fed by TMA (every other bf16 conv); and the launches of each.
WGRAD_VARIANTS = ("cuda_core", "wmma", "wgmma")
WGRAD_VARIANT_LAUNCHES = dict.fromkeys(WGRAD_VARIANTS, 0)

KERNEL_WIDTHS = (1, 3, 5, 7)
KERNEL_MAX_HEIGHT = 7
# The f32 filter-gradient kernel's output tile (rows of the (kt·kh·kw·cin) axis
# × output channels) and the number of blocks it aims to keep in flight: the
# pixel reduction is split across blocks until the grid has about this many.
WGRAD_TILE_K, WGRAD_TILE_CO, WGRAD_TARGET_BLOCKS = 128, 16, 1056
# The bf16 (tensor-core) filter-gradient kernel, ``csrc/conv3d_wgrad.cu``: the
# pixel tile (rows, columns), the warps of a block, the accumulator fragments a
# warp holds, the 16-wide output-channel fragments a block owns at most, the
# blocks the pixel split aims for (4 per SM of the H100) and the most f32
# elements of partials it may take (32 MiB).
WGRAD_MMA_TILE = (8, 32)
WGRAD_MMA_WARPS, WGRAD_MMA_MAX_FRAGS, WGRAD_MMA_MAX_NJ = 8, 7, 4
WGRAD_MMA_TARGET_BLOCKS, WGRAD_MMA_MAX_WORKSPACE = 528, 8 << 20
CUDA_MAX_GRID_Y = 65535
# The bf16 wgmma filter-gradient kernel, ``csrc/conv3d_wgrad_wg.cuh``: pixels of
# a K block (one 128-byte row of B), its N-tile widths, the widest N tile for
# each kh (kh * nb / 2 f32 accumulators a thread), the ring's slots at most,
# the image rows of a pixel tile at most, the waves of blocks the pixel split
# aims for by output-channel band (a 16-channel band's blocks, paced by their
# A boxes' L2 traffic, ran 11 % faster in three waves than in one; wider bands
# lose to the larger partials; a wave is ``CONV_MMA_BLOCKS``, one block an
# SM), its alignment slack and the most f32 elements of partials it may take
# (128 MiB).
WGRAD_WG_KB, WGRAD_WG_NB = 64, (16, 32, 64, 128)
WGRAD_WG_MAX_NB = {1: 128, 3: 128, 5: 32, 7: 32}
WGRAD_WG_MAX_STAGES, WGRAD_WG_MAX_ROWS = 8, 64
WGRAD_WG_WAVES = {16: 3, 32: 1, 64: 1}
WGRAD_WG_SMEM_ALIGN, WGRAD_WG_MAX_WORKSPACE = 1024, 32 << 20
# The bf16 (tensor-core) direct conv, ``csrc/conv3d_mma.cuh``: the tile width, the
# consumer warps of a block (each 2 rows x 32 columns), the input channels of a
# stage, the (n8 tiles a warp, warps side by side in N) that make up each
# output-channel block width, in the order tried (taller tiles first), the
# shared memory a block may use, and the persistent blocks it launches (one an
# SM of the H100).
CONV_MMA_TILE_W, CONV_MMA_WARPS, CONV_MMA_CHUNK = 32, 8, 16
CONV_MMA_N_BLOCKS = {8: [(1, 1)], 16: [(2, 1), (1, 2)], 32: [(4, 1), (2, 2), (1, 4)], 64: [(4, 2), (2, 4)]}
CONV_MMA_MAX_SMEM, CONV_MMA_BLOCKS = 232448, 132
# The tap-dot conv, ``csrc/conv3d_tapdot.cu``: input channels a slab (K), pixels
# of a B panel (one image row segment, one TMA box), the most slots of either
# ring, the alignment slack of its shared memory; the shared memory and
# persistent blocks are the direct conv's.
TAPDOT_BK, TAPDOT_PANEL = 64, 64
TAPDOT_MAX_STAGES, TAPDOT_SMEM_ALIGN = 6, 1024


def tapdot_supported(x1, x2, kernel) -> bool:
    """Whether this conv takes the tap-dot kernel: the JAX package's gate.

    ``VVT_TAPDOT=1`` in the environment (read at every call), kt = 1, a frame
    at least 128 wide, at least 128 input channels, input, output and each
    source's channels multiples of 8, and a 2-byte dtype (a float32 conv
    stays on the direct kernel).
    """
    kt, _, _, cin, cout = kernel.shape
    sources = [x1] if x2 is None else [x1, x2]
    return (
        os.environ.get("VVT_TAPDOT", "0") == "1"
        and kt == 1
        and x1.shape[4] >= 128
        and cin >= 128
        and cin % 8 == 0
        and cout % 8 == 0
        and all(s.shape[2] % 8 == 0 for s in sources)
        and x1.dtype == torch.bfloat16
    )


def _dispatch(x1, x2, kernel, bias, pool=False):
    """The forward conv by device and gate; with ``pool`` also its 2×2 max pool."""
    tapdot = tapdot_supported(x1, x2, kernel)
    log_kernel("conv3d_tapdot" if tapdot else "conv3d_cf", x1)
    if x1.device.type == "cpu":
        plain = conv3d_tapdot_plain if tapdot else conv3d_cf_plain
        return plain(x1, x2, kernel, bias, pool=pool)
    if x1.device.type == "cuda":
        launch = conv3d_tapdot_cuda if tapdot else conv3d_cf_cuda
        return launch(x1, x2, kernel, bias, pool=pool)
    raise ValueError(f"conv3d_cf: unsupported device {x1.device}")


def _cf_grads(x1, x2, kernel, g, need_dx, need_dkernel, need_dbias, bias_dtype):
    """(dx1, dx2, dkernel, dbias) of the conv of [x1; x2] for the cotangent g;
    each None where its input needs no gradient (a frozen filter launches no
    filter gradient).

    g may be f32 (the pooled entry point sums two cotangents in f32): the
    bias gradient is the sum of that, the kernels take g in the input dtype.
    """
    kt, kh, kw, cin, _ = kernel.shape
    dbias = g.float().sum(dim=(0, 1, 3, 4)).to(bias_dtype) if need_dbias else None
    g = g.to(x1.dtype).contiguous()
    dx1 = dx2 = None
    if need_dx:
        # stride 1, SAME, odd taps: dx is the forward conv of g with the
        # spatially flipped, IO-swapped kernel
        flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
        zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
        dx = _dispatch(g, None, flipped, zero)
        c1 = x1.shape[2]
        dx1, dx2 = (dx, None) if x2 is None else (dx[:, :, :c1], dx[:, :, c1:])
    dkernel = conv3d_wgrad(x1, x2, g, kt, kh, kw).to(kernel.dtype) if need_dkernel else None
    return dx1, dx2, dkernel, dbias


class _Conv3dCF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, kernel, bias):
        ctx.save_for_backward(x1, x2, kernel)
        ctx.bias_dtype = bias.dtype
        return _dispatch(x1, x2, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x1, x2, kernel = ctx.saved_tensors
        need = ctx.needs_input_grad
        return _cf_grads(x1, x2, kernel, g, need[0] or need[1], need[2], need[3], ctx.bias_dtype)


class _Conv3dCFPooled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        full, pooled = _dispatch(x, None, kernel, bias, pool=True)
        ctx.save_for_backward(x, kernel, full)
        ctx.bias_dtype = bias.dtype
        return full, pooled

    @staticmethod
    def backward(ctx, g_full, g_pool):
        """The pooled cotangent goes through the max pool's own VJP on the
        saved conv output, is added to g_full in f32, then one conv backward."""
        x, kernel, full = ctx.saved_tensors
        with torch.enable_grad():
            leaf = full.detach().requires_grad_()
            pooled = max_pool_2x_cf(leaf)
        (g_from_pool,) = torch.autograd.grad(pooled, leaf, g_pool.to(full.dtype))
        g = g_full.float() + g_from_pool.float()
        need = ctx.needs_input_grad
        dx, _, dkernel, dbias = _cf_grads(x, None, kernel, g, need[0], need[1], need[2], ctx.bias_dtype)
        return dx, dkernel, dbias


def conv3d_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(b, t, cin, h, w) → (b, t, cout, h, w) with a DHWIO kernel."""
    return _Conv3dCF.apply(x, None, kernel, bias)


def conv3d_cf_cat2(
    x1: torch.Tensor, x2: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """The conv of the channel concat [x1; x2]; the concat is never built."""
    return _Conv3dCF.apply(x1, x2, kernel, bias)


def conv3d_cf_pooled(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """The conv and its 2×2 spatial max pool: (full, pooled), h and w even.

    The pooled output comes out of the forward kernel's epilogue (taken from
    the f32 sums, rounded once). Only for a pool that follows the conv
    directly; the UNet's DownBlocks pool after GroupNorm + SiLU.
    """
    if x.shape[3] % 2 or x.shape[4] % 2:
        raise ValueError(f"conv3d_cf_pooled needs an even frame, got {tuple(x.shape[3:])}")
    return _Conv3dCFPooled.apply(x, kernel, bias)


def conv3d_wgrad(
    x1: torch.Tensor, x2: Optional[torch.Tensor], g: torch.Tensor, kt: int, kh: int, kw: int
) -> torch.Tensor:
    """f32 filter gradient (kt, kh, kw, c1 + c2, cout) of the conv of [x1; x2]."""
    log_kernel("conv3d_cf_wgrad", x1)
    if x1.device.type == "cpu":
        return conv3d_wgrad_plain(x1, x2, g, kt, kh, kw)
    if x1.device.type == "cuda":
        return conv3d_wgrad_cuda(x1, x2, g, kt, kh, kw)
    raise ValueError(f"conv3d_wgrad: unsupported device {x1.device}")


def _padded_f32(x1, x2, kt, kh, kw):
    x = x1 if x2 is None else torch.cat([x1, x2], dim=2)
    return F.pad(x.float(), (kw // 2, kw // 2, kh // 2, kh // 2, 0, 0, kt // 2, kt // 2))


def conv3d_cf_plain(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    kernel: torch.Tensor,
    bias: torch.Tensor,
    pool: bool = False,
):
    """The kernel's arithmetic in plain PyTorch: one f32 product per tap.

    Sums kt·kh·kw shifted (b,t,cin,h,w)·(cin,cout) contractions of the
    zero-padded input in f32, adds the bias and rounds once. With ``pool``
    returns (full, pooled): the 2×2 spatial max of the f32 sums, rounded.
    """
    b, t, _, h, w = x1.shape
    kt, kh, kw, _, cout = kernel.shape
    xp = _padded_f32(x1, x2, kt, kh, kw)
    wf = kernel.float()
    y = torch.zeros((b, t, cout, h, w), dtype=torch.float32, device=x1.device)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                xs = xp[:, dt : dt + t, :, dh : dh + h, dw : dw + w]
                y += torch.einsum("btchw,cd->btdhw", xs, wf[dt, dh, dw])
    y += bias.float()[None, None, :, None, None]
    if pool:
        return y.to(x1.dtype), max_pool_2x_cf(y).to(x1.dtype)
    return y.to(x1.dtype)


def conv3d_tapdot_plain(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    kernel: torch.Tensor,
    bias: torch.Tensor,
    pool: bool = False,
):
    """The tap-dot kernel's arithmetic in plain PyTorch, for a kt = 1 kernel.

    One (cout × cin)·(cin × pixels) f32 product per spatial tap, in tap
    order, over the channels of both sources, zero outside the frame; the
    bias added in f32, one rounding. With ``pool`` returns (full, pooled),
    the pooled output taken from the f32 sums.
    """
    b, t, _, h, w = x1.shape
    kt, kh, kw, _, cout = kernel.shape
    if kt != 1:
        raise ValueError(f"the tap-dot conv takes kt = 1, got {kt}")
    xp = _padded_f32(x1, x2, 1, kh, kw).reshape(b * t, -1, h + kh - 1, w + kw - 1)
    wf = kernel.float()[0]
    y = torch.zeros((b * t, cout, h * w), dtype=torch.float32, device=x1.device)
    for dh in range(kh):
        for dw in range(kw):
            window = xp[:, :, dh : dh + h, dw : dw + w].reshape(b * t, -1, h * w)
            y += torch.matmul(wf[dh, dw].t(), window)
    y = (y + bias.float()[None, :, None]).reshape(b, t, cout, h, w)
    if pool:
        return y.to(x1.dtype), max_pool_2x_cf(y).to(x1.dtype)
    return y.to(x1.dtype)


def conv3d_wgrad_plain(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    g: torch.Tensor,
    kt: int,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """The filter-gradient kernel's arithmetic in plain PyTorch, in f32.

    dW[dt, dh, dw] = Σ_{b,t,y,x} xpad[b, t+dt, :, y+dh, x+dw] ⊗ g[b, t, :, y, x]:
    one f32 (cin × cout) contraction per tap of the zero-padded input.
    """
    b, t, _, h, w = x1.shape
    xp = _padded_f32(x1, x2, kt, kh, kw)
    gf = g.float()
    taps = [
        torch.einsum("btchw,btdhw->cd", xp[:, dt : dt + t, :, dh : dh + h, dw : dw + w], gf)
        for dt in range(kt)
        for dh in range(kh)
        for dw in range(kw)
    ]
    return torch.stack(taps).reshape(kt, kh, kw, *taps[0].shape)


def _check_sources(name, x1, x2):
    """Device, dtype, layout checks shared by both CUDA wrappers; returns c2."""
    if not x1.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if x1.dtype not in DTYPE_CODES:
        raise TypeError(f"conv kernels take float32 or bfloat16, not {x1.dtype}")
    for s in [x1] if x2 is None else [x1, x2]:
        if s.dim() != 5 or not s.is_contiguous():
            raise ValueError("activations must be contiguous (b, t, c, h, w) tensors")
        if s.dtype != x1.dtype or s.device != x1.device:
            raise ValueError("both sources must share dtype and device")
    if x2 is not None and (x2.shape[:2] != x1.shape[:2] or x2.shape[3:] != x1.shape[3:]):
        raise ValueError("the two sources must differ only in channels")
    return 0 if x2 is None else x2.shape[2]


def _check_kernel_size(kt, kh, kw):
    if kt % 2 == 0 or kh % 2 == 0 or kh > KERNEL_MAX_HEIGHT or kw not in KERNEL_WIDTHS:
        raise ValueError(f"kernel size {(kt, kh, kw)} not supported (odd, kh <= 7, kw in 1,3,5,7)")


def _check_conv_operands(name, x1, x2, kernel, bias, pool):
    """Checks shared by the two forward wrappers; returns c2."""
    c2 = _check_sources(name, x1, x2)
    c1, h, w = x1.shape[2:]
    if kernel.dim() != 5 or not kernel.is_contiguous() or kernel.dtype != x1.dtype:
        raise ValueError("kernel must be a contiguous DHWIO tensor in the input dtype")
    kt, kh, kw, cin, cout = kernel.shape
    if cin != c1 + c2:
        raise ValueError(f"kernel takes {cin} input channels, activations have {c1 + c2}")
    _check_kernel_size(kt, kh, kw)
    if bias.shape != (cout,) or bias.dtype != torch.float32 or not bias.is_contiguous():
        raise ValueError("bias must be a contiguous float32 (cout,) tensor")
    if kernel.device != x1.device or bias.device != x1.device:
        raise ValueError("kernel and bias must be on the activations' device")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"the pooled output needs an even frame, got {(h, w)}")
    return c2


def _empty_outputs(x1, cout, pool):
    b, t, _, h, w = x1.shape
    y = torch.empty((b, t, cout, h, w), dtype=x1.dtype, device=x1.device)
    pooled = None
    if pool:
        pooled = torch.empty((b, t, cout, h // 2, w // 2), dtype=x1.dtype, device=x1.device)
    return y, pooled


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Launch geometry of the bf16 direct conv kernel for one conv.

    A work item is one output frame, a ``tile_h`` × 32 pixel tile and
    ``n_block`` output channels; each of the 8 consumer warps owns 2 rows × 32
    columns of the tile by ``wn`` 8-wide channel tiles, ``wgn`` warps side by
    side in N. ``blocks`` persistent blocks deal the items out in turn: block
    i takes items i, i + blocks, … (frame-major, then tile, then channel
    block), each from its first stage to its epilogue.
    """

    cin: int
    cout: int
    frames: int
    h: int
    w: int
    kt: int
    kh: int
    kw: int
    wn: int
    wgn: int
    blocks: int

    @property
    def n_block(self) -> int:
        return 8 * self.wn * self.wgn

    @property
    def tile_h(self) -> int:
        return 2 * CONV_MMA_WARPS // self.wgn

    @property
    def tiles_w(self) -> int:
        return -(-self.w // CONV_MMA_TILE_W)

    @property
    def tiles_h(self) -> int:
        return -(-self.h // self.tile_h)

    @property
    def co_tiles(self) -> int:
        return -(-self.cout // self.n_block)

    @property
    def items(self) -> int:
        return self.frames * self.tiles_h * self.tiles_w * self.co_tiles

    @property
    def smem(self) -> int:
        return conv_mma_smem(self.wn, self.wgn, self.kh, self.kw)


def conv_mma_smem(wn: int, wgn: int, kh: int, kw: int) -> int:
    """Shared memory of the bf16 conv kernel, two of each: the transposed window
    (rows of 32 + kw pixels, each pixel's 16 channels in a 48-byte line), the
    weights of every spatial tap (16 rows of the output-channel block, padded to
    an odd number of 16-byte units) and the raw window (16 channel planes of rows
    of 96 bytes), each rounded up to 128 bytes."""
    n = 8 * wn * wgn
    ld = n if (n // 8) % 2 else n + 8
    rows = 2 * CONV_MMA_WARPS // wgn + kh - 1
    parts = (rows * (CONV_MMA_TILE_W + kw) * 48, kh * kw * CONV_MMA_CHUNK * ld * 2, CONV_MMA_CHUNK * rows * 96)
    return 2 * sum(-(-part // 128) * 128 for part in parts)


def conv_plan(cin: int, cout: int, b: int, t: int, h: int, w: int, kt: int, kh: int, kw: int) -> ConvPlan:
    """The bf16 direct conv kernel's geometry (see :class:`ConvPlan`).

    The narrowest output-channel block that holds cout, 64 at most (cout 12 →
    16, 3 → 8, 512 → 8 blocks of 64), with the tallest tile whose buffers fit
    the block's shared memory, and a narrower block where none does (a 7×7
    kernel's weights); one persistent block an SM, fewer where there are fewer
    items.
    """
    widths = sorted(CONV_MMA_N_BLOCKS)
    n = next((width for width in widths if width >= cout), widths[-1])
    while True:
        fits = [wn_wgn for wn_wgn in CONV_MMA_N_BLOCKS[n] if conv_mma_smem(*wn_wgn, kh, kw) <= CONV_MMA_MAX_SMEM]
        if fits or n == widths[0]:
            break
        n //= 2
    wn, wgn = fits[0]
    one = ConvPlan(cin, cout, b * t, h, w, kt, kh, kw, wn, wgn, blocks=1)
    return dataclasses.replace(one, blocks=min(one.items, CONV_MMA_BLOCKS))


@dataclasses.dataclass(frozen=True)
class TapdotPlan:
    """Launch geometry of the tap-dot kernel for one conv.

    A tile is one frame, ``bm`` output channels and ``rows`` image rows of 64
    pixels (one TMA box, a B panel, each); ``blocks`` persistent blocks deal
    the tiles out in turn (block i takes tiles i, i + blocks, …; output-channel
    tile fastest, then column tile, row tile, frame). A tile runs ``groups``
    B groups, dw-major: for each column shift dw the 64-channel slabs of x1,
    then of x2; a group is ``panels`` boxes of 64 pixels × 64 channels of the
    source's channels-last copy (which the kernel's first launch makes), the
    tile's rows and the kh − 1 rows of its taps' halo (``b_box``), in a ring
    of ``b_stages`` slots; each of its kh taps (dh) takes the weights' ``bm``
    × 64 box (``a_box``) from a ring of ``a_stages`` slots and the group's
    panels dh … dh + rows − 1. ``tma_store``: each consumer warpgroup's
    output goes through a staging tile to a TMA store, where TMA can describe
    the output (its strides multiples of 16 bytes: w % 8 == 0); else the
    second route, stores from registers.
    """

    c1: int
    c2: int
    cout: int
    frames: int
    h: int
    w: int
    kh: int
    kw: int
    bm: int
    bn: int
    a_stages: int
    b_stages: int
    blocks: int
    tma_store: bool

    @property
    def rows(self) -> int:
        return self.bn // TAPDOT_PANEL

    @property
    def tiles_w(self) -> int:
        return -(-self.w // TAPDOT_PANEL)

    @property
    def tiles_h(self) -> int:
        return -(-self.h // self.rows)

    @property
    def co_tiles(self) -> int:
        return -(-self.cout // self.bm)

    @property
    def tiles(self) -> int:
        return self.frames * self.tiles_h * self.tiles_w * self.co_tiles

    @property
    def slabs1(self) -> int:
        return -(-self.c1 // TAPDOT_BK)

    @property
    def slabs(self) -> int:
        return self.slabs1 + -(-self.c2 // TAPDOT_BK)

    @property
    def groups(self) -> int:
        return self.kw * self.slabs

    @property
    def panels(self) -> int:
        return self.rows + self.kh - 1

    @property
    def smem(self) -> int:
        return tapdot_smem(self.bm, self.bn, self.kh, self.a_stages, self.b_stages)

    def tile(self, t: int) -> tuple[int, int, int, int]:
        """(frame, first row, first column, first output channel) of tile t."""
        co_t, t = t % self.co_tiles, t // self.co_tiles
        tx, t = t % self.tiles_w, t // self.tiles_w
        return t // self.tiles_h, (t % self.tiles_h) * self.rows, tx * TAPDOT_PANEL, co_t * self.bm

    def slab(self, s: int) -> tuple[int, int, int]:
        """(source 0 or 1, its first channel, the weights' K column) of slab s."""
        first = s < self.slabs1
        ci0 = (s if first else s - self.slabs1) * TAPDOT_BK
        return (0, ci0, ci0) if first else (1, ci0, self.c1 + ci0)

    def a_box(self, t: int, tap: int, s: int) -> tuple[int, int]:
        """(K column, row) of the weights' bm x 64 box: rows tap · cout + co0 …"""
        return self.slab(s)[2], tap * self.cout + self.tile(t)[3]

    def b_box(self, t: int, dw: int, s: int, q: int) -> tuple[int, int, int, int]:
        """(channel, x, y, frame) of panel q's 64-channel × 64-pixel box of the
        B group (dw, slab s) in the source's channels-last copy, innermost
        first: image row y0 − kh // 2 + q, columns shifted by dw − kw // 2,
        negative or past the edge where SAME pads."""
        frame, y0, x0, _ = self.tile(t)
        return self.slab(s)[1], x0 + dw - self.kw // 2, y0 - self.kh // 2 + q, frame


def tapdot_smem(bm: int, bn: int, kh: int, a_stages: int, b_stages: int) -> int:
    """Dynamic shared memory of a tap-dot block (``conv3d_tapdot.cu:tapdot_smem_bytes``):
    alignment slack, the ring of weight slabs, the ring of B groups (bn / 64 +
    kh − 1 panels each), the two consumer warpgroups' output staging tiles (64
    channels by their pixels), a full and an empty mbarrier a slot."""
    panel = TAPDOT_PANEL * TAPDOT_BK * 2
    staging = 64 * (bn if bm == 128 else bn // 2) * 2
    return (TAPDOT_SMEM_ALIGN + a_stages * bm * TAPDOT_BK * 2 + b_stages * (bn // TAPDOT_PANEL + kh - 1) * panel
            + 2 * staging + (a_stages + b_stages) * 2 * 8)


def tapdot_plan(c1: int, c2: int, cout: int, b: int, t: int, h: int, w: int, kh: int, kw: int) -> TapdotPlan:
    """The tap-dot kernel's geometry (see :class:`TapdotPlan`).

    64 output channels a tile where cout ≤ 64 (both consumer warpgroups on
    them, each on half of 4 rows), else 128; 4 rows of 64 pixels, or 2 where
    4-row tiles would not fill every SM once or their rings would not fit;
    three B group slots where four or more weight slots fit beside them, else
    two, and the most weight slots that fit (at most ``TAPDOT_MAX_STAGES``);
    one persistent block an SM; TMA stores where w % 8 == 0.
    """
    frames = b * t
    if cout <= 64:
        bm, widths = 64, (256,)
    else:
        bm = 128
        tiles = frames * -(-h // 4) * -(-w // TAPDOT_PANEL) * -(-cout // bm)
        widths = (256, 128) if tiles >= CONV_MMA_BLOCKS else (128,)
    for bn in widths:
        for b_stages, least in ((3, 4), (2, 2)):
            fit = [a for a in range(2, TAPDOT_MAX_STAGES + 1)
                   if tapdot_smem(bm, bn, kh, a, b_stages) <= CONV_MMA_MAX_SMEM]
            if fit and max(fit) >= least:
                one = TapdotPlan(c1, c2, cout, frames, h, w, kh, kw, bm, bn, max(fit), b_stages, 1, w % 8 == 0)
                return dataclasses.replace(one, blocks=min(one.tiles, CONV_MMA_BLOCKS))
    raise ValueError(f"no tap-dot tile fits a {kh}-row kernel")


def conv3d_cf_cuda(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    kernel: torch.Tensor,
    bias: torch.Tensor,
    pool: bool = False,
):
    """Launch the direct conv kernel over one source, or two without their concat.

    bf16 takes the tensor-core kernel (geometry from :func:`conv_plan`), f32
    the CUDA-core one. With ``pool`` the kernel's epilogue also writes the 2×2
    spatial max pool and the call returns (full, pooled).
    """
    c2 = _check_conv_operands("conv3d_cf_cuda", x1, x2, kernel, bias, pool)
    b, t, c1, h, w = x1.shape
    kt, kh, kw, _, cout = kernel.shape
    plan = conv_plan(c1 + c2, cout, b, t, h, w, kt, kh, kw)
    y, pooled = _empty_outputs(x1, cout, pool)
    with torch.cuda.device(x1.device):
        CONV3D.launch(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), c1, c2,
            kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if pooled is None else pooled.data_ptr(),
            b, t, h, w, cout, kt, kh, kw, DTYPE_CODES[x1.dtype], plan.wn, plan.wgn, plan.blocks,
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
    return (y, pooled) if pool else y


def conv3d_tapdot_cuda(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    kernel: torch.Tensor,
    bias: torch.Tensor,
    pool: bool = False,
):
    """Launch the tap-dot kernel (kt = 1, bf16, channels multiples of 8).

    One source, or two without their concat; with ``pool`` the call returns
    (full, pooled). The kernel's weights are laid out here, once a call, as
    (kh·kw·cout, cin), tap-major: the JAX wrapper's ``wmat``, a K-major A;
    the kernel's first launch copies each source channels-last into scratch
    allocated here. Tiles, rings and store route from :func:`tapdot_plan`.
    """
    c2 = _check_conv_operands("conv3d_tapdot_cuda", x1, x2, kernel, bias, pool)
    b, t, c1, h, w = x1.shape
    kt, kh, kw, cin, cout = kernel.shape
    if x1.dtype != torch.bfloat16:
        raise TypeError(f"the tap-dot kernel takes bfloat16, not {x1.dtype}")
    if kt != 1:
        raise ValueError(f"the tap-dot kernel takes kt = 1, got {kt}")
    if c1 % 8 or c2 % 8 or cout % 8:
        raise ValueError(f"the tap-dot kernel takes channels that are multiples of 8, got {c1}, {c2}, {cout}")
    plan = tapdot_plan(c1, c2, cout, b, t, h, w, kh, kw)
    wmat = kernel[0].permute(0, 1, 3, 2).reshape(kh * kw * cout, cin).contiguous()
    y, pooled = _empty_outputs(x1, cout, pool)
    xt1 = torch.empty((b * t, h, w, c1), dtype=x1.dtype, device=x1.device)
    xt2 = None if x2 is None else torch.empty((b * t, h, w, c2), dtype=x1.dtype, device=x1.device)
    if any(s.data_ptr() % 16 for s in (x1, x2, wmat, y) if s is not None):
        raise ValueError("the tap-dot kernel needs 16-byte aligned tensors")
    with torch.cuda.device(x1.device):
        CONV3D_TAPDOT.launch(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), c1, c2,
            wmat.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if pooled is None else pooled.data_ptr(),
            xt1.data_ptr(), None if xt2 is None else xt2.data_ptr(),
            b * t, h, w, cout, kh, kw, plan.bm, plan.bn, plan.a_stages, plan.b_stages, plan.blocks,
            int(plan.tma_store), plan.smem,
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
    return (y, pooled) if pool else y


def wgrad_splits(k_rows: int, cout: int, segments: int) -> int:
    """How many blocks share one output tile's pixel reduction (the f32 kernel)."""
    tiles = -(-k_rows // WGRAD_TILE_K) * -(-cout // WGRAD_TILE_CO)
    return max(1, min(segments, WGRAD_TARGET_BLOCKS // tiles))


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """Launch geometry of the bf16 filter-gradient kernel for one conv.

    Grid (chunks · co_tiles · kt, splits): a block owns one 16-channel input
    chunk, ``nj`` 16-wide output-channel fragments and one temporal tap dt, and
    the ``splits``-th share of the pixel tiles of the frames whose tap dt lands
    inside the clip. Its kh·kw·nj accumulator fragments are dealt out to the
    consumer warps of each of ``row_groups`` groups, which split a tile's rows
    (four more warps stage the tiles); every (split, row group) writes its own
    f32 partial of the padded (kt, kh, kw, cin_pad, cout_pad) gradient, summed
    in a fixed order after.
    """

    cin: int
    cout: int
    kt: int
    kh: int
    kw: int
    nj: int
    row_groups: int
    pixel_tiles: int  # tiles of the centre tap, which reads every frame
    splits: int

    @property
    def chunks(self) -> int:
        return -(-self.cin // 16)

    @property
    def co_tiles(self) -> int:
        return -(-self.cout // (16 * self.nj))

    @property
    def cin_pad(self) -> int:
        return 16 * self.chunks

    @property
    def cout_pad(self) -> int:
        return 16 * self.nj * self.co_tiles

    @property
    def grid(self) -> tuple[int, int]:
        return self.chunks * self.co_tiles * self.kt, self.splits

    @property
    def workspace(self) -> int:
        """f32 elements of the partials."""
        taps = self.kt * self.kh * self.kw
        return self.splits * self.row_groups * taps * self.cin_pad * self.cout_pad

    def fragments(self) -> Iterator[tuple[int, int, int, int, int, int]]:
        """(block x, warp, dt, spatial tap, first input channel, first output
        channel) of every 16 × 16 accumulator fragment of one split, as the
        kernel deals them out."""
        lanes = WGRAD_MMA_WARPS // self.row_groups
        taps = self.kh * self.kw
        for bx in range(self.grid[0]):
            chunk, co_tile = bx % self.chunks, (bx // self.chunks) % self.co_tiles
            dt = bx // (self.chunks * self.co_tiles)
            for warp in range(WGRAD_MMA_WARPS):
                for f in range(warp % lanes, taps * self.nj, lanes):
                    yield bx, warp, dt, f // self.nj, 16 * chunk, 16 * (self.nj * co_tile + f % self.nj)


def wgrad_plan(cin: int, cout: int, b: int, t: int, h: int, w: int, kt: int, kh: int, kw: int) -> WgradPlan:
    """The bf16 filter-gradient kernel's geometry (see :class:`WgradPlan`).

    Up to 64 output channels a block (16, 32 or 64), fewer where kh·kw
    fragments of 16 would not fit its warps; the row groups that give the
    busiest warp the fewest products, with a whole number of output-channel
    blocks in each group's warps; the pixel tiles split until the grid has about
    ``WGRAD_MMA_TARGET_BLOCKS`` blocks, within the workspace bound.
    """
    taps = kh * kw
    # a power of two, so that a warp's fragments can share one output-channel block
    nj = min(WGRAD_MMA_MAX_NJ, 1 << (-(-cout // 16) - 1).bit_length())
    while taps * nj > WGRAD_MMA_WARPS * WGRAD_MMA_MAX_FRAGS:
        nj //= 2
    rows = WGRAD_MMA_TILE[0]
    fits = [
        g for g in (1, 2, 4, 8)
        if (WGRAD_MMA_WARPS // g) % nj == 0
        and -(-taps * nj // (WGRAD_MMA_WARPS // g)) <= WGRAD_MMA_MAX_FRAGS
    ]
    row_groups = min(fits, key=lambda g: -(-taps * nj // (WGRAD_MMA_WARPS // g)) * (rows // g))
    pixel_tiles = b * t * -(-h // rows) * -(-w // WGRAD_MMA_TILE[1])
    one = WgradPlan(cin, cout, kt, kh, kw, nj, row_groups, pixel_tiles, splits=1)
    splits = min(pixel_tiles, CUDA_MAX_GRID_Y, -(-WGRAD_MMA_TARGET_BLOCKS // one.grid[0]),
                 WGRAD_MMA_MAX_WORKSPACE // one.workspace)
    return dataclasses.replace(one, splits=max(1, splits))


def wgrad_variant(dtype: torch.dtype, w: int) -> str:
    """Which of ``WGRAD_VARIANTS`` computes a filter gradient, from the dtype and
    the frame width alone: f32 the CUDA-core kernel; bf16 the wgmma kernel where
    a tensor map can describe the frame (its row stride a multiple of 16 bytes:
    w % 8 == 0), else PR 6's wmma kernel."""
    if dtype == torch.float32:
        return "cuda_core"
    return "wgmma" if w % 8 == 0 else "wmma"


def wgrad_wg_smem(nb: int, kh: int, bw: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of a wgmma filter-gradient block
    (``conv3d_wgrad_wg.cuh:wgrad_wg_smem_bytes``): alignment slack, ``stages``
    ring slots of the A boxes (128 bytes a pixel of the rows + kh − 1 image
    rows of bw columns) and the B box (nb channels × rows · bw pixels), a full
    and an empty mbarrier a slot."""
    return WGRAD_WG_SMEM_ALIGN + stages * (128 * bw * (rows + kh - 1) + 2 * nb * bw * rows) + stages * 16


@dataclasses.dataclass(frozen=True)
class WgradWgPlan:
    """Launch geometry of the wgmma filter-gradient kernel for one conv.

    dWᵀ[tap] = Σ_p g[p − off(tap)] · x[p]: M = output channels, N = input
    channels, K = pixels. g is copied channels-last, (b, t, h, w, cp), its
    channels padded to ``cp`` = band · co_bands; a box of that copy is ``band``
    output channels × ``bw`` pixels × ``rows + kh − 1`` image rows of one
    frame at the tap's (dt, dw) offset. Box j of an M-tile group holds
    (dt, dw, output-channel band) ``box(group · bpm + j)``; the group's
    ``bpm`` = 64 / band boxes side by side are the 64 rows of its kh M-tiles,
    M-tile dh starting kh − 1 − dh rows into each box. An N tile is ``nb``
    channels of one source (x1's tiles, then x2's), or, where both sources'
    channels rounded up to 8 fit one (``joint``), x1's ``c1p`` rows then x2's.
    A pixel tile is ``rows``
    image rows × ``bw`` columns of one frame (``tile``); a K block is 64 of
    its pixels (``64 / bw`` whole rows where the frame is narrower than 64).
    The grid is (groups · N tiles, splits): block (x, split) owns group
    x % groups and N tile x // groups, and the split-th share of the tiles,
    which its two consumer warpgroups take in turns, through a ring of
    ``stages`` slots; each (split, warpgroup) writes an f32 partial
    [slot][m-tile][n][64] summed in slot order after.
    """

    c1: int
    c2: int
    cout: int
    b: int
    t: int
    h: int
    w: int
    kt: int
    kh: int
    kw: int
    band: int
    nb: int
    rows: int
    stages: int
    splits: int

    @property
    def bpm(self) -> int:
        return 64 // self.band

    @property
    def co_bands(self) -> int:
        return -(-self.cout // self.band)

    @property
    def cp(self) -> int:
        return self.band * self.co_bands

    @property
    def boxes(self) -> int:
        return self.kt * self.kw * self.co_bands

    @property
    def groups(self) -> int:
        return -(-self.boxes // self.bpm)

    @property
    def mtiles(self) -> int:
        return self.groups * self.kh

    @property
    def c1p(self) -> int:
        return -(-self.c1 // 8) * 8

    @property
    def c2p(self) -> int:
        return -(-self.c2 // 8) * 8

    @property
    def joint(self) -> bool:
        """Both sources in one N tile: x1's c1p rows, then x2's c2p."""
        return self.c2 > 0 and self.c1p + self.c2p <= self.nb

    @property
    def nt1(self) -> int:
        return 1 if self.joint else -(-self.c1 // self.nb)

    @property
    def n_tiles(self) -> int:
        return 1 if self.joint else self.nt1 + -(-self.c2 // self.nb)

    @property
    def n2(self) -> int:
        """x2's first column of the padded N axis."""
        return self.c1p if self.joint else self.nt1 * self.nb

    @property
    def cin_pad(self) -> int:
        return self.nb * self.n_tiles

    @property
    def flat(self) -> bool:
        """B from the (h·w, c, frames) map: a frame narrower than 64 that divides 64."""
        return self.w < WGRAD_WG_KB and WGRAD_WG_KB % self.w == 0

    @property
    def bw(self) -> int:
        return self.w if self.flat else WGRAD_WG_KB

    @property
    def kblocks(self) -> int:
        return self.rows * self.bw // WGRAD_WG_KB

    @property
    def tiles_w(self) -> int:
        return -(-self.w // self.bw)

    @property
    def tiles_h(self) -> int:
        return -(-self.h // self.rows)

    @property
    def tiles(self) -> int:
        return self.b * self.t * self.tiles_h * self.tiles_w

    @property
    def grid(self) -> tuple[int, int]:
        return self.groups * self.n_tiles, self.splits

    @property
    def smem(self) -> int:
        return wgrad_wg_smem(self.nb, self.kh, self.bw, self.rows, self.stages)

    @property
    def workspace(self) -> int:
        """f32 elements of the partials."""
        return self.splits * 2 * self.mtiles * self.cin_pad * 64

    @property
    def copy_elements(self) -> int:
        """bf16 elements of g's channels-last copy."""
        return self.b * self.t * self.h * self.w * self.cp

    def box(self, j: int) -> tuple[int, int, int]:
        """(dt, dw, first output channel) of box j."""
        tap, cb = divmod(j, self.co_bands)
        dt, dw = divmod(tap, self.kw)
        return dt, dw, cb * self.band

    def tile(self, i: int) -> tuple[int, int, int]:
        """(frame, first row, first column) of pixel tile i (column tile fastest)."""
        rest, tx = divmod(i, self.tiles_w)
        frame, ty = divmod(rest, self.tiles_h)
        return frame, ty * self.rows, tx * self.bw

    def split_tiles(self, split: int) -> range:
        return range(self.tiles * split // self.splits, self.tiles * (split + 1) // self.splits)

    def a_coords(self, i: int, j: int) -> tuple[int, int, int, int, int]:
        """(channel, x, y, t, b) of box j's TMA box for pixel tile i, innermost
        first: g at the tile's pixels less the tap's offset, outside the frame
        or the clip where SAME pads."""
        frame, y0, x0 = self.tile(i)
        dt, dw, co0 = self.box(j)
        return co0, x0 - dw + self.kw // 2, y0 - self.kh // 2, frame % self.t - dt + self.kt // 2, frame // self.t

    def maps(self) -> list[dict]:
        """Every tensor map the entry point encodes: dims (innermost first), the
        byte strides of dims 1.., the box and the swizzle's width in bytes."""
        p, frames = self.h * self.w, self.b * self.t
        out = [dict(name="g", dims=(self.cp, self.w, self.h, self.t, self.b),
                    strides=(2 * self.cp, 2 * self.cp * self.w, 2 * self.cp * p, 2 * self.cp * p * self.t),
                    box=(self.band, self.bw, self.rows + self.kh - 1, 1, 1), swizzle=2 * self.band)]
        for name, c, rows in (("x1", self.c1, self.c1p), ("x2", self.c2, self.c2p)):
            if c == 0:
                continue
            n = rows if self.joint else self.nb  # a joint tile's box: one K block of the source's rows
            if self.flat:
                out.append(dict(name=name, dims=(p, c, frames), strides=(2 * p, 2 * p * c),
                                box=(WGRAD_WG_KB, n, 1), swizzle=128))
            else:
                out.append(dict(name=name, dims=(self.w, c, self.h, frames), strides=(2 * p, 2 * self.w, 2 * p * c),
                                box=(WGRAD_WG_KB, n, 1 if self.joint else self.rows, 1), swizzle=128))
        return out


def wgrad_wg_plan(c1: int, c2: int, cout: int, b: int, t: int, h: int, w: int, kt: int, kh: int, kw: int
                  ) -> WgradWgPlan:
    """The wgmma filter-gradient kernel's geometry (see :class:`WgradWgPlan`).

    Bands of 16, 32 or 64 output channels (the narrowest that holds cout, so a
    12- or 16-channel conv stacks four taps in an M-tile); the narrowest N tile
    that holds both sources' channels (each rounded up to 8: one joint tile),
    or else the wider source, at most ``WGRAD_WG_MAX_NB[kh]``; the tallest
    row tile (doubling from one K block, no taller than the frame needs) whose
    ring holds two slots, with as many slots as fit (the A boxes' halo rows
    cost more L2 traffic than a shallow ring costs waiting); then the pixel
    split: the fewest splits that give ``WGRAD_WG_WAVES[band]`` waves of
    ``CONV_MMA_BLOCKS`` blocks, 90 % full (else the best share), at most
    half the tiles (both consumer warpgroups work) and within the workspace
    bound.
    """
    if w % 8:
        raise ValueError(f"the wgmma filter gradient takes frames whose width is a multiple of 8, got {w}")
    band = next(n for n in (16, 32, 64) if n >= cout or n == 64)
    max_nb = WGRAD_WG_MAX_NB[kh]
    both = -(-c1 // 8) * 8 + -(-c2 // 8) * 8 if c2 else 0
    nb = min(max_nb, next(n for n in WGRAD_WG_NB if n >= max(c1, c2, both) or n == WGRAD_WG_NB[-1]))
    one = WgradWgPlan(c1, c2, cout, b, t, h, w, kt, kh, kw, band, nb, rows=1, stages=2, splits=1)
    rk = WGRAD_WG_KB // one.bw
    fits = []  # (rows, most stages)
    rows = rk
    while rows <= WGRAD_WG_MAX_ROWS:
        per_slot = wgrad_wg_smem(nb, kh, one.bw, rows, 1) - WGRAD_WG_SMEM_ALIGN
        stages = min(WGRAD_WG_MAX_STAGES, (CONV_MMA_MAX_SMEM - WGRAD_WG_SMEM_ALIGN) // per_slot)
        if stages >= 2:
            fits.append((rows, stages))
        if rows >= h:
            break
        rows *= 2
    if not fits:
        raise ValueError(f"no wgmma filter-gradient tile fits a {kh}-row kernel")
    rows, stages = fits[-1]
    one = dataclasses.replace(one, rows=rows, stages=stages)
    base = one.grid[0]
    per_split = 2 * one.mtiles * one.cin_pad * 64
    cap = max(1, min(one.tiles // 2, CUDA_MAX_GRID_Y, WGRAD_WG_MAX_WORKSPACE // per_split))

    def share(s):  # the busy share of the last wave's SMs, over the whole grid
        blocks = base * s
        return blocks / (CONV_MMA_BLOCKS * -(-blocks // CONV_MMA_BLOCKS))

    waves = WGRAD_WG_WAVES[band]
    splits = next((s for s in range(1, cap + 1) if base * s >= waves * CONV_MMA_BLOCKS and share(s) >= 0.9),
                  max(range(1, cap + 1), key=lambda s: (share(s), -s)))
    return dataclasses.replace(one, splits=splits)


def conv3d_wgrad_cuda(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    g: torch.Tensor,
    kt: int,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the filter-gradient kernel: f32 (kt, kh, kw, c1 + c2, cout).

    The kernel by :func:`wgrad_variant`: bf16 inputs take the wgmma kernel
    (geometry from :func:`wgrad_wg_plan`; its first launch copies g
    channels-last into scratch allocated here) or, at a width a tensor map
    cannot describe, PR 6's wmma kernel (:func:`wgrad_plan`); f32 inputs the
    CUDA-core one. Each splits the pixel reduction across blocks, each writing
    an f32 partial of its output tile, and a last launch sums the partials in a
    fixed order: no atomics, the same bits on every run.
    """
    c2 = _check_sources("conv3d_wgrad_cuda", x1, x2)
    b, t, c1, h, w = x1.shape
    if g.dim() != 5 or g.shape[:2] != (b, t) or g.shape[3:] != (h, w):
        raise ValueError("g must be a (b, t, cout, h, w) tensor over the activations' pixels")
    if g.dtype != x1.dtype or g.device != x1.device or not g.is_contiguous():
        raise ValueError("g must be contiguous, in the activations' dtype and device")
    _check_kernel_size(kt, kh, kw)
    cout = g.shape[2]
    variant = wgrad_variant(x1.dtype, w)
    # (splits, nj, row_groups, band, nb, rows, stages, smem), workspace, copy of g
    gt = None
    if variant == "wgmma":
        plan = wgrad_wg_plan(c1, c2, cout, b, t, h, w, kt, kh, kw)
        geometry = (plan.splits, 0, 0, plan.band, plan.nb, plan.rows, plan.stages, plan.smem)
        workspace = plan.workspace
        gt = torch.empty(plan.copy_elements, dtype=torch.bfloat16, device=x1.device)
        if any(s.data_ptr() % 16 for s in (x1, x2, g) if s is not None):
            raise ValueError("the wgmma filter gradient needs 16-byte aligned tensors")
    elif variant == "wmma":
        plan = wgrad_plan(c1 + c2, cout, b, t, h, w, kt, kh, kw)
        geometry = (plan.splits, plan.nj, plan.row_groups, 0, 0, 0, 0, 0)
        workspace = plan.workspace
    else:
        k_rows = kt * kh * kw * (c1 + c2)
        # the pixel reduction runs over row segments of 32 pixels
        splits = wgrad_splits(k_rows, cout, b * t * h * -(-w // 32))
        geometry = (splits, 0, 0, 0, 0, 0, 0, 0)
        workspace = splits * k_rows * cout
    partials = torch.empty(workspace, dtype=torch.float32, device=x1.device)
    dw = torch.empty((kt, kh, kw, c1 + c2, cout), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        CONV3D_WGRAD.launch(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), g.data_ptr(),
            None if gt is None else gt.data_ptr(), partials.data_ptr(), dw.data_ptr(),
            c1, c2, b, t, h, w, cout, kt, kh, kw, WGRAD_VARIANTS.index(variant), *geometry,
            DTYPE_CODES[x1.dtype], torch.cuda.current_stream(x1.device).cuda_stream,
        )
    WGRAD_VARIANT_LAUNCHES[variant] += 1
    return dw
