"""Stride-1 SAME 3-D convolution on channels-first (b, t, c, h, w) activations.

Counterpart of the JAX package's ``ops/conv3d.py:conv3d_cf`` and
``conv3d_cf_cat2`` (the Pallas ``_conv_kernel`` forward and ``_wgrad_kernel``
filter gradient, with the custom VJP ``_cf_grads``). The kernel stays DHWIO
(kt, kh, kw, cin, cout) as in the JAX params; the bias is f32; accumulation
is f32 and the output takes the input dtype.

Both entry points are ``torch.autograd.Function``s. Each piece dispatches by
the tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA
tensor takes the CUDA kernel or the call raises.

* forward: ``csrc/conv3d.cu``;
* input gradient: the forward conv of g with the spatially flipped,
  IO-swapped kernel and a zero bias, so ``csrc/conv3d.cu`` again;
* filter gradient: ``csrc/conv3d_wgrad.cu`` over one or two sources (the
  UpBlock's skip concat is never built);
* bias gradient: the f32 sum of g over (b, t, h, w).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from video_vae_tpu_torch.ops._build import CudaKernel

CONV3D = CudaKernel(
    "conv3d.cu",
    "vvt_conv3d_cf",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
CONV3D_WGRAD = CudaKernel(
    "conv3d_wgrad.cu",
    "vvt_conv3d_wgrad",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
)

KERNEL_WIDTHS = (1, 3, 5, 7)
KERNEL_MAX_HEIGHT = 7
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The filter-gradient kernel's output tile (rows of the (kt·kh·kw·cin) axis ×
# output channels) and the number of blocks it aims to keep in flight: the
# pixel reduction is split across blocks until the grid has about this many.
WGRAD_TILE_K, WGRAD_TILE_CO, WGRAD_TARGET_BLOCKS = 128, 16, 1056


def _dispatch(x1, x2, kernel, bias):
    if x1.device.type == "cpu":
        return conv3d_cf_plain(x1, x2, kernel, bias)
    if x1.device.type == "cuda":
        return conv3d_cf_cuda(x1, x2, kernel, bias)
    raise ValueError(f"conv3d_cf: unsupported device {x1.device}")


class _Conv3dCF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, kernel, bias):
        ctx.save_for_backward(x1, x2, kernel)
        ctx.bias_dtype = bias.dtype
        return _dispatch(x1, x2, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x1, x2, kernel = ctx.saved_tensors
        kt, kh, kw, cin, cout = kernel.shape
        g = g.to(x1.dtype).contiguous()
        dx1 = dx2 = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # stride 1, SAME, odd taps: dx is the forward conv of g with the
            # spatially flipped, IO-swapped kernel
            flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
            zero = torch.zeros(cin, dtype=torch.float32, device=g.device)
            dx = _dispatch(g, None, flipped, zero)
            c1 = x1.shape[2]
            dx1, dx2 = (dx, None) if x2 is None else (dx[:, :, :c1], dx[:, :, c1:])
        dkernel = conv3d_wgrad(x1, x2, g, kt, kh, kw).to(kernel.dtype)
        dbias = g.float().sum(dim=(0, 1, 3, 4)).to(ctx.bias_dtype)
        return dx1, dx2, dkernel, dbias


def conv3d_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(b, t, cin, h, w) → (b, t, cout, h, w) with a DHWIO kernel."""
    return _Conv3dCF.apply(x, None, kernel, bias)


def conv3d_cf_cat2(
    x1: torch.Tensor, x2: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """The conv of the channel concat [x1; x2]; the concat is never built."""
    return _Conv3dCF.apply(x1, x2, kernel, bias)


def conv3d_wgrad(
    x1: torch.Tensor, x2: Optional[torch.Tensor], g: torch.Tensor, kt: int, kh: int, kw: int
) -> torch.Tensor:
    """f32 filter gradient (kt, kh, kw, c1 + c2, cout) of the conv of [x1; x2]."""
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
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: one f32 product per tap.

    Sums kt·kh·kw shifted (b,t,cin,h,w)·(cin,cout) contractions of the
    zero-padded input in f32, adds the bias and rounds once.
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
    if x1.dtype not in _DTYPE_CODES:
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


def conv3d_cf_cuda(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    kernel: torch.Tensor,
    bias: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel over one source, or two without their concat."""
    c2 = _check_sources("conv3d_cf_cuda", x1, x2)
    b, t, c1, h, w = x1.shape
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
    y = torch.empty((b, t, cout, h, w), dtype=x1.dtype, device=x1.device)
    with torch.cuda.device(x1.device):
        CONV3D.launch(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), c1, c2,
            kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, t, h, w, cout, kt, kh, kw, _DTYPE_CODES[x1.dtype],
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
    return y


def wgrad_splits(k_rows: int, cout: int, segments: int) -> int:
    """How many blocks share one output tile's pixel reduction."""
    tiles = -(-k_rows // WGRAD_TILE_K) * -(-cout // WGRAD_TILE_CO)
    return max(1, min(segments, WGRAD_TARGET_BLOCKS // tiles))


def conv3d_wgrad_cuda(
    x1: torch.Tensor,
    x2: Optional[torch.Tensor],
    g: torch.Tensor,
    kt: int,
    kh: int,
    kw: int,
) -> torch.Tensor:
    """Launch the filter-gradient kernel: f32 (kt, kh, kw, c1 + c2, cout).

    The kernel splits the pixel reduction across blocks, each writing an f32
    partial of its output tile, and a second pass sums the partials in a
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
    k_rows = kt * kh * kw * (c1 + c2)
    # the pixel reduction runs over row segments of 32 pixels
    splits = wgrad_splits(k_rows, cout, b * t * h * -(-w // 32))
    partials = torch.empty((splits, k_rows, cout), dtype=torch.float32, device=x1.device)
    dw = torch.empty((kt, kh, kw, c1 + c2, cout), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        CONV3D_WGRAD.launch(
            x1.data_ptr(), None if x2 is None else x2.data_ptr(), g.data_ptr(),
            partials.data_ptr(), dw.data_ptr(),
            c1, c2, b, t, h, w, cout, kt, kh, kw, splits, _DTYPE_CODES[x1.dtype],
            torch.cuda.current_stream(x1.device).cuda_stream,
        )
    return dw
