"""The whole MLP sublayer behind one kernel entry point.

Counterpart of the JAX package's ``ops/fused_block.py``:

    y = x + W2 · silu(W1 · LayerNorm(x) + b1) + b2        on (B, S, C) tokens

:func:`fused_mlp_sublayer` is a ``torch.autograd.Function`` whose forward
dispatches by the tensor's device: a CPU tensor takes the plain PyTorch
version (:func:`fused_mlp_sublayer_plain`), a CUDA tensor takes the CUDA
kernel (:func:`fused_mlp_sublayer_cuda`, ``csrc/fused_mlp.cu``) or the call
raises. Where a graph is being recorded (grad mode on and an input that
requires a gradient) the kernel's training variant also writes the backward's
residuals (the post-LN activations ``xa`` and the pre-SiLU hidden ``h``, both
bf16); otherwise, as under ``no_grad`` or ``inference_mode`` whatever the
parameters require, the inference variant writes y alone.

Roundings are the Pallas kernel's, whatever x's dtype: LN statistics in f32,
``xa`` rounded to bf16, both weight matrices cast to bf16, ``h`` and
``silu(h)`` rounded to bf16, and y = f32(x) + (the second product in f32 +
b2) cast once. That is not the module chain's rounding (``x + mlp(x)`` rounds
the branch before the add), and a float32 model on this path still multiplies
bf16 operands.

The kernel is three launches (``csrc/fused_mlp.cu``): the token LN, then two
warp-specialised wgmma GEMMs with fused epilogues (``csrc/gemm_sm90.cuh``),
whose tile width, ring stages and persistent grid come from
:func:`mlp_plan`.

The backward has no kernel in the JAX package and none here: cuBLAS GEMMs on
bf16 operands with f32 output around the SiLU and LayerNorm VJPs in f32.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from video_vae_tpu_torch.ops._build import DTYPE_CODES, CudaKernel
from video_vae_tpu_torch.parallel.sharding import log_kernel
from video_vae_tpu_torch.ops.flash_attention import ln_affine, matmul_f32

FUSED_MLP = CudaKernel(
    "fused_mlp.cu",
    "vvt_fused_mlp",
    [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)
# FUSED_MLP's launches by variant: "training" writes the residuals, "inference" y alone
VARIANT_LAUNCHES = {"inference": 0, "training": 0}

# The GEMM of csrc/gemm_sm90.cuh: a block owns GEMM_BM rows by a tile width of
# GEMM_WIDTHS, its ring holds slabs of GEMM_BK columns of K, W arrives in TMA
# boxes GEMM_PANEL columns wide; two consumer warpgroups of 64 rows each.
GEMM_BM, GEMM_BK, GEMM_PANEL = 128, 64, 64
GEMM_WIDTHS = (256, 128)
GEMM_CONSUMER_WARPGROUPS = 2
GEMM_MAX_STAGES = 5
GEMM_SMEM_ALIGN = 1024
# the epilogue's staging: each consumer warp's 16 rows by 64 columns in f32
GEMM_EPI_BYTES = GEMM_CONSUMER_WARPGROUPS * 4 * 16 * 64 * 4
MAX_SMEM = 232_448  # a block's shared memory on the H100
H100_SMS = 132


def gemm_smem(bn: int, stages: int) -> int:
    """Dynamic shared memory of a GEMM block (``gemm_sm90.cuh:gemm_smem_bytes``):
    alignment slack, the ring's A and W slabs, the epilogue's staging, a full
    and an empty mbarrier a stage."""
    ring = stages * (GEMM_BM * GEMM_BK * 2 + GEMM_BK * bn * 2)
    return GEMM_SMEM_ALIGN + ring + GEMM_EPI_BYTES + stages * 2 * 8


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """One product (n, k) · (k, m) of the MLP kernel.

    A block owns a ``GEMM_BM`` × ``bn`` output tile; ``blocks`` persistent
    blocks walk the tiles, block b taking tiles b, b + blocks, … with the
    column tile fastest; the ring holds ``stages`` slabs of K.
    """

    n: int
    k: int
    m: int
    bn: int
    stages: int
    blocks: int

    @property
    def col_tiles(self) -> int:
        return -(-self.m // self.bn)

    @property
    def tiles(self) -> int:
        return -(-self.n // GEMM_BM) * self.col_tiles

    @property
    def smem(self) -> int:
        return gemm_smem(self.bn, self.stages)

    @property
    def args(self) -> tuple[int, int, int, int]:
        """The fields the C entry point takes, in its order."""
        return self.bn, self.stages, self.blocks, self.smem


@dataclasses.dataclass(frozen=True)
class MlpPlan:
    """The MLP kernel's two products: ``up`` = xa · W1 (K = C, M = F) and
    ``down`` = a · W2 (K = F, M = C)."""

    up: GemmPlan
    down: GemmPlan


def gemm_plan(n: int, k: int, m: int, sms: int = H100_SMS) -> GemmPlan:
    """The tile width with the least work in its last wave (waves × width; the
    wider tile on a tie), the most stages that fit, one block an SM."""
    def cost(bn):
        tiles = -(-n // GEMM_BM) * -(-m // bn)
        return -(-tiles // sms) * bn

    bn = min(GEMM_WIDTHS, key=cost)  # the first of equals: the wider
    stages = min(GEMM_MAX_STAGES, max(s for s in range(2, GEMM_MAX_STAGES + 1) if gemm_smem(bn, s) <= MAX_SMEM))
    plan = GemmPlan(n, k, m, bn, stages, blocks=1)
    return dataclasses.replace(plan, blocks=min(plan.tiles, sms))


def mlp_plan(n: int, C: int, F: int, sms: int = H100_SMS) -> MlpPlan:
    """The MLP kernel's geometry for n tokens of width C and hidden width F."""
    return MlpPlan(up=gemm_plan(n, C, F, sms), down=gemm_plan(n, F, C, sms))


class _MLPSublayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, training):
        args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
        if x.device.type == "cpu":
            y, xa, h = fused_mlp_sublayer_plain(*args)
        elif x.device.type == "cuda":
            y, xa, h = fused_mlp_sublayer_cuda(*args, save_residuals=training)
        else:
            raise ValueError(f"fused_mlp_sublayer: unsupported device {x.device}")
        if training:
            ctx.save_for_backward(x, ln_scale, ln_bias, w1, w2, xa, h)
        return y

    @staticmethod
    def backward(ctx, dy):
        """dgrad/wgrad GEMMs on bf16 operands with f32 sums, SiLU' and the token
        LN backward in f32; db1 and db2 are sums of the unrounded f32 values."""
        x, ln_scale, ln_bias, w1, w2, xa, h = ctx.saved_tensors
        b, s, c = x.shape
        n = b * s
        bf16 = torch.bfloat16
        dy2 = dy.reshape(n, c).float()
        _, xn, r = ln_affine(x.reshape(n, c), ln_scale, ln_bias)
        g32 = ln_scale.float()

        hf = h.float()
        sig = torch.sigmoid(hf)
        a16 = (hf * sig).to(bf16)
        dy16 = dy2.to(bf16)

        da = matmul_f32(dy16, w2.to(bf16).t())  # (N, F)
        dw2 = matmul_f32(a16.t(), dy16)  # (F, C)
        db2 = dy2.sum(dim=0)
        dh = da * (sig + hf * sig * (1.0 - sig))
        dh16 = dh.to(bf16)
        dw1 = matmul_f32(xa.t(), dh16)  # (C, F)
        db1 = dh.sum(dim=0)
        dxa = matmul_f32(dh16, w1.to(bf16).t())  # (N, C)

        dscale = (dxa * xn).sum(dim=0)
        dbias = dxa.sum(dim=0)
        du = dxa * g32
        dx_ln = r * (du - du.mean(dim=-1, keepdim=True) - xn * (du * xn).mean(dim=-1, keepdim=True))
        return (
            (dy2 + dx_ln).to(x.dtype).reshape(b, s, c),
            dscale.to(ln_scale.dtype), dbias.to(ln_scale.dtype),
            dw1.to(w1.dtype), db1.to(w1.dtype),
            dw2.to(w2.dtype), db2.to(w2.dtype),
            None,
        )


def fused_mlp_sublayer(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """y = x + MLP(LN(x)) for x (B, S, C); w1 (C, F), w2 (F, C).

    Parameters arrive in their stored dtype and their gradients come back in
    it; both products run on bf16 operands with f32 accumulation whatever x's
    dtype is.
    """
    if x.dim() != 3:
        raise ValueError("x must be (B, S, C)")
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    # Decided here and not in forward: there the grad mode is always off, and
    # needs_input_grad follows requires_grad even under no_grad or inference_mode.
    training = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    log_kernel("fused_mlp", x)
    return _MLPSublayer.apply(*args, training)


def fused_mlp_sublayer_plain(x, ln_scale, ln_bias, w1, b1, w2, b2):
    """The MLP kernel's arithmetic in plain PyTorch: (y, xa, h).

    xa = LN(x)·g + b rounded to bf16 (N, C); h = xa·W1 (bf16 operands, f32
    accumulation) + b1 rounded to bf16 (N, F); a = silu(f32(h)) rounded to
    bf16; y = f32(x) + (a·W2 + b2 in f32) with one rounding to x's dtype.
    """
    bf16 = torch.bfloat16
    lead, c = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, c)
    xa, _, _ = ln_affine(x2, ln_scale, ln_bias)
    h = (matmul_f32(xa, w1.to(bf16)) + b1.float()).to(bf16)
    hf = h.float()
    a = (hf * torch.sigmoid(hf)).to(bf16)
    y = matmul_f32(a, w2.to(bf16)) + b2.float()
    return (x2.float() + y).to(x.dtype).reshape(*lead, c), xa, h


def fused_mlp_sublayer_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, save_residuals=True):
    """Launch the MLP kernel: (y, xa, h); xa and h are None for the inference variant.

    x is (..., C) with any number of rows. The weights are cast to bf16 and
    the vectors to f32 here, outside the kernel, as the JAX wrapper does; the
    geometry of the two products is :func:`mlp_plan`'s for this card's SMs.
    """
    if not x.is_cuda:
        raise ValueError("fused_mlp_sublayer_cuda needs a CUDA tensor")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"the MLP kernel takes float32 or bfloat16, not {x.dtype}")
    c = x.shape[-1]
    f = w1.shape[-1]
    if w1.shape != (c, f) or w2.shape != (f, c):
        raise ValueError("w1 must be (C, F) and w2 (F, C)")
    if ln_scale.shape != (c,) or ln_bias.shape != (c,) or b1.shape != (f,) or b2.shape != (c,):
        raise ValueError("ln_scale, ln_bias, b2 must be (C,) and b1 (F,)")
    if c % 8 or f % 8:
        raise ValueError(f"the MLP kernel takes C and F that are multiples of 8, got {c}, {f}")
    device = x.device
    x = x.contiguous()
    n = x.numel() // c
    if n < 1:
        raise ValueError("x has no rows")

    def f32(t):
        return t.to(device=device, dtype=torch.float32).contiguous()

    def weight(t):
        return t.to(device=device, dtype=torch.bfloat16).contiguous()

    lng, lnb, b1f, b2f = f32(ln_scale), f32(ln_bias), f32(b1), f32(b2)
    w1b, w2b = weight(w1), weight(w2)
    y = torch.empty_like(x)
    xa = torch.empty((n, c), dtype=torch.bfloat16, device=device)
    a = torch.empty((n, f), dtype=torch.bfloat16, device=device)
    h = torch.empty((n, f), dtype=torch.bfloat16, device=device) if save_residuals else None
    tensors = (x, lng, lnb, w1b, b1f, w2b, b2f, y, xa, a) + (() if h is None else (h,))
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the MLP kernel needs 16-byte aligned tensors")
    if n >= 2**31:
        raise ValueError(f"the MLP kernel takes fewer than 2^31 rows, got {n}")
    plan = mlp_plan(n, c, f, torch.cuda.get_device_properties(device).multi_processor_count)
    with torch.cuda.device(device):
        FUSED_MLP.launch(
            x.data_ptr(), lng.data_ptr(), lnb.data_ptr(), w1b.data_ptr(), b1f.data_ptr(),
            w2b.data_ptr(), b2f.data_ptr(), y.data_ptr(), xa.data_ptr(),
            None if h is None else h.data_ptr(), a.data_ptr(),
            n, c, f, DTYPE_CODES[x.dtype], *plan.up.args, *plan.down.args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    VARIANT_LAUNCHES["training" if save_residuals else "inference"] += 1
    return (y, xa, h) if save_residuals else (y, None, None)
