"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no GPU. On a GPU machine without
JAX (``tests/conftest.py`` imports it):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from video_vae_tpu_torch.ops.conv3d import (
    CONV3D,
    CONV3D_TAPDOT,
    CONV3D_WGRAD,
    conv3d_cf,
    conv3d_cf_cat2,
    conv3d_cf_cuda,
    conv3d_cf_plain,
    conv3d_cf_pooled,
    conv3d_tapdot_cuda,
    conv3d_tapdot_plain,
    conv3d_wgrad_cuda,
    conv3d_wgrad_plain,
)
from video_vae_tpu_torch.ops.flash_attention import (
    ATTENTION_SUBLAYER,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    FUSED_ATTENTION,
    FUSED_ATTENTION_BWD,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    fused_attention_sublayer,
    fused_attention_sublayer_cuda,
    fused_attention_sublayer_plain,
    fused_qkv_attention,
    fused_qkv_attention_bwd_cuda,
    fused_qkv_attention_bwd_plain,
    fused_qkv_attention_cuda,
    fused_qkv_attention_plain,
)
from video_vae_tpu_torch.ops.fused_block import (
    FUSED_MLP,
    fused_mlp_sublayer,
    fused_mlp_sublayer_cuda,
    fused_mlp_sublayer_plain,
)

pytestmark = pytest.mark.cuda

# max-abs error over max|plain|: f32 sums in another order; bf16 one output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,masked", [(40, 16, True), (3, 256, False), (5, 37, True)])
def test_fused_attention_kernel_matches_plain(device, dtype, B, S, masked):
    H, D = 8, 64
    gen = torch.Generator(device="cpu").manual_seed(S)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, dtype)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    mask = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    before = FUSED_ATTENTION.launches
    out = fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION.launches == before + 1
    ref = fused_qkv_attention_plain(qkv, qs, ks, mask, H)
    assert out.dtype == dtype and _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,cins,cout,k",
    [
        ((2, 3, 20, 40), (12,), 12, (3, 7, 7)),
        ((1, 4, 33, 65), (16, 16), 16, (3, 3, 3)),
        ((2, 2, 16, 32), (64,), 128, (3, 3, 3)),
        ((1, 3, 9, 11), (5,), 3, (1, 5, 1)),
    ],
)
def test_conv3d_kernel_matches_plain(device, dtype, shape, cins, cout, k):
    b, t, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) + cout)
    xs = [torch.randn(b, t, c, h, w, generator=gen).to(device, dtype) for c in cins]
    kernel = (torch.randn(*k, sum(cins), cout, generator=gen) * 0.1).to(device, dtype)
    bias = torch.randn(cout, generator=gen).to(device)
    x2 = xs[1] if len(xs) == 2 else None
    before = CONV3D.launches
    out = conv3d_cf_cuda(xs[0], x2, kernel, bias)
    torch.cuda.synchronize()
    assert CONV3D.launches == before + 1
    ref = conv3d_cf_plain(xs[0], x2, kernel, bias)
    assert out.dtype == dtype and _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,masked", [(40, 16, True), (3, 256, False), (5, 37, True), (2, 200, True)])
def test_fused_attention_bwd_kernel_matches_plain(device, dtype, B, S, masked):
    H, D = 8, 64
    gen = torch.Generator(device="cpu").manual_seed(S + 1)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, dtype)
    g = torch.randn(B, S, H * D, generator=gen).to(device, dtype)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    mask = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    before = FUSED_ATTENTION_BWD.launches
    out = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    again = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 2
    ref = fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
    assert out[0].dtype == dtype
    for a, b, c in zip(out, ref, again):
        assert _rel_err(a, b) <= TOL[dtype]
        assert torch.equal(a, c)  # no atomics: the same bits on every run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,cins,cout,k",
    [
        ((2, 3, 20, 40), (12,), 12, (3, 7, 7)),
        ((1, 4, 33, 65), (16, 16), 16, (3, 3, 3)),
        ((2, 2, 16, 32), (64,), 128, (3, 3, 3)),
        ((1, 3, 9, 11), (5,), 3, (1, 5, 1)),
        ((1, 5, 24, 72), (12,), 12, (3, 7, 7)),  # the flagship patch mixer, a cut frame
        ((1, 3, 16, 48), (32,), 256, (3, 3, 3)),  # cout across four output-channel tiles
        ((2, 2, 20, 48), (12,), 12, (1, 7, 7)),  # the tap-dot model's kt = 1 patch mixer
        ((1, 2, 8, 16), (256, 256), 256, (1, 3, 3)),  # its (256+256) -> 256 decoder conv
        ((2, 2, 12, 6), (16,), 32, (3, 3, 3)),  # a frame narrower than 16 pixels
    ],
)
def test_conv3d_wgrad_kernel_matches_plain(device, dtype, shape, cins, cout, k):
    b, t, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) * cout)
    xs = [torch.randn(b, t, c, h, w, generator=gen).to(device, dtype) for c in cins]
    g = torch.randn(b, t, cout, h, w, generator=gen).to(device, dtype)
    x2 = xs[1] if len(xs) == 2 else None
    before = CONV3D_WGRAD.launches
    out = conv3d_wgrad_cuda(xs[0], x2, g, *k)
    again = conv3d_wgrad_cuda(xs[0], x2, g, *k)
    torch.cuda.synchronize()
    assert CONV3D_WGRAD.launches == before + 2
    ref = conv3d_wgrad_plain(xs[0], x2, g, *k)
    # f32 output either way: bf16 operands multiply exactly, sums are f32
    assert out.dtype == torch.float32 and _rel_err(out, ref) <= TOL[torch.float32]
    assert torch.equal(out, again)  # no atomics: the same bits on every run


@pytest.mark.parametrize("two_sources", [False, True])
def test_conv_backward_launches_dgrad_and_wgrad_kernels(device, two_sources):
    """A backward through the conv launches the forward kernel for dx and the wgrad kernel."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    cins = (8, 8) if two_sources else (12,)
    xs = [torch.randn(2, 3, c, 16, 32, generator=gen).to(device).requires_grad_() for c in cins]
    kernel = (0.1 * torch.randn(3, 3, 3, sum(cins), 8, generator=gen)).to(device).requires_grad_()
    bias = torch.randn(8, generator=gen).to(device).requires_grad_()
    g = torch.randn(2, 3, 8, 16, 32, generator=gen).to(device)
    conv_before, wgrad_before = CONV3D.launches, CONV3D_WGRAD.launches
    out = conv3d_cf(*xs, kernel, bias) if not two_sources else conv3d_cf_cat2(*xs, kernel, bias)
    grads = torch.autograd.grad(out, [*xs, kernel, bias], g)
    torch.cuda.synchronize()
    # the forward, then the input gradient through the same kernel; one wgrad
    assert CONV3D.launches == conv_before + 2 and CONV3D_WGRAD.launches == wgrad_before + 1
    cpu = [x.detach().cpu().requires_grad_() for x in (*xs, kernel, bias)]
    ref_out = conv3d_cf(*cpu) if not two_sources else conv3d_cf_cat2(*cpu)
    ref = torch.autograd.grad(ref_out, cpu, g.cpu())
    for a, b in zip(grads, ref):
        assert _rel_err(a.cpu(), b) <= TOL[torch.float32]


def test_attention_backward_launches_bwd_kernel(device):
    gen = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn(6, 16, 3 * 8 * 64, generator=gen).to(device).requires_grad_()
    qs = torch.ones(64, device=device, requires_grad=True)
    ks = torch.ones(64, device=device, requires_grad=True)
    out = fused_qkv_attention(qkv, qs, ks, None, 8)
    before = FUSED_ATTENTION_BWD.launches
    grads = torch.autograd.grad(out, [qkv, qs, ks], torch.randn(out.shape, generator=gen).to(device))
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 1
    assert all(torch.isfinite(x).all() for x in grads)


def _flash_inputs(device, dtype, B, S, masked, strided):
    H, D = 8, 64
    gen = torch.Generator(device="cpu").manual_seed(S + 2)
    if strided:  # q, k, v as views into one fused (B, S, 3*H*D) projection
        qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, dtype)
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.chunk(3, dim=-1))
        assert not v.is_contiguous()
    else:
        q, k, v = (torch.randn(B, S, H, D, generator=gen).to(device, dtype) for _ in range(3))
    g = torch.randn(B, S, H, D, generator=gen).to(device, dtype)
    mask = None
    if masked:
        lengths = torch.randint(0, S + 1, (B,), generator=gen)  # 0: a fully masked sequence
        lengths[0] = 0
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    return q, k, v, g, mask


FLASH_CASES = [(40, 16, True, False), (3, 256, False, True), (5, 37, True, True), (2, 200, True, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,masked,strided", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(device, dtype, B, S, masked, strided):
    q, k, v, _, mask = _flash_inputs(device, dtype, B, S, masked, strided)
    before = FLASH_ATTENTION.launches
    out = flash_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 1
    ref = flash_attention_plain(q, k, v, mask)
    assert out.dtype == dtype and out.is_contiguous() and torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,masked,strided", FLASH_CASES)
def test_flash_attention_bwd_kernel_matches_plain(device, dtype, B, S, masked, strided):
    q, k, v, g, mask = _flash_inputs(device, dtype, B, S, masked, strided)
    before = FLASH_ATTENTION_BWD.launches
    out = flash_attention_bwd_cuda(q, k, v, mask, g)
    again = flash_attention_bwd_cuda(q, k, v, mask, g)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_BWD.launches == before + 2
    ref = flash_attention_bwd_plain(q, k, v, mask, g)
    for a, b, c in zip(out, ref, again):
        assert a.dtype == dtype and _rel_err(a, b) <= TOL[dtype]
        assert torch.equal(a, c)  # no atomics: the same bits on every run


def _sublayer_args(device, dtype, B, S, C, H, masked):
    D = 64
    gen = torch.Generator(device="cpu").manual_seed(B + S)
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    args = [
        rn(B, S, C).to(dtype), 1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, 3 * H * D) / C**0.5,
        0.2 * rn(3 * H * D), 1 + 0.2 * rn(D), 1 + 0.2 * rn(D), rn(H * D, C) / (H * D) ** 0.5,
        0.2 * rn(C),
    ]
    mask = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    return [a.to(device) for a in args], mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,C,H,masked",
    [(64, 16, 768, 8, True), (3, 256, 768, 8, False), (5, 37, 136, 3, True)],  # the last: ragged tiles
)
def test_attention_sublayer_kernel_matches_plain(device, dtype, B, S, C, H, masked):
    args, mask = _sublayer_args(device, dtype, B, S, C, H, masked)
    before, fused_before = ATTENTION_SUBLAYER.launches, FUSED_ATTENTION.launches
    out = fused_attention_sublayer_cuda(*args, mask, H)
    torch.cuda.synchronize()
    assert ATTENTION_SUBLAYER.launches == before + 1
    assert FUSED_ATTENTION.launches == fused_before  # its attention is the sublayer's own launch
    ref = fused_attention_sublayer_plain(*args, mask, H)
    # both sides round the GEMM operands to bf16 whatever x's dtype is
    for name, a, b in zip(("y", "qkv", "o"), out, ref):
        assert a.dtype == dtype and _rel_err(a, b) <= TOL[torch.bfloat16], name


def test_attention_sublayer_backward_launches_fused_bwd_kernel(device):
    args, mask = _sublayer_args(device, torch.bfloat16, 6, 16, 768, 8, True)
    leaves = [a.requires_grad_() for a in args]
    counts = (ATTENTION_SUBLAYER.launches, FUSED_ATTENTION.launches, FUSED_ATTENTION_BWD.launches)
    y = fused_attention_sublayer(*leaves, mask, 8)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(device, y.dtype)
    grads = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert ATTENTION_SUBLAYER.launches == counts[0] + 1
    assert FUSED_ATTENTION.launches == counts[1] and FUSED_ATTENTION_BWD.launches == counts[2] + 1
    cpu = [a.detach().cpu().requires_grad_() for a in args]
    ref = torch.autograd.grad(fused_attention_sublayer(*cpu, mask.cpu(), 8), cpu, g.cpu())
    for a, b in zip(grads, ref):
        assert a.dtype == b.dtype and _rel_err(a.cpu(), b) <= TOL[torch.bfloat16]


def _mlp_args(device, dtype, rows, C, F):
    gen = torch.Generator(device="cpu").manual_seed(sum(rows) + C)
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    args = [
        rn(*rows, C).to(dtype), 1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, F) / C**0.5, 0.2 * rn(F),
        rn(F, C) / F**0.5, 0.2 * rn(C),
    ]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "rows,C,F",
    [((32, 16), 768, 1536), ((1, 13), 768, 1536), ((3, 50), 136, 264)],  # ragged rows, ragged tiles
)
def test_fused_mlp_kernel_matches_plain(device, dtype, rows, C, F):
    args = _mlp_args(device, dtype, rows, C, F)
    before = FUSED_MLP.launches
    out = fused_mlp_sublayer_cuda(*args, save_residuals=True)
    y_only = fused_mlp_sublayer_cuda(*args, save_residuals=False)
    torch.cuda.synchronize()
    assert FUSED_MLP.launches == before + 2
    ref = fused_mlp_sublayer_plain(*args)
    # both sides round the GEMM operands to bf16 whatever x's dtype is
    for name, a, b in zip(("y", "xa", "h"), out, ref):
        assert a.shape == b.shape and _rel_err(a, b) <= TOL[torch.bfloat16], name
    assert out[0].dtype == dtype and out[1].dtype == out[2].dtype == torch.bfloat16
    # the inference variant: the same y, no residuals
    assert torch.equal(y_only[0], out[0]) and y_only[1] is None and y_only[2] is None


def test_fused_mlp_backward_matches_cpu(device):
    args = _mlp_args(device, torch.bfloat16, (6, 16), 768, 1536)
    leaves = [a.requires_grad_() for a in args]
    before = FUSED_MLP.launches
    y = fused_mlp_sublayer(*leaves)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(device, y.dtype)
    grads = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert FUSED_MLP.launches == before + 1
    cpu = [a.detach().cpu().requires_grad_() for a in args]
    ref = torch.autograd.grad(fused_mlp_sublayer(*cpu), cpu, g.cpu())
    for a, b in zip(grads, ref):
        assert a.dtype == b.dtype and _rel_err(a.cpu(), b) <= TOL[torch.bfloat16]


@pytest.mark.parametrize(
    "shape,cins,cout,k,pool",
    [
        ((1, 2, 128, 128), (128,), 128, (1, 3, 3), False),
        ((1, 2, 128, 128), (128, 64), 128, (1, 3, 3), False),
        ((1, 1, 128, 128), (128,), 256, (1, 3, 3), False),
        ((1, 2, 128, 128), (128,), 64, (1, 3, 3), True),
        ((2, 1, 22, 136), (136, 8), 72, (1, 5, 3), True),  # ragged tiles, a chunk across both sources
        ((1, 1, 9, 130), (128,), 8, (1, 1, 7), False),  # a width that rules out vector loads
    ],
)
def test_tapdot_kernel_matches_plain(device, shape, cins, cout, k, pool):
    b, t, h, w = shape
    dtype = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) + cout)
    xs = [torch.randn(b, t, c, h, w, generator=gen).to(device, dtype) for c in cins]
    kernel = (torch.randn(*k, sum(cins), cout, generator=gen) / (sum(cins) * k[1] * k[2]) ** 0.5).to(device, dtype)
    bias = torch.randn(cout, generator=gen).to(device)
    x2 = xs[1] if len(xs) == 2 else None
    before = CONV3D_TAPDOT.launches
    out = conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=pool)
    torch.cuda.synchronize()
    assert CONV3D_TAPDOT.launches == before + 1
    ref = conv3d_tapdot_plain(xs[0], x2, kernel, bias, pool=pool)
    for a, r in zip(out if pool else (out,), ref if pool else (ref,)):
        assert a.dtype == dtype and a.shape == r.shape and _rel_err(a, r) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,cin,cout,k", [((1, 2, 64, 64), 12, 16, (3, 3, 3)), ((2, 2, 18, 44), 5, 19, (1, 3, 5))]
)
def test_conv3d_kernel_pooled_output_matches_plain(device, dtype, shape, cin, cout, k):
    b, t, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(cin + cout)
    x = torch.randn(b, t, cin, h, w, generator=gen).to(device, dtype)
    kernel = (torch.randn(*k, cin, cout, generator=gen) * 0.1).to(device, dtype)
    bias = torch.randn(cout, generator=gen).to(device)
    before = CONV3D.launches
    full, pooled = conv3d_cf_cuda(x, None, kernel, bias, pool=True)
    torch.cuda.synchronize()
    assert CONV3D.launches == before + 1
    ref_full, ref_pooled = conv3d_cf_plain(x, None, kernel, bias, pool=True)
    assert pooled.shape == (b, t, cout, h // 2, w // 2) and pooled.dtype == dtype
    assert _rel_err(full, ref_full) <= TOL[dtype] and _rel_err(pooled, ref_pooled) <= TOL[dtype]
    assert torch.equal(full, conv3d_cf_cuda(x, None, kernel, bias))


@pytest.mark.parametrize("tapdot", [False, True])
def test_conv3d_cf_pooled_dispatch_and_backward(device, tapdot, monkeypatch):
    """The pooled entry point: one forward launch of the kernel the gate picks,
    then the shared conv backward; gradients against the CPU's."""
    monkeypatch.setenv("VVT_TAPDOT", "1" if tapdot else "0")
    dtype = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(1, 2, 128, 16, 128, generator=gen).to(device, dtype).requires_grad_()
    kernel = (torch.randn(1, 3, 3, 128, 16, generator=gen) / 34).to(device, dtype).requires_grad_()
    bias = torch.randn(16, generator=gen).to(device).requires_grad_()
    counts = (CONV3D.launches, CONV3D_TAPDOT.launches, CONV3D_WGRAD.launches)
    full, pooled = conv3d_cf_pooled(x, kernel, bias)
    g = [torch.randn(t.shape, generator=gen).to(device, dtype) for t in (full, pooled)]
    grads = torch.autograd.grad([full, pooled], [x, kernel, bias], g)
    torch.cuda.synchronize()
    # forward through the gated kernel; the input gradient (16 channels in) through the direct one
    assert CONV3D_TAPDOT.launches - counts[1] == (1 if tapdot else 0)
    assert CONV3D.launches - counts[0] == (1 if tapdot else 2)
    assert CONV3D_WGRAD.launches - counts[2] == 1
    cpu = [t.detach().cpu().requires_grad_() for t in (x, kernel, bias)]
    ref = torch.autograd.grad(conv3d_cf_pooled(*cpu), cpu, [t.cpu() for t in g])
    for a, r in zip(grads, ref):
        assert a.dtype == r.dtype and _rel_err(a.cpu(), r) <= TOL[dtype]


def _small_model(device, **overrides):
    from video_vae_tpu_torch import ModelConfig, VideoVAE

    cfg = ModelConfig(height=64, width=64, encoder_depth=1, decoder_depth=1, remat=False, **overrides)
    return cfg, VideoVAE(cfg, device=device, seed=0)


@pytest.mark.parametrize("path", ["pallas", "sublayer"])
def test_model_paths_launch_their_kernels(device, path, monkeypatch):
    """One train step per path: 2 attention calls per block, forward and backward."""
    from video_vae_tpu_torch import DynamicHParams, LossConfig
    from video_vae_tpu_torch.ops import KERNELS
    from video_vae_tpu_torch.train.step import loss_and_grads

    if path == "sublayer":
        monkeypatch.setenv("VVT_ATTN_SUBLAYER", "1")
        cfg, model = _small_model(device, attention_impl="fused")
        used = {"vvt_attention_sublayer": 4, "vvt_fused_attention_bwd": 4}
    else:
        monkeypatch.delenv("VVT_ATTN_SUBLAYER", raising=False)
        cfg, model = _small_model(device, attention_impl="pallas")
        used = {"vvt_flash_attention_fwd": 4, "vvt_flash_attention_bwd": 4}
    before = {k.symbol: k.launches for k in KERNELS}
    video = torch.rand(1, 4, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(device)
    loss, _, grads = loss_and_grads(
        model, video, torch.ones(1, 4, device=device), DynamicHParams.default(),
        LossConfig(use_perceptual=False), None, generator=torch.Generator(device=device).manual_seed(1),
    )
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    for kernel in KERNELS:
        if kernel.symbol.startswith("vvt_conv3d"):
            continue
        assert kernel.launches - before[kernel.symbol] == used.get(kernel.symbol, 0), kernel.symbol


@pytest.mark.parametrize("sublayer", [False, True])
def test_mlp_path_launches_its_kernel(device, sublayer, monkeypatch):
    """VVT_MLP_FUSED=1: two MLP sublayers per block, the training variant under
    autograd and the inference variant in the serving pass."""
    from video_vae_tpu_torch import DynamicHParams, LossConfig, reconstruct
    from video_vae_tpu_torch.ops import KERNELS
    from video_vae_tpu_torch.train.step import loss_and_grads

    monkeypatch.setenv("VVT_MLP_FUSED", "1")
    monkeypatch.setenv("VVT_ATTN_SUBLAYER", "1" if sublayer else "0")
    monkeypatch.delenv("VVT_TAPDOT", raising=False)
    cfg, model = _small_model(device)
    video = torch.rand(1, 4, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(device)
    mask = torch.ones(1, 4, device=device)
    from video_vae_tpu_torch.ops.fused_block import VARIANT_LAUNCHES

    before = {k.symbol: k.launches for k in KERNELS}
    variants = dict(VARIANT_LAUNCHES)
    out = reconstruct(model, video, mask, device=device)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    # the parameters require gradients, the serving pass records no graph
    assert VARIANT_LAUNCHES == {"inference": variants["inference"] + 4, "training": variants["training"]}
    forward = "vvt_attention_sublayer" if sublayer else "vvt_fused_attention_fwd"
    used = {"vvt_fused_mlp": 4, forward: 4}
    for kernel in KERNELS:
        if not kernel.symbol.startswith("vvt_conv3d"):
            assert kernel.launches - before[kernel.symbol] == used.get(kernel.symbol, 0), kernel.symbol
    before = {k.symbol: k.launches for k in KERNELS}
    loss, _, grads = loss_and_grads(
        model, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=False), None,
        generator=torch.Generator(device=device).manual_seed(1),
    )
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert VARIANT_LAUNCHES == {"inference": variants["inference"] + 4, "training": variants["training"] + 4}
    used = {"vvt_fused_mlp": 4, forward: 4, "vvt_fused_attention_bwd": 4}
    for kernel in KERNELS:
        if not kernel.symbol.startswith("vvt_conv3d"):
            assert kernel.launches - before[kernel.symbol] == used.get(kernel.symbol, 0), kernel.symbol


def test_tapdot_path_launches_its_kernel(device, monkeypatch):
    """VVT_TAPDOT=1 on a kt = 1 UNet of base width 64 at 256 x 256: the gate
    sends 4 forward convs and 4 input gradients to the tap-dot kernel."""
    from video_vae_tpu_torch.models.unet import UNet3D

    def run(flag):
        monkeypatch.setenv("VVT_TAPDOT", flag)
        unet = UNet3D(12, 64, 3, 3, torch.Generator().manual_seed(0), temporal_kernel=1,
                      dtype=torch.bfloat16).to(device)
        with torch.no_grad():
            unet.final_conv.kernel.normal_(0.0, 0.1, generator=torch.Generator(device=device).manual_seed(1))
        x = torch.randn(1, 2, 12, 256, 256, generator=torch.Generator().manual_seed(2)).to(device)
        x.requires_grad_()
        counts = (CONV3D.launches, CONV3D_TAPDOT.launches, CONV3D_WGRAD.launches)
        y = unet(x)
        (dx,) = torch.autograd.grad(y.float().square().sum(), x)
        torch.cuda.synchronize()
        got = (CONV3D.launches - counts[0], CONV3D_TAPDOT.launches - counts[1], CONV3D_WGRAD.launches - counts[2])
        return y, dx, got

    y1, dx1, got1 = run("1")
    y0, dx0, got0 = run("0")
    assert got1 == (22, 8, 15) and got0 == (30, 0, 15)
    assert _rel_err(y1, y0) <= 5e-2 and _rel_err(dx1, dx0) <= 5e-2
