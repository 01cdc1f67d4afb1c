"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no GPU. On a GPU machine without
JAX (``tests/conftest.py`` imports it):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from video_vae_tpu_torch.ops.conv3d import (
    CONV3D,
    CONV3D_WGRAD,
    conv3d_cf,
    conv3d_cf_cat2,
    conv3d_cf_cuda,
    conv3d_cf_plain,
    conv3d_wgrad_cuda,
    conv3d_wgrad_plain,
)
from video_vae_tpu_torch.ops.flash_attention import (
    FUSED_ATTENTION,
    FUSED_ATTENTION_BWD,
    fused_qkv_attention,
    fused_qkv_attention_bwd_cuda,
    fused_qkv_attention_bwd_plain,
    fused_qkv_attention_cuda,
    fused_qkv_attention_plain,
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
    assert torch.equal(out, again)


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
