"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no GPU. On a GPU machine without
JAX (``tests/conftest.py`` imports it):
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import ctypes
import math

import pytest
import torch

from video_vae_tpu_torch.ops._build import CudaKernel
from video_vae_tpu_torch.ops.conv3d import (
    CONV3D,
    CONV3D_TAPDOT,
    CONV3D_WGRAD,
    WGRAD_VARIANT_LAUNCHES,
    conv3d_cf,
    conv3d_cf_cat2,
    conv3d_cf_cuda,
    conv3d_cf_plain,
    conv3d_cf_pooled,
    conv3d_tapdot_cuda,
    conv3d_tapdot_plain,
    conv3d_wgrad_cuda,
    conv3d_wgrad_plain,
    wgrad_variant,
)
from video_vae_tpu_torch.ops.flash_attention import (
    ATTENTION_SUBLAYER,
    BWD_VARIANT_LAUNCHES,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    FUSED_ATTENTION,
    FUSED_ATTENTION_BWD,
    FWD_VARIANT_LAUNCHES,
    KERNEL_HEAD_DIMS,
    NEG_INF,
    WIDE_LAUNCHES,
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
    ln_affine,
    matmul_f32,
)
from video_vae_tpu_torch.ops.fused_block import (
    FUSED_MLP,
    fused_mlp_sublayer,
    fused_mlp_sublayer_cuda,
    fused_mlp_sublayer_plain,
)
from video_vae_tpu_torch.ops.rope import rope_tables, rotate_half

pytestmark = pytest.mark.cuda

# max-abs error over max|plain|: f32 sums in another order; bf16 one output rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# every head dim the attention kernels are instantiated for
HEAD_DIMS = pytest.mark.parametrize("D", KERNEL_HEAD_DIMS)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _check_fused_attention(device, dtype, B, S, H, masked, D=64):
    """One fused forward launch against the plain version; a bf16 one twice, same bits.

    masked: False, True (each sequence keeps a prefix of at least one key) or
    "empty" (as True, and sequence 0 keeps no key: its rows average all S keys).
    """
    gen = torch.Generator(device="cpu").manual_seed(S)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, dtype)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    mask = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        if masked == "empty":
            lengths[0] = 0
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    before = FUSED_ATTENTION.launches
    out = fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION.launches == before + 1
    ref = fused_qkv_attention_plain(qkv, qs, ks, mask, H)
    assert out.dtype == dtype and _rel_err(out, ref) <= TOL[dtype]
    if masked == "empty":
        assert _rel_err(out[0], ref[0]) <= TOL[dtype]
    if dtype == torch.bfloat16:  # no atomics: the same bits on every run
        assert torch.equal(out, fused_qkv_attention_cuda(qkv, qs, ks, mask, H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,masked",
    [(40, 16, True), (3, 256, False), (5, 37, True), (7, 1, False), (6, 17, True), (2, 256, True),
     (12, 16, "empty")],
)
@HEAD_DIMS
def test_fused_attention_kernel_matches_plain(device, dtype, B, S, masked, D):
    _check_fused_attention(device, dtype, B, S, 8, masked, D)


@pytest.mark.parametrize(
    "B,S,H,masked",
    [
        (5, 16, 2, True),  # four sequences a slab block, the last block part empty
        (3, 80, 8, True),  # P normalised before its rounding over two key chunks
        (2, 64, 8, "empty"),  # a 64-row tile, one chunk, normalised first
        (3, 200, 3, True),  # a ragged last warp tile and key chunk
    ],
)
@HEAD_DIMS
def test_fused_attention_bf16_kernel_geometries(device, B, S, H, masked, D):
    _check_fused_attention(device, torch.bfloat16, B, S, H, masked, D)


@pytest.mark.parametrize("D", [0, 7, 129])
def test_attention_kernels_refuse_other_head_dims(device, D):
    """0 or an odd head dim raises on the card, naming the range the kernels
    take; nothing falls back to the plain version. (Every even head dim up to
    128 runs, padded: ``test_padded_head_dims_launch_their_kernels``; past 128
    the wide variant: ``test_wide_head_dims_launch_their_kernels``.)"""
    B, S, H = 2, 16, 2
    qkv = torch.zeros(B, S, 3 * H * D, device=device, dtype=torch.bfloat16)
    qs = torch.ones(D, device=device)
    q = torch.zeros(B, S, H, D, device=device, dtype=torch.bfloat16)
    kernels = (FUSED_ATTENTION, FUSED_ATTENTION_BWD, FLASH_ATTENTION, FLASH_ATTENTION_BWD, ATTENTION_SUBLAYER)
    before = [k.launches for k in kernels]
    calls = [
        lambda: fused_qkv_attention_cuda(qkv, qs, qs, None, H),
        lambda: fused_qkv_attention_bwd_cuda(qkv, qs, qs, None, qkv[..., : H * D].contiguous(), H),
        lambda: flash_attention_cuda(q, q, q, None),
        lambda: flash_attention_bwd_cuda(q, q, q, None, q),
        lambda: fused_attention_sublayer_cuda(
            torch.zeros(B, S, 64, device=device), torch.ones(64, device=device), torch.zeros(64, device=device),
            torch.zeros(64, 3 * H * D, device=device), torch.zeros(3 * H * D, device=device), qs, qs,
            torch.zeros(H * D, 64, device=device), torch.zeros(64, device=device), None, H),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=r"an even head_dim of at least 2 \(padded to the next of "
                                             r"\(16, 32, 64, 128\), past 128 to a multiple of 128\)"):
            call()
    assert before == [k.launches for k in kernels]


def _attention_calls(device, dtype, B, S, H, masked, D, seed):
    """(kernel, run, plain, tolerance dtype) of #1, #3, #5, #6 and #7 at one shape."""
    qkv, g, qs, ks, mask = _bwd_inputs(device, dtype, B, S, H, masked, seed, D)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    q, k, g4 = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)
    args, smask = _sublayer_args(device, dtype, B, S, 64, H, masked, D)
    return (
        (FUSED_ATTENTION, lambda: fused_qkv_attention_cuda(qkv, qs, ks, mask, H),
         lambda: fused_qkv_attention_plain(qkv, qs, ks, mask, H), dtype),
        (FUSED_ATTENTION_BWD, lambda: fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H),
         lambda: fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H), dtype),
        (FLASH_ATTENTION, lambda: flash_attention_cuda(q, k, v, mask), lambda: flash_attention_plain(q, k, v, mask),
         dtype),
        (FLASH_ATTENTION_BWD, lambda: flash_attention_bwd_cuda(q, k, v, mask, g4),
         lambda: flash_attention_bwd_plain(q, k, v, mask, g4), dtype),
        # both sides round the GEMM operands to bf16 whatever x's dtype is
        (ATTENTION_SUBLAYER, lambda: fused_attention_sublayer_cuda(*args, smask, H),
         lambda: fused_attention_sublayer_plain(*args, smask, H), torch.bfloat16),
    )


# Head dims the kernels pad to the next instantiation (ops/flash_attention.py:pad_heads):
# D = 8 and 24 (at 16 and 32: mma.sync everywhere), 48 and 96 (at 64 and 128: the
# wgmma tile of #3 and the wgmma split launches); (B, S, H, masked) a slab, a ragged
# slab, a tile and a split call
PADDED_HEAD_DIMS = pytest.mark.parametrize("D", [8, 24, 48, 96])
PADDED_CASES = [(40, 16, 8, True), (5, 37, 3, True), (3, 256, 8, "empty"), (3, 300, 2, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,masked", PADDED_CASES)
@PADDED_HEAD_DIMS
def test_padded_head_dims_launch_their_kernels(device, dtype, B, S, H, masked, D):
    """#1, #3, #5, #6 and #7 at a padded head dim: each call launches its kernel
    once (the counters), nothing takes the plain version, every output at D and
    within the kernel tolerance of the plain version at D, a bf16 call the same
    bits twice."""
    calls = _attention_calls(device, dtype, B, S, H, masked, D, 7 * S + D)
    for kernel, run, plain, tol in calls:
        before = kernel.launches
        out = run()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, kernel.symbol
        out, ref = (t if isinstance(t, tuple) else (t,) for t in (out, plain()))
        for a, b in zip(out, ref):
            assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda, kernel.symbol
            assert _within(a, b, TOL[tol]), (kernel.symbol, _rel_err(a, b))
        if masked == "empty" and kernel in (FUSED_ATTENTION, FLASH_ATTENTION):
            assert _within(out[0][0], ref[0][0], TOL[tol]), kernel.symbol
        if dtype == torch.bfloat16:  # no atomics: the same bits on every run
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(a, b) for a, b in zip(out, again)), kernel.symbol


@PADDED_HEAD_DIMS
def test_padded_head_dims_through_autograd(device, D):
    """The autograd wrappers on CUDA tensors at a padded head dim: the forward
    and backward kernels launch, and the gradients (the scales' too) equal the
    ``*_cuda`` wrappers' own."""
    B, S, H = 4, 65, 2
    qkv, g, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, True, 11 + D, D)
    leaves = [t.clone().requires_grad_() for t in (qkv, qs, ks)]
    before = (FUSED_ATTENTION.launches, FUSED_ATTENTION_BWD.launches)
    out = fused_qkv_attention(leaves[0], leaves[1], leaves[2], mask, H)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (FUSED_ATTENTION.launches - before[0], FUSED_ATTENTION_BWD.launches - before[1]) == (1, 1)
    assert torch.equal(out, fused_qkv_attention_cuda(qkv, qs, ks, mask, H))
    ref = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    assert torch.equal(grads[0], ref[0]) and torch.equal(grads[1], ref[1]) and torch.equal(grads[2], ref[2])


# Head dims past 128 (ops/flash_attention.py:padded_head_dim pads them to a multiple of
# 128): the wide variant in both dtypes; (B, S, H, masked) cases as PADDED_CASES'
WIDE_HEAD_DIMS = pytest.mark.parametrize("D", [130, 192, 256, 384, 512])
WIDE_CASES = [(40, 16, 8, True), (5, 37, 3, True), (3, 256, 8, "empty"), (3, 300, 2, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,masked", WIDE_CASES)
@WIDE_HEAD_DIMS
def test_wide_head_dims_launch_their_kernels(device, dtype, B, S, H, masked, D):
    """#1, #3, #5, #6 and #7 past head dim 128: each call launches its kernel
    once, on its wide variant (``WIDE_LAUNCHES``), nothing takes the plain
    version, every output within the kernel tolerance of the plain version at
    D (bf16 2e-2, f32 1e-4 of the largest reference value), a sequence that
    keeps no key too, and the same bits twice in either dtype."""
    for kernel, run, plain, tol in _attention_calls(device, dtype, B, S, H, masked, D, 5 * S + D):
        before, wide = kernel.launches, WIDE_LAUNCHES[kernel.symbol]
        out = run()
        torch.cuda.synchronize()
        assert (kernel.launches - before, WIDE_LAUNCHES[kernel.symbol] - wide) == (1, 1), kernel.symbol
        out, ref = (t if isinstance(t, tuple) else (t,) for t in (out, plain()))
        for a, b in zip(out, ref):
            assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda, kernel.symbol
            assert _within(a, b, TOL[tol]), (kernel.symbol, _rel_err(a, b))
        if masked == "empty" and kernel in (FUSED_ATTENTION, FLASH_ATTENTION):
            assert _within(out[0][0], ref[0][0], TOL[tol]), kernel.symbol
        again = run()  # no atomics: the same bits on every run
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), kernel.symbol


@WIDE_HEAD_DIMS
def test_wide_head_dims_through_autograd(device, D):
    """The autograd wrapper on CUDA tensors past head dim 128: the wide forward
    and backward launch, and the gradients (the scales' too) equal the
    ``*_cuda`` wrappers' own."""
    B, S, H = 4, 65, 2
    qkv, g, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, True, 13 + D, D)
    leaves = [t.clone().requires_grad_() for t in (qkv, qs, ks)]
    before = (FWD_VARIANT_LAUNCHES["wide"], BWD_VARIANT_LAUNCHES["wide"])
    out = fused_qkv_attention(leaves[0], leaves[1], leaves[2], mask, H)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (FWD_VARIANT_LAUNCHES["wide"] - before[0], BWD_VARIANT_LAUNCHES["wide"] - before[1]) == (1, 1)
    assert torch.equal(out, fused_qkv_attention_cuda(qkv, qs, ks, mask, H))
    ref = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    assert torch.equal(grads[0], ref[0]) and torch.equal(grads[1], ref[1]) and torch.equal(grads[2], ref[2])


def test_head_dim_96_f32_step_matches_cpu(device):
    """One float32 train step of ``ModelConfig(qkv_features=768)`` (8 heads of 96,
    the kernels at 128) at depth 1/1 and 64², card against CPU with the same
    weights and draws: loss and metrics within 1e-4, every gradient within 1e-3
    of its leaf's largest value (``chip_smoke``'s f32 bounds), #1 and #3
    launched once a call."""
    import chip_smoke
    from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE
    from video_vae_tpu_torch.train.step import loss_and_grads

    cfg = chip_smoke.d96_config().replace(height=64, width=64, encoder_depth=1, decoder_depth=1, dtype="float32",
                                          remat=False)
    assert (cfg.num_heads, cfg.head_dim) == (8, 96)
    cpu_model = VideoVAE(cfg, device="cpu", seed=4)
    gen = torch.Generator().manual_seed(5)
    chip_smoke.random_final_conv(cpu_model, gen)
    gpu_model = VideoVAE(cfg, device=device, seed=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    video = torch.rand(1, 4, 64, 64, 3, generator=gen)
    mask = torch.ones(1, 4)
    mask[0, 3:] = 0
    noise, uniforms = chip_smoke._draws(cpu_model, video, mask, seed=6)
    results = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, device)):
        before = (FUSED_ATTENTION.launches, FUSED_ATTENTION_BWD.launches)
        _, metrics, grads = loss_and_grads(model, video.to(dev), mask.to(dev), DynamicHParams.default(),
                                           LossConfig(use_perceptual=False), None, noise=noise.to(dev),
                                           uniforms=uniforms.to(dev))
        launched = (FUSED_ATTENTION.launches - before[0], FUSED_ATTENTION_BWD.launches - before[1])
        results[name] = ({k: float(v.detach()) for k, v in metrics.items()}, [t.cpu() for t in grads], launched)
    (m_cpu, g_cpu, l_cpu), (m_gpu, g_gpu, l_gpu) = results["cpu"], results["gpu"]
    calls = 2 * (cfg.encoder_depth + cfg.decoder_depth)
    assert l_cpu == (0, 0) and l_gpu == (calls, calls)
    chip_smoke._hold_metrics("f32-d96", m_gpu, m_cpu)
    names = [name for name, _ in cpu_model.named_parameters()]
    chip_smoke._hold_grads("f32-d96", names, g_gpu, g_cpu, chip_smoke._noise_leaves(names, g_cpu))


# Share of the bf16 outputs whose bits may differ from the JAX rounding chain:
# f32 sums taken in another order flip a last bit now and then. On the H100 the
# kernel differs in at most 0.02 % (the test prints the shares), each chain
# with one rounding left out or the other rule for P in 17-42 %. A max-abs
# bound this tight could not hold: one flip near 2 is 2^-6.
ROUNDING_SHARE_TOL = 1e-2


def _jax_rounding_chain(qkv, qs, ks, mask, H, round_qk=True, round_p=True, normalize=None):
    """The JAX package's bf16 rounding chain of the fused forward, in f32.

    LN + RoPE in f32, q~ and k~ rounded to bf16, f32 scores, P rounded to bf16
    before P.V: normalised first on JAX's packed rule (S < 128, S*H % 128 ==
    0), else unnormalised with 1/l on the f32 output, against the running max
    of key chunks as the kernel keeps it: 64 keys (exact up to 64), but 128 in
    the split variant's wgmma forward at head_dim 64 (S > 256; its key tile).
    The keyword arguments leave a rounding out or take the other rule for P.
    """
    B, S, three_hd = qkv.shape
    D = three_hd // (3 * H)
    if normalize is None:
        normalize = S < 128 and S * H % 128 == 0
    cos, sin = rope_tables(S, D, device=str(qkv.device))
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2).float() for t in qkv.split(H * D, -1))

    def norm_rope(x, scale):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp(x.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        xn = (x - mean) * torch.rsqrt(var + 1e-6) * scale
        y = xn * cos + rotate_half(xn) * sin
        return y.bfloat16().float() if round_qk else y

    scores = norm_rope(q, qs) @ norm_rope(k, ks).transpose(-1, -2)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    c = D**-0.5 * math.log2(math.e)  # 1/sqrt(D) in the exp2 domain, as the kernel's

    def rnd(p):
        return p.bfloat16().float() if round_p else p

    if normalize:
        p = torch.exp2((scores - scores.amax(-1, keepdim=True)) * c)
        o = rnd(p * (1 / p.sum(-1, keepdim=True))) @ v
    else:
        m = torch.full_like(scores[..., :1], -math.inf)
        l = torch.zeros_like(m)
        o = torch.zeros_like(q)
        chunk = 128 if S > 256 and D == 64 else 64
        for c0 in range(0, S, chunk):
            s_c = scores[..., c0 : c0 + chunk]
            m_new = torch.maximum(m, s_c.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * c)
            p = torch.exp2((s_c - m_new) * c)
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + rnd(p) @ v[..., c0 : c0 + chunk, :]
            m = m_new
        o = o * (1 / l)
    return o.transpose(1, 2).reshape(B, S, H * D).bfloat16()


def _bits_differ(out, ref):
    """Share of the elements of two bf16 tensors whose bits differ."""
    return (out.view(torch.int16) != ref.view(torch.int16)).float().mean().item()


@pytest.mark.parametrize(
    "B,S,H",
    [
        (64, 16, 8),  # the temporal shape: normalised before the rounding, one chunk
        (32, 16, 2),  # S*H not a multiple of 128: unnormalised
        (6, 80, 8),  # normalised over two key chunks (a first pass of scores)
        (2, 256, 8),  # the spatial shape: unnormalised, running max over four chunks
    ],
)
@HEAD_DIMS
def test_fused_attention_bf16_kernel_rounds_as_jax(device, B, S, H, D):
    """The bf16 kernel rounds q~, k~ and P where the JAX package does: its
    output's bits match the JAX chain's but for a few ulp flips from f32 sums
    taken in another order, while each chain with one rounding left out or
    the other rule for P misses far more of them."""
    gen = torch.Generator(device="cpu").manual_seed(S * H)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, torch.bfloat16)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    lengths = torch.randint(1, S + 1, (B,), generator=gen)
    lengths[0] = 0  # sequence 0 keeps no key
    mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    out = fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
    share = _bits_differ(out, _jax_rounding_chain(qkv, qs, ks, mask, H))
    normalize = S < 128 and S * H % 128 == 0
    others = {
        name: _bits_differ(out, _jax_rounding_chain(qkv, qs, ks, mask, H, **kw))
        for name, kw in (("q~k~ in f32", dict(round_qk=False)), ("P in f32", dict(round_p=False)),
                         ("the other P rule", dict(normalize=not normalize)))
    }
    print(f"rounding B={B} S={S} H={H} D={D}: bits differ {share:.5f}; " + ", ".join(f"{k} {v:.4f}" for k, v in others.items()))
    assert share <= ROUNDING_SHARE_TOL
    for name, other in others.items():
        assert other > 5 * ROUNDING_SHARE_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,cins,cout,k",
    [
        ((2, 3, 20, 40), (12,), 12, (3, 7, 7)),
        ((1, 4, 33, 65), (16, 16), 16, (3, 3, 3)),
        ((2, 2, 16, 32), (64,), 128, (3, 3, 3)),
        ((1, 3, 9, 11), (5,), 3, (1, 5, 1)),
        ((2, 2, 20, 48), (12,), 12, (1, 7, 7)),  # the tap-dot model's kt = 1 patch mixer
        ((1, 3, 17, 40), (24,), 40, (3, 5, 3)),  # kh != kw, ragged rows
        ((2, 3, 1, 37), (8,), 24, (3, 3, 5)),  # one row a frame
        ((1, 2, 32, 32), (512,), 512, (1, 3, 3)),  # the tap-dot model's bottleneck
        ((1, 3, 12, 24), (20, 12), 24, (3, 3, 3)),  # a chunk across both sources
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


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits); 0 at x = 0."""
    x = x.float().abs()
    return torch.where(x > 0, torch.exp2(torch.floor(torch.log2(x.clamp_min(1e-30))) - 7), torch.zeros_like(x))


def _conv_rounding_partials(x1, x2, kernel, bias, chunk=16):
    """The conv with its f32 partial sums rounded to bf16 after every temporal tap
    and 16-channel chunk: the rounding the kernel must not make."""
    b, t, _, h, w = x1.shape
    kt, kh, kw, cin, cout = kernel.shape
    x = x1 if x2 is None else torch.cat([x1, x2], dim=2)
    xp = torch.nn.functional.pad(x.float(), (kw // 2, kw // 2, kh // 2, kh // 2, 0, 0, kt // 2, kt // 2))
    wf = kernel.float()
    acc = torch.zeros((b, t, cout, h, w), dtype=torch.float32, device=x1.device)
    for dt in range(kt):
        for c0 in range(0, cin, chunk):
            for dh in range(kh):
                for dw in range(kw):
                    xs = xp[:, dt : dt + t, c0 : c0 + chunk, dh : dh + h, dw : dw + w]
                    acc += torch.einsum("btchw,cd->btdhw", xs, wf[dt, dh, dw, c0 : c0 + chunk])
            acc = acc.to(torch.bfloat16).float()
    return (acc + bias.float()[None, None, :, None, None]).to(x1.dtype)


# a bf16 conv against conv3d_cf_plain (the JAX rounding: f32 sums, bias, one
# rounding): each element within 1 ulp of the plain output plus 1e-5 of its
# largest value (sums taken in another order flip a rounding now and then), and
# under ROUNDING_SHARE_TOL of the elements with other bits
ROUNDING_ABS_TOL = 1e-5


def _conv_rounding_gap(out, ref):
    """(elements past 1 ulp + 1e-5 max|ref|, share of elements whose bits differ)."""
    bound = _bf16_ulp(ref) + ROUNDING_ABS_TOL * ref.float().abs().max()
    past = int(((out.float() - ref.float()).abs() > bound).sum())
    return past, (out != ref).float().mean().item()


@pytest.mark.parametrize(
    "shape,cins,cout,k",
    [
        ((1, 4, 24, 40), (48,), 32, (3, 3, 3)),  # 3 chunks x 3 temporal taps
        ((1, 3, 16, 48), (24, 24), 16, (3, 3, 3)),  # two sources
        ((2, 3, 20, 40), (12,), 12, (3, 7, 7)),  # the patch mixer
    ],
)
def test_conv3d_bf16_kernel_rounds_as_jax(device, shape, cins, cout, k):
    """The bf16 direct conv sums every tap and channel in f32 and rounds once, as
    the JAX kernel and conv3d_cf_plain do; the same call twice gives the same
    bits, and a bf16 and an f32 call each launch the kernel once. A variant that
    rounds its partial sums to bf16 after every temporal tap and channel chunk
    misses the same bound."""
    b, t, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) * cout)
    xs = [torch.randn(b, t, c, h, w, generator=gen).to(device, torch.bfloat16) for c in cins]
    kernel = (torch.randn(*k, sum(cins), cout, generator=gen) / (sum(cins) * k[0] * k[1] * k[2]) ** 0.5)
    kernel = kernel.to(device, torch.bfloat16)
    bias = (0.1 * torch.randn(cout, generator=gen)).to(device)
    x2 = xs[1] if len(xs) == 2 else None
    before = CONV3D.launches
    out = conv3d_cf_cuda(xs[0], x2, kernel, bias)
    torch.cuda.synchronize()
    assert CONV3D.launches == before + 1
    again = conv3d_cf_cuda(xs[0], x2, kernel, bias)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no split-K, no atomics: the same bits on every launch
    ref = conv3d_cf_plain(xs[0], x2, kernel, bias)
    past, share = _conv_rounding_gap(out, ref)
    rounded_past, rounded_share = _conv_rounding_gap(_conv_rounding_partials(xs[0], x2, kernel, bias), ref)
    print(f"conv rounding {shape} {cins}->{cout} {k}: {past} past the bound, bits differ {share:.5f}; "
          f"partials rounded: {rounded_past} past, {rounded_share:.4f}")
    assert past == 0 and share < ROUNDING_SHARE_TOL
    assert rounded_past > 0 or rounded_share >= ROUNDING_SHARE_TOL

    before = CONV3D.launches
    conv3d_cf_cuda(xs[0].float(), None if x2 is None else x2.float(), kernel.float(), bias)
    torch.cuda.synchronize()
    assert CONV3D.launches == before + 1


def _within(out, ref, tol):
    """max|out - ref| <= tol * max|ref|: a reference of zeros (the scale
    gradients at S = 1) asks for zeros."""
    return ((out.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()).item()


def _bwd_inputs(device, dtype, B, S, H, masked, seed, D=64):
    """(qkv, g, q_scale, k_scale, key mask) of a fused attention backward call;
    masked as in :func:`_check_fused_attention` ("empty": sequence 0 keeps no key)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(device, dtype)
    g = torch.randn(B, S, H * D, generator=gen).to(device, dtype)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(device)
    mask = None
    if masked:
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        if masked == "empty":
            lengths[0] = 0
        mask = (torch.arange(S)[None, :] < lengths[:, None]).to(device)
    return qkv, g, qs, ks, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,masked",
    [
        (40, 16, 8, True),
        (3, 256, 8, False),
        (5, 37, 8, True),
        (2, 200, 8, True),
        (7, 1, 8, False),  # one key: P = 1, dS = 0, the scale gradients exactly 0
        (6, 17, 8, True),  # one row past a 16-row tile
        (3, 64, 8, True),  # the longest slab: four query tiles share a pair's P and dS
        (3, 65, 8, True),  # the shortest tile block: one key past a 64-key word
        (3, 80, 8, True),
        (5, 16, 2, True),  # slab blocks of pairs from several sequences, the last block part empty
        (12, 16, 8, "empty"),  # sequence 0 keeps no key: P spreads over all S keys
        (2, 256, 8, "empty"),
    ],
)
@HEAD_DIMS
def test_fused_attention_bwd_kernel_matches_plain(device, dtype, B, S, H, masked, D):
    qkv, g, qs, ks, mask = _bwd_inputs(device, dtype, B, S, H, masked, S + 1, D)
    before = FUSED_ATTENTION_BWD.launches
    out = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    again = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 2
    ref = fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
    assert out[0].dtype == dtype
    for a, b, c in zip(out, ref, again):
        assert _within(a, b, TOL[dtype])
        assert torch.equal(a, c)  # no atomics: the same bits on every run
    if masked == "empty":
        assert _within(out[0][0], ref[0][0], TOL[dtype])


def _bwd_rounding_chain(qkv, g, qs, ks, mask, H, round_qk=True, round_p=True, round_ds=True):
    """The bf16 backward kernel's rounding rule, in f32 torch on the same inputs:
    (dqkv rounded to bf16 once, f32 dq_scale, f32 dk_scale).

    LN + scale + RoPE of q and k in f32, q~ and k~ rounded to bf16; f32 scores and
    exact softmax P; P rounded to bf16 for dv = P^T dO; dP = dO v^T, row = sum_j
    P dP and dS = P (dP - row) / sqrt(D) in f32 from f32 P, dS rounded to bf16 for
    dq~ = dS k~ and dk~ = dS^T q~; RoPE transpose and LN backward in f32. The
    keyword arguments leave a rounding out.
    """
    B, S, three_hd = qkv.shape
    D = three_hd // (3 * H)
    cos, sin = rope_tables(S, D, device=str(qkv.device))
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2).float() for t in qkv.split(H * D, -1))
    do = g.float().reshape(B, S, H, D).transpose(1, 2)

    def rnd(x, on):
        return x.bfloat16().float() if on else x

    def ln(x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp(x.square().mean(-1, keepdim=True) - mean.square(), min=0.0)
        r = torch.rsqrt(var + 1e-6)
        return (x - mean) * r, r

    (xq, rq), (xk, rk) = ln(q), ln(k)

    def rope(x):
        return x * cos + rotate_half(x) * sin

    qr, kr = rnd(rope(xq * qs), round_qk), rnd(rope(xk * ks), round_qk)
    scores = (qr @ kr.transpose(-1, -2)) * D**-0.5
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = rnd(p, round_p).transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * D**-0.5, round_ds)
    dqr, dkr = ds @ kr, ds.transpose(-1, -2) @ qr

    def ln_rope_bwd(du, xn, r, scale):
        a, b = (du * sin).chunk(2, dim=-1)
        dln = du * cos + torch.cat((b, -a), dim=-1)
        dxn = dln * scale
        dx = r * (dxn - dxn.mean(-1, keepdim=True) - xn * (dxn * xn).mean(-1, keepdim=True))
        return dx, (dln * xn).sum(dim=(0, 1, 2))

    (dq, dqs), (dk, dks) = ln_rope_bwd(dqr, xq, rq, qs), ln_rope_bwd(dkr, xk, rk, ks)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, H * D) for t in (dq, dk, dv)], dim=-1)
    return dqkv.bfloat16(), dqs, dks


# The bf16 backward against its rounding chain: in each of dq, dk and dv at
# most this share of the elements may have other bits (f32 sums taken in
# another order flip a last bit now and then, and the LN backward's
# differences carry such flips on), and the scale gradients within
# BWD_SCALE_TOL of the chain's, relative. On the H100 (the test prints the
# shares) the kernel differs in at most 0.09 % of a part's elements and its
# scale gradients by at most 7e-5; a chain with one rounding left out differs
# in 2.6-55 % of the parts that rounding reaches (P in f32: 2.6 % of dv at
# S = 256, where a row's P is small and many keys average its rounding out).
BWD_ROUNDING_SHARE_TOL = 5e-3
BWD_SCALE_TOL = 5e-4


def _bits_differ_parts(dqkv, ref):
    """Share of the elements whose bits differ in the dq, dk and dv thirds of two bf16 dqkv."""
    return dict(zip(("dq", "dk", "dv"), (_bits_differ(a, b) for a, b in zip(dqkv.chunk(3, -1), ref.chunk(3, -1)))))


@pytest.mark.parametrize(
    "B,S,H",
    [
        (64, 16, 8),  # the temporal shape: a slab block of 8 pairs
        (32, 16, 2),  # slab blocks of pairs from several sequences
        (6, 80, 8),  # a tile block, a ragged last tile of queries and keys
        (2, 256, 8),  # the spatial shape
    ],
)
@HEAD_DIMS
def test_fused_attention_bwd_bf16_kernel_rounds_as_chain(device, B, S, H, D):
    """The bf16 backward rounds q~, k~, P and dS where its rule says and nowhere
    else: its dqkv's bits match the chain's but for a few flips, while each
    chain with one of those roundings left out misses far more of them. A bf16
    and an f32 call each launch the kernel once."""
    qkv, g, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, "empty", S * H, D)
    before = FUSED_ATTENTION_BWD.launches
    dqkv, dqs, dks = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 1
    ref, ref_qs, ref_ks = _bwd_rounding_chain(qkv, g, qs, ks, mask, H)
    share = _bits_differ_parts(dqkv, ref)
    scale_err = max(_rel_err(dqs, ref_qs), _rel_err(dks, ref_ks))
    # each rounding left out, and the parts of dqkv it reaches
    others = {
        name: (_bits_differ_parts(dqkv, _bwd_rounding_chain(qkv, g, qs, ks, mask, H, **kw)[0]), parts)
        for name, kw, parts in (("q~k~ in f32", dict(round_qk=False), ("dq", "dk", "dv")),
                                ("P in f32", dict(round_p=False), ("dv",)),
                                ("dS in f32", dict(round_ds=False), ("dq", "dk")))
    }
    print(f"bwd rounding B={B} S={S} H={H} D={D}: bits differ {share}, scale gradients {scale_err:.2e}; "
          + "; ".join(f"{k} {v[0]}" for k, v in others.items()))
    assert max(share.values()) <= BWD_ROUNDING_SHARE_TOL and scale_err <= BWD_SCALE_TOL
    for name, (other, parts) in others.items():
        assert min(other[part] for part in parts) > 2 * BWD_ROUNDING_SHARE_TOL, name

    before = FUSED_ATTENTION_BWD.launches
    fused_qkv_attention_bwd_cuda(qkv.float(), qs, ks, mask, g.float(), H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 1


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
        ((1, 2, 256, 256), (16,), 16, (3, 3, 3)),  # the flagship's top level (encoders.0.conv2)
        ((1, 3, 16, 64), (24, 40), 32, (3, 3, 3)),  # two sources, c1 = 24
        ((2, 3, 16, 32), (16,), 12, (3, 3, 3)),  # cout = 12 with kt = 3
    ],
)
def test_conv3d_wgrad_kernel_matches_plain(device, dtype, shape, cins, cout, k):
    """Each launch goes to the variant ``wgrad_variant`` names: the wgmma kernel
    for bf16 at a width that is a multiple of 8, PR 6's wmma kernel for the
    others, the CUDA-core kernel for f32."""
    b, t, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) * cout)
    xs = [torch.randn(b, t, c, h, w, generator=gen).to(device, dtype) for c in cins]
    g = torch.randn(b, t, cout, h, w, generator=gen).to(device, dtype)
    x2 = xs[1] if len(xs) == 2 else None
    before = CONV3D_WGRAD.launches
    variant = wgrad_variant(dtype, w)
    variants = dict(WGRAD_VARIANT_LAUNCHES)
    out = conv3d_wgrad_cuda(xs[0], x2, g, *k)
    again = conv3d_wgrad_cuda(xs[0], x2, g, *k)
    torch.cuda.synchronize()
    assert CONV3D_WGRAD.launches == before + 2
    assert WGRAD_VARIANT_LAUNCHES == {**variants, variant: variants[variant] + 2}
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


def _flash_inputs(device, dtype, B, S, masked, strided, H=8, seed=None, D=64):
    gen = torch.Generator(device="cpu").manual_seed(S + 2 if seed is None else seed)
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


# (B, S, H, masked, strided); masked: sequence 0 keeps no key, the others a prefix
FLASH_CASES = [
    (40, 16, 8, True, False),
    (3, 256, 8, False, True),
    (5, 37, 8, True, True),
    (2, 200, 8, True, False),
    (7, 1, 8, False, True),  # one key: P = 1, dS = 0, dq and dk exactly 0
    (5, 16, 2, True, True),  # slab blocks of pairs from several sequences
    (6, 17, 8, True, True),  # one row past a 16-row tile
    (3, 64, 8, True, True),  # the longest slab: four query tiles share a pair's P and dS
    (3, 65, 8, True, True),  # the shortest tile block: one key past a 64-key word
    (3, 80, 8, True, False),
    (2, 256, 8, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,masked,strided", FLASH_CASES)
@HEAD_DIMS
def test_flash_attention_kernel_matches_plain(device, dtype, B, S, H, masked, strided, D):
    q, k, v, _, mask = _flash_inputs(device, dtype, B, S, masked, strided, H, D=D)
    before = FLASH_ATTENTION.launches
    out = flash_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 1
    ref = flash_attention_plain(q, k, v, mask)
    assert out.dtype == dtype and out.is_contiguous() and torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("B,S,H", [(40, 16, 8), (3, 256, 8)])
@HEAD_DIMS
def test_flash_attention_bf16_kernel_same_bits_twice(device, B, S, H, D):
    """No split over the keys and no atomics: two bf16 launches on the same
    inputs (v a view into a fused projection, sequence 0 keeping no key) give
    the same bits, one launch a call."""
    q, k, v, _, mask = _flash_inputs(device, torch.bfloat16, B, S, True, True, H, D=D)
    before = FLASH_ATTENTION.launches
    out = flash_attention_cuda(q, k, v, mask)
    assert FLASH_ATTENTION.launches == before + 1
    again = flash_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 2
    assert torch.equal(out, again)


def _flash_fwd_chain(q, k, v, mask, round_p=True, normalize=True):
    """JAX ``_fwd_kernel``'s rounding chain in f32 torch on the same inputs.

    f32 scores times 1/sqrt(D), masked keys at -1e30, P = exp(s - max) / sum
    with the exact row max and sum, P rounded to bf16, P.V in f32, o rounded
    to bf16 once. ``round_p=False`` keeps P in f32; ``normalize=False`` rounds
    P unnormalised and puts 1/sum on the f32 output (the fused forward's rule
    off its packed path).
    """
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    s = (qf @ kf.transpose(-1, -2)) * qf.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)

    def rnd(x):
        return x.bfloat16().float() if round_p else x

    o = rnd(p / l) @ vf if normalize else (rnd(p) @ vf) / l
    return o.transpose(1, 2).bfloat16()


@pytest.mark.parametrize(
    "B,S,H",
    [
        (64, 16, 8),  # the temporal shape: a slab block, one chunk of keys
        (32, 16, 2),  # slab blocks of several sequences
        (6, 80, 8),  # a tile block, the keys walked twice over two chunks
        (2, 256, 8),  # the spatial shape: four chunks walked twice
    ],
)
@HEAD_DIMS
def test_flash_attention_bf16_kernel_rounds_as_jax(device, B, S, H, D):
    """The bf16 kernel rounds P where JAX's ``_fwd_kernel`` does, normalised
    with the exact row max and sum: its output's bits match that chain's but
    for a few flips from f32 sums taken in another order (and the scale taken
    in the exp2 domain), while the chain with P kept in f32, or with P
    rounded unnormalised and 1/l on the f32 output, misses far more of them.
    v is a view into a fused projection and sequence 0 keeps no key. On the
    H100 the kernel's bits differ from the chain's in 0, 0, 0.009 % and
    0.038 % of o at its four shapes, the chain with P in f32 in
    34.3, 33.7, 37.1 and 21.1 %, the one with P rounded unnormalised in 38.1,
    37.6, 42.3 and 24.6 % (the test prints them; at D = 64)."""
    q, k, v, _, mask = _flash_inputs(device, torch.bfloat16, B, S, True, True, H, seed=S * H, D=D)
    before = FLASH_ATTENTION.launches
    out = flash_attention_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 1
    share = _bits_differ(out, _flash_fwd_chain(q, k, v, mask))
    others = {
        name: _bits_differ(out, _flash_fwd_chain(q, k, v, mask, **kw))
        for name, kw in (("P in f32", dict(round_p=False)), ("P rounded unnormalised", dict(normalize=False)))
    }
    print(f"flash fwd rounding B={B} S={S} H={H} D={D}: bits differ {share:.5f}; "
          + ", ".join(f"{k} {v:.4f}" for k, v in others.items()))
    assert share <= ROUNDING_SHARE_TOL
    for name, other in others.items():
        assert other > 5 * ROUNDING_SHARE_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,masked,strided", FLASH_CASES)
@HEAD_DIMS
def test_flash_attention_bwd_kernel_matches_plain(device, dtype, B, S, H, masked, strided, D):
    q, k, v, g, mask = _flash_inputs(device, dtype, B, S, masked, strided, H, D=D)
    before = FLASH_ATTENTION_BWD.launches
    out = flash_attention_bwd_cuda(q, k, v, mask, g)
    again = flash_attention_bwd_cuda(q, k, v, mask, g)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_BWD.launches == before + 2
    ref = flash_attention_bwd_plain(q, k, v, mask, g)
    for a, b, c in zip(out, ref, again):
        assert a.dtype == dtype and a.is_contiguous() and _within(a, b, TOL[dtype])
        assert torch.equal(a, c)  # no atomics: the same bits on every run
        if masked:  # sequence 0 keeps no key: P spreads over all S keys
            assert _within(a[0], b[0], TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_one_launch_no_workspace(device, dtype):
    """A bf16 call launches the kernel once and allocates nothing but dq, dk and
    dv; an f32 call launches once and adds its workspace of m, l and row."""
    B, S, H = 40, 16, 8
    q, k, v, g, _ = _flash_inputs(device, dtype, B, S, False, False, H)
    flash_attention_bwd_cuda(q, k, v, None, g)  # build and load first
    torch.cuda.synchronize()
    before, allocated = FLASH_ATTENTION_BWD.launches, torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = flash_attention_bwd_cuda(q, k, v, None, g)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_BWD.launches == before + 1
    outputs = sum(t.numel() * t.element_size() for t in out)
    workspace = 0 if dtype == torch.bfloat16 else 3 * B * H * S * 4
    assert torch.cuda.max_memory_allocated(device) - allocated == outputs + workspace


def _flash_rounding_chain(q, k, v, mask, g, round_p=True, round_ds=True):
    """The bf16 plain attention backward's rounding rule, in f32 torch on the
    same inputs: (dq, dk, dv), each rounded to bf16 once.

    f32 scores and exact softmax P; P rounded to bf16 for dv = P^T dO; dP =
    dO v^T, row = sum_j P dP and dS = P (dP - row) / sqrt(D) in f32 from f32 P,
    dS rounded to bf16 for dq = dS k and dk = dS^T q. The keyword arguments
    leave a rounding out.
    """
    qf, kf, vf, do = (t.float().transpose(1, 2) for t in (q, k, v, g))  # (B, H, S, D)

    def rnd(x, on):
        return x.bfloat16().float() if on else x

    scale = qf.shape[-1] ** -0.5
    scores = (qf @ kf.transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = rnd(p, round_p).transpose(-1, -2) @ do
    dp = do @ vf.transpose(-1, -2)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale, round_ds)
    return tuple(t.transpose(1, 2).bfloat16() for t in (ds @ kf, ds.transpose(-1, -2) @ qf, dv))


# The bf16 plain attention backward against its rounding chain: in each of dq,
# dk and dv at most this share of the elements may have other bits (f32 sums
# taken in another order flip a last bit now and then).
FLASH_BWD_ROUNDING_SHARE_TOL = 5e-3


@pytest.mark.parametrize(
    "B,S,H",
    [
        (64, 16, 8),  # the temporal shape: a slab block of 4 pairs
        (32, 16, 2),  # slab blocks of pairs from several sequences
        (6, 80, 8),  # a tile block, a ragged last tile of queries and keys
        (2, 256, 8),  # the spatial shape
    ],
)
@HEAD_DIMS
def test_flash_attention_bwd_bf16_kernel_rounds_as_chain(device, B, S, H, D):
    """The bf16 backward rounds P and dS where its rule says and nowhere else:
    its dq, dk and dv match the chain's bits but for a few flips, while each
    chain with one of those roundings left out misses far more of them. v is
    a view into a fused projection and sequence 0 keeps no key."""
    q, k, v, g, mask = _flash_inputs(device, torch.bfloat16, B, S, True, True, H, seed=S * H, D=D)
    before = FLASH_ATTENTION_BWD.launches
    got = flash_attention_bwd_cuda(q, k, v, mask, g)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_BWD.launches == before + 1
    parts = ("dq", "dk", "dv")

    def shares(ref):
        return dict(zip(parts, (_bits_differ(a, b) for a, b in zip(got, ref))))

    share = shares(_flash_rounding_chain(q, k, v, mask, g))
    # each rounding left out, and the gradients it reaches
    others = {
        name: (shares(_flash_rounding_chain(q, k, v, mask, g, **kw)), reach)
        for name, kw, reach in (("P in f32", dict(round_p=False), ("dv",)),
                                ("dS in f32", dict(round_ds=False), ("dq", "dk")))
    }
    print(f"flash bwd rounding B={B} S={S} H={H} D={D}: bits differ {share}; "
          + "; ".join(f"{k} {v[0]}" for k, v in others.items()))
    assert max(share.values()) <= FLASH_BWD_ROUNDING_SHARE_TOL
    for name, (other, reach) in others.items():
        assert min(other[part] for part in reach) > 2 * FLASH_BWD_ROUNDING_SHARE_TOL, name


# ---- the split variant (S > 256, csrc/attention_split.cuh) ------------------
# (B, S, H): one key past the tile variant, ragged against every 16- and 64-row
# tile, and the flagship's 512² spatial calls (b1 x 16 frames, S = 1024)
SPLIT_CASES = [(3, 257, 2), (16, 1024, 8)]
SPLIT_HEAD_DIMS = pytest.mark.parametrize("D", [64, 128])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", SPLIT_CASES)
@SPLIT_HEAD_DIMS
def test_split_fused_attention_matches_plain(device, dtype, B, S, H, D):
    """#1 past 256 tokens, sequence 0 keeping no key: one launch a call, the
    plain version's output, bf16 the same bits twice."""
    _check_fused_attention(device, dtype, B, S, H, "empty", D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", SPLIT_CASES)
@SPLIT_HEAD_DIMS
def test_split_fused_attention_bwd_matches_plain(device, dtype, B, S, H, D):
    """#3 past 256 tokens: dqkv and both scale gradients within the bound,
    sequence 0's too, the same bits twice (no atomics: dq has its own pass)."""
    qkv, g, qs, ks, mask = _bwd_inputs(device, dtype, B, S, H, "empty", S + 3, D)
    before = FUSED_ATTENTION_BWD.launches
    out = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    again = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION_BWD.launches == before + 2
    ref = fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
    for a, b, c in zip(out, ref, again):
        assert _within(a, b, TOL[dtype]) and torch.equal(a, c)
    assert _within(out[0][0], ref[0][0], TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", SPLIT_CASES)
@SPLIT_HEAD_DIMS
def test_split_flash_attention_matches_plain(device, dtype, B, S, H, D):
    """#5 and #6 past 256 tokens, v a view into a fused projection, sequence 0
    keeping no key: one launch a call each, the plain versions' outputs, the
    backward the same bits twice."""
    q, k, v, g, mask = _flash_inputs(device, dtype, B, S, True, True, H, seed=S + 5, D=D)
    before = (FLASH_ATTENTION.launches, FLASH_ATTENTION_BWD.launches)
    out = flash_attention_cuda(q, k, v, mask)
    got = flash_attention_bwd_cuda(q, k, v, mask, g)
    again = flash_attention_bwd_cuda(q, k, v, mask, g)
    torch.cuda.synchronize()
    assert (FLASH_ATTENTION.launches - before[0], FLASH_ATTENTION_BWD.launches - before[1]) == (1, 2)
    assert _rel_err(out, flash_attention_plain(q, k, v, mask)) <= TOL[dtype]
    for a, b, c in zip(got, flash_attention_bwd_plain(q, k, v, mask, g), again):
        assert _within(a, b, TOL[dtype]) and _within(a[0], b[0], TOL[dtype]) and torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H", SPLIT_CASES)
@SPLIT_HEAD_DIMS
def test_split_attention_sublayer_matches_plain(device, dtype, B, S, H, D):
    """#7 past 256 tokens (its attention #1's split variant): y, qkv and o within
    the bf16 bound (both products on bf16 operands), one launch a call."""
    args, mask = _sublayer_args(device, dtype, B, S, 768, H, True, D)
    before = ATTENTION_SUBLAYER.launches
    got = fused_attention_sublayer_cuda(*args, mask, H)
    torch.cuda.synchronize()
    assert ATTENTION_SUBLAYER.launches == before + 1
    for a, b in zip(got, fused_attention_sublayer_plain(*args, mask, H)):
        assert _rel_err(a, b) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("B,S,H", SPLIT_CASES)
@SPLIT_HEAD_DIMS
def test_split_bf16_kernels_round_as_their_chains(device, B, S, H, D):
    """The split variant keeps each kernel's rounding rule: #1's output against
    the JAX chain (q~, k~ and P unnormalised rounded, the running max of the
    kernel's key tile: 128 keys at head_dim 64, 64 at 128), #5's
    against ``_fwd_kernel``'s (P normalised first), #3's and #6's gradients
    against their chains (P and dS rounded), each matching but for a few flips
    while the chain with P kept in f32 misses far more."""
    qkv, g, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, "empty", S * H, D)
    out = fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
    assert _bits_differ(out, _jax_rounding_chain(qkv, qs, ks, mask, H)) <= ROUNDING_SHARE_TOL
    assert _bits_differ(out, _jax_rounding_chain(qkv, qs, ks, mask, H, round_p=False)) > 5 * ROUNDING_SHARE_TOL
    dqkv, dqs, dks = fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
    ref, ref_qs, ref_ks = _bwd_rounding_chain(qkv, g, qs, ks, mask, H)
    assert max(_bits_differ_parts(dqkv, ref).values()) <= BWD_ROUNDING_SHARE_TOL
    assert max(_rel_err(dqs, ref_qs), _rel_err(dks, ref_ks)) <= BWD_SCALE_TOL
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    q, k, gh = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)
    out = flash_attention_cuda(q, k, v, mask)
    assert _bits_differ(out, _flash_fwd_chain(q, k, v, mask)) <= ROUNDING_SHARE_TOL
    assert _bits_differ(out, _flash_fwd_chain(q, k, v, mask, round_p=False)) > 5 * ROUNDING_SHARE_TOL
    got = flash_attention_bwd_cuda(q, k, v, mask, gh)
    for a, b in zip(got, _flash_rounding_chain(q, k, v, mask, gh)):
        assert _bits_differ(a, b) <= FLASH_BWD_ROUNDING_SHARE_TOL


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_split_forward_takes_its_kernel_by_head_dim(device, D):
    """Past 256 tokens #1, #5 and #7's attention launch the wgmma forward
    (``split_wg_fwd_kernel``, attention_split_fwd.cuh; #5 twice, its statistics
    and its P.V) at head dims 64 and 128 and the mma.sync one
    (``split_fwd_kernel``, once) at 16 and 32, by the plan's head dim alone, as
    the profiler's kernel names show (a trace that kept no kernel record, as
    happens now and then on the H100, is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    B, S, H = 3, 300, 2
    qkv, _, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, "empty", 41, D)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    args, smask = _sublayer_args(device, torch.bfloat16, B, S, 768, H, True, D)
    want = "split_wg_fwd_kernel" if D >= 64 else "split_fwd_kernel"
    for name, call in (("fused", lambda: fused_qkv_attention_cuda(qkv, qs, ks, mask, H)),
                       ("flash", lambda: flash_attention_cuda(q.contiguous(), k.contiguous(), v, mask)),
                       ("sublayer", lambda: fused_attention_sublayer_cuda(*args, smask, H))):
        for _ in range(6):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
            if names:
                break
        split = [n for n in names if "split_wg_fwd_kernel" in n or "split_fwd_kernel" in n]
        assert len(split) == (2 if name == "flash" and D >= 64 else 1), (name, names)
        assert all(want in n for n in split), (name, names)


@pytest.mark.parametrize("masked", [None, "empty"])
@SPLIT_HEAD_DIMS
def test_split_forward_same_bits_twice_at_512(device, masked, D):
    """The wgmma split forward at the 512² spatial call (b2: 32 sequences of
    1024 tokens, the flagship's width in heads of D), unmasked and with
    sequence 0 keeping no key: #1, #5 and #7 each within the bf16 bound of its
    plain version and the same bits on a second launch (no atomics, one owner
    of every output row)."""
    B, S, H = 32, 1024, 512 // D
    qkv, _, qs, ks, mask = _bwd_inputs(device, torch.bfloat16, B, S, H, masked, 43, D)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    q, k = q.contiguous(), k.contiguous()
    for run, plain in ((lambda: fused_qkv_attention_cuda(qkv, qs, ks, mask, H),
                        lambda: fused_qkv_attention_plain(qkv, qs, ks, mask, H)),
                       (lambda: flash_attention_cuda(q, k, v, mask), lambda: flash_attention_plain(q, k, v, mask))):
        out, again = run(), run()
        torch.cuda.synchronize()
        ref = plain()
        assert _rel_err(out, ref) <= TOL[torch.bfloat16] and torch.equal(out, again)
        if masked:
            assert _rel_err(out[0], ref[0]) <= TOL[torch.bfloat16]
    args, smask = _sublayer_args(device, torch.bfloat16, 4, S, 768, H, True, D)
    got, again = (fused_attention_sublayer_cuda(*args, smask, H) for _ in range(2))
    torch.cuda.synchronize()
    for a, b, c in zip(got, fused_attention_sublayer_plain(*args, smask, H), again):
        assert _rel_err(a, b) <= TOL[torch.bfloat16] and torch.equal(a, c)


def test_serving_pass_at_512_on_the_card(device):
    """The flagship at 512² (spatial S = 1024: #1's split variant) at full width
    and depth, bf16, b1 x 16 frames with 3 padded frames: a finite output of the
    clip's shape, 42 launches of #1 and 15 of #2, and no other kernel."""
    from video_vae_tpu_torch import ModelConfig, VideoVAE, reconstruct
    from video_vae_tpu_torch.ops import KERNELS

    cfg = ModelConfig(height=512, width=512)
    assert cfg.num_patches == 1024 and cfg.attention_impl == "fused"
    model = VideoVAE(cfg, device=device)
    video = torch.rand(1, 16, 512, 512, 3, generator=torch.Generator().manual_seed(0)).to(device)
    mask = torch.ones(1, 16, device=device)
    mask[0, 13:] = 0
    before = {k.symbol: k.launches for k in KERNELS}
    out = reconstruct(model, video, mask, device=device)
    torch.cuda.synchronize()
    assert out.shape == (1, 16, 512, 512, 3) and torch.isfinite(out.float()).all()
    used = {"vvt_fused_attention_fwd": 2 * (cfg.encoder_depth + cfg.decoder_depth),
            "vvt_conv3d_cf": 1 + 4 * cfg.unet_levels + 2}
    assert {k.symbol: k.launches - before[k.symbol] for k in KERNELS} == {
        k.symbol: used.get(k.symbol, 0) for k in KERNELS}


def _sublayer_args(device, dtype, B, S, C, H, masked, D=64):
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


# the third: ragged tiles; the last: tiny_config's width and heads (H·D = 32 at D = 16:
# o·Wout's K under one 64-column slab)
SUBLAYER_CASES = [(64, 16, 768, 8, True), (3, 256, 768, 8, False), (5, 37, 136, 3, True), (32, 16, 192, 2, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,H,masked", SUBLAYER_CASES)
@HEAD_DIMS
def test_attention_sublayer_kernel_matches_plain(device, dtype, B, S, C, H, masked, D):
    args, mask = _sublayer_args(device, dtype, B, S, C, H, masked, D)
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


@pytest.mark.parametrize("B,S,C,H,masked", SUBLAYER_CASES)
@HEAD_DIMS
def test_attention_sublayer_bf16_attention_is_fused_attention(device, B, S, C, H, masked, D):
    """bf16 x runs the fused attention's tensor-core kernel as it stands: the
    sublayer's o is fused_qkv_attention_cuda's on the sublayer's own qkv, bit
    for bit."""
    args, mask = _sublayer_args(device, torch.bfloat16, B, S, C, H, masked, D)
    _, qkv, o = fused_attention_sublayer_cuda(*args, mask, H)
    before = FUSED_ATTENTION.launches
    ref = fused_qkv_attention_cuda(qkv, args[5], args[6], mask, H)
    torch.cuda.synchronize()
    assert FUSED_ATTENTION.launches == before + 1 and torch.equal(o, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,C,H,masked", SUBLAYER_CASES)
@HEAD_DIMS
def test_attention_sublayer_kernel_same_bits_twice(device, dtype, B, S, C, H, masked, D):
    """No split-K and no atomics: two launches give the same y, qkv and o."""
    args, mask = _sublayer_args(device, dtype, B, S, C, H, masked, D)
    out = fused_attention_sublayer_cuda(*args, mask, H)
    again = fused_attention_sublayer_cuda(*args, mask, H)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "qkv", "o"), out, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("B,S,C,H,masked", SUBLAYER_CASES)
@HEAD_DIMS
def test_attention_sublayer_f32_reads_o_as_bf16(device, B, S, C, H, masked, D):
    """f32 x: the out product reads the f32 o rounded to bf16, as the plain
    version does. y matches a torch copy of that rule to f32 summation order,
    and misses the same product on the unrounded o by far more."""
    args, mask = _sublayer_args(device, torch.float32, B, S, C, H, masked, D)
    x, wout, bout = args[0], args[7], args[8]
    y, _, o = fused_attention_sublayer_cuda(*args, mask, H)
    o2, w16 = o.reshape(B * S, -1), wout.to(torch.bfloat16)
    rounded = x + (matmul_f32(o2.to(torch.bfloat16), w16) + bout).reshape(x.shape)
    unrounded = x + (o2 @ w16.float() + bout).reshape(x.shape)
    err = _rel_err(y, rounded)
    print(f"sublayer f32 B={B} S={S} D={D}: y against o.to(bf16) {err:.3e}, against f32 o {_rel_err(y, unrounded):.3e}")
    assert err <= TOL[torch.float32]
    assert _rel_err(y, unrounded) > 10 * err


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


def _mlp_rounding_chain(x, lng, lnb, w1, b1, w2, b2, round_h=True, round_a=True, round_branch=False):
    """y of the MLP sublayer with the kernel's roundings, or with one left out
    (h or a kept in f32) or the module chain's added (the branch rounded to
    x's dtype before the residual add)."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    xa, _, _ = ln_affine(x2, lng, lnb)
    h = torch.mm(xa.float(), w1.bfloat16().float()) + b1.float()
    if round_h:
        h = h.bfloat16().float()
    a = h * (1.0 / (1.0 + torch.exp(-h)))
    if round_a:
        a = a.bfloat16().float()
    branch = torch.mm(a, w2.bfloat16().float()) + b2.float()
    if round_branch:
        branch = branch.to(x.dtype).float()
    return (x2.float() + branch).to(x.dtype)


@pytest.mark.parametrize("rows", [(8192,), (1, 13)])
def test_fused_mlp_bf16_kernel_rounds_as_jax(device, rows):
    """The kernel rounds xa, h and a where the JAX kernel does and y once: the
    bits of y, xa and h match the plain version's but for flips from f32 sums
    taken in another order, while each chain with the h or the a rounding
    left out, or with the branch rounded before the add, misses far more of
    y's bits. Two launches of each variant give the same bits. On the H100
    (the test prints the shares): y, xa, h 0.085 %, 0.002 %, 0.035 % at N =
    8192 and none at N = 13, y against the torch chain 0.71 % and 0.18 %;
    without the h rounding 42.7 % and 43.6 %, without the a rounding 29.9 %,
    the branch rounded first 26.3 % and 26.2 %."""
    args = _mlp_args(device, torch.bfloat16, rows, 768, 1536)
    out = fused_mlp_sublayer_cuda(*args, save_residuals=True)
    again = fused_mlp_sublayer_cuda(*args, save_residuals=True)
    y_only = fused_mlp_sublayer_cuda(*args, save_residuals=False)
    y_again = fused_mlp_sublayer_cuda(*args, save_residuals=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(y_only[0], y_again[0]) and torch.equal(y_only[0], out[0])
    shares = {name: _bits_differ(a, b) for name, a, b in zip(("y", "xa", "h"), out, fused_mlp_sublayer_plain(*args))}
    chain = _bits_differ(out[0], _mlp_rounding_chain(*args))
    others = {
        name: _bits_differ(out[0], _mlp_rounding_chain(*args, **kw))
        for name, kw in (("h in f32", dict(round_h=False)), ("a in f32", dict(round_a=False)),
                         ("branch rounded", dict(round_branch=True)))
    }
    print(f"mlp rounding rows={rows}: bits differ " + ", ".join(f"{k} {v:.5f}" for k, v in shares.items())
          + f", y against the chain {chain:.5f}; " + ", ".join(f"{k} {v:.4f}" for k, v in others.items()))
    for share in (*shares.values(), chain):
        assert share <= ROUNDING_SHARE_TOL
    for name, other in others.items():
        assert other > 5 * ROUNDING_SHARE_TOL, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_wide_rows_match_plain(device, dtype):
    """Rows wider than a warp keeps in registers (C > 2048) take the token LN's
    two-pass path: the kernel matches the plain version and repeats its bits."""
    args = _mlp_args(device, dtype, (3, 100), 2560, 512)
    out = fused_mlp_sublayer_cuda(*args, save_residuals=True)
    again = fused_mlp_sublayer_cuda(*args, save_residuals=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "xa", "h"), out, fused_mlp_sublayer_plain(*args)):
        assert a.shape == b.shape and _rel_err(a, b) <= TOL[torch.bfloat16], name
    assert all(torch.equal(a, b) for a, b in zip(out, again))


SILU_CHECK = CudaKernel(
    "mlp_silu_check.cu", "vvt_mlp_silu_check", [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
)


def test_fused_mlp_silu_matches_the_division(device):
    """The MLP kernel's SiLU takes the division's fast path without its check:
    at every bf16 input (all h can be) it gives the bits of v * (1.f / (1.f +
    expf(-v))) with the IEEE division, NaN for NaN."""
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).to(device)
    fast, exact = (torch.empty(bits.numel(), dtype=torch.float32, device=device) for _ in range(2))
    SILU_CHECK.launch(bits.data_ptr(), fast.data_ptr(), exact.data_ptr(), bits.numel(),
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    same = (fast.view(torch.int32) == exact.view(torch.int32)) | (fast.isnan() & exact.isnan())
    assert same.all(), f"{(~same).sum().item()} of {same.numel()} differ"


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


# the convs the gate sends to the tap-dot kernel on the tap-dot model (forward
# convs and input gradients; chip_smoke.tapdot_launches), and cout = 64 at 256^2
# from one source
TAPDOT_MODEL_SHAPES = [  # (h, w), source channels, cout
    ((128, 128), (128,), 128), ((128, 128), (128, 128), 128), ((256, 256), (64, 64), 64),
    ((128, 128), (128,), 64), ((128, 128), (128,), 256), ((256, 256), (128,), 64),
]


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("hw,cins,cout", TAPDOT_MODEL_SHAPES)
def test_tapdot_kernel_at_the_model_shapes(device, hw, cins, cout, pool):
    """b1 x 1 frame of each shape against the plain version; two launches give
    the same bits; the pooled variant's full output is the unpooled call's."""
    h, w = hw
    dtype = torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(sum(cins) + cout + h)
    xs = [torch.randn(1, 1, c, h, w, generator=gen).to(device, dtype) for c in cins]
    kernel = (torch.randn(1, 3, 3, sum(cins), cout, generator=gen) / (sum(cins) * 9) ** 0.5).to(device, dtype)
    bias = torch.randn(cout, generator=gen).to(device)
    x2 = xs[1] if len(xs) == 2 else None
    out = conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=pool)
    again = conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=pool)
    unpooled = conv3d_tapdot_cuda(xs[0], x2, kernel, bias)
    torch.cuda.synchronize()
    ref = conv3d_tapdot_plain(xs[0], x2, kernel, bias, pool=pool)
    outs, agains, refs = (t if pool else (t,) for t in (out, again, ref))
    for a, b, r in zip(outs, agains, refs):
        assert a.dtype == dtype and a.shape == r.shape and _rel_err(a, r) <= TOL[dtype]
        assert torch.equal(a, b)
    assert torch.equal(outs[0], unpooled)


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


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_tiny_trainer_two_steps(device, overlap, tmp_path, monkeypatch):
    """Two steps of the training entry point on the card: ``tiny_config`` itself
    (32², head_dim 16, one UNet level of 4 channels) on 2 clips of 8 frames a
    step. Each step launches #1-#4 alike, the batch copy on the side stream
    (``VVT_H2D_OVERLAP=1``) or on the compute stream gives the same metrics, the
    checkpoint restores bit-exactly."""
    import json
    import os

    from video_vae_tpu_torch.core.config import tiny_config
    from video_vae_tpu_torch.ops import KERNELS
    from video_vae_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("VVT_H2D_OVERLAP", overlap)
    cfg = tiny_config()
    cfg = cfg.replace(
        data=cfg.data.replace(synthetic_num_clips=4),
        train=cfg.train.replace(log_every=1, video_every=0, checkpoint_dir=str(tmp_path / "ckpt")),
    )
    trainer = Trainer(cfg, install_signal_handlers=False)
    assert trainer.device.type == "cuda" and all(p.is_cuda for p in trainer.model.parameters())
    per_step, inner = [], trainer.train_step

    def counted(*args, **kw):
        before = {k.symbol: k.launches for k in KERNELS}
        out = inner(*args, **kw)
        per_step.append({k.symbol: k.launches - before[k.symbol] for k in KERNELS})
        return out

    trainer.train_step = counted
    assert trainer.run_epoch(0) and trainer.global_step == 2
    used = ("vvt_fused_attention_fwd", "vvt_fused_attention_bwd", "vvt_conv3d_cf", "vvt_conv3d_wgrad")
    assert per_step[0] == per_step[1] and all(per_step[0][k] > 0 for k in used)
    with open(os.path.join(cfg.train.checkpoint_dir, "train.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [1, 2]
    assert all(math.isfinite(v) for line in lines for v in line.values())
    restored = Trainer(cfg, install_signal_handlers=False)
    assert restored.global_step == 2 and restored.optimizer.count == 2
    for a, b in zip([*trainer.model.parameters(), *trainer.optimizer.mu, *trainer.optimizer.nu],
                    [*restored.model.parameters(), *restored.optimizer.mu, *restored.optimizer.nu]):
        assert a.is_cuda and torch.equal(a, b)
    # the same run with the other copy mode logs the same metrics
    monkeypatch.setenv("VVT_H2D_OVERLAP", "0" if overlap == "1" else "1")
    other = Trainer(cfg.replace(train=cfg.train.replace(checkpoint_dir=str(tmp_path / "other"))),
                    install_signal_handlers=False)
    assert other.run_epoch(0)
    with open(os.path.join(tmp_path, "other", "train.jsonl")) as f:
        again = [json.loads(line) for line in f]
    for a, b in zip(lines, again):
        for key in a:
            if key != "elapsed":
                assert abs(a[key] - b[key]) <= 1e-5 * max(abs(b[key]), 1e-30), key


def test_h4_train_step_is_finite(device):
    """One bf16 train step of ``ModelConfig(num_heads=4)`` (the flagship's width in
    4 heads of 128) at reduced size on the fused path: #1 and #3 launch at head_dim
    128 once per attention call, and the loss and gradient norm are finite."""
    from video_vae_tpu_torch import DynamicHParams, LossConfig, ModelConfig, OptimConfig, VideoVAE
    from video_vae_tpu_torch import create_optimizer, train_step

    cfg = ModelConfig(num_heads=4, height=64, width=64, encoder_depth=1, decoder_depth=1, remat=False)
    assert cfg.head_dim == 128
    model = VideoVAE(cfg, device=device)
    opt = create_optimizer(model, OptimConfig())
    gen = torch.Generator().manual_seed(0)
    video = torch.rand(1, 16, 64, 64, 3, generator=gen).to(device)
    mask = torch.ones(1, 16, device=device)
    mask[0, 13:] = 0
    before = (FUSED_ATTENTION.launches, FUSED_ATTENTION_BWD.launches)
    metrics = train_step(model, opt, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=False), None,
                         generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.synchronize()
    calls = 2 * (cfg.encoder_depth + cfg.decoder_depth)
    assert (FUSED_ATTENTION.launches - before[0], FUSED_ATTENTION_BWD.launches - before[1]) == (calls, calls)
    assert math.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0


def test_latent_clis_on_the_card(device, tmp_path, monkeypatch, capsys):
    """``cli/cache_latents.py`` and ``cli/decode_latents.py`` at ``--tiny`` under their
    default device (CUDA), on two in-memory clips (the card machine has no OpenCV):
    the latents and the decoded video are finite and of the JAX CLI's shapes, and the
    encode launched #1 once per attention call of each clip."""
    import numpy as np

    from video_vae_tpu_torch.cli import cache_latents, decode_latents
    from video_vae_tpu_torch.core.config import tiny_config

    cfg = tiny_config().model
    rng = np.random.default_rng(0)
    clips = {}
    for name, frames in (("a.mp4", 8), ("b.mp4", 5)):
        video = np.zeros((8, 32, 32, 3), np.float32)
        video[:frames] = rng.uniform(0, 1, (frames, 32, 32, 3))
        mask = (np.arange(8) < frames).astype(np.float32)
        clips[name] = (video, mask)
    written = {}
    monkeypatch.setattr("video_vae_tpu_torch.data.source.list_video_files",
                        lambda d, max_shards=100: [str(tmp_path / n) for n in sorted(clips)])
    monkeypatch.setattr("video_vae_tpu_torch.data.video_io.load_video",
                        lambda path, *a, **k: tuple(x.copy() for x in clips[path.split("/")[-1]]))
    monkeypatch.setattr("video_vae_tpu_torch.data.video_io.write_video",
                        lambda batch, path, fps=30.0, sample_index=0: written.update({path: batch}))
    before = FUSED_ATTENTION.launches
    cache_latents.main(["--model_path", str(tmp_path / "none"), "--data_dir", str(tmp_path),
                        "--out_dir", str(tmp_path / "out"), "--tiny", "--max_frames", "8"])
    assert FUSED_ATTENTION.launches - before == 2 * 2 * cfg.encoder_depth
    assert "WARNING: checkpoint restore failed" in capsys.readouterr().out
    for name, (video, mask) in clips.items():
        npz = np.load(tmp_path / "out" / name.replace(".mp4", ".npz"))
        assert npz["mean"].shape == (8, cfg.num_patches, cfg.latent_dim) and np.isfinite(npz["mean"]).all()
        assert npz["selection_prob"].shape == (8, 1) and np.array_equal(npz["mask"], mask)
        decode_latents.main(["--model_path", str(tmp_path / "none"), "--latents",
                             str(tmp_path / "out" / name.replace(".mp4", ".npz")), "--out", str(tmp_path / name),
                             "--tiny"])
        recon = written[str(tmp_path / name)]["video"]
        assert recon.shape == video.shape and np.isfinite(recon).all()


@pytest.mark.parametrize("remat", [False, True])
def test_discriminator_matches_cpu(device, remat):
    """The discriminator's f32 logits, gradients and ``u`` on the card against the CPU
    (its convs are cuDNN's; no kernel of the port), remat on and off."""
    from video_vae_tpu_torch.models import Discriminator

    kw = dict(base_features=8, num_levels=2, remat=remat, dtype=torch.float32, seed=3)
    cpu, gpu = Discriminator(device="cpu", **kw), Discriminator(device=device, **kw)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    out = {}
    for name, disc, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, device)):
        logits = disc(x.to(dev))
        grads = torch.autograd.grad((logits * torch.tensor([[1.0], [-2.0]], device=dev)).sum(),
                                    list(disc.parameters()))
        out[name] = (logits.detach().cpu(), [g.cpu() for g in grads], [b.cpu() for b in disc.buffers()])
    (l_cpu, g_cpu, u_cpu), (l_gpu, g_gpu, u_gpu) = out["cpu"], out["gpu"]
    assert _rel_err(l_gpu, l_cpu) <= TOL[torch.float32]
    scale = max(float(g.abs().max()) for g in g_cpu)
    for a, b in zip(g_gpu, g_cpu):
        if float(b.abs().max()) <= 1e-5 * scale:  # a conv bias the one-channel GroupNorm removes
            assert float(a.abs().max()) <= 1e-5 * scale
        else:
            assert _rel_err(a, b) <= 1e-3
    for a, b in zip(u_gpu, u_cpu):  # one power step a call, remat's recompute included
        assert _rel_err(a, b) <= TOL[torch.float32]


def test_gan_step_runs_on_the_card(device):
    """One bf16 GAN step of the tiny VAE and a small discriminator: the train step's
    kernels launch, the metrics are the JAX step's and finite, every ``u`` moves."""
    from video_vae_tpu_torch import DynamicHParams, VideoVAE, create_optimizer, tiny_config
    from video_vae_tpu_torch.models import Discriminator
    from video_vae_tpu_torch.train import make_adversarial_train_step

    cfg = tiny_config(dtype="bfloat16")
    model = VideoVAE(cfg.model, device=device)
    disc = Discriminator(base_features=8, num_levels=2, device=device)
    opt, d_opt = create_optimizer(model, cfg.optim), create_optimizer(disc, cfg.optim)
    u0 = [b.clone() for b in disc.buffers()]
    before = {k: k.launches for k in (FUSED_ATTENTION, FUSED_ATTENTION_BWD, CONV3D, CONV3D_WGRAD)}
    gen = torch.Generator().manual_seed(0)
    video = torch.rand(2, 8, 32, 32, 3, generator=gen).to(device)
    metrics = make_adversarial_train_step(cfg.loss, None)(
        model, opt, disc, d_opt, video, torch.ones(2, 8, device=device), DynamicHParams.default(), 0,
        generator=torch.Generator(device=device).manual_seed(1),
    )
    assert all(k.launches > n for k, n in before.items())
    assert {"loss", "generator_adv_loss", "discriminator_loss", "discriminator_accuracy"} <= set(metrics)
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(disc.buffers(), u0))


def test_mae_matches_cpu_at_s196(device):
    """The VideoMAE at 224² (spatial S = 196: the fused kernels' partial last tile),
    f32, depth 1 + 1, with an injected token mask: prediction, loss and every
    gradient on the card against the CPU, kernels #1 and #3 launched."""
    from video_vae_tpu_torch import ModelConfig
    from video_vae_tpu_torch.models import VideoMAE, mae_loss

    cfg = ModelConfig(height=224, width=224, dtype="float32", encoder_depth=1, decoder_depth=1, remat=False)
    cpu, gpu = VideoMAE(cfg, device="cpu", seed=2), VideoMAE(cfg, device=device, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    video = torch.rand(1, 4, 224, 224, 3, generator=gen)
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    token_mask = torch.rand(1, 4, 196, generator=gen) < 0.9
    before = FUSED_ATTENTION.launches, FUSED_ATTENTION_BWD.launches
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, device)):
        res = model(video.to(dev), mask.to(dev), token_mask=token_mask.to(dev))
        loss, _ = mae_loss(res, mask.to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (res.prediction.detach().cpu(), float(loss.detach()), [g.cpu() for g in grads])
    assert FUSED_ATTENTION.launches - before[0] == 4 and FUSED_ATTENTION_BWD.launches - before[1] == 4
    (p_cpu, l_cpu, g_cpu), (p_gpu, l_gpu, g_gpu) = out["cpu"], out["gpu"]
    assert _rel_err(p_gpu, p_cpu) <= TOL[torch.float32]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for a, b in zip(g_gpu, g_cpu):
        assert _rel_err(a, b) <= 1e-3


def test_reference_import_on_the_card(device):
    """``import_reference_state`` at ``tiny_config`` on the card: one model's parameters as a
    reference checkpoint's tree (nested dicts, block stacks as lists, ``.value`` leaves, RoPE
    caches) into a model of another seed give every parameter and a bf16 serving pass the
    same bits; a changed shape raises and leaves the model as it was."""
    from video_vae_tpu_torch import VideoVAE, reconstruct, tiny_config
    from video_vae_tpu_torch.train import import_reference_state

    class Leaf:
        def __init__(self, value):
            self.value = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        return [node[str(i)] for i in range(len(node))] if all(k.isdigit() for k in node) else node

    cfg = tiny_config(dtype="bfloat16").model

    def reference_tree(values):
        tree = {}
        for key, value in values.items():
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = Leaf(value)
        for stack in ("encoder", "decoder"):
            for block in tree[stack]["layers"].values():
                for name in ("SpatialAttention", "TemporalAttention"):
                    block[name]["ROPE"] = {c: Leaf(torch.ones(8, cfg.head_dim).numpy()) for c in ("cos", "sin")}
        return listify(tree)

    source, target = VideoVAE(cfg, device=device, seed=0), VideoVAE(cfg, device=device, seed=1)
    with torch.no_grad():
        fc = source.decoder.unet.final_conv.kernel  # zero at init: it would hide the UNet
        fc.copy_(torch.randn(fc.shape, generator=torch.Generator().manual_seed(2)).to(device))
    params = {name.replace(".", "/"): p.detach().cpu().numpy() for name, p in source.named_parameters()}
    last = list(params)[-1]
    before = [p.detach().clone() for p in target.parameters()]
    with pytest.raises(ValueError, match=f"shape mismatch at {last}"):
        import_reference_state(target, reference_tree({**params, last: params[last][..., None]}))
    assert all(torch.equal(p, q) for p, q in zip(target.parameters(), before))

    assert import_reference_state(target, reference_tree(params)) == len(params)
    assert all(torch.equal(p, q) for p, q in zip(target.parameters(), source.parameters()))
    gen = torch.Generator().manual_seed(3)
    video = torch.rand(2, 8, 32, 32, 3, generator=gen).to(device)
    mask = torch.ones(2, 8, device=device)
    mask[1, 5:] = 0
    launches = FUSED_ATTENTION.launches, CONV3D.launches
    out = [reconstruct(model, video, mask, device=device) for model in (source, target)]
    assert FUSED_ATTENTION.launches > launches[0] and CONV3D.launches > launches[1]
    assert torch.isfinite(out[0].float()).all() and torch.equal(out[0], out[1])
