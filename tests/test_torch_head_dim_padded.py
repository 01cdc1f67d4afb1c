"""Head dims the attention kernels pad, on the CPU.

The kernels are instantiated at head dims 16, 32, 64 and 128. A call at another
even head dim D up to 128 pads each head to the next of those, Dp
(``padded_head_dim``), by halves (``pad_heads``), and runs the kernel at Dp with
the true D's 1/D in its LN statistics and 1/√D in its scores. Here:

* ``pad_heads`` / ``unpad_heads``: the round trip, the place of every column and
  the zeros, and RoPE's rotate-half partners kept;
* the padded contract in plain form (the ``*_plain`` functions at Dp with
  ``head_dim=D``) against the plain versions at D, for #1 forward and backward
  (the scale gradients too), #5, #6 and #7's forward, at D = 8, 24, 40, 48, 72
  and 96 (every Dp, near its top and far below it) and S = 16, 65 and 257, f32
  with a ragged key mask and one sequence that keeps no key. The padded columns
  are exact zeros, so the two agree up to the order of f32 sums:
  ``CONTRACT_TOL`` of the largest reference value, ten times tighter than the
  card's f32 kernel checks (#7's y ``SUBLAYER_Y_TOL``: o is rounded to bf16
  before the out projection, as the kernel rounds it, so a last-bit difference
  in o can move one bf16 rounding);
* ``tiny_config(qkv_features=48, num_heads=2)`` (D = 24) and
  ``qkv_features=96`` (D = 48) against the JAX package, as
  ``tests/test_torch_head_dim_128.py`` holds D = 128: the serving pass in f32
  and bf16 and one f32 train step's metrics and gradients, the JAX draws
  injected (the CPU runs the plain versions at the true D).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import BF16_TOL, F32_TOL, random_params, set_jax_params
from test_torch_train_step import _close, _draws, _flat_grads, _inputs

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import _loss_fn, make_reconstruct_fn
from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops import flash_attention as fa
from video_vae_tpu_torch.ops.rope import rope_tables, rotate_half
from video_vae_tpu_torch.train.step import loss_and_grads

CONTRACT_TOL = 1e-5
SUBLAYER_Y_TOL = 1e-3
HEAD_DIMS = (8, 24, 40, 48, 72, 96)
SEQS = (16, 65, 257)
CASES = [(d, s) for d in HEAD_DIMS for s in SEQS]
HEADS, WIDTH = 2, 32


def _rand(gen, *shape):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32))


def _mask(gen, b, s):
    """A ragged key mask: a random kept prefix of each sequence, none of the first."""
    lengths = gen.integers(1, s + 1, b)
    lengths[0] = 0
    return torch.arange(s)[None, :] < torch.from_numpy(lengths)[:, None]


def _close_to(name, got, ref, tol=CONTRACT_TOL):
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (name, err, ref.abs().max().item())


# ---------------------------------------------------------------------------
# pad_heads / unpad_heads
# ---------------------------------------------------------------------------


def test_padded_head_dim_is_the_next_instantiation():
    assert fa.KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    want = {2: 16, 8: 16, 16: 16, 18: 32, 24: 32, 32: 32, 40: 64, 48: 64, 64: 64, 72: 128, 80: 128, 96: 128,
            128: 128, 130: 256, 192: 256, 256: 256, 258: 384, 384: 384, 512: 512}
    assert {d: fa.padded_head_dim(d) for d in want} == want
    for bad in (0, 7, 129, 131, 255):
        with pytest.raises(ValueError, match="even head_dim of at least 2"):
            fa.padded_head_dim(bad)


@pytest.mark.parametrize("d", [2, 8, 24, 40, 48, 72, 96, 64])
def test_pad_heads_places_each_half(d):
    gen = np.random.default_rng(d)
    dp, heads = fa.padded_head_dim(d), 3
    t = _rand(gen, 2, 5, heads * d)
    p = fa.pad_heads(t, heads, d, dp)
    assert p.shape == (2, 5, heads * dp)
    if dp == d:
        assert p is t and fa.unpad_heads(p, heads, d, dp) is t
        return
    for h in range(heads):
        real, padded = t[..., h * d:(h + 1) * d], p[..., h * dp:(h + 1) * dp]
        assert torch.equal(padded[..., : d // 2], real[..., : d // 2])
        assert torch.equal(padded[..., dp // 2: dp // 2 + d // 2], real[..., d // 2:])
        assert not padded[..., d // 2: dp // 2].any() and not padded[..., dp // 2 + d // 2:].any()
    back = fa.unpad_heads(p, heads, d, dp)
    assert back.is_contiguous() and torch.equal(back, t)


@pytest.mark.parametrize("d", [8, 24, 48, 96])
def test_pad_heads_keeps_the_rope_partners(d):
    """rotate_half and the RoPE tables of D, both padded, rotate the real
    columns as at D: the padded rotation unpads to the rotation at D."""
    gen = np.random.default_rng(100 + d)
    dp, s = fa.padded_head_dim(d), 9
    x = _rand(gen, 2, s, d)
    cos, sin = rope_tables(s, d)
    xp, cp, sp = (fa.pad_heads(t, 1, d, dp) for t in (x, cos, sin))
    assert torch.equal(fa.unpad_heads(rotate_half(xp), 1, d, dp), rotate_half(x))
    assert torch.equal(fa.unpad_heads(xp * cp + rotate_half(xp) * sp, 1, d, dp), x * cos + rotate_half(x) * sin)


def test_softmax_scale_is_the_jax_wrappers():
    """1/√D as the JAX wrappers compute it; in f32 at the instantiations, the
    constants the kernels held before they took the scale at run time."""
    assert fa.softmax_scale(96) == 1.0 / 96**0.5
    f32 = {d: np.float32(fa.softmax_scale(d)) for d in fa.KERNEL_HEAD_DIMS}
    assert f32 == {16: np.float32(0.25), 32: np.float32(0.17677669529663687), 64: np.float32(0.125),
                   128: np.float32(0.0883883461356163)}


# ---------------------------------------------------------------------------
# The padded contract in plain form against the plain versions at D
# ---------------------------------------------------------------------------


def _qkv_case(d, s, seed):
    gen = np.random.default_rng(seed)
    b = 3
    qkv = _rand(gen, b, s, 3 * HEADS * d)
    g = _rand(gen, b, s, HEADS * d)
    qs, ks = 1 + 0.2 * _rand(gen, d), 1 + 0.2 * _rand(gen, d)
    return qkv, g, qs, ks, _mask(gen, b, s)


@pytest.mark.parametrize("d,s", CASES)
def test_fused_forward_padded_contract(d, s):
    qkv, _, qs, ks, mask = _qkv_case(d, s, d * 1000 + s)
    dp = fa.padded_head_dim(d)
    ref = fa.fused_qkv_attention_plain(qkv, qs, ks, mask, HEADS)
    out = fa.fused_qkv_attention_plain(
        fa.pad_heads(qkv, 3 * HEADS, d, dp), fa.pad_heads(qs, 1, d, dp), fa.pad_heads(ks, 1, d, dp), mask, HEADS,
        head_dim=d,
    )
    assert out.shape == (3, s, HEADS * dp)
    assert not out.unflatten(-1, (HEADS, 2, dp // 2))[..., d // 2:].any()  # the padded columns stay zero
    _close_to("out", fa.unpad_heads(out, HEADS, d, dp), ref)


@pytest.mark.parametrize("d,s", CASES)
def test_fused_backward_padded_contract(d, s):
    qkv, g, qs, ks, mask = _qkv_case(d, s, d * 1000 + s + 1)
    dp = fa.padded_head_dim(d)
    ref = fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, HEADS)
    dqkv, dqs, dks = fa.fused_qkv_attention_bwd_plain(
        fa.pad_heads(qkv, 3 * HEADS, d, dp), fa.pad_heads(qs, 1, d, dp), fa.pad_heads(ks, 1, d, dp), mask,
        fa.pad_heads(g, HEADS, d, dp), HEADS, head_dim=d,
    )
    # the padded columns of q and k get no scale gradient: their dln is 0
    for part in (dqs, dks):
        assert not part.unflatten(-1, (2, dp // 2))[:, d // 2:].any()
    got = (fa.unpad_heads(dqkv, 3 * HEADS, d, dp), *(fa.unpad_heads(t, 1, d, dp) for t in (dqs, dks)))
    for name, a, b in zip(("dqkv", "dq_scale", "dk_scale"), got, ref):
        _close_to(name, a, b)


@pytest.mark.parametrize("d,s", CASES)
def test_flash_forward_padded_contract(d, s):
    qkv, _, _, _, mask = _qkv_case(d, s, d * 1000 + s + 2)
    dp = fa.padded_head_dim(d)
    q, k, v = (t.reshape(3, s, HEADS, d) for t in qkv.split(HEADS * d, -1))
    ref = fa.flash_attention_plain(q, k, v, mask)
    out = fa.flash_attention_plain(*(fa.pad_heads(t, 1, d, dp) for t in (q, k, v)), mask, head_dim=d)
    _close_to("o", fa.unpad_heads(out, 1, d, dp), ref)


@pytest.mark.parametrize("d,s", CASES)
def test_flash_backward_padded_contract(d, s):
    qkv, g, _, _, mask = _qkv_case(d, s, d * 1000 + s + 3)
    dp = fa.padded_head_dim(d)
    q, k, v = (t.reshape(3, s, HEADS, d) for t in qkv.split(HEADS * d, -1))
    g = g.reshape(3, s, HEADS, d)
    ref = fa.flash_attention_bwd_plain(q, k, v, mask, g)
    got = fa.flash_attention_bwd_plain(*(fa.pad_heads(t, 1, d, dp) for t in (q, k, v)), mask,
                                       fa.pad_heads(g, 1, d, dp), head_dim=d)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close_to(name, fa.unpad_heads(a, 1, d, dp), b)


@pytest.mark.parametrize("d,s", CASES)
def test_sublayer_padded_contract(d, s):
    """#7's forward: Wqkv's and bqkv's columns and Wout's rows padded by heads,
    so that qkv and o come out padded (zeros in the padded columns) and y as at D."""
    gen = np.random.default_rng(d * 1000 + s + 4)
    dp, hd, b = fa.padded_head_dim(d), HEADS * d, 2
    x = _rand(gen, b, s, WIDTH)
    params = (1 + 0.2 * _rand(gen, WIDTH), 0.2 * _rand(gen, WIDTH), _rand(gen, WIDTH, 3 * hd) / WIDTH**0.5,
              0.2 * _rand(gen, 3 * hd), 1 + 0.2 * _rand(gen, d), 1 + 0.2 * _rand(gen, d),
              0.1 * _rand(gen, hd, WIDTH) / hd**0.5, 0.2 * _rand(gen, WIDTH))
    lng, lnb, wqkv, bqkv, qs, ks, wout, bout = params
    mask = _mask(gen, b, s)
    ref = fa.fused_attention_sublayer_plain(x, *params, mask, HEADS)
    y, qkv, o = fa.fused_attention_sublayer_plain(
        x, lng, lnb, fa.pad_heads(wqkv, 3 * HEADS, d, dp), fa.pad_heads(bqkv, 3 * HEADS, d, dp),
        fa.pad_heads(qs, 1, d, dp), fa.pad_heads(ks, 1, d, dp), fa.pad_heads(wout.t(), HEADS, d, dp).t(), bout,
        mask, HEADS, head_dim=d,
    )
    got = (y, fa.unpad_heads(qkv, 3 * HEADS, d, dp), fa.unpad_heads(o, HEADS, d, dp))
    assert torch.equal(got[1], ref[1])  # one product over the same K: the padded columns add exact zeros
    for name, a, r, tol in zip(("y", "qkv", "o"), got, ref, (SUBLAYER_Y_TOL, CONTRACT_TOL, CONTRACT_TOL)):
        _close_to(name, a, r, tol)


def test_check_head_dim_raises_past_the_pads():
    """0 and an odd head dim raise; an even one past the pads runs wide."""
    for bad in (0, 1, 3, 95, 129, 193, 257):
        with pytest.raises(ValueError, match="even head_dim of at least 2"):
            fa.check_head_dim(bad)
    for wide in (130, 192, 256, 384, 512):
        fa.check_head_dim(wide)
        assert fa.fused_attention_plan(2, 16, 2, fa.padded_head_dim(wide)) == ("wide", 1)


# ---------------------------------------------------------------------------
# Tiny models at D = 24 and D = 48 against the JAX package
# ---------------------------------------------------------------------------

SEED = 12
# (overrides, the sampling stream of the step: no decision within 0.02 of its uniform)
MODELS = {24: (dict(qkv_features=48, num_heads=2), 25), 48: (dict(qkv_features=96, num_heads=2), 25)}


def _jax_model(dtype, overrides):
    return nnx.jit(lambda: JaxVideoVAE(jax_tiny_config(dtype=dtype, **overrides).model, nnx.Rngs(0, sampling=1)))()


@pytest.fixture(scope="module")
def params():
    return {d: random_params(_jax_model("float32", overrides), SEED) for d, (overrides, _) in MODELS.items()}


def _models(dtype, d, params):
    overrides = MODELS[d][0]
    jax_model = _jax_model(dtype, overrides)
    set_jax_params(jax_model, params[d])
    port = VideoVAE(tiny_config(dtype=dtype, **overrides).model, device="cpu")
    assert load_jax_params(port, params[d]) == len(params[d])
    return jax_model, port


@pytest.mark.parametrize("d", sorted(MODELS))
def test_the_configs_pad(d):
    cfg = tiny_config(**MODELS[d][0]).model
    assert cfg.head_dim == d and d not in fa.KERNEL_HEAD_DIMS and fa.padded_head_dim(d) == {24: 32, 48: 64}[d]


@pytest.mark.parametrize("d", sorted(MODELS))
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_reconstruct_at_padded_head_dims_matches_jax(d, dtype, tol, params):
    video, mask = _inputs()
    jax_model, port = _models(dtype, d, params)
    ref = make_reconstruct_fn(jnp.dtype(dtype))(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("d", sorted(MODELS))
def test_train_step_at_padded_head_dims_matches_jax_f32(d, params):
    """One f32 step's loss, metrics and every gradient, the JAX draws injected."""
    jax_model, port = _models("float32", d, params)
    video, mask = _inputs()
    draw_seed = MODELS[d][1]
    noise, uniforms = _draws(draw_seed, jax_model, video, mask, "float32")
    hp = JaxDynamicHParams.default()
    jloss_cfg = JaxLossConfig(use_perceptual=False)

    @nnx.jit
    def jax_grads(model, video, mask, rngs, hp):
        def f(model, rngs):
            return _loss_fn(model, video, mask, rngs, hp, jloss_cfg, None)

        (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
        return metrics, grads

    metrics, grads = jax_grads(jax_model, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=draw_seed), hp)
    ref = {k: float(v) for k, v in metrics.items()}
    ref_grads = _flat_grads(grads)
    _, ours, our_grads = loss_and_grads(
        port, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=False), None,
        noise=noise, uniforms=uniforms,
    )
    assert set(ours) == set(ref)
    for key, value in ours.items():
        value = float(value.detach())
        assert _close(value, ref[key], key, F32_TOL), (key, value, ref[key])
    assert 0 < ref["kept_frame_density"] < 1
    names = [n.replace(".", "/") for n, _ in port.named_parameters()]
    assert set(names) == set(ref_grads)
    scale = max(np.abs(g).max() for g in ref_grads.values())
    # a conv bias whose GroupNorm has one channel per group: 0 up to rounding on both
    # sides (tests/test_torch_train_step.py), held to that
    vanishing = {
        f"{n}/conv/bias".replace(".", "/")
        for n, m in port.named_modules()
        if isinstance(m, ConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()
    }
    for name, g in zip(names, our_grads):
        theirs = ref_grads[name]
        if name in vanishing:
            assert max(np.abs(g.numpy()).max(), np.abs(theirs).max()) <= 1e-6 * scale, name
            continue
        err = np.abs(g.numpy() - theirs).max()
        assert err <= F32_TOL * np.abs(theirs).max(), (name, err, np.abs(theirs).max())
