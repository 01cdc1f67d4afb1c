"""The attention paths past 256 tokens against the JAX package, on the CPU.

On the card a sequence longer than ``TILE_MAX_SEQ`` = 256 takes the kernels'
split variant; on the CPU the wrappers take the plain versions, as every CPU
tensor does. The JAX package has no such limit: its fused attention and
sublayer run their plain chains off the TPU, and its plain attention runs
its Pallas kernels in interpret mode, as its own tests run them. The same
numpy inputs go through both packages at S = 257 (one past the tile
variant) and S = 324 (the 18² patch grid of ``--resize 288``), 3 sequences
of 2 heads of 16, with partly masked sequences and one whose keys are all
masked: #1's and #3's arithmetic (``fused_qkv_attention`` forward and
gradients), #5's and #6's (``flash_attention``), #7's
(``fused_attention_sublayer``). A sequence with no key is held where JAX's
CPU path and the kernels agree on it: every forward, and the plain
attention's gradients (the Pallas backward's rule, which the port's kernels
keep: such a row's dS spreads over all S keys); JAX's plain chains take
their gradients through ``where``, which gives such a row none, so the fused
attention's and the sublayer's gradients are held with every sequence
keeping a key, as ``tests/test_torch_backward.py`` holds them. Then a
``tiny_config`` model at 144² (patch
8: spatial S = 324) through ``load_jax_params``, its serving pass in f32 and
bf16 and one f32 train step with the JAX side's draws injected.

Tolerances, as max-abs error over max|reference|: f32 1e-4 (the same
arithmetic in another summation order; ``tests/test_torch_attention.py``'s),
f32 plain attention 1e-5 (``tests/test_torch_flash_attention.py``'s), bf16
2e-2 (a few bf16 roundings), the sublayer's forward 2e-2 and gradients 3e-2
of each leaf's largest value (both GEMMs on bf16 operands:
``tests/test_torch_attention_sublayer.py``'s), the model's ``test_torch_model``
bounds (f32 1e-4, bf16 3e-2) and every gradient of the step 1e-4 of its
leaf's largest value, or of 1 % of the step's largest where a leaf's sums
cancel below that (``CANCEL_FLOOR``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import BF16_TOL as MODEL_BF16_TOL
from test_torch_model import F32_TOL as MODEL_F32_TOL
from test_torch_model import random_params, set_jax_params
from test_torch_train_step import _close, _draws, _flat_grads

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.ops import flash_attention as jfa
from video_vae_tpu.train.step import _loss_fn, make_reconstruct_fn
from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops.flash_attention import (
    TILE_MAX_SEQ,
    flash_attention,
    fused_attention_sublayer,
    fused_attention_plan,
    fused_qkv_attention,
)
from video_vae_tpu_torch.train.step import loss_and_grads

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_F32_TOL = 1e-5
SUBLAYER_FWD_TOL, SUBLAYER_GRAD_TOL = 2e-2, 3e-2
B, H, D, C = 3, 2, 16, 64
SEQS = (257, 324)
CASES = [(S, dtype, masked) for S in SEQS for dtype in TOL for masked in (False, True)]
IDS = [f"S{S}-{dtype}-{'masked' if masked else 'open'}" for S, dtype, masked in CASES]
# the model: tiny_config at 144² (an 18 x 18 grid of 8-pixel patches), b2 x 8 frames
SIDE, SEED = 144, 21
DRAW_SEED = 22  # the sampling stream of the step: no decision within 0.02 of its uniform
# a gradient held against its leaf's largest value, but no smaller a scale than this
# share of the step's largest: a UNet GroupNorm bias sums a group's 8 x 144² activations'
# gradients, which cancel to under 1e-3 of the step's largest, so that the two
# frameworks' summation orders weigh more there than at tiny's 32²
CANCEL_FLOOR = 1e-2


def _mask(S, rng, empty=True):
    """Sequence 0 keeps a prefix past the first key tile of 64, 1 keeps no key
    (``empty``) or a prefix within the first tile, 2 keeps all."""
    mask = np.ones((B, S), bool)
    mask[0, rng.integers(65, S) :] = False
    mask[1, 0 if empty else rng.integers(1, 64) :] = False
    return mask


def _rel_err(ours, theirs):
    theirs = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


def test_the_long_sequences_split_on_the_card():
    for S in SEQS:
        assert S > TILE_MAX_SEQ and fused_attention_plan(B, S, H, D) == ("split", 1)
    assert tiny_config(height=SIDE, width=SIDE).model.num_patches == 324


@pytest.mark.parametrize("S,dtype,masked", CASES, ids=IDS)
def test_fused_attention_matches_jax(S, dtype, masked):
    """Forward (a sequence with no key among the masked), and (f32) the gradients
    of qkv and both scales through the autograd wrapper (every sequence with a key)."""
    rng = np.random.default_rng(S)
    qkv = rng.standard_normal((B, S, 3 * H * D)).astype(np.float32)
    qs, ks = ((1 + 0.2 * rng.standard_normal(D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    masks = [_mask(S, rng, empty) if masked else None for empty in (True, False)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(qkv, jdt), jnp.asarray(qs), jnp.asarray(ks))

    def run(mask):
        jmask = None if mask is None else jnp.asarray(mask).reshape(B, 1, 1, S)

        def jax_fwd(x, q_scale, k_scale):
            return jfa.fused_qkv_attention(x, q_scale, k_scale, jmask, H)

        leaves = [torch.from_numpy(qkv).to(tdt).requires_grad_(), torch.from_numpy(qs).requires_grad_(),
                  torch.from_numpy(ks).requires_grad_()]
        out = fused_qkv_attention(*leaves, None if mask is None else torch.from_numpy(mask), H)
        return jax_fwd, leaves, out

    jax_fwd, _, out = run(masks[0])
    assert out.dtype == tdt and out.shape == (B, S, H * D) and torch.isfinite(out.float()).all()
    assert _rel_err(out, jax.jit(jax_fwd)(*jargs)) <= TOL[dtype]
    if dtype == "float32":
        jax_fwd, leaves, out = run(masks[1])

        def jax_loss(*args):
            return jnp.sum(jax_fwd(*args).astype(jnp.float32) * jnp.asarray(g))

        refs = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*jargs)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        for name, ours, theirs in zip(("dqkv", "dq_scale", "dk_scale"), grads, refs):
            assert _rel_err(ours, theirs) <= TOL[dtype], name


@pytest.mark.parametrize("S,dtype,masked", CASES, ids=IDS)
def test_flash_attention_matches_jax(S, dtype, masked):
    """Forward and the three gradients against the Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(S + 1)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    mask = _mask(S, rng) if masked else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jmask = None if mask is None else jnp.asarray(mask).reshape(B, 1, 1, S)
    tol = FLASH_F32_TOL if dtype == "float32" else TOL[dtype]

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, jmask, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    ref = jax.jit(lambda q, k, v: jfa.flash_attention(q, k, v, jmask, True))(*jargs)
    refs = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(*jargs)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, None if mask is None else torch.from_numpy(mask))
    assert out.dtype == tdt and torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= tol
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    for name, ours, theirs in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel_err(ours, theirs) <= tol, name


@pytest.mark.parametrize("S,masked", [(S, masked) for S in SEQS for masked in (False, True)])
def test_sublayer_matches_jax(S, masked):
    """bf16 x: y against the JAX sublayer's plain chain, and every gradient."""
    rng = np.random.default_rng(S + 2)
    arrays = [
        rng.standard_normal((B, S, C)), 1 + 0.2 * rng.standard_normal(C), 0.2 * rng.standard_normal(C),
        rng.standard_normal((C, 3 * H * D)) / np.sqrt(C), 0.2 * rng.standard_normal(3 * H * D),
        1 + 0.2 * rng.standard_normal(D), 1 + 0.2 * rng.standard_normal(D),
        rng.standard_normal((H * D, C)) / np.sqrt(H * D), 0.2 * rng.standard_normal(C),
    ]
    arrays = [a.astype(np.float32) for a in arrays]
    g = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = _mask(S, rng, empty=False) if masked else None
    jmask = None if mask is None else jnp.asarray(mask).reshape(B, 1, 1, S)
    jargs = [jnp.asarray(a) for a in arrays]
    jargs[0] = jargs[0].astype(jnp.bfloat16)

    def jax_fwd(*args):
        return jfa.fused_attention_sublayer(*args, jmask, H)

    def jax_loss(*args):
        return jnp.sum(jax_fwd(*args).astype(jnp.float32) * jnp.asarray(g))

    ref = jax.jit(jax_fwd)(*jargs)
    refs = jax.jit(jax.grad(jax_loss, argnums=tuple(range(len(arrays)))))(*jargs)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    leaves[0] = torch.from_numpy(arrays[0]).to(torch.bfloat16).requires_grad_()
    y = fused_attention_sublayer(*leaves, None if mask is None else torch.from_numpy(mask), H)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    assert _rel_err(y, ref) <= SUBLAYER_FWD_TOL
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(y.dtype))
    for i, (ours, theirs) in enumerate(zip(grads, refs)):
        assert _rel_err(ours, theirs) <= SUBLAYER_GRAD_TOL, i


# ---- a tiny_config model at 144² (spatial S = 324) ----------------------------


def _jax_model(dtype):
    return nnx.jit(lambda: JaxVideoVAE(jax_tiny_config(dtype=dtype, height=SIDE, width=SIDE).model,
                                       nnx.Rngs(0, sampling=1)))()


@pytest.fixture(scope="module")
def params():
    return random_params(_jax_model("float32"), SEED)


def _models(dtype, params):
    jax_model = _jax_model(dtype)
    set_jax_params(jax_model, params)
    port = VideoVAE(tiny_config(dtype=dtype, height=SIDE, width=SIDE).model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    return jax_model, port


def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, SIDE, SIDE, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


@pytest.mark.parametrize("dtype,tol", [("float32", MODEL_F32_TOL), ("bfloat16", MODEL_BF16_TOL)])
def test_reconstruct_at_144_matches_jax(dtype, tol, params):
    video, mask = _inputs()
    jax_model, port = _models(dtype, params)
    assert port.cfg.num_patches == 324
    ref = make_reconstruct_fn(jnp.dtype(dtype))(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, SIDE, SIDE, 3)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def test_train_step_at_144_matches_jax_f32(params):
    """One f32 step's loss, metrics and every gradient, the JAX draws injected
    (perceptual off: its VGG does not see the attention)."""
    jax_model, port = _models("float32", params)
    video, mask = _inputs()
    noise, uniforms = _draws(DRAW_SEED, jax_model, video, mask, "float32")
    jloss_cfg = JaxLossConfig(use_perceptual=False)

    @nnx.jit
    def jax_grads(model, video, mask, rngs, hp):
        def f(model, rngs):
            return _loss_fn(model, video, mask, rngs, hp, jloss_cfg, None)

        (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
        return metrics, grads

    metrics, grads = jax_grads(jax_model, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=DRAW_SEED),
                               JaxDynamicHParams.default())
    ref = {k: float(v) for k, v in metrics.items()}
    ref_grads = _flat_grads(grads)
    _, ours, our_grads = loss_and_grads(
        port, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=False), None,
        noise=noise, uniforms=uniforms,
    )
    assert set(ours) == set(ref)
    for key, value in ours.items():
        value = float(value.detach())
        assert _close(value, ref[key], key, MODEL_F32_TOL), (key, value, ref[key])
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
        assert err <= MODEL_F32_TOL * max(np.abs(theirs).max(), CANCEL_FLOOR * scale), (name, err, np.abs(theirs).max())
