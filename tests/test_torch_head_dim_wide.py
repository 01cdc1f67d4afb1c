"""Head dims past 128, which the attention kernels run on their wide variant, on the CPU.

A call at an even head dim D > 128 pads each head by halves to Dp = 128·⌈D/128⌉
(``padded_head_dim``, ``pad_heads``) and runs the wide variant
(``csrc/attention_wide.cuh``), which walks the head dim in 128-column chunks,
with the true D's 1/D in its LN statistics and 1/√D in its scores. Here:

* ``padded_head_dim`` and ``pad_heads`` / ``unpad_heads`` past 128, at D = 130,
  192, 258 and 384: the round trip, the place of every column and the zeros,
  RoPE's rotate-half partners kept;
* the wide plans' geometry (``tests/helpers/wide_geometry.py``): grids, shared
  memory up to Dp = 1024, stages and per-warp state;
* the padded contract in plain form (the ``*_plain`` functions at Dp with
  ``head_dim=D``) against the plain versions at D, for #1 forward and backward
  (the scale gradients too), #5, #6 and #7's forward, at D = 130, 192, 256, 384
  and 512 and S = 16, 65 and 257, f32 with a ragged key mask and one sequence
  that keeps no key: ``tests/test_torch_head_dim_padded.py``'s checks and
  bounds (``CONTRACT_TOL``, #7's y ``SUBLAYER_Y_TOL``);
* ``tiny_config(qkv_features=512, num_heads=2)`` (D = 256, run as it is) and
  ``qkv_features=384`` (D = 192, padded to 256) against the JAX package: the
  serving pass in f32 and bf16 and one f32 train step's metrics and every
  gradient, the JAX draws injected (the CPU runs the plain versions at the true D).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_head_dim_padded as padded
from flax import nnx
from test_torch_model import BF16_TOL, F32_TOL, random_params, set_jax_params
from test_torch_train_step import _close, _draws, _flat_grads, _inputs

from helpers.threads import one_thread  # noqa: F401
from helpers.wide_geometry import MAX_SMEM, WideGeometry, check_wide
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import _loss_fn, make_reconstruct_fn
from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops import flash_attention as fa
from video_vae_tpu_torch.train.step import loss_and_grads

HEAD_DIMS = (130, 192, 256, 384, 512)
SEQS = (16, 65, 257)
CASES = [(d, s) for d in HEAD_DIMS for s in SEQS]


# ---------------------------------------------------------------------------
# padded_head_dim, pad_heads / unpad_heads past 128
# ---------------------------------------------------------------------------


def test_padded_head_dim_past_128_is_the_next_chunk():
    want = {130: 256, 192: 256, 254: 256, 256: 256, 258: 384, 384: 384, 386: 512, 512: 512, 1024: 1024}
    assert {d: fa.padded_head_dim(d) for d in want} == want
    assert all(fa.is_wide(dp) for dp in want.values()) and not any(fa.is_wide(d) for d in fa.KERNEL_HEAD_DIMS)
    for bad in (0, 129, 131, 257):
        with pytest.raises(ValueError, match="even head_dim of at least 2"):
            fa.padded_head_dim(bad)


@pytest.mark.parametrize("d", [130, 192, 258, 384])
def test_pad_heads_places_each_half_past_128(d):
    padded.test_pad_heads_places_each_half(d)


@pytest.mark.parametrize("d", [130, 192, 258, 384])
def test_pad_heads_keeps_the_rope_partners_past_128(d):
    """rotate_half and the RoPE tables of D, both padded, rotate the real
    columns as at D: every chunk boundary of Dp leaves the partners Dp/2 apart."""
    padded.test_pad_heads_keeps_the_rope_partners(d)


# ---------------------------------------------------------------------------
# The wide plans' geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [256, 384, 512, 640, 1024])
@pytest.mark.parametrize("b,s,h", [(512, 16, 2), (16, 256, 2), (4, 1024, 8), (3, 65, 3), (1, 1, 1), (2, 257, 2)])
def test_wide_geometry(b, s, h, dp):
    geo = check_wide(b, s, h, dp)
    assert geo.smem == 69632 <= MAX_SMEM and geo.f32_smem == 17088
    assert geo.stats_grid * geo.chunks == geo.grid


def test_wide_geometry_of_the_d256_model():
    """ModelConfig(num_heads=2)'s calls: b1 x 16 frames, 16 x 16 patches (a train
    step's encoder; its decoder doubles the batch)."""
    temporal, spatial = WideGeometry(256, 16, 2, 256), WideGeometry(16, 256, 2, 256)
    assert (temporal.grid, spatial.grid) == (1024, 256)
    assert spatial.fwd_stages(False)[:3] == [(False, 0, 0), (False, 0, 1), (False, 0, "v")]
    assert len(spatial.query_stages()) == 4 * 5 and len(spatial.key_stages()) == 8 * 5
    assert spatial.ln_partials == 16 * 256 * 2 // 8
    assert spatial.fused_bwd_work(2) == (2 * 8192 * 256 * 4 + 2 * 8192 * 256 * 2 + 3 * 8192 * 4)


# ---------------------------------------------------------------------------
# The padded contract in plain form against the plain versions at D
# ---------------------------------------------------------------------------


# the padded file's contract checks, which take any even D, at the wide head dims


@pytest.mark.parametrize("d,s", CASES)
def test_fused_forward_wide_contract(d, s):
    padded.test_fused_forward_padded_contract(d, s)


@pytest.mark.parametrize("d,s", CASES)
def test_fused_backward_wide_contract(d, s):
    padded.test_fused_backward_padded_contract(d, s)


@pytest.mark.parametrize("d,s", CASES)
def test_flash_forward_wide_contract(d, s):
    padded.test_flash_forward_padded_contract(d, s)


@pytest.mark.parametrize("d,s", CASES)
def test_flash_backward_wide_contract(d, s):
    padded.test_flash_backward_padded_contract(d, s)


@pytest.mark.parametrize("d,s", CASES)
def test_sublayer_wide_contract(d, s):
    """#7's forward: Wqkv's and bqkv's columns and Wout's rows padded by heads."""
    padded.test_sublayer_padded_contract(d, s)


# ---------------------------------------------------------------------------
# Tiny models at D = 256 and D = 192 against the JAX package
# ---------------------------------------------------------------------------

SEED = 12
# (overrides, the sampling stream of the step: no decision within 0.02 of its uniform)
MODELS = {256: (dict(qkv_features=512, num_heads=2), 20), 192: (dict(qkv_features=384, num_heads=2), 24)}


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
def test_the_configs_run_wide(d):
    cfg = tiny_config(**MODELS[d][0]).model
    dp = fa.padded_head_dim(d)
    assert cfg.head_dim == d and dp == 256 and fa.fused_attention_plan(2, 8, cfg.num_heads, dp) == ("wide", 1)


@pytest.mark.parametrize("d", sorted(MODELS))
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_reconstruct_at_wide_head_dims_matches_jax(d, dtype, tol, params):
    video, mask = _inputs()
    jax_model, port = _models(dtype, d, params)
    ref = make_reconstruct_fn(jnp.dtype(dtype))(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("d", sorted(MODELS))
def test_train_step_at_wide_head_dims_matches_jax_f32(d, params):
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
