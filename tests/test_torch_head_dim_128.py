"""The port at head_dim 128 against the JAX package, on the CPU.

``tiny_config(qkv_features=128, num_heads=1)`` gives one head of 128, the
head dim whose kernels (#1, #3, #5, #6, #7 at 128) run on the card; here the
wrappers take their plain versions, as every CPU tensor does. The same
numpy-drawn weights go into both packages through ``load_jax_params``; the
serving pass in f32 and bf16 and one f32 train step (loss, every metric and
every gradient, the JAX side's draws injected) are held to the JAX package's.
The perceptual loss is off in the step: its VGG is the same at every head dim
and ``tests/test_torch_train_step.py`` holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import BF16_TOL, F32_TOL, random_params, set_jax_params
from test_torch_train_step import _close, _draws, _flat_grads, _inputs

from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import _loss_fn, make_reconstruct_fn
from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS
from video_vae_tpu_torch.train.step import loss_and_grads

SEED = 12
DRAW_SEED = 25  # the sampling stream of the step: no decision within 0.02 of its uniform
OVERRIDES = dict(qkv_features=128, num_heads=1)  # one head of 128


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers (tests/test_torch_trainer.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_model(dtype):
    model = nnx.jit(lambda: JaxVideoVAE(jax_tiny_config(dtype=dtype, **OVERRIDES).model, nnx.Rngs(0, sampling=1)))()
    return model


@pytest.fixture(scope="module")
def params():
    return random_params(_jax_model("float32"), SEED)


def _models(dtype, params):
    jax_model = _jax_model(dtype)
    set_jax_params(jax_model, params)
    port = VideoVAE(tiny_config(dtype=dtype, **OVERRIDES).model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    return jax_model, port


def test_the_config_has_head_dim_128():
    cfg = tiny_config(**OVERRIDES).model
    assert cfg.head_dim == 128 and 128 in KERNEL_HEAD_DIMS


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_reconstruct_at_head_dim_128_matches_jax(dtype, tol, params):
    video, mask = _inputs()
    jax_model, port = _models(dtype, params)
    ref = make_reconstruct_fn(jnp.dtype(dtype))(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def test_train_step_at_head_dim_128_matches_jax_f32(params):
    """One f32 step's loss, metrics and every gradient, the JAX draws injected."""
    jax_model, port = _models("float32", params)
    video, mask = _inputs()
    noise, uniforms = _draws(DRAW_SEED, jax_model, video, mask, "float32")
    hp = JaxDynamicHParams.default()
    jloss_cfg = JaxLossConfig(use_perceptual=False)

    @nnx.jit
    def jax_grads(model, video, mask, rngs, hp):
        def f(model, rngs):
            return _loss_fn(model, video, mask, rngs, hp, jloss_cfg, None)

        (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
        return metrics, grads

    metrics, grads = jax_grads(jax_model, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=DRAW_SEED), hp)
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
