"""Every attention path of the port's model against the JAX package's, on the CPU:
the ``Attention`` module alone and the serving pass.

``ModelConfig(attention_impl=...)`` picks ``"fused"``, ``"xla"`` or ``"pallas"``
in both packages, and ``VVT_ATTN_SUBLAYER=1`` (with ``"fused"``) routes each
block's attention sublayer through the one-kernel sublayer. The same
numpy-drawn weights and inputs go through both, at ``tiny_config``. Off the
TPU the JAX ``"pallas"`` path takes its XLA chain, so ``"xla"`` and
``"pallas"`` share one JAX reference; the JAX sublayer kernel runs in
interpret mode (``VVT_PALLAS_INTERPRET=1``). One train step's loss, metrics
and gradients on each path, the ``"ste"`` selection mode,
``scan_rollout_decode`` and the eval step are in
``test_torch_attention_steps.py``, which shares this file's helpers.

Bounds are those of ``test_torch_model.py`` and ``test_torch_train_step.py``:
f32 1e-4 of the reference's max (gradients 1e-3 of their leaf's max), bf16
3e-2. The sublayer rounds its GEMM operands to bf16 inside an f32 model, so
its f32 runs are held to the bf16 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.layers import Attention as JaxAttention
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import make_reconstruct_fn
from video_vae_tpu_torch import VideoVAE, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.layers import Attention

SEED = 10
F32_TOL, GRAD_F32_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2
MIN_MARGIN = 0.02  # decisions are compared only where no probability is a near-tie
# (name, attention_impl, sublayer): the paths of the port
PATHS = [("xla", "xla", False), ("pallas", "pallas", False), ("sublayer", "fused", True)]


def _set_path(monkeypatch, sublayer):
    if sublayer:
        monkeypatch.setenv("VVT_ATTN_SUBLAYER", "1")
        monkeypatch.setenv("VVT_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("VVT_ATTN_SUBLAYER", raising=False)


def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


def _models(dtype, **overrides):
    """(JAX model, port) with the same numpy-drawn parameters."""
    jcfg = jax_tiny_config(dtype=dtype, **overrides).model
    jax_model = nnx.jit(lambda: JaxVideoVAE(jcfg, nnx.Rngs(0, sampling=1)))()
    params = random_params(jax_model, SEED)
    set_jax_params(jax_model, params)
    port = VideoVAE(tiny_config(dtype=dtype, **overrides).model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    return jax_model, port


def _rel_err(ours, theirs):
    theirs = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()



# ---- the Attention module alone --------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("impl", ["fused", "xla", "pallas"])
def test_attention_module_matches_jax(impl, dtype, tol):
    C, H, QKV, B, S = 48, 2, 32, 3, 8
    jattn = JaxAttention(C, H, QKV, nnx.Rngs(0), attention_impl=impl, dtype=jnp.dtype(dtype))
    params = random_params(jattn, SEED)
    set_jax_params(jattn, params)
    attn = Attention(C, H, QKV, torch.Generator().manual_seed(0), attention_impl=impl,
                     dtype=getattr(torch, dtype))
    assert load_jax_params(attn, params) == len(params)
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 5:] = False
    ref = nnx.jit(lambda m, x, k: m(x, k))(
        jattn, jnp.asarray(x).astype(dtype), jnp.asarray(mask).reshape(B, 1, 1, S)
    )
    with torch.no_grad():
        out = attn(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask))
    assert out.shape == (B, S, C)
    assert _rel_err(out, ref) <= tol


def test_rope_tables_first_made_in_inference_mode_serve_autograd():
    """The serving pass runs under inference_mode and caches the tables; a
    train step on the unfused chain then multiplies them into its graph."""
    from video_vae_tpu_torch.ops.rope import apply_rope, rope_tables

    seq = 11  # a length no other test caches first
    with torch.inference_mode():
        cos, _ = rope_tables(seq, 16)
    assert not cos.is_inference()
    q = torch.randn(2, seq, 2, 16, requires_grad=True)
    qr, kr = apply_rope(q, q)
    (g,) = torch.autograd.grad((qr * kr).sum(), q)
    assert torch.isfinite(g).all()


# ---- the serving pass -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reconstructions():
    """The JAX serving pass per (dtype, sublayer), computed once."""
    cache = {}

    def get(dtype, sublayer):
        if (dtype, sublayer) not in cache:
            video, mask = _inputs()
            jax_model, _ = _models(dtype, attention_impl="fused" if sublayer else "xla")
            jdt = jnp.dtype(dtype)
            ref = make_reconstruct_fn(jdt)(jax_model, jnp.asarray(video), jnp.asarray(mask))
            prob = nnx.jit(lambda m, v, f: m.encode(v.astype(jdt), f)[2])(
                jax_model, jnp.asarray(video), jnp.asarray(mask)
            )
            cache[dtype, sublayer] = (
                np.asarray(ref.astype(jnp.float32)), np.asarray(prob.astype(jnp.float32))
            )
        return cache[dtype, sublayer]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,impl,sublayer", PATHS)
def test_reconstruct_matches_jax_on_each_path(name, impl, sublayer, dtype, monkeypatch,
                                              jax_reconstructions):
    _set_path(monkeypatch, sublayer)
    ref, j_prob = jax_reconstructions(dtype, sublayer)
    video, mask = _inputs()
    _, port = _models(dtype, attention_impl=impl)
    assert port.encoder.layers[0].TemporalAttention.attention_impl == impl
    out = reconstruct(port, video, mask, device="cpu")
    tol = F32_TOL if dtype == "float32" and not sublayer else BF16_TOL
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    assert np.abs(out.float().numpy() - ref).max() / np.abs(ref).max() <= tol
    with torch.inference_mode():
        prob = port.encode(
            torch.from_numpy(video).to(port.cfg.compute_dtype()), torch.from_numpy(mask)
        )[2].float().numpy()
    assert np.abs(j_prob - 0.5).min() > MIN_MARGIN  # no decision is a tie
    np.testing.assert_array_equal(prob >= 0.5, j_prob >= 0.5)
