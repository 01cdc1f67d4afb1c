"""The port's weight bridge, configs and norms against the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from video_vae_tpu.core import config as jax_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.ops.norm import group_norm_cf as jax_group_norm_cf
from video_vae_tpu.ops.norm import layer_norm as jax_layer_norm
from video_vae_tpu.ops.norm import max_pool_2x_cf as jax_max_pool_2x_cf
from video_vae_tpu_torch import VideoVAE, load_jax_params
from video_vae_tpu_torch.core import config
from video_vae_tpu_torch.ops.norm import group_norm_cf, layer_norm, max_pool_2x_cf


def _flat(state):
    return {"/".join(map(str, path)): var.get_value() for path, var in state.flat_state()}


def test_load_jax_params_copies_every_param_once():
    jax_model = nnx.jit(
        lambda: JaxVideoVAE(jax_config.tiny_config().model, nnx.Rngs(0, sampling=1))
    )()
    params = {k: np.asarray(v) for k, v in _flat(nnx.state(jax_model, nnx.Param)).items()}
    port = VideoVAE(config.tiny_config().model, device="cpu", seed=1)
    assert load_jax_params(port, params) == len(params) == len(list(port.parameters()))
    ours = {name.replace(".", "/"): p for name, p in port.named_parameters()}
    for key, value in params.items():
        np.testing.assert_array_equal(ours[key].detach().numpy(), value)


def test_param_tree_matches_jax_at_flagship_widths():
    """Names and shapes at the flagship widths, 3 UNet levels (depth cut)."""
    jcfg = jax_config.ModelConfig(encoder_depth=1, decoder_depth=2)
    abstract = nnx.eval_shape(lambda: JaxVideoVAE(jcfg, nnx.Rngs(0, sampling=1)))
    theirs = {k: tuple(v.shape) for k, v in _flat(nnx.state(abstract, nnx.Param)).items()}
    port = VideoVAE(config.ModelConfig(encoder_depth=1, decoder_depth=2), device="cpu")
    ours = {name.replace(".", "/"): tuple(p.shape) for name, p in port.named_parameters()}
    assert ours == theirs


def test_load_jax_params_rejects_mismatch():
    port = VideoVAE(config.tiny_config().model, device="cpu")
    params = {name.replace(".", "/"): p.detach().numpy() for name, p in port.named_parameters()}
    missing = dict(params)
    missing.pop("fill_token")
    with pytest.raises(KeyError, match="fill_token"):
        load_jax_params(port, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(port, {**params, "extra": np.zeros(1)})
    key = "decoder/unet/patch_mixer/kernel"
    with pytest.raises(ValueError, match="patch_mixer"):
        load_jax_params(port, {**params, key: params[key][..., :1]})


@pytest.mark.parametrize(
    "name", ["ModelConfig", "LossConfig", "OptimConfig", "MeshConfig", "DataConfig", "TrainConfig"]
)
def test_config_fields_match_jax(name):
    theirs = [(f.name, f.default) for f in dataclasses.fields(getattr(jax_config, name))]
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(config, name))]
    assert ours == theirs


def test_tiny_config_matches_jax():
    theirs = jax_config.tiny_config()
    ours = config.tiny_config()
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(theirs.model)
    assert dataclasses.asdict(ours.loss) == dataclasses.asdict(theirs.loss)
    assert dataclasses.asdict(ours.optim) == dataclasses.asdict(theirs.optim)
    assert dataclasses.asdict(ours.data) == dataclasses.asdict(theirs.data)
    assert dataclasses.asdict(ours.train) == dataclasses.asdict(theirs.train)
    assert [f.name for f in dataclasses.fields(config.VAEConfig)] == [
        f.name for f in dataclasses.fields(jax_config.VAEConfig)
    ]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_matches_jax(dtype, with_bias):
    rng = np.random.default_rng(0)
    # a common offset: the E[x²]−mean² form cancels partly, as on real tokens
    x = (rng.standard_normal((4, 7, 64)) + 3.0).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(64)).astype(np.float32) if with_bias else None
    ref = jax_layer_norm(
        jnp.asarray(x, dtype), jnp.asarray(scale), None if bias is None else jnp.asarray(bias), 1e-6
    )
    out = layer_norm(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias),
    )
    tol = 1e-5 if dtype == "float32" else 1e-2  # bf16: one output rounding
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_matches_jax_across_frames(dtype, silu):
    """Statistics span every frame: frames with different offsets share them."""
    rng = np.random.default_rng(1)
    b, t, c, h, w, groups = 2, 5, 8, 6, 10, 4
    x = rng.standard_normal((b, t, c, h, w)) + 2.0 * np.arange(t)[None, :, None, None, None]
    x = x.astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    ref = jax_group_norm_cf(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias), groups, silu=silu
    )
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(scale), torch.from_numpy(bias), groups)
    out = group_norm_cf(torch.from_numpy(x).to(tdt), *args, silu=silu).float().numpy()
    tol = 1e-5 if dtype == "float32" else 3e-2  # bf16: subtract and affine in bf16
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    per_frame = torch.cat(
        [group_norm_cf(torch.from_numpy(x[:, i : i + 1]).to(tdt), *args, silu=silu)
         for i in range(t)], dim=1,
    ).float().numpy()
    assert np.abs(per_frame - ref).max() > 0.5  # the test can tell the two apart


def test_max_pool_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        max_pool_2x_cf(torch.from_numpy(x)).numpy(), np.asarray(jax_max_pool_2x_cf(jnp.asarray(x)))
    )
