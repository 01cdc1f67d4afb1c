"""The port's serving pass against the JAX package's, end to end, on the CPU.

The same numpy-drawn weights (every parameter at unit-ish scale, so neither
the 1e-2 out-projection init nor the zero final conv hides a branch) go into
the JAX VideoVAE and, through ``load_jax_params``, into the port. The JAX side
keeps its defaults (space-to-depth-packed UNet, fused attention through its
reference chain), so agreement also shows that the port's unpacked UNet is
the same function.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import make_reconstruct_fn
from video_vae_tpu_torch import VideoVAE, load_jax_params, reconstruct, tiny_config

SEED = 10
# f32: the same arithmetic in another summation order
F32_TOL = 1e-4
# bf16: rounding happens at other places in the two frameworks; the bound the
# JAX package's own packed-attention test uses (tests/test_flash_attention.py)
BF16_TOL = 3e-2
# keep decisions are compared only where no probability sits at the threshold
MIN_MARGIN = 0.02


def random_params(model, seed):
    """Every nnx.Param of ``model`` redrawn with numpy, keyed by its '/' path."""
    rng = np.random.default_rng(seed)
    params = {}
    for path, var in nnx.state(model, nnx.Param).flat_state():
        shape = var.get_value().shape
        if path[-1] == "kernel":
            arr = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif path[-1] == "scale":
            arr = 1.0 + 0.2 * rng.standard_normal(shape)
        else:  # biases and the fill token
            arr = 0.2 * rng.standard_normal(shape)
        params["/".join(map(str, path))] = arr.astype(np.float32)
    return params


def set_jax_params(model, params):
    for key, arr in params.items():
        obj = model
        *parents, leaf = key.split("/")
        for p in parents:
            obj = obj[int(p)] if p.isdigit() else getattr(obj, p)
        getattr(obj, leaf).set_value(jnp.asarray(arr))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


@pytest.fixture(scope="module")
def params():
    model = nnx.jit(lambda: JaxVideoVAE(jax_tiny_config().model, nnx.Rngs(0, sampling=1)))()
    return random_params(model, SEED)


def _models(dtype, params):
    jax_model = nnx.jit(
        lambda: JaxVideoVAE(jax_tiny_config(dtype=dtype).model, nnx.Rngs(0, sampling=1))
    )()
    set_jax_params(jax_model, params)
    port = VideoVAE(tiny_config(dtype=dtype).model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    return jax_model, port


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_reconstruct_matches_jax(dtype, tol, params, inputs):
    video, mask = inputs
    jax_model, port = _models(dtype, params)
    jdt = jnp.dtype(dtype)

    ref = make_reconstruct_fn(jdt)(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, err

    j_mean, j_logvar, j_prob = nnx.jit(lambda m, v, f: m.encode(v.astype(jdt), f))(
        jax_model, jnp.asarray(video), jnp.asarray(mask)
    )
    with torch.inference_mode():
        mean, logvar, prob = port.encode(
            torch.from_numpy(video).to(port.cfg.compute_dtype()), torch.from_numpy(mask)
        )
    for name, ours, theirs in (
        ("mean", mean, j_mean), ("log_variance", logvar, j_logvar), ("prob", prob, j_prob)
    ):
        theirs = np.asarray(theirs.astype(jnp.float32))
        e = np.abs(ours.float().numpy() - theirs).max() / np.abs(theirs).max()
        assert e <= tol, (name, e)

    j_prob = np.asarray(j_prob.astype(jnp.float32))
    assert np.abs(j_prob - 0.5).min() > MIN_MARGIN  # the decisions below are not ties
    j_keep = j_prob >= 0.5
    assert j_keep.any() and not j_keep.all()  # the fill-token blend is exercised
    np.testing.assert_array_equal(prob.float().numpy() >= 0.5, j_keep)
