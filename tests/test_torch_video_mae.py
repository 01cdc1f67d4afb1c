"""The port's VideoMAE against the JAX package's, on the CPU.

``tiny_config`` with mask ratio 0.75 (the JAX file's fixture), every
parameter redrawn with numpy and carried across by ``load_jax_params``, a
batch of two clips of 8 frames whose clip 1 ends in 3 padded frames. The
training token mask is the JAX model's own Bernoulli draw, reproduced from
the same ``rngs.sampling()`` key and handed to the port as ``token_mask``.

Held: the JAX test file's three properties on the port; the train and eval
forward (prediction, target, token mask) and ``mae_loss`` with the frame
mask, f32 and bf16; every parameter's gradient of the loss against
``jax.grad`` with remat on and off; and the sharding rules' placement of
every MAE and discriminator parameter under a (2, 2, 2) mesh.

Bounds: f32 1e-4 of the reference's max (gradients 1e-3 of their leaf's
max), bf16 3e-2, as in ``test_torch_model.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import ModelConfig as JaxModelConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.classifier import Discriminator as JaxDiscriminator
from video_vae_tpu.models.video_mae import MAEOutput as JaxMAEOutput
from video_vae_tpu.models.video_mae import VideoMAE as JaxVideoMAE
from video_vae_tpu.models.video_mae import mae_loss as jax_mae_loss
from video_vae_tpu.parallel import mesh as jax_mesh
from video_vae_tpu.parallel import sharding as jax_sharding
from video_vae_tpu_torch import ModelConfig, load_jax_params, tiny_config
from video_vae_tpu_torch.models import Discriminator, MAEOutput, VideoMAE, mae_loss
from video_vae_tpu_torch.parallel import mesh as port_mesh
from video_vae_tpu_torch.parallel import sharding as port_sharding

SEED = 10
MASK_RATIO = 0.75
DRAW_SEED = 3
F32_TOL, GRAD_F32_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]



def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_err(ours, theirs):
    theirs = _np(theirs)
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


def _models(dtype, remat=False):
    """(JAX VideoMAE, port VideoMAE) with the same numpy-drawn parameters."""
    jcfg = jax_tiny_config(dtype=dtype, remat=remat).model
    jmae = nnx.jit(lambda: JaxVideoMAE(jcfg, nnx.Rngs(0, sampling=1), mask_ratio=MASK_RATIO))()
    params = random_params(jmae, SEED)
    set_jax_params(jmae, params)
    mae = VideoMAE(tiny_config(dtype=dtype, remat=remat).model, mask_ratio=MASK_RATIO, device="cpu")
    assert load_jax_params(mae, params) == len(params)
    return jmae, mae


def _jax_token_mask(seed, shape):
    """The JAX forward's Bernoulli draw for ``nnx.Rngs(sampling=seed)``."""
    return np.asarray(jax.random.bernoulli(nnx.Rngs(sampling=seed).sampling(), MASK_RATIO, shape))


# ---- the JAX test file's three properties, on the port ------------------------


def test_mae_shapes_and_loss():
    mae = VideoMAE(tiny_config().model, mask_ratio=MASK_RATIO, device="cpu")
    video, mask = (torch.from_numpy(a) for a in _inputs())
    out = mae(video, mask, generator=torch.Generator().manual_seed(0))
    loss, metrics = mae_loss(out, mask)
    assert out.prediction.shape == out.target.shape == (2, 8, 16, 192)
    assert out.token_mask.shape == (2, 8, 16)
    assert 0.5 < float(out.token_mask.float().mean()) < 0.95  # ≈ mask_ratio
    assert torch.isfinite(loss) and float(loss) > 0
    assert set(metrics) == {"loss", "masked_mse", "full_mse"}


def test_mae_eval_unmasked():
    mae = VideoMAE(tiny_config().model, mask_ratio=MASK_RATIO, device="cpu")
    video = torch.rand((1, 8, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = mae(video, torch.ones(1, 8), train=False)
    assert float(out.token_mask.sum()) == 0.0


def test_mae_loss_only_counts_masked():
    pred = torch.zeros((1, 2, 4, 8))
    target = torch.zeros((1, 2, 4, 8))
    target[0, 0] = 1.0  # error only in frame 0
    token_mask = torch.zeros((1, 2, 4))
    token_mask[0, 1] = 1.0  # but only frame 1 masked
    loss, _ = mae_loss(MAEOutput(prediction=pred, target=target, token_mask=token_mask))
    assert float(loss) == 0.0


# ---- against the JAX package ---------------------------------------------------


def test_mae_loss_matches_jax_with_a_frame_mask():
    rng = np.random.default_rng(SEED + 1)
    pred, target = (rng.standard_normal((2, 3, 4, 12)).astype(np.float32) for _ in range(2))
    token_mask = (rng.uniform(size=(2, 3, 4)) < 0.6).astype(np.float32)
    frame_mask = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    ours = mae_loss(MAEOutput(*(torch.from_numpy(a) for a in (pred, target, token_mask))),
                    torch.from_numpy(frame_mask))[1]
    theirs = jax_mae_loss(JaxMAEOutput(prediction=jnp.asarray(pred), target=jnp.asarray(target),
                                       token_mask=jnp.asarray(token_mask)), jnp.asarray(frame_mask))[1]
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert abs(float(ours[key]) - float(value)) <= 1e-6 * abs(float(value)), key
    # no masked token of a real frame: the denominator's floor of 1
    empty = np.zeros_like(token_mask)
    loss = mae_loss(MAEOutput(*(torch.from_numpy(a) for a in (pred, target, empty))), torch.from_numpy(frame_mask))[0]
    assert float(loss) == 0.0


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_forward_matches_jax(dtype, tol, train):
    jmae, mae = _models(dtype)
    video, mask = _inputs()

    @nnx.jit
    def jax_run(m, v, f, rngs):
        out = m(v, f, rngs, train=train)
        return out, jax_mae_loss(out, f)

    out_j, (loss_j, metrics_j) = jax_run(jmae, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=DRAW_SEED))
    token_mask = torch.from_numpy(_jax_token_mask(DRAW_SEED, (2, 8, 16))) if train else None
    with torch.no_grad():
        out = mae(torch.from_numpy(video), torch.from_numpy(mask), train=train, token_mask=token_mask)
        loss, metrics = mae_loss(out, torch.from_numpy(mask))
    np.testing.assert_array_equal(out.token_mask.float().numpy(), _np(out_j.token_mask))
    assert out.token_mask.dtype == getattr(torch, dtype)
    if train:
        assert 0 < float(out.token_mask.sum()) < out.token_mask.numel()
    assert out.prediction.dtype == out.target.dtype == torch.float32
    assert _rel_err(out.target, out_j.target) == 0.0
    assert out.prediction.shape == out_j.prediction.shape == (2, 8, 16, 192)
    assert _rel_err(out.prediction, out_j.prediction) <= tol
    for key, value in metrics_j.items():
        assert abs(float(metrics[key]) - float(value)) <= tol * abs(float(value)), key
    assert abs(float(loss) - float(loss_j)) <= tol * abs(float(loss_j))


@pytest.mark.parametrize("remat", [False, True])
def test_gradient_of_every_parameter_matches_jax(remat):
    jmae, mae = _models("float32", remat=remat)
    video, mask = _inputs()

    @nnx.jit
    def jax_grads(m, v, f, rngs):
        def loss_fn(m, rngs):
            return jax_mae_loss(m(v, f, rngs, train=True), f)[0]

        return nnx.value_and_grad(loss_fn)(m, rngs)

    loss_j, grads_j = jax_grads(jmae, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=DRAW_SEED))
    grads_j = {"/".join(map(str, p)): _np(v.get_value()) for p, v in grads_j.flat_state()}
    token_mask = torch.from_numpy(_jax_token_mask(DRAW_SEED, (2, 8, 16)))
    out = mae(torch.from_numpy(video), torch.from_numpy(mask), token_mask=token_mask)
    loss, _ = mae_loss(out, torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(mae.parameters()))
    assert abs(float(loss) - float(loss_j)) <= F32_TOL * abs(float(loss_j))
    names = [n.replace(".", "/") for n, _ in mae.named_parameters()]
    assert set(names) == set(grads_j)
    for name, g in zip(names, grads):
        theirs = grads_j[name]
        assert np.abs(theirs).max() > 0, name  # every parameter is reached
        assert np.abs(g.numpy() - theirs).max() <= GRAD_F32_TOL * np.abs(theirs).max(), name


def _port_shapes(build):
    """{path: shape} of a port module built on the meta device (no weights drawn)."""
    with torch.device("meta"), mock.patch.object(torch.nn.Module, "to", lambda self, *a, **k: self):
        model = build()
    return {n.replace(".", "/"): torch.empty(tuple(p.shape), device="meta") for n, p in model.named_parameters()}


@pytest.mark.parametrize("model", ["mae-tiny", "mae-flagship", "discriminator"])
def test_param_shardings_match_jax(model):
    """Every parameter of the MAE (tiny and flagship) and of the default
    discriminator placed by both packages' rules on a (2, 2, 2) mesh."""
    build_jax, build_port = {
        "mae-tiny": (lambda: JaxVideoMAE(jax_tiny_config().model, nnx.Rngs(0, sampling=1)),
                     lambda: VideoMAE(tiny_config().model, device="cpu")),
        "mae-flagship": (lambda: JaxVideoMAE(JaxModelConfig(height=224, width=224), nnx.Rngs(0, sampling=1)),
                         lambda: VideoMAE(ModelConfig(height=224, width=224), device="cpu")),
        "discriminator": (lambda: JaxDiscriminator(rngs=nnx.Rngs(0)), lambda: Discriminator(device="cpu")),
    }[model]
    abstract = nnx.eval_shape(build_jax)
    shapes = {"/".join(map(str, p)): v.get_value() for p, v in nnx.state(abstract, nnx.Param).flat_state()}
    jm = jax_mesh.build_mesh(2, 2, 2, devices=jax.devices()[:8])
    theirs = jax_sharding.param_shardings(shapes, jm)
    ours = port_sharding.param_shardings(_port_shapes(build_port), port_mesh.build_mesh(2, 2, 2, world_size=8))
    assert set(ours) == set(theirs)
    split = 0
    for path, sharding in theirs.items():
        spec = tuple(sharding.spec) + (None,) * (len(shapes[path].shape) - len(sharding.spec))
        assert ours[path] == spec, (path, ours[path], spec)
        split += any(a is not None for a in spec)
    assert split > 0
