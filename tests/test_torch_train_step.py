"""The port's whole train step against the JAX package's, on the CPU.

``tiny_config`` in "rl" mode with the perceptual loss on (the VGG filters of
the JAX ``load_vgg(None)`` carried across), a batch of two clips of 8 frames
of which clip 1 ends in 3 padded frames, and every parameter redrawn with
numpy so that no branch hides behind a small or zero init. The random draws
are the JAX model's own: the test takes the two ``rngs.sampling()`` keys the
JAX forward will take (the latent noise, then the Bernoulli uniforms), draws
with them, and hands the values to the port.

JAX's metrics come from ``make_train_step`` (which also updates its
optimizer), its gradients from ``nnx.value_and_grad`` of the step's
``_loss_fn``. Each JAX reference is built once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.losses.perceptual import make_perceptual_loss_fn as jax_make_perceptual
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.models.vgg import load_vgg as jax_load_vgg
from video_vae_tpu.train.setup import create_optimizer as jax_create_optimizer
from video_vae_tpu.train.step import _loss_fn, make_train_step
from video_vae_tpu_torch import (
    DynamicHParams,
    LossConfig,
    VideoVAE,
    create_optimizer,
    load_jax_params,
    tiny_config,
    train_step,
)
from video_vae_tpu_torch.losses import make_perceptual_loss_fn
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.models.vgg import load_vgg
from video_vae_tpu_torch.train.step import loss_and_grads

SEED = 10
DRAW_SEEDS = (22, 34)  # the sampling streams of step 1 and step 2 (no near-ties)
# f32: the same arithmetic in another order through 2 blocks, the UNet,
# the VGG and the losses
F32_TOL = 1e-4
# the perceptual term rounds both videos to bf16 before the VGG (trap:
# a 1e-6 difference in the reconstruction can round to another bf16 value)
PERCEPTUAL_F32_TOL = 1e-3
# gradients, per leaf against the largest JAX gradient of that leaf: the
# VGG's bf16 backward feeds every parameter's gradient
GRAD_F32_TOL = 1e-3
# bf16: rounding at other places in the two frameworks (the serving test's bound)
BF16_TOL = 3e-2
# keep decisions are compared only where no probability sits near its uniform
MIN_MARGIN = 0.02
METRICS = ("loss", "MSE", "per_sample_MAE", "perceptual_loss", "selection_loss", "kl_loss",
           "kept_frame_density", "rl_loss", "mean_trajectory_prob", "grad_norm", "max_grad")


def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


def _draws(seed, jax_model, video, mask, dtype):
    """The JAX forward's two draws for ``nnx.Rngs(sampling=seed)``, as numpy."""
    rngs = nnx.Rngs(sampling=seed)
    k_noise, k_uniform = rngs.sampling(), rngs.sampling()
    mean, logvar, prob = nnx.jit(lambda m, v, f: m.encode(v, f))(
        jax_model, jnp.asarray(video, dtype), jnp.asarray(mask)
    )
    noise = jax.random.normal(k_noise, logvar.shape, dtype)
    uniforms = jax.random.uniform(k_uniform, (2 * video.shape[0], video.shape[1], 1, 1), jnp.float32)
    p = np.repeat(np.asarray(prob.astype(jnp.float32)), 2, axis=0)[..., None]
    assert np.abs(np.asarray(uniforms) - p).min() > MIN_MARGIN  # no decision is a tie
    noise = torch.from_numpy(np.array(noise.astype(jnp.float32))).to(getattr(torch, dtype))
    return noise, torch.from_numpy(np.array(uniforms))


def _flat_grads(grads):
    return {"/".join(map(str, p)): np.asarray(v.get_value()) for p, v in grads.flat_state()}


def _run(dtype):
    """Both sides, two steps each; returns a dict of numpy results."""
    jcfg = jax_tiny_config(dtype=dtype)
    jdt = jnp.dtype(dtype)
    loss_kw = dict(use_perceptual=True)
    jax_model = nnx.jit(lambda: JaxVideoVAE(jcfg.model, nnx.Rngs(0, sampling=1)))()
    params = random_params(jax_model, SEED)
    set_jax_params(jax_model, params)
    jax_vgg = jax_load_vgg(None)
    jax_pf = jax_make_perceptual(jax_vgg)
    hp = JaxDynamicHParams.default()
    jloss_cfg = JaxLossConfig(**loss_kw)
    video, mask = _inputs()
    draws = [_draws(s, jax_model, video, mask, dtype) for s in DRAW_SEEDS]
    res = {"draws": draws, "params": params}

    jv, jm = jnp.asarray(video), jnp.asarray(mask)
    if dtype == "float32":
        @nnx.jit
        def jax_grads(model, video, mask, rngs, hp):
            def f(model, rngs):
                return _loss_fn(model, video.astype(jdt), mask, rngs, hp, jloss_cfg, jax_pf)

            (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
            return metrics, grads

        metrics, grads = jax_grads(jax_model, jv, jm, nnx.Rngs(sampling=DRAW_SEEDS[0]), hp)
        res["loss_metrics"] = {k: float(v) for k, v in metrics.items()}
        res["grads"] = _flat_grads(grads)

    step = make_train_step(jloss_cfg, jax_pf, compute_dtype=jdt)
    opt = jax_create_optimizer(jax_model, jcfg.optim)
    res["step_metrics"] = []
    for s in DRAW_SEEDS:
        m = step(jax_model, opt, jv, jm, nnx.Rngs(sampling=s), hp)
        res["step_metrics"].append({k: float(v) for k, v in m.items()})
    res["vgg"] = {
        "/".join(map(str, p)): np.asarray(v.get_value())
        for p, v in nnx.state(jax_vgg, nnx.Param).flat_state()
    }
    return res


@pytest.fixture(scope="module")
def jax_f32():
    return _run("float32")


@pytest.fixture(scope="module")
def jax_bf16():
    return _run("bfloat16")


def _port(dtype, ref, **model_overrides):
    cfg = tiny_config(dtype=dtype, **model_overrides)
    model = VideoVAE(cfg.model, device="cpu")
    assert load_jax_params(model, ref["params"]) == len(ref["params"])
    vgg = load_vgg(None, device="cpu")
    load_jax_params(vgg, ref["vgg"])
    return cfg, model, make_perceptual_loss_fn(vgg)


def _close(ours, theirs, key, tol):
    # rl_loss is 0 up to rounding: its scale is the standardised disadvantage, 1
    scale = 1.0 if key == "rl_loss" else abs(theirs)
    return abs(ours - theirs) <= tol * scale


@pytest.mark.filterwarnings("ignore:Perceptual loss is using RANDOM")
def test_train_step_loss_and_grads_match_jax_f32(jax_f32):
    cfg, model, pf = _port("float32", jax_f32)
    video, mask = _inputs()
    noise, uniforms = jax_f32["draws"][0]
    loss, metrics, grads = loss_and_grads(
        model, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=True), pf,
        noise=noise, uniforms=uniforms,
    )
    ref = jax_f32["loss_metrics"]
    assert set(metrics) == set(ref)
    for key, value in metrics.items():
        tol = PERCEPTUAL_F32_TOL if key == "perceptual_loss" else F32_TOL
        value = float(value.detach())
        assert _close(value, ref[key], key, tol), (key, value, ref[key])
    # the objective really has every term
    assert ref["perceptual_loss"] > 0 and 0 < ref["kept_frame_density"] < 1

    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    assert set(names) == set(jax_f32["grads"])
    scale = max(np.abs(g).max() for g in jax_f32["grads"].values())
    # A conv bias whose GroupNorm has one channel per group shifts that group
    # by a constant, which the norm removes: its gradient is 0 on both sides
    # up to rounding, and is held to that instead.
    vanishing = {
        f"{n}/conv/bias".replace(".", "/")
        for n, m in model.named_modules()
        if isinstance(m, ConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()
    }
    assert len(vanishing) == 6
    for name, g in zip(names, grads):
        theirs = jax_f32["grads"][name]
        assert g.shape == theirs.shape
        if name in vanishing:
            assert max(np.abs(g.numpy()).max(), np.abs(theirs).max()) <= 1e-6 * scale, name
            continue
        err = np.abs(g.numpy() - theirs).max()
        assert err <= GRAD_F32_TOL * np.abs(theirs).max(), (name, err, np.abs(theirs).max())


@pytest.mark.filterwarnings("ignore:Perceptual loss is using RANDOM")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_metrics_and_update_match_jax(dtype, request):
    ref = request.getfixturevalue("jax_f32" if dtype == "float32" else "jax_bf16")
    cfg, model, pf = _port(dtype, ref)
    video, mask = _inputs()
    opt = create_optimizer(model, cfg.optim)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (noise, uniforms) in enumerate(ref["draws"]):
        metrics = train_step(
            model, opt, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=True), pf,
            noise=noise, uniforms=uniforms,
        )
        assert set(metrics) == set(METRICS)
        for key in METRICS:
            theirs = ref["step_metrics"][i][key]
            if dtype == "bfloat16":
                tol = BF16_TOL
            else:
                tol = PERCEPTUAL_F32_TOL if key == "perceptual_loss" else F32_TOL
            assert _close(float(metrics[key]), theirs, key, tol), (i, key, float(metrics[key]), theirs)
        assert float(metrics["grad_norm"]) > cfg.optim.clip_global_norm  # the clip acts
        changed = [not torch.equal(p, before[n]) for n, p in model.named_parameters()]
        if i == 0:  # the schedule starts at lr 0: the first step moves nothing
            assert not any(changed)
        else:
            assert all(changed)



@pytest.mark.filterwarnings("ignore:Perceptual loss is using RANDOM")
def test_remat_matches_no_remat(jax_f32):
    video, mask = _inputs()
    noise, uniforms = jax_f32["draws"][0]
    results = []
    for remat in (False, True):
        cfg, model, pf = _port("float32", jax_f32, remat=remat)
        assert model.decoder.layers[0].remat == remat
        loss, _, grads = loss_and_grads(
            model, video, mask, DynamicHParams.default(), LossConfig(use_perceptual=True), pf,
            noise=noise, uniforms=uniforms,
        )
        results.append((float(loss), grads))
    (loss0, grads0), (loss1, grads1) = results
    assert abs(loss0 - loss1) <= 1e-6 * abs(loss0)
    for a, b in zip(grads0, grads1):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_ste_mode_is_not_ported_yet():
    """The name dates from when "ste" raised; the mode now runs (its values are
    held to the JAX package in test_torch_attention_paths.py)."""
    model = VideoVAE(tiny_config(selection_mode="ste").model, device="cpu")
    with torch.no_grad():
        out = model(torch.rand(1, 8, 32, 32, 3), torch.ones(1, 8),
                    generator=torch.Generator().manual_seed(0))
    assert out.rollouts == 1 and out.reconstruction.shape == (1, 8, 32, 32, 3)
    assert out.selection_mask.shape == (1, 8, 1, 1)
    assert set(out.selection_mask.unique().tolist()) <= {0.0, 1.0}
