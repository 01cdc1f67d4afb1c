"""The port's GAN train step against the JAX package's, on the CPU.

``tiny_config`` in f32 and "rl" mode, a batch of two clips of 8 frames (clip
1 ends in 3 padded frames), the VAE's and a ``Discriminator(base_features=4,
num_levels=1)``'s parameters redrawn with numpy, the discriminator's ``u``
and the VGG filters carried across, the VAE forward's draws the JAX step's
own (``test_torch_train_step.py``'s pattern). Two steps of JAX's
``make_adversarial_train_step`` and of the port's, remat on and off, and
with ``adversarial_start_step=1`` (step 0 updates the discriminator on zero
gradients). Held after each step: every metric; after the two: both models'
parameters, both optimizers' Adam moments and counts, and every ``u`` (three
power steps a step: trap 4). With b = 2 the discriminator's fake rows are
clip 0's two rollouts (trap 5): its loss, accuracy and moments show it.

Bounds: metrics f32 1e-4 (perceptual 1e-3); moments 1e-3 of their leaf's
largest JAX value (the gradients' bound of ``test_torch_train_step.py``),
the second moments twice that (they square the gradients), a leaf whose true
gradient is 0 under ``NOISE`` of the largest moment on both sides; parameters
after the update within 1e-4 of their leaf's largest value (such a leaf
within twice the learning rate: Adam moves noise by up to it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_discriminator import batch_stats, vanishing_biases
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.losses.perceptual import make_perceptual_loss_fn as jax_make_perceptual
from video_vae_tpu.models.classifier import Discriminator as JaxDiscriminator
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.models.vgg import load_vgg as jax_load_vgg
from video_vae_tpu.train.adversarial import make_adversarial_train_step as jax_make_adversarial_train_step
from video_vae_tpu.train.setup import create_optimizer as jax_create_optimizer
from video_vae_tpu_torch import DynamicHParams, LossConfig, VideoVAE, create_optimizer, load_jax_params, tiny_config
from video_vae_tpu_torch.losses import make_perceptual_loss_fn
from video_vae_tpu_torch.models import Discriminator
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.models.vgg import load_vgg
from video_vae_tpu_torch.parallel.sharding import model_sharding
from video_vae_tpu_torch.train import load_jax_batch_stats, load_jax_optimizer_state, make_adversarial_train_step
from video_vae_tpu_torch.train.adversarial import fake_rows

SEED = 10
DRAW_SEEDS = (22, 34)  # the sampling streams of steps 0 and 1 (no near-ties)
F32_TOL, PERCEPTUAL_F32_TOL, MOMENT_TOL = 1e-4, 1e-3, 1e-3
PARAM_TOL = 1e-4
# a leaf whose true gradient is 0 (a conv bias before a GroupNorm of one channel a
# group) holds rounding noise: the GN backward's sum over 1024-4096 values leaves
# up to ~1e-6 of the largest moment on the JAX side in the discriminator
NOISE = 1e-5
MIN_MARGIN = 0.02
ADAM = "opt_state/1/0/"
METRICS = ("loss", "MSE", "per_sample_MAE", "perceptual_loss", "selection_loss", "kl_loss", "kept_frame_density",
           "rl_loss", "mean_trajectory_prob", "generator_adv_loss", "discriminator_loss", "discriminator_accuracy")
# (remat of both models, adversarial_start_step)
CASES = [(False, 0), (True, 0), (False, 1)]



def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


def _flat(state):
    return {"/".join(map(str, p)): np.array(v.get_value()) for p, v in state.flat_state()}


def _draws(seed, jax_model, video, mask):
    """The JAX VAE forward's two draws for ``nnx.Rngs(sampling=seed)``, as torch tensors."""
    rngs = nnx.Rngs(sampling=seed)
    k_noise, k_uniform = rngs.sampling(), rngs.sampling()
    _, logvar, prob = nnx.jit(lambda m, v, f: m.encode(v, f))(jax_model, jnp.asarray(video), jnp.asarray(mask))
    noise = jax.random.normal(k_noise, logvar.shape, jnp.float32)
    uniforms = jax.random.uniform(k_uniform, (4, 8, 1, 1), jnp.float32)
    assert np.abs(np.asarray(uniforms) - np.repeat(np.asarray(prob), 2, axis=0)[..., None]).min() > MIN_MARGIN
    return torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(uniforms))


@pytest.fixture(scope="module")
def jax_runs():
    """Per case, the JAX GAN step's two steps from the same start: the inputs,
    draws and metrics, then both models' state and both optimizers'."""
    cache = {}

    def get(remat, start):
        if (remat, start) in cache:
            return cache[remat, start]
        jcfg = jax_tiny_config(dtype="float32", remat=remat)
        model = nnx.jit(lambda: JaxVideoVAE(jcfg.model, nnx.Rngs(0, sampling=1)))()
        params = random_params(model, SEED)
        set_jax_params(model, params)
        disc = nnx.jit(lambda: JaxDiscriminator(channels=3, base_features=4, num_levels=1, rngs=nnx.Rngs(5),
                                                remat=remat, dtype=jnp.float32))()
        d_params = random_params(disc, SEED + 1)
        set_jax_params(disc, d_params)
        vgg = jax_load_vgg(None)
        video, mask = _inputs()
        res = {"params": params, "d_params": d_params, "u": batch_stats(disc), "vgg": _flat(nnx.state(vgg, nnx.Param)),
               "draws": [_draws(s, model, video, mask) for s in DRAW_SEEDS]}
        opt, d_opt = jax_create_optimizer(model, jcfg.optim), jax_create_optimizer(disc, jcfg.optim)
        step = jax_make_adversarial_train_step(JaxLossConfig(use_perceptual=True), jax_make_perceptual(vgg),
                                               adversarial_start_step=start, compute_dtype=jnp.float32)
        hp = JaxDynamicHParams.default()
        res["metrics"] = [
            {k: float(v) for k, v in step(model, opt, disc, d_opt, jnp.asarray(video), jnp.asarray(mask),
                                          nnx.Rngs(sampling=s), hp, jnp.asarray(i)).items()}
            for i, s in enumerate(DRAW_SEEDS)
        ]
        res.update(params_after=_flat(nnx.state(model, nnx.Param)), d_params_after=_flat(nnx.state(disc, nnx.Param)),
                   u_after=batch_stats(disc), opt=_flat(nnx.state(opt)), d_opt=_flat(nnx.state(d_opt)))
        cache[remat, start] = res
        return res

    return get


def _port(ref, remat):
    cfg = tiny_config(dtype="float32", remat=remat)
    model = VideoVAE(cfg.model, device="cpu")
    load_jax_params(model, ref["params"])
    disc = Discriminator(3, 4, 1, remat=remat, dtype=torch.float32, device="cpu")
    load_jax_params(disc, ref["d_params"])
    assert load_jax_batch_stats(disc, ref["u"]) == 3
    vgg = load_vgg(None, device="cpu")
    load_jax_params(vgg, ref["vgg"])
    return cfg, model, disc, make_perceptual_loss_fn(vgg)


def _moments(flat):
    """(count, mu, nu) of a JAX optimizer's flat state, keyed by parameter path."""
    mu = {k[len(ADAM + "mu/"):]: v for k, v in flat.items() if k.startswith(ADAM + "mu/")}
    nu = {k[len(ADAM + "nu/"):]: v for k, v in flat.items() if k.startswith(ADAM + "nu/")}
    return int(flat[ADAM + "count"]), mu, nu


def _hold_optimizer(label, opt, flat, vanishing):
    count, mu, nu = _moments(flat)
    assert opt.count == count == 2, label
    scale = {key: max(np.abs(m).max() for m in moments.values()) for key, moments in (("mu", mu), ("nu", nu))}
    for name, m, n in zip(opt.names, opt.mu, opt.nu):
        for key, ours, theirs, tol in (("mu", m, mu[name], MOMENT_TOL), ("nu", n, nu[name], 2 * MOMENT_TOL)):
            ours = ours.numpy()
            if name in vanishing:  # rounding noise on both sides, under NOISE of the largest value
                bound = (NOISE if key == "mu" else NOISE**2) * scale[key]
                assert max(np.abs(ours).max(), np.abs(theirs).max()) <= bound, (label, key, name)
                continue
            assert np.abs(ours - theirs).max() <= tol * np.abs(theirs).max(), (label, key, name)


def _hold_params(label, module, theirs, vanishing, lr):
    for name, p in module.named_parameters():
        name = name.replace(".", "/")
        # Adam moves a rounding-noise gradient by up to the learning rate either way
        slack = 2 * lr if name in vanishing else 0.0
        err = np.abs(p.detach().numpy() - theirs[name]).max()
        assert err <= PARAM_TOL * np.abs(theirs[name]).max() + slack, (label, name, err)


@pytest.mark.filterwarnings("ignore:Perceptual loss is using RANDOM")
@pytest.mark.parametrize("remat,start", CASES)
def test_gan_step_matches_jax(remat, start, jax_runs):
    ref = jax_runs(remat, start)
    cfg, model, disc, pf = _port(ref, remat)
    video, mask = _inputs()
    opt, d_opt = create_optimizer(model, cfg.optim), create_optimizer(disc, cfg.optim)
    step = make_adversarial_train_step(LossConfig(use_perceptual=True), pf, adversarial_start_step=start)
    d_before = {n: p.detach().clone() for n, p in disc.named_parameters()}
    for i, (noise, uniforms) in enumerate(ref["draws"]):
        metrics = step(model, opt, disc, d_opt, video, mask, DynamicHParams.default(), i,
                       noise=noise, uniforms=uniforms)
        assert set(metrics) == set(ref["metrics"][i]) == set(METRICS)
        for key in METRICS:
            theirs, ours = ref["metrics"][i][key], float(metrics[key])
            tol = PERCEPTUAL_F32_TOL if key == "perceptual_loss" else F32_TOL
            scale = 1.0 if key in ("rl_loss", "discriminator_loss") else abs(theirs)  # 0 where the gate is off
            assert abs(ours - theirs) <= tol * scale, (i, key, ours, theirs)
        if i < start:  # the gate is off: no GAN term, D updated on zero gradients
            assert float(metrics["discriminator_loss"]) == 0.0
            assert all(float(m.abs().max()) == 0.0 for m in d_opt.mu)
            assert all(torch.equal(p, d_before[n]) for n, p in disc.named_parameters())
    assert ref["metrics"][1]["generator_adv_loss"] > 0 and ref["metrics"][1]["discriminator_loss"] > 0

    vae_vanishing = {f"{n}/conv/bias".replace(".", "/") for n, m in model.named_modules()
                     if isinstance(m, ConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()}
    d_vanishing = vanishing_biases(disc)
    assert len(d_vanishing) == 3  # 4 and 8 channels in as many groups
    lr = opt.schedule(1)
    _hold_optimizer("vae", opt, ref["opt"], vae_vanishing)
    _hold_optimizer("discriminator", d_opt, ref["d_opt"], d_vanishing)
    _hold_params("vae", model, ref["params_after"], vae_vanishing, lr)
    _hold_params("discriminator", disc, ref["d_params_after"], d_vanishing, lr)
    for name, u in disc.named_buffers():  # three power steps a GAN step, remat's recompute included
        theirs = ref["u_after"][name.replace(".", "/")]
        assert not np.array_equal(theirs, ref["u"][name.replace(".", "/")])
        assert np.abs(u.numpy() - theirs).max() <= 1e-5 * np.abs(theirs).max(), name
    # the JAX discriminator optimizer's state carries into a fresh port optimizer unchanged
    fresh = create_optimizer(disc, cfg.optim)
    assert load_jax_optimizer_state(fresh, *_moments(ref["d_opt"])) == len(list(disc.parameters()))
    assert fresh.count == 2


def test_fake_rows_are_clip_0s_rollouts():
    """One device: ``reconstruction[:b]``, in (b r) order clip 0's two rollouts at b = 2."""
    model = VideoVAE(tiny_config().model, device="cpu")
    recon = torch.arange(4.0).reshape(4, 1)  # rows c0r0, c0r1, c1r0, c1r1
    assert fake_rows(recon, 2, model_sharding(model)).ravel().tolist() == [0.0, 1.0]
