"""The port's discriminator and GAN losses against the JAX package's, on the CPU.

``SpectralNorm`` on a Linear and on a Conv (σ, the output and ``u`` after 1
and 3 calls of 3 power steps each), flax's ``nnx.GroupNorm``, the whole
``Discriminator(base_features=4, num_levels=2)`` forward and gradient with
remat on and off (``u`` must move once a call: trap 4), and both GAN losses.
The same numpy-drawn weights and ``u`` go into both packages through
``load_jax_params`` and ``load_jax_batch_stats``.

Bounds: f32 1e-4 of the reference's max (gradients 1e-3 of their leaf's
max, the train-step tests' rule), bf16 3e-2, as in ``test_torch_model.py``;
gradients are held in f32 (see the discriminator test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.losses.losses import discriminator_loss as jax_discriminator_loss
from video_vae_tpu.losses.losses import generator_adversarial_loss as jax_generator_adversarial_loss
from video_vae_tpu.models.classifier import Discriminator as JaxDiscriminator
from video_vae_tpu.models.classifier import SpectralNorm as JaxSpectralNorm
from video_vae_tpu_torch.losses import discriminator_loss, generator_adversarial_loss
from video_vae_tpu_torch.models import Discriminator
from video_vae_tpu_torch.models.classifier import Conv3d, GroupNorm, SNConvBlock3D, SpectralNorm
from video_vae_tpu_torch.models.layers import Linear
from video_vae_tpu_torch.train import load_jax_batch_stats, load_jax_params

SEED = 10
F32_TOL, GRAD_F32_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2
DTYPES = [("float32", F32_TOL), ("bfloat16", BF16_TOL)]



def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_err(ours, theirs):
    theirs = _np(theirs)
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


def batch_stats(model):
    """{'/' path: value} of every ``nnx.BatchStat`` of a JAX module."""
    return {"/".join(map(str, p)): np.array(v.get_value()) for p, v in nnx.state(model, nnx.BatchStat).flat_state()}


def carry_over(jax_module, port_module, seed=SEED):
    """Redraw the JAX module's parameters with numpy and load them and its ``u`` into the port."""
    params = random_params(jax_module, seed)
    set_jax_params(jax_module, params)
    assert load_jax_params(port_module, params) == len(params)
    stats = batch_stats(jax_module)
    assert load_jax_batch_stats(port_module, stats) == len(stats)
    return params


def _assert_same_u(jax_module, port_module, tol=1e-5):
    ours = {n.replace(".", "/"): b for n, b in port_module.named_buffers()}
    theirs = batch_stats(jax_module)
    assert set(ours) == set(theirs) and theirs
    for key, value in theirs.items():
        assert np.abs(ours[key].numpy() - value).max() <= tol * np.abs(value).max(), key


def vanishing_biases(disc):
    """The '/' paths of the conv biases whose GroupNorm has one channel a group:
    the norm removes a per-channel constant, so their true gradient is 0."""
    return {f"{n}/conv/layer/bias".replace(".", "/") for n, m in disc.named_modules()
            if isinstance(m, SNConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()}


def assert_grads_match(ours, theirs, tol, vanishing=()):
    """Each gradient within ``tol`` of its JAX leaf's largest value; a leaf in
    ``vanishing`` is rounding noise on both sides, under 1e-6 of the largest gradient."""
    ours = {k.replace(".", "/"): v for k, v in ours.items()}
    assert set(ours) == set(theirs)
    scale = max(np.abs(g).max() for g in theirs.values())
    for name, g in ours.items():
        if name in vanishing:
            assert max(np.abs(g).max(), np.abs(theirs[name]).max()) <= 1e-6 * scale, name
            continue
        assert np.abs(g - theirs[name]).max() <= tol * np.abs(theirs[name]).max(), name


# ---- SpectralNorm ------------------------------------------------------------


def _sn_pair(kind):
    """(JAX SpectralNorm, port SpectralNorm, input as numpy, JAX→port and port→JAX layout of x)."""
    rngs, gen = nnx.Rngs(0), torch.Generator().manual_seed(0)
    rng = np.random.default_rng(SEED + 1)
    if kind == "linear":
        jsn = JaxSpectralNorm(nnx.Linear(16, 8, rngs=rngs), rngs=rngs, n_steps=3)
        sn = SpectralNorm(Linear(16, 8, gen, dtype=torch.float32), gen, n_steps=3)
        x = rng.standard_normal((5, 16)).astype(np.float32)
        to_port = to_jax = lambda t: t  # noqa: E731
    else:
        jsn = JaxSpectralNorm(nnx.Conv(4, 6, (3, 3, 3), padding="SAME", rngs=rngs), rngs=rngs, n_steps=3)
        sn = SpectralNorm(Conv3d(4, 6, (3, 3, 3), gen, dtype=torch.float32), gen, n_steps=3)
        x = rng.standard_normal((2, 3, 6, 5, 4)).astype(np.float32)  # (b, t, h, w, c)
        to_port, to_jax = (lambda t: t.permute(0, 4, 1, 2, 3)), (lambda t: t.permute(0, 2, 3, 4, 1))
    carry_over(jsn, sn)
    return jsn, sn, x, to_port, to_jax


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_spectral_norm_sigma_and_u_match_jax(kind):
    jsn, sn, _, _, _ = _sn_pair(kind)
    sigma_of = nnx.jit(lambda m, update: m._sigma(update), static_argnums=1)
    theirs = float(sigma_of(jsn, False))  # without update_stats: σ from u as it stands, u left alone
    assert abs(float(sn.sigma(update_stats=False)) - theirs) <= 1e-5 * theirs
    _assert_same_u(jsn, sn)
    for _ in range(3):
        theirs = float(sigma_of(jsn, True))
        ours = float(sn.sigma())
        assert abs(ours - theirs) <= 1e-5 * theirs, (ours, theirs)
        _assert_same_u(jsn, sn)


@pytest.mark.parametrize("calls", [1, 3])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_spectral_norm_output_and_u_match_jax(kind, calls):
    jsn, sn, x, to_port, to_jax = _sn_pair(kind)
    apply = nnx.jit(lambda m, x, update: m(x, update_stats=update), static_argnums=2)
    xt = to_port(torch.from_numpy(x))
    for update in [True] * calls + [False]:  # the last call leaves u as it is
        ref = apply(jsn, jnp.asarray(x), update)
        with torch.no_grad():
            out = to_jax(sn(xt, update_stats=update))
        assert tuple(out.shape) == ref.shape
        assert _rel_err(out, ref) <= F32_TOL
        _assert_same_u(jsn, sn)


def test_spectral_norm_bounds_linear_as_the_jax_test_does():
    """The JAX file's property: after a few calls the normalised operator's
    largest singular value is ≈ 1."""
    gen = torch.Generator().manual_seed(0)
    layer = Linear(16, 8, gen, dtype=torch.float32)
    with torch.no_grad():
        layer.kernel.mul_(10.0)
        layer.bias.zero_()
    sn = SpectralNorm(layer, gen, n_steps=3)
    x = torch.eye(16)
    with torch.no_grad():
        for _ in range(5):
            y = sn(x)
    assert 0.8 < float(torch.linalg.svdvals(y)[0]) < 1.2


# ---- flax's GroupNorm -------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("channels", [4, 16])
@pytest.mark.parametrize("offset,spread", [(3.0, 1.0), (0.0, 1e-3)])
def test_group_norm_matches_flax(offset, spread, channels, dtype, tol):
    """A mean away from 0; and a variance of 1e-6, where eps (flax's 1e-6, not
    torch's 1e-5) sets the scale."""
    groups = min(8, channels)
    jgn = nnx.GroupNorm(num_groups=groups, num_features=channels, dtype=jnp.dtype(dtype), rngs=nnx.Rngs(0))
    gn = GroupNorm(channels, groups, dtype=getattr(torch, dtype))
    carry_over(jgn, gn)
    rng = np.random.default_rng(SEED + 2)
    x = (offset + spread * rng.standard_normal((2, 3, 5, 4, channels))).astype(np.float32)
    ref = nnx.jit(lambda m, x: m(x))(jgn, jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        out = gn(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert out.dtype == getattr(torch, dtype)
    assert _rel_err(out, ref) <= tol


# ---- the Discriminator ------------------------------------------------------


def _discriminators(dtype, remat):
    jdisc = nnx.jit(lambda: JaxDiscriminator(channels=3, base_features=4, num_levels=2, rngs=nnx.Rngs(5),
                                             remat=remat, dtype=jnp.dtype(dtype)))()
    disc = Discriminator(3, 4, 2, remat=remat, dtype=getattr(torch, dtype), device="cpu")
    params = carry_over(jdisc, disc)
    return jdisc, disc, params


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_discriminator_forward_gradient_and_u_match_jax(dtype, tol, remat):
    jdisc, disc, params = _discriminators(dtype, remat)
    names = {n.replace(".", "/") for n, _ in disc.named_parameters()}
    assert names == set(params)
    assert {n.replace(".", "/") for n, _ in disc.named_buffers()} == set(batch_stats(jdisc))
    x = np.random.default_rng(SEED + 3).uniform(0.0, 1.0, (2, 4, 16, 16, 3)).astype(np.float32)

    @nnx.jit
    def jax_run(d, x):
        def f(d):
            logits = d(x)
            return jnp.sum(logits.astype(jnp.float32) * jnp.array([[1.0], [-2.0]])), logits

        (_, logits), grads = nnx.value_and_grad(f, has_aux=True)(d)
        return logits, grads

    logits_j, grads_j = jax_run(jdisc, jnp.asarray(x).astype(dtype))
    grads_j = {"/".join(map(str, p)): _np(v.get_value()) for p, v in grads_j.flat_state()}
    logits = disc(torch.from_numpy(x).to(getattr(torch, dtype)))
    loss = (logits.float() * torch.tensor([[1.0], [-2.0]])).sum()
    grads = torch.autograd.grad(loss, list(disc.parameters()))  # remat: the blocks' recompute runs here
    assert logits.shape == (2, 1) and logits.dtype == getattr(torch, dtype)
    assert _rel_err(logits, logits_j) <= tol
    _assert_same_u(jdisc, disc)  # one power step a call, the recompute included
    ours = {n: g.float().numpy() for (n, _), g in zip(disc.named_parameters(), grads)}
    assert all(np.isfinite(g).all() for g in ours.values())
    if dtype == "float32":
        # in bf16 both packages' gradients of this 2-level D are 10-30 % of their
        # leaf's max off their own f32 ones (the rounding of 4-8-channel maps), so
        # they are held in f32 only
        assert_grads_match(ours, grads_j, GRAD_F32_TOL, vanishing_biases(disc))


def test_discriminator_output_shape_as_the_jax_test_does():
    disc = Discriminator(3, 4, 2, remat=False, device="cpu")
    x = torch.rand((2, 4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = disc(x)
    assert logits.shape == (2, 1) and torch.isfinite(logits.float()).all()


def test_discriminator_defaults_are_jax_s():
    """Channels 3, base 32, 4 levels, temporal kernel 3, remat, bf16 compute, f32
    parameters: the same parameter and buffer tree, shape for shape."""
    abstract = nnx.eval_shape(lambda: JaxDiscriminator(rngs=nnx.Rngs(0)))
    theirs = {"/".join(map(str, p)): tuple(v.get_value().shape) for p, v in nnx.state(abstract, nnx.Param).flat_state()}
    disc = Discriminator(device="cpu")
    assert {n.replace(".", "/"): tuple(p.shape) for n, p in disc.named_parameters()} == theirs
    assert all(p.dtype == torch.float32 for p in disc.parameters())
    assert disc.dtype == torch.bfloat16 and all(e.remat for e in disc.encoders)
    assert {n.replace(".", "/"): tuple(b.shape) for n, b in disc.named_buffers()} == {
        "/".join(map(str, p)): tuple(v.get_value().shape) for p, v in nnx.state(abstract, nnx.BatchStat).flat_state()}


def test_batch_stats_bridge_raises_on_wrong_keys_and_shapes():
    disc = Discriminator(3, 4, 1, device="cpu")
    stats = {n.replace(".", "/"): np.zeros(tuple(b.shape), np.float32) for n, b in disc.named_buffers()}
    assert load_jax_batch_stats(disc, stats) == 3
    with pytest.raises(KeyError, match="missing"):
        load_jax_batch_stats(disc, {k: v for k, v in list(stats.items())[1:]})
    with pytest.raises(KeyError, match="unused"):
        load_jax_batch_stats(disc, {**stats, "extra/u": np.zeros((1, 4), np.float32)})
    key = next(iter(stats))
    with pytest.raises(ValueError, match="shape"):
        load_jax_batch_stats(disc, {**stats, key: np.zeros((1, 5), np.float32)})


# ---- the GAN losses ---------------------------------------------------------


def test_gan_losses_match_jax():
    # exactly 0 counts as wrong on both sides
    real = np.array([[0.0], [1.5], [-2.0], [30.0]], np.float32)
    fake = np.array([[0.0], [-0.5], [2.5], [-40.0]], np.float32)
    for dtype in ("float32", "bfloat16"):
        r, f = torch.from_numpy(real).to(getattr(torch, dtype)), torch.from_numpy(fake).to(getattr(torch, dtype))
        jr, jf = jnp.asarray(real).astype(dtype), jnp.asarray(fake).astype(dtype)
        g = generator_adversarial_loss(f)
        loss, acc = discriminator_loss(r, f)
        jloss, jacc = jax_discriminator_loss(jr, jf)
        assert g.dtype == loss.dtype == acc.dtype == torch.float32
        assert abs(float(g) - float(jax_generator_adversarial_loss(jf))) <= 1e-6 * abs(float(g))
        assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(loss))
        assert float(acc) == float(jacc) == 0.5 * (2 / 4 + 2 / 4)
    # the all-right and the all-wrong ends
    assert float(discriminator_loss(torch.ones(3, 1), -torch.ones(3, 1))[1]) == 1.0
    assert float(discriminator_loss(-torch.ones(3, 1), torch.ones(3, 1))[1]) == 0.0
