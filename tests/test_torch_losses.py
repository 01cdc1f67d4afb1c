"""The port's objective and optimizer against the JAX package's, on the CPU.

* ``vae_loss`` and its gradient with respect to the model outputs, for every
  ``LossConfig`` variant, on numpy-drawn outputs;
* the VGG perceptual loss, with the JAX ``load_vgg(None)`` filters carried
  across through ``load_jax_params``, one pass and chunked;
* the warmup-cosine schedule, the global-norm clip and Adam against optax.
"""

import dataclasses
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import OptimConfig as JaxOptimConfig
from video_vae_tpu.losses.losses import vae_loss as jax_vae_loss
from video_vae_tpu.losses.perceptual import make_perceptual_loss_fn as jax_make_perceptual
from video_vae_tpu.models.vae import VAEOutput as JaxVAEOutput
from video_vae_tpu.models.vgg import load_vgg as jax_load_vgg
from video_vae_tpu.train.setup import make_lr_schedule as jax_make_lr_schedule
from video_vae_tpu.train.setup import make_tx
from video_vae_tpu_torch import DynamicHParams, LossConfig, OptimConfig, load_jax_params
from video_vae_tpu_torch.losses import make_perceptual_loss_fn, vae_loss
from video_vae_tpu_torch.models.vae import VAEOutput
from video_vae_tpu_torch.models.vgg import load_vgg
from video_vae_tpu_torch.train.setup import Optimizer, make_lr_schedule

# f32, the same arithmetic in another order
F32_TOL = 1e-4
# both sides run the VGG in bf16 (the JAX loss rounds its inputs to bf16);
# their convolutions accumulate in other orders before each bf16 rounding, so
# a few activations land one bf16 step (2^-8 relative) apart. The loss is an
# f32 mean over many of them (measured 4e-6); its gradient goes back through
# the bf16 chain (measured 5.3e-3 at the worst element, 1e-4 on average)
VGG_VALUE_TOL = 1e-4
VGG_GRAD_TOL = 1e-2


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_dynamic_hparams_defaults_match_jax():
    ours = dataclasses.asdict(DynamicHParams.default())
    theirs = JaxDynamicHParams.default()
    assert set(ours) == {f.name for f in dataclasses.fields(theirs)}
    for name, value in ours.items():
        assert np.float32(value) == np.asarray(getattr(theirs, name)), name
    assert DynamicHParams.default().with_compression_rate(8).max_compression_rate == 8.0


def _outputs(rollouts, seed):
    rng = np.random.default_rng(seed)
    b, t, hw, latent = 2, 6, 4, 5
    B = b * rollouts
    video = rng.uniform(0, 1, (b, t, 8, 8, 3)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 4:] = 0
    fields = dict(
        reconstruction=rng.uniform(-0.2, 1.2, (B, t, 8, 8, 3)).astype(np.float32),
        selection_prob=rng.uniform(0.05, 0.95, (B, t, 1, 1)).astype(np.float32),
        log_variance=(0.5 * rng.standard_normal((B, t, hw, latent))).astype(np.float32),
        mean=rng.standard_normal((B, t, hw, latent)).astype(np.float32),
    )
    # kept fractions below and above 1/max_compression_rate (both magnify
    # branches), far apart within each pair: the standardised disadvantage
    # of a pair with near-equal losses is a difference of near-equal f32
    # numbers, conditioned far worse than the rest of the loss
    sel = np.array([[1, 0, 0, 0, 1, 0], [1, 1, 1, 0, 1, 1],
                    [1, 0, 0, 0, 1, 1], [1, 1, 1, 0, 1, 1]], np.float32)
    sel = sel[:: 2 // rollouts][:, :, None, None]
    return video, mask, fields, sel


GRAD_FIELDS = ("reconstruction", "selection_prob", "log_variance", "mean")


@pytest.mark.parametrize(
    "penalty,objective,normalizer,rollouts",
    [(*v, 2) for v in itertools.product(("square", "abs"), ("normalized_prod", "log_prob"),
                                         ("seq_len", "kept_frames"))]
    + [("abs", "log_prob", "kept_frames", 1)],
)
def test_vae_loss_and_grads_match_jax(penalty, objective, normalizer, rollouts):
    video, mask, fields, sel = _outputs(rollouts, seed=rollouts)
    kw = dict(selection_penalty=penalty, rl_objective=objective, kl_normalizer=normalizer,
              use_perceptual=False)
    hp = dict(max_compression_rate=2.0, rl_loss_weight=0.5)

    def jax_fn(*arrays):
        out = JaxVAEOutput(latent=None, selection_mask=jnp.asarray(sel), rollouts=rollouts,
                           **dict(zip(GRAD_FIELDS, arrays)))
        return jax_vae_loss(out, jnp.asarray(video), jnp.asarray(mask),
                            JaxDynamicHParams.default(**hp), JaxLossConfig(**kw))

    (j_loss, j_metrics), j_grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(fields[k]) for k in GRAD_FIELDS)
    )

    leaves = {k: torch.from_numpy(fields[k]).requires_grad_() for k in GRAD_FIELDS}
    out = VAEOutput(latent=None, selection_mask=torch.from_numpy(sel), rollouts=rollouts, **leaves)
    loss, metrics = vae_loss(out, torch.from_numpy(video), torch.from_numpy(mask),
                             DynamicHParams.default(**hp), LossConfig(**kw))
    grads = torch.autograd.grad(loss, [leaves[k] for k in GRAD_FIELDS], allow_unused=True)

    assert set(metrics) == set(j_metrics)
    for key, value in metrics.items():
        ref = float(j_metrics[key])
        # rl_loss is 0 up to rounding (the trajectory term is 1 or 0 in value
        # and the standardised disadvantages sum to 0): its scale is theirs, 1
        scale = 1.0 if key == "rl_loss" else abs(ref)
        assert abs(float(value.detach()) - ref) <= F32_TOL * scale, key
    for name, g, jg in zip(GRAD_FIELDS, grads, j_grads):
        jg = np.asarray(jg)
        if g is None:  # "none" mode: the probability reaches no loss term
            assert not jg.any(), name
        else:
            assert _rel_err(g.numpy(), jg) <= F32_TOL, name


@pytest.fixture(scope="module")
def vggs():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_vgg = jax_load_vgg(None)
        port = load_vgg(None, device="cpu")
    flat = {"/".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jax_vgg, nnx.Param).flat_state()}
    assert load_jax_params(port, flat) == 6
    return jax_vgg, port


@pytest.mark.parametrize("chunk_frames", [32, 5])
def test_perceptual_loss_matches_jax(vggs, chunk_frames):
    jax_vgg, port = vggs
    rng = np.random.default_rng(chunk_frames)
    x = rng.uniform(0, 1, (4, 3, 16, 16, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    j_fn = jax_make_perceptual(jax_vgg, chunk_frames=chunk_frames)
    j_val, j_vjp = jax.vjp(lambda a: j_fn(a, jnp.asarray(target), 2), jnp.asarray(x))
    cot = rng.uniform(0.5, 1.5, (4,)).astype(np.float32)
    (j_grad,) = j_vjp(jnp.asarray(cot))

    fn = make_perceptual_loss_fn(port, chunk_frames=chunk_frames)
    xt = torch.from_numpy(x).requires_grad_()
    val = fn(xt, torch.from_numpy(target), 2)
    (grad,) = torch.autograd.grad(val, [xt], torch.from_numpy(cot))
    assert val.shape == (4,)
    assert _rel_err(val.detach().numpy(), j_val) <= VGG_VALUE_TOL
    assert _rel_err(grad.numpy(), j_grad) <= VGG_GRAD_TOL


def test_lr_schedule_matches_optax():
    cfg = dict(learning_rate=1e-3, warmup_steps=5, decay_steps=20, end_value_factor=0.1)
    ours = make_lr_schedule(OptimConfig(**cfg))
    theirs = jax_make_lr_schedule(JaxOptimConfig(**cfg))
    for count in range(0, 30):
        assert abs(ours(count) - float(theirs(count))) <= 1e-6 * cfg["learning_rate"], count
    assert ours(0) == 0.0


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip idle, clip triggered
def test_clip_adam_matches_optax(grad_scale):
    cfg = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10, clip_global_norm=1.0)
    rng = np.random.default_rng(int(grad_scale * 100))
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(4)]
    norms = [np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)) for gs in grads]
    assert all((n > 1.0) == (grad_scale > 1) for n in norms)

    tx = make_tx(JaxOptimConfig(**cfg))
    j_params = [jnp.asarray(p) for p in params]
    state = tx.init(j_params)
    ours = [torch.from_numpy(p.copy()) for p in params]
    opt = Optimizer(ours, OptimConfig(**cfg))
    for step, gs in enumerate(grads):
        before = [p.clone() for p in ours]
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.update([torch.from_numpy(g) for g in gs])
        for p, b, jp in zip(ours, before, j_params):
            delta, j_delta = (p - b).numpy(), np.asarray(jp) - b.numpy()
            if step == 0:  # the schedule starts at 0: the first update is a no-op
                assert not delta.any() and not j_delta.any()
            else:
                assert _rel_err(delta, j_delta) <= F32_TOL, step
