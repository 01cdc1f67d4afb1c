"""Adversarial training: the VAE's update with a GAN term, then the discriminator's.

Counterpart of the JAX package's ``train/adversarial.py``
(``make_adversarial_train_step``), in its order:

1. the VAE's forward (both rollouts), ``vae_loss``, and the non-saturating
   generator loss softplus(−D(reconstruction)) over every rollout row, added
   with ``adversarial_weight`` once ``step >= adversarial_start_step``; the
   gradient is taken for the VAE's parameters only, then the VAE updated;
2. the discriminator's loss softplus(−D(video)) + softplus(D(fake)), times
   the same gate, with ``fake = reconstruction[:b]`` without gradient: with
   b > 1 these are clip 0's rollouts, not each clip's first, because the
   rollouts are in (b r) order (the JAX code's rows, whatever its comment
   says); then the discriminator updated. While the gate is off it updates
   on zero gradients, so Adam's count advances, as in JAX.

The discriminator's spectral norms move ``u`` on each of its three calls. The
metrics are JAX's: the ``vae_loss`` keys with ``loss`` the total,
``generator_adv_loss``, ``discriminator_loss`` and
``discriminator_accuracy``.

Under a mesh (a VAE from ``train/setup.py:create_sharded_model``) the step
takes this rank's rows of a global batch split over the (data, fsdp) ranks,
as ``train_step`` does: the VAE's metrics and gradients reduce through its
``ParamSharding``. The discriminator stays whole on every rank; its
gradients and its two metrics are averaged over the same ranks, and its
fake rows are the global batch's first b (the reconstructions are gathered
over the (data, fsdp) ranks and each rank takes its rows of those).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from video_vae_tpu_torch.core.config import DynamicHParams, LossConfig
from video_vae_tpu_torch.losses.losses import (
    PerceptualFn,
    discriminator_loss,
    generator_adversarial_loss,
    vae_loss,
)
from video_vae_tpu_torch.models.classifier import Discriminator
from video_vae_tpu_torch.models.vae import VideoVAE
from video_vae_tpu_torch.parallel.sharding import ParamSharding, model_sharding
from video_vae_tpu_torch.train.setup import Optimizer


def _grads(loss: torch.Tensor, params: list) -> list:
    """d loss / d params, a zero gradient where the loss does not reach a parameter."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def fake_rows(reconstruction: torch.Tensor, b: int, sharding: ParamSharding) -> torch.Tensor:
    """This rank's rows of the global ``reconstruction[:B]`` (B the global batch),
    where each of the n (data, fsdp) ranks holds b clips' rollouts; on one
    device ``reconstruction[:b]``."""
    index = sharding.coord["data"] * sharding.sizes["fsdp"] + sharding.coord["fsdp"]
    return sharding.gather_batch(reconstruction)[index * b:(index + 1) * b]  # of the global (b r) rows


def make_adversarial_train_step(
    loss_cfg: LossConfig,
    perceptual_fn: Optional[PerceptualFn] = None,
    *,
    adversarial_weight: float = 0.1,
    adversarial_start_step: int = 0,
) -> Callable[..., dict]:
    """Returns ``step(model, optimizer, discriminator, disc_optimizer, video,
    frame_mask, hp, step, *, generator=None, noise=None, uniforms=None) -> metrics``.

    The video is cast to the VAE's compute dtype first. ``noise`` and
    ``uniforms`` replace the VAE forward's two draws, as in ``train_step``;
    without them they come from ``generator``. The metrics are 0-d tensors;
    nothing here waits for the device.
    """

    def train_step(
        model: VideoVAE,
        optimizer: Optimizer,
        discriminator: Discriminator,
        disc_optimizer: Optimizer,
        video,
        frame_mask,
        hp: DynamicHParams,
        step,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> dict:
        video = torch.as_tensor(video, device=model.device).to(model.cfg.compute_dtype())
        frame_mask = torch.as_tensor(frame_mask, device=model.device)
        adv_on = float(int(step) >= adversarial_start_step)
        sharding = model_sharding(model)

        # ---- generator (VAE) update ----
        out = model(video, frame_mask, train=True, generator=generator, noise=noise, uniforms=uniforms)
        loss, metrics = vae_loss(out, video, frame_mask, hp, loss_cfg, perceptual_fn)
        g_adv = generator_adversarial_loss(discriminator(out.reconstruction))
        metrics["generator_adv_loss"] = g_adv
        metrics["loss"] = total = loss + adversarial_weight * adv_on * g_adv
        keys = list(metrics)
        reduced, grads = sharding.reduce_gradients([metrics[k].detach() for k in keys],
                                                   _grads(total, list(model.parameters())))
        optimizer.update(grads)
        metrics = dict(zip(keys, reduced))

        # ---- discriminator update on (real, the first b reconstructions) ----
        fake = fake_rows(out.reconstruction.detach(), video.shape[0], sharding)
        del out
        d_loss, d_acc = discriminator_loss(discriminator(video), discriminator(fake))
        d_loss = d_loss * adv_on
        d_grads = _grads(d_loss, list(discriminator.parameters()))
        d_loss, d_acc, *d_grads = sharding.reduce_mean([d_loss.detach(), d_acc, *d_grads])
        disc_optimizer.update(d_grads)
        metrics["discriminator_loss"] = d_loss
        metrics["discriminator_accuracy"] = d_acc
        return metrics

    return train_step
