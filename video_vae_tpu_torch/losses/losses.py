"""Training objective: masked reconstruction + KL + selection density + REINFORCE.

Counterpart of the JAX package's ``losses/losses.py`` (``vae_loss``,
``_reinforce_loss`` and their helpers), every ``LossConfig`` variant:

* selection_penalty: "square" or "abs" of the magnified density gap;
* rl_objective: "normalized_prod" (self-normalised product of the kept/dropped
  probabilities) or "log_prob" (sum of centred log-probabilities);
* kl_normalizer: "seq_len" or "kept_frames".

Everything is masked by the (b, t) frame mask, so padded frames add nothing,
and reduced in f32. Rollouts are b-major, r-minor (``repeat_interleave``).

The GAN losses of ``train/adversarial.py``: the non-saturating generator loss
and the discriminator's loss with its accuracy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from video_vae_tpu_torch.core.config import DynamicHParams, LossConfig
from video_vae_tpu_torch.models.vae import VAEOutput

LossMetrics = Dict[str, torch.Tensor]
# (reconstruction at B = b·r, un-duplicated target at b, rollouts) -> (B,)
PerceptualFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def magnify_negatives(x: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(x < 0, x * rate, x)


def _repeat_rollouts(x: torch.Tensor, r: int) -> torch.Tensor:
    return x.repeat_interleave(r, dim=0) if r > 1 else x


def _masked_recon_terms(video, reconstruction, output_mask, seq_len):
    """Per-sample masked MSE and MAE: sum over time / true frame count, then mean."""
    err = ((video - reconstruction) * output_mask[:, :, None, None, None].to(video.dtype)).float()
    sl = seq_len[:, :, None, None, None]
    mae = per_sample_mean(err.abs().sum(dim=1, keepdim=True) / sl)
    mse = per_sample_mean(err.square().sum(dim=1, keepdim=True) / sl)
    return mse, mae


def vae_loss(
    out: VAEOutput,
    video: torch.Tensor,
    frame_mask: torch.Tensor,
    hp: DynamicHParams,
    cfg: LossConfig,
    perceptual_fn: Optional[PerceptualFn] = None,
) -> Tuple[torch.Tensor, LossMetrics]:
    """Full training objective.

    out: model outputs at batch B = b·rollouts; video: (b, t, H, W, C) clip
    before the rollout duplication; frame_mask: (b, t), 1 = real frame.
    """
    r = out.rollouts
    frame_mask = frame_mask.float()
    output_mask = _repeat_rollouts(frame_mask, r)
    video_r = _repeat_rollouts(video, r)
    seq_len = torch.clamp(output_mask.sum(dim=1, keepdim=True), min=1.0)

    mse, mae = _masked_recon_terms(video_r, out.reconstruction, output_mask, seq_len)

    if perceptual_fn is not None:
        perceptual = perceptual_fn(out.reconstruction, video, r).float()
    else:
        perceptual = torch.zeros_like(mse)

    ksm = output_mask[:, :, None, None]  # kl-and-selection mask
    sel_mask_f = out.selection_mask.float()
    sel_sum = (sel_mask_f * ksm).sum(dim=(1, 2, 3))[:, None]
    kept_frame_density = sel_sum / seq_len
    density_diff = kept_frame_density - (1.0 / hp.max_compression_rate)
    magnified = magnify_negatives(density_diff, hp.magnify_negatives_rate)
    if cfg.selection_penalty == "square":
        selection_loss = per_sample_mean(magnified.square())
    else:
        selection_loss = per_sample_mean(magnified.abs())

    logvar = out.log_variance.float()
    mean = out.mean.float()
    kl_map = 0.5 * (torch.exp(logvar) - 1.0 - logvar + mean.square()) * ksm
    if cfg.kl_normalizer == "kept_frames":
        kl_map = kl_map * sel_mask_f
        kl_norm = torch.clamp(sel_sum, min=1.0)[:, :, None, None]
    else:
        kl_norm = seq_len[:, :, None, None]
    kl_loss = per_sample_mean(kl_map / kl_norm)

    per_sample_loss = (
        mse
        + hp.gamma_perceptual * perceptual
        + hp.gamma_selection * selection_loss
        + hp.gamma_kl * kl_loss
        + hp.gamma_mae * mae
    )

    metrics: LossMetrics = {
        "MSE": mse.mean(),
        "per_sample_MAE": mae.mean(),
        "perceptual_loss": perceptual.mean(),
        "selection_loss": selection_loss.mean(),
        "kl_loss": kl_loss.mean(),
        "kept_frame_density": kept_frame_density.mean(),
    }
    if r > 1:
        rl_loss, traj_prob = _reinforce_loss(out, per_sample_loss, output_mask, cfg)
        loss = per_sample_loss.mean() + rl_loss.mean() * hp.rl_loss_weight
        metrics["rl_loss"] = rl_loss.mean()
        metrics["mean_trajectory_prob"] = traj_prob
    else:
        loss = per_sample_loss.mean()
        zero = torch.zeros((), device=loss.device)
        metrics["rl_loss"] = zero
        metrics["mean_trajectory_prob"] = zero
    metrics["loss"] = loss
    return loss, metrics


def _reinforce_loss(out: VAEOutput, per_sample_loss, output_mask, cfg: LossConfig):
    """REINFORCE over paired rollouts with standardised, detached disadvantages.

    The gradient flows only through the selection probability: P(X=a) =
    |p + a − 1| for a Bernoulli sample a ∈ {0, 1}. The pair's std is the
    population std (``jnp.std``), not torch's default Bessel-corrected one.
    """
    n = out.rollouts
    pairs = per_sample_loss.reshape(-1, n)
    pair_mean = pairs.mean(dim=1, keepdim=True)
    pair_std = pairs.std(dim=1, correction=0, keepdim=True) + 1e-6
    disadvantages = ((pairs - pair_mean) / pair_std).detach()[:, :, None]

    b = pairs.shape[0]
    actions = out.selection_mask.float().reshape(b, n, -1)
    probs = out.selection_prob.float().reshape(b, n, -1)
    raw_probs = torch.clamp(torch.abs(probs + actions - 1.0), 1e-6, 1.0 - 1e-6)
    rl_mask = output_mask.reshape(b, n, -1).bool()

    raw_masked = torch.where(rl_mask, raw_probs, 1.0)
    traj_prob = raw_masked.prod(dim=2).mean()

    if cfg.rl_objective == "normalized_prod":
        norm_probs = torch.where(rl_mask, raw_probs / raw_probs.detach(), 1.0)
        trajectory = norm_probs.prod(dim=2, keepdim=True)
    else:  # "log_prob"
        log_probs = torch.log(raw_probs) - torch.log(raw_probs).detach()
        trajectory = torch.where(rl_mask, log_probs, 0.0).sum(dim=2, keepdim=True)
    return trajectory * disadvantages, traj_prob


def generator_adversarial_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss: mean(softplus(−D(fake))) in f32."""
    return F.softplus(-fake_logits.float()).mean()


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor):
    """softplus(−D(real)) + softplus(D(fake)), each a mean in f32; returns
    (loss, accuracy). A logit of exactly 0 counts as wrong on both sides."""
    real_logits, fake_logits = real_logits.float(), fake_logits.float()
    loss = F.softplus(-real_logits).mean() + F.softplus(fake_logits).mean()
    accuracy = 0.5 * ((real_logits > 0).float().mean() + (fake_logits < 0).float().mean())
    return loss, accuracy
