"""The train step and the serving pass.

Counterparts of the JAX package's ``train/step.py``: ``make_train_step``
(forward with paired rollouts → ``vae_loss`` → backward → gradient telemetry →
clipped Adam) as :func:`train_step`, ``make_eval_step`` as :func:`eval_step`,
``build_perceptual`` and ``make_reconstruct_fn`` as :func:`reconstruct`.

Under a mesh (a model from ``train/setup.py:create_sharded_model``) each
rank computes its rows of the global batch; the loss metrics and the
gradients are then averaged over the (data, fsdp) ranks, so every rank sees
the global batch's, as the JAX step's are, and a gradient split over fsdp
comes out as the rank's shard of it (``ParamSharding.reduce_gradients``: a
reduce-scatter over fsdp). The gradients come from ``torch.autograd.grad`` on
the rank's own parameter tensors and are reduced here: no wrapper module
stands between the step and the parameters. On one device every collective
is the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_vae_tpu_torch.core.config import DynamicHParams, LossConfig
from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.losses.losses import PerceptualFn, vae_loss
from video_vae_tpu_torch.losses.perceptual import make_perceptual_loss_fn
from video_vae_tpu_torch.models.vae import VideoVAE
from video_vae_tpu_torch.models.vgg import load_vgg
from video_vae_tpu_torch.parallel.sharding import model_sharding
from video_vae_tpu_torch.train.setup import Optimizer
from video_vae_tpu_torch.utils.metrics import masked_sse, psnr_from_sse


def loss_and_grads(
    model: VideoVAE,
    video,
    frame_mask,
    hp: DynamicHParams,
    loss_cfg: LossConfig,
    perceptual_fn: Optional[PerceptualFn] = None,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
):
    """(loss, metrics, one gradient per ``model.parameters()``), no update.

    The video is cast to the compute dtype first, as the JAX step does. A
    parameter the loss does not reach gets a zero gradient, as in JAX. Under
    a mesh the metrics and the gradients are the global batch's, each
    gradient that of the rank's shard of its parameter (see the module
    docstring); the loss is the rank's own.
    """
    video = torch.as_tensor(video, device=model.device).to(model.cfg.compute_dtype())
    frame_mask = torch.as_tensor(frame_mask, device=model.device)
    out = model(
        video, frame_mask, train=True, generator=generator, noise=noise, uniforms=uniforms
    )
    loss, metrics = vae_loss(out, video, frame_mask, hp, loss_cfg, perceptual_fn)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    keys = list(metrics)
    reduced, grads = model_sharding(model).reduce_gradients([metrics[k].detach() for k in keys], grads)
    return loss, dict(zip(keys, reduced)), grads


def train_step(
    model: VideoVAE,
    optimizer: Optimizer,
    video,
    frame_mask,
    hp: DynamicHParams,
    loss_cfg: LossConfig,
    perceptual_fn: Optional[PerceptualFn] = None,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> dict:
    """One training step on the model's device; returns the metrics as 0-d tensors.

    The keys are those of the JAX step: loss, MSE, per_sample_MAE,
    perceptual_loss, selection_loss, kl_loss, kept_frame_density, rl_loss,
    mean_trajectory_prob, and grad_norm and max_grad of the gradients before
    the clip. ``noise`` and ``uniforms`` replace the two random draws (see
    ``VideoVAE.forward``); without them they come from ``generator``. Nothing
    here waits for the device.
    """
    _, metrics, grads = loss_and_grads(
        model, video, frame_mask, hp, loss_cfg, perceptual_fn,
        generator=generator, noise=noise, uniforms=uniforms,
    )
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["max_grad"] = model_sharding(model).grad_max_abs(grads)
    metrics["grad_norm"] = optimizer.update(grads)
    return metrics


def eval_step(
    model: VideoVAE,
    video,
    frame_mask,
    hp: DynamicHParams,
    loss_cfg: LossConfig,
    perceptual_fn: Optional[PerceptualFn] = None,
    *,
    sample_latent: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> dict:
    """The loss metrics of one batch without gradients, plus ``psnr_sampled``.

    ``sample_latent=True`` keeps the training forward's latent sampling and
    stochastic selection, as the JAX package's eval does; False evaluates at
    the latent mean. ``psnr_sampled`` is the masked PSNR of the
    reconstruction against the target repeated across the rollouts. The
    draws are those of :func:`train_step`.
    """
    with torch.no_grad():
        video = torch.as_tensor(video, device=model.device).to(model.cfg.compute_dtype())
        frame_mask = torch.as_tensor(frame_mask, device=model.device)
        out = model(
            video, frame_mask, train=sample_latent, generator=generator, noise=noise,
            uniforms=uniforms,
        )
        _, metrics = vae_loss(out, video, frame_mask, hp, loss_cfg, perceptual_fn)
        r = out.rollouts
        target, mask = video.repeat_interleave(r, dim=0), frame_mask.repeat_interleave(r, dim=0)
        keys = list(metrics)
        sums = list(masked_sse(out.reconstruction, target, mask))
        reduced = model_sharding(model).reduce_mean([metrics[k] for k in keys] + sums)
        metrics = dict(zip(keys, reduced[: len(keys)]))
        metrics["psnr_sampled"] = psnr_from_sse(*reduced[len(keys):])
    return metrics


def build_perceptual(
    loss_cfg: LossConfig,
    weights_path: Optional[str] = None,
    *,
    device: str | torch.device = "cuda",
) -> Optional[PerceptualFn]:
    """The perceptual fn the loss config asks for (or None), its VGG on ``device``.

    The VGG's filters come from the ``.npz`` at ``weights_path`` (see
    ``models/vgg.py:load_vgg``), random ones with a warning without it; its
    layout is ``loss_cfg.vgg_layout`` (``"cf"``: the convs on the direct conv
    kernel).
    """
    if not loss_cfg.use_perceptual:
        return None
    vgg = load_vgg(weights_path, layout=loss_cfg.vgg_layout, device=device)
    return make_perceptual_loss_fn(vgg, chunk_frames=loss_cfg.perceptual_chunk_frames)


def reconstruct(
    model: VideoVAE,
    video,
    frame_mask,
    *,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """(b, t, H, W, C) video and (b, t) frame mask → (b, t, H, W, C) reconstruction.

    Frames whose selection probability is below 0.5 are replaced by the fill
    token before decoding. ``device`` must be the model's device; it defaults
    to CUDA and raises where there is none.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, reconstruct was asked for {dev}")
    with torch.inference_mode():
        video = torch.as_tensor(video, device=model.device).to(model.cfg.compute_dtype())
        frame_mask = torch.as_tensor(frame_mask, device=model.device)
        mean, _, prob = model.encode(video, frame_mask)
        keep = (prob >= 0.5).to(mean.dtype)[..., None]  # (b, t, 1, 1)
        return model.decode(model.blend_fill(mean, keep), frame_mask)
