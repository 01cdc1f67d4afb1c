"""Per-sample VGG perceptual loss.

Counterpart of the JAX package's ``losses/perceptual.py``: flatten (b, t) into
frames, run the truncated VGG on the prediction and (without gradient) on the
target, sum the per-frame MSEs over relu1_1, relu1_2 and relu2_1, and average
over frames. Both videos are rounded to bf16 before the VGG, whatever the
model's dtype. Past ``chunk_frames`` frames the passes run chunk by chunk
(the last chunk zero-padded), each chunk's whole loss under activation
checkpointing, which bounds the memory the feature maps take.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from video_vae_tpu_torch.models.vgg import PERCEPTUAL_LAYERS, VGG16Features


def make_perceptual_loss_fn(
    vgg: VGG16Features, *, chunk_frames: int = 32
) -> Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]:
    """Returns fn(x, target, rollouts) -> (B,) per-sample loss.

    x: (b·rollouts, t, h, w, c) reconstructions, rollouts b-major; target:
    the un-duplicated (b, t, h, w, c) clip, tiled across the rollouts here.
    """

    def per_frame_loss(x_flat: torch.Tensor, tgt_flat: torch.Tensor) -> torch.Tensor:
        acts_x = vgg(x_flat)
        with torch.no_grad():
            acts_t = vgg(tgt_flat)
        loss = 0.0
        for layer in PERCEPTUAL_LAYERS:
            diff = acts_x[layer].float() - acts_t[layer].float()
            loss = loss + diff.square().mean(dim=(1, 2, 3))
        return loss

    def perceptual_loss(x: torch.Tensor, target: torch.Tensor, rollouts: int = 1) -> torch.Tensor:
        br, t = x.shape[:2]
        if rollouts > 1:
            target = target.repeat_interleave(rollouts, dim=0)
        x_flat = x.reshape(br * t, *x.shape[2:]).to(torch.bfloat16)
        tgt_flat = target.reshape(br * t, *target.shape[2:]).to(torch.bfloat16)
        n = x_flat.shape[0]
        if chunk_frames and n > chunk_frames:
            pad = (-n) % chunk_frames
            if pad:
                zeros = x_flat.new_zeros((pad, *x_flat.shape[1:]))
                x_flat = torch.cat([x_flat, zeros])
                tgt_flat = torch.cat([tgt_flat, zeros])
            losses = [
                checkpoint(per_frame_loss, xc, tc, use_reentrant=False)
                for xc, tc in zip(x_flat.split(chunk_frames), tgt_flat.split(chunk_frames))
            ]
            loss = torch.cat(losses)[:n]
        else:
            loss = per_frame_loss(x_flat, tgt_flat)
        return loss.reshape(br, t).mean(dim=-1)

    return perceptual_loss
