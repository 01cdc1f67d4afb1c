"""VideoMAE: masked-autoencoding pretraining over the factored space/time blocks.

Counterpart of the JAX package's ``models/video_mae.py``, with its module and
parameter names:

* tube masking: each (frame, patch) token of a clip is masked with
  probability ``mask_ratio`` in training (none in eval); a masked token is
  replaced by the learned ``mask_token`` on the full (t, hw) grid, which the
  factored attention needs;
* an encoder stack of ``encoder_depth`` blocks, then a decoder stack of
  ``max(1, decoder_depth // 3)``, each block the VAE's ``FactoredAttention``
  (the fused attention kernels #1 and #3 on ``attention_impl="fused"``), the
  frame mask as the temporal key mask;
* ``prediction_head``, a Linear back to the p²c pixels of a patch;
* :func:`mae_loss`: the MSE over the masked tokens of real frames, with
  ``full_mse`` over every token beside it.

The token mask is drawn from a ``torch.Generator`` or handed in
(``token_mask=``), the counterpart of the JAX model's
``jax.random.bernoulli(rngs.sampling(), mask_ratio, (b, t, hw))``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from einops import rearrange
from torch import nn

from video_vae_tpu_torch.core.config import ModelConfig
from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.models.layers import Linear, PatchEmbedding
from video_vae_tpu_torch.models.vae import _block_stack, _key_mask
from video_vae_tpu_torch.parallel.sharding import draw_local


@dataclass
class MAEOutput:
    prediction: torch.Tensor  # (b, t, hw, p²c) predicted patch pixels, f32
    target: torch.Tensor  # (b, t, hw, p²c) true patch pixels, f32
    token_mask: torch.Tensor  # (b, t, hw) 1 = masked (to be reconstructed), compute dtype


class VideoMAE(nn.Module):
    """Masked video autoencoder over the factored space/time backbone.

    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (the mask token ~ N(0, 0.02²)); ``device`` defaults to CUDA and raises
    where there is none.
    """

    def __init__(self, cfg: ModelConfig, *, mask_ratio: float = 0.9, decoder_depth: Optional[int] = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dt = cfg.compute_dtype()
        gen = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.mask_ratio = mask_ratio
        self.patch_embedding = PatchEmbedding(cfg.channels, cfg.patch_size, gen, dtype=dt)
        self.encoder_layers = _block_stack(cfg, cfg.encoder_depth, gen)
        depth = decoder_depth if decoder_depth is not None else max(1, cfg.decoder_depth // 3)
        self.decoder_layers = _block_stack(cfg, depth, gen)
        self.mask_token = nn.Parameter(torch.randn((1, 1, 1, cfg.embed_dim), generator=gen) * 0.02)
        self.prediction_head = Linear(cfg.embed_dim, cfg.embed_dim, gen, dtype=dt)
        self.to(device=dev, dtype=cfg.params_dtype())

    @property
    def device(self) -> torch.device:
        return self.mask_token.device

    def _patch_targets(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        return rearrange(x, "b t (h p1) (w p2) c -> b t (h w) (p1 p2 c)", p1=p, p2=p)

    def forward(
        self,
        x: torch.Tensor,
        frame_mask: Optional[torch.Tensor] = None,
        *,
        train: bool = True,
        generator: Optional[torch.Generator] = None,
        token_mask: Optional[torch.Tensor] = None,
    ) -> MAEOutput:
        """(b, t, H, W, C) video → :class:`MAEOutput`.

        In training a token is masked where a uniform draw from ``generator``
        (torch's default one when that is None) is below ``mask_ratio``, or
        where ``token_mask`` (b, t, hw) is 1; under
        ``parallel.sharding.local_rows`` the draw is the global batch's and
        this rank keeps its rows. In eval no token is masked.
        """
        b, t = x.shape[:2]
        hw = self.cfg.num_patches
        key_mask = _key_mask(frame_mask)
        target = self._patch_targets(x).float()
        tokens = self.patch_embedding(x)
        if not train:
            token_mask = torch.zeros((b, t, hw), dtype=tokens.dtype, device=tokens.device)
        elif token_mask is None:
            dev = generator.device if generator is not None else tokens.device
            uniforms = draw_local(torch.rand, (b, t, hw), generator=generator, dtype=torch.float32, device=dev)
            token_mask = uniforms.to(tokens.device) < self.mask_ratio
        token_mask = token_mask.to(device=tokens.device, dtype=tokens.dtype)
        m = token_mask[..., None]
        tokens = tokens * (1.0 - m) + self.mask_token.to(tokens.dtype) * m
        for layer in self.encoder_layers:
            tokens = layer(tokens, key_mask)
        for layer in self.decoder_layers:
            tokens = layer(tokens, key_mask)
        prediction = self.prediction_head(tokens).float()
        return MAEOutput(prediction=prediction, target=target, token_mask=token_mask)


def mae_loss(out: MAEOutput, frame_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """MSE over the masked tokens of real frames: Σ w·err / max(Σw·p²c, 1), with
    w the token mask times the frame mask; ``full_mse`` over every token."""
    err = (out.prediction - out.target).square()  # (b, t, hw, p²c)
    weight = out.token_mask.float()
    if frame_mask is not None:
        weight = weight * frame_mask.float()[:, :, None]
    denom = torch.clamp(weight.sum() * err.shape[-1], min=1.0)
    loss = (err * weight[..., None]).sum() / denom
    return loss, {"loss": loss, "masked_mse": loss, "full_mse": err.mean()}
