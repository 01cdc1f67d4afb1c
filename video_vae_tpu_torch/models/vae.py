"""VideoVAE: factored space/time transformer VAE with learned frame selection.

Counterpart of the JAX package's ``models/vae.py``: the same modules, names
and parameter layouts, the deterministic sub-paths the serving pass uses
(``encode``, ``blend_fill``, ``decode``) and the training forward
(``forward``: the reparameterised latent, then the selection of
``ModelConfig.selection_mode``: two paired Bernoulli rollouts per clip in
``"rl"`` mode, a Gumbel-sigmoid straight-through gate in ``"ste"`` mode, every
frame kept in ``"none"`` mode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from video_vae_tpu_torch.core.config import ModelConfig
from video_vae_tpu_torch.core.device import resolve_device
from video_vae_tpu_torch.models.layers import (
    FactoredAttention,
    Linear,
    PatchEmbedding,
    PatchUnEmbedding,
)
from video_vae_tpu_torch.models.unet import UNet3D
from video_vae_tpu_torch.ops.ste import gumbel_sigmoid_sample
from video_vae_tpu_torch.parallel.sharding import draw_local


NUM_ROLLOUTS = 2  # paired rollouts for the REINFORCE advantage


@dataclass
class VAEOutput:
    """All tensors are at batch size b·rollouts (rollouts=2 in "rl" mode)."""

    reconstruction: torch.Tensor  # (B, t, H, W, C)
    latent: torch.Tensor  # (B, t, hw, latent_dim), fill-blended
    selection_prob: torch.Tensor  # (B, t, 1, 1) keep probability
    selection_mask: torch.Tensor  # (B, t, 1, 1) hard {0,1} keep decision
    log_variance: torch.Tensor  # (B, t, hw, latent_dim)
    mean: torch.Tensor  # (B, t, hw, latent_dim)
    rollouts: int = 1


def _block_stack(cfg: ModelConfig, depth: int, gen: torch.Generator) -> nn.ModuleList:
    return nn.ModuleList(
        FactoredAttention(
            cfg.embed_dim, cfg.mlp_dim, cfg.num_heads, cfg.qkv_features, gen,
            rope_base=cfg.rope_base, rope_alpha=cfg.rope_alpha,
            attention_impl=cfg.attention_impl, remat=cfg.remat,
            dtype=cfg.compute_dtype(),
        )
        for _ in range(depth)
    )


def _key_mask(frame_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(b, t) {0,1} frame mask → (b, t) bool key mask."""
    return None if frame_mask is None else frame_mask.bool()


class Encoder(nn.Module):
    """Patches → depth × FactoredAttention → (mean, log_variance, selection logits).

    The variance head predicts softplus⁻¹(variance), so log-variance is
    log(softplus(·)). The selection head reduces channels (selection_layer1),
    then the frame's patches (selection_layer2), plus selection_logit_bias.
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = cfg.compute_dtype()
        self.cfg_bias = cfg.selection_logit_bias
        self.patch_embedding = PatchEmbedding(cfg.channels, cfg.patch_size, gen, dtype=dt)
        self.layers = _block_stack(cfg, cfg.encoder_depth, gen)
        self.spatial_compression = Linear(cfg.embed_dim, cfg.latent_dim, gen, dtype=dt)
        self.variance_estimator = Linear(cfg.embed_dim, cfg.latent_dim, gen, dtype=dt)
        self.selection_layer1 = Linear(cfg.latent_dim, 1, gen, dtype=dt)
        self.selection_layer2 = Linear(cfg.num_patches, 1, gen, dtype=dt)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor]):
        x = self.patch_embedding(x)
        for layer in self.layers:
            x = layer(x, key_mask)
        mean = self.spatial_compression(x)
        log_variance = torch.log(F.softplus(self.variance_estimator(x)))
        sel = self.selection_layer1(mean)[..., 0]  # (b, t, hw)
        logits = self.selection_layer2(sel) + self.cfg_bias  # (b, t, 1)
        return mean, log_variance, logits


class Decoder(nn.Module):
    """Latents → depth × FactoredAttention → patch unembed → direct + UNet.

    Returns pixels-last (b, t, H, W, C).
    """

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = cfg.compute_dtype()
        self.spatial_decompression = Linear(cfg.latent_dim, cfg.embed_dim, gen, dtype=dt)
        self.layers = _block_stack(cfg, cfg.decoder_depth, gen)
        self.patch_unembedding = PatchUnEmbedding(
            cfg.height, cfg.width, cfg.channels, cfg.patch_size,
            cfg.unembedding_upsample_rate, gen, dtype=dt,
        )
        self.unet = UNet3D(
            cfg.channels * cfg.unembedding_upsample_rate, cfg.unet_base_features,
            cfg.unet_levels, cfg.channels, gen, temporal_kernel=cfg.temporal_kernel,
            remat=cfg.remat, dtype=dt,
        )

    def forward(self, z: torch.Tensor, key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.spatial_decompression(z)
        for layer in self.layers:
            x = layer(x, key_mask)
        conv_features, direct = self.patch_unembedding(x)
        out = direct + self.unet(conv_features)
        return out.permute(0, 1, 3, 4, 2).contiguous()


class VideoVAE(nn.Module):
    """End-to-end video VAE with adaptive temporal compression.

    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``,
    mirroring the JAX initialisers (lecun-normal kernels, 1e-2 truncated
    normal on residual out projections, zero biases and final conv, unit
    norm scales, fill token ~ N(0, 0.02²)). ``device`` defaults to CUDA and
    raises where there is none; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(cfg, gen)
        self.decoder = Decoder(cfg, gen)
        self.fill_token = nn.Parameter(torch.randn((1, 1, 1, cfg.latent_dim), generator=gen) * 0.02)
        self.to(device=dev, dtype=cfg.params_dtype())

    @property
    def device(self) -> torch.device:
        return self.fill_token.device

    def encode(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        """Deterministic encode: (mean, log_variance, selection_prob (b, t, 1))."""
        mean, log_variance, logits = self.encoder(x, _key_mask(frame_mask))
        return mean, log_variance, torch.sigmoid(logits)

    def decode(self, z: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decoder(z, _key_mask(frame_mask))

    def blend_fill(self, latent: torch.Tensor, selection_mask: torch.Tensor) -> torch.Tensor:
        """Replace dropped frames (selection_mask 0) with the learned fill token."""
        sel = selection_mask.to(latent.dtype)
        return self.fill_token.to(latent.dtype) * (1.0 - sel) + latent * sel

    def _decode_rollouts_in_turn(
        self, blended: torch.Tensor, key_mask: torch.Tensor, rollouts: int
    ) -> torch.Tensor:
        """Decode one rollout at a time, each under activation checkpointing.

        The rollouts are independent decodes with the same weights, so this
        equals the batched (b·rollouts) decode while the decoder's backward
        temporaries are one rollout's at a time (the JAX package's checkpointed
        scan over the rollout axis). The (b r) batch order is kept.
        """
        def decode(z, m):
            return self.decoder(z, m)

        recon = []
        for r in range(rollouts):
            z, m = blended[r::rollouts], key_mask[r::rollouts]
            if torch.is_grad_enabled():
                recon.append(checkpoint(decode, z, m, use_reentrant=False))
            else:
                recon.append(decode(z, m))
        out = torch.stack(recon, dim=1)  # (b, r, t, H, W, C)
        return out.reshape(-1, *out.shape[2:])

    def forward(
        self,
        x: torch.Tensor,
        frame_mask: torch.Tensor,
        *,
        train: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> VAEOutput:
        """Training forward: encode, sample, select, fill-blend, decode.

        ``noise`` (the shape of log_variance, compute dtype) and ``uniforms``
        (f32) take the place of the JAX model's two ``rngs.sampling()`` draws;
        without them both are drawn from ``generator`` (torch's default one
        when that is None). In ``"rl"`` mode the uniforms are (b·2, t, 1, 1)
        and a frame is kept where uniform < p; in ``"ste"`` mode they are
        (b, t, 1) and feed the gate's logistic noise (no draw when ``train``
        is False). Rollouts repeat b-major, r-minor, as the JAX ``repeat(...,
        "b ... -> (b r) ...")`` does. Under ``parallel.sharding.local_rows``
        the draws are made for the whole global batch and this rank keeps its
        rows.
        """
        cfg = self.cfg
        key_mask = _key_mask(frame_mask)
        mean, log_variance, logits = self.encoder(x, key_mask)

        def draw(fn, shape, dtype):  # this rank's rows of the global batch's draw
            dev = generator.device if generator is not None else mean.device
            return draw_local(fn, shape, generator=generator, dtype=dtype, device=dev).to(mean.device)

        if train:
            if noise is None:
                noise = draw(torch.randn, log_variance.shape, mean.dtype)
            noise = noise.to(device=mean.device, dtype=mean.dtype)
            latent = mean + noise * torch.exp(log_variance.float() / 2).to(mean.dtype)
        else:
            latent = mean

        prob = torch.sigmoid(logits)  # (b, t, 1)
        if cfg.selection_mode == "rl":
            rep = lambda v: v.repeat_interleave(NUM_ROLLOUTS, dim=0)  # noqa: E731
            prob = rep(prob)[..., None]  # (b·2, t, 1, 1)
            latent, mean, log_variance, key_mask = (
                rep(latent), rep(mean), rep(log_variance), rep(key_mask)
            )
            if uniforms is None:
                uniforms = draw(torch.rand, prob.shape, torch.float32)
            uniforms = uniforms.to(device=prob.device, dtype=torch.float32)
            selection_mask = (uniforms < prob.float()).to(latent.dtype)
            rollouts = NUM_ROLLOUTS
        elif cfg.selection_mode == "none":
            prob = prob[..., None]
            selection_mask = torch.ones_like(prob)
            rollouts = 1
        else:  # "ste"
            if train and uniforms is None:
                uniforms = draw(torch.rand, logits.shape, torch.float32)
            gate = gumbel_sigmoid_sample(
                logits, uniforms=uniforms, temperature=cfg.gumbel_temperature, train=train
            )
            selection_mask = gate[..., None]
            prob = prob[..., None]
            rollouts = 1

        blended = self.blend_fill(latent, selection_mask)
        if cfg.scan_rollout_decode and rollouts > 1:
            reconstruction = self._decode_rollouts_in_turn(blended, key_mask, rollouts)
        else:
            reconstruction = self.decoder(blended, key_mask)
        return VAEOutput(
            reconstruction=reconstruction,
            latent=blended,
            selection_prob=prob,
            selection_mask=selection_mask,
            log_variance=log_variance,
            mean=mean,
            rollouts=rollouts,
        )
