"""Offline latent caching: encode a video directory with the trained VideoVAE.

The JAX package's ``cli/cache_latents.py`` in the port. For each video of
``--data_dir`` (``data/source.py:list_video_files``), the clip is decoded
(``load_video``, ``on_error="skip"``), its scene changes are found over the
valid frames (:func:`hist_diff_indices`), and the model's deterministic
encoder runs on the bf16 clip under ``torch.inference_mode()``. One ``.npz``
per video holds ``mean``, ``log_variance`` and ``selection_prob`` (f32),
``mask``, ``scene_changes`` (int32) and ``source``, as the JAX CLI writes.

    python -m video_vae_tpu_torch.cli.cache_latents --model_path ckpt --data_dir D --out_dir O [--device cpu]

The flags are the JAX CLI's (``--batch_frames`` is parsed and unused, as
there), plus ``--device`` (default ``cuda``; without CUDA only ``--device
cpu`` runs). The weights come from the port's checkpoint format,
``<model_path>/state.pt`` entry ``"model"`` (``train/checkpoint.py``); where
that fails, the CLI warns and goes on with the seeded initial weights, as the
JAX CLI does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def hist_diff_indices(frames: np.ndarray, threshold: float = 0.35, bins: int = 32):
    """Scene-change frame indices by the histogram distance of consecutive frames'
    saturation and value (HSV), as the JAX package computes them.

    frames: (T, H, W, 3) float32 in [0,1].
    """
    maxc = frames.max(axis=-1)
    minc = frames.min(axis=-1)
    v = maxc
    s = np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-8), 0.0)
    hists = []
    for t in range(frames.shape[0]):
        h_s, _ = np.histogram(s[t], bins=bins, range=(0, 1), density=True)
        h_v, _ = np.histogram(v[t], bins=bins, range=(0, 1), density=True)
        hists.append(np.concatenate([h_s, h_v]) / bins)
    hists = np.stack(hists)
    diffs = 0.5 * np.abs(hists[1:] - hists[:-1]).sum(axis=1)
    return [0] + [int(i) + 1 for i in np.nonzero(diffs > threshold)[0]]


def load_model(model_cfg, model_path: str, device: str, tag: str):
    """The VideoVAE on ``device`` with the weights of ``model_path``, or with its
    seeded initial weights and a warning where the restore fails; in eval mode."""
    from video_vae_tpu_torch.models.vae import VideoVAE
    from video_vae_tpu_torch.train.checkpoint import load_model_state

    model = VideoVAE(model_cfg, device=device)
    try:
        load_model_state(model, model_path)
    except Exception as e:  # noqa: BLE001 (random weights for smoke tests, as the JAX CLI)
        print(f"[{tag}] WARNING: checkpoint restore failed ({e}); random weights")
    return model.eval()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Cache VAE latents for a video dir")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--max_frames", type=int, default=64)
    parser.add_argument("--resize", type=int, default=256)
    parser.add_argument("--batch_frames", type=int, default=32, help="frames per device batch")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from video_vae_tpu_torch.core.config import ModelConfig, tiny_config
    from video_vae_tpu_torch.data.source import list_video_files
    from video_vae_tpu_torch.data.video_io import load_video

    model_cfg = tiny_config().model if args.tiny else ModelConfig(height=args.resize, width=args.resize)
    model = load_model(model_cfg, args.model_path, args.device, "cache_latents")

    os.makedirs(args.out_dir, exist_ok=True)
    paths = list_video_files(args.data_dir)
    print(f"[cache_latents] {len(paths)} videos")
    for path in paths:
        video, mask = load_video(
            path, max_frames=args.max_frames, resize=(model_cfg.height, model_cfg.width),
            crop_size=max(model_cfg.height, model_cfg.width), on_error="skip",
        )
        scene_changes = hist_diff_indices(video[mask.astype(bool)])
        with torch.inference_mode():
            x = torch.from_numpy(video)[None].to(model.device, torch.bfloat16)
            mean, logvar, prob = model.encode(x, torch.from_numpy(mask)[None].to(model.device))
        name = os.path.splitext(os.path.basename(path))[0]
        np.savez(
            os.path.join(args.out_dir, f"{name}.npz"),
            mean=mean[0].float().cpu().numpy(),
            log_variance=logvar[0].float().cpu().numpy(),
            selection_prob=prob[0].float().cpu().numpy(),
            mask=mask,
            scene_changes=np.asarray(scene_changes, np.int32),
            source=path,
        )
    print(f"[cache_latents] wrote {len(paths)} latent files to {args.out_dir}")


if __name__ == "__main__":
    main()
