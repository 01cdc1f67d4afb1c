"""Decode cached latents back to a video: the JAX package's ``cli/decode_latents.py`` in the port.

Reads one ``.npz`` of ``cli/cache_latents.py``, keeps the frames whose
selection probability is at least 0.5, fills the others with the learned fill
token (``VideoVAE.blend_fill``), decodes under ``torch.inference_mode()`` and
writes the valid frames with ``data/video_io.py:write_video``.

    python -m video_vae_tpu_torch.cli.decode_latents --model_path ckpt --latents L.npz --out out.mp4 [--device cpu]

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without
CUDA only ``--device cpu`` runs); the weights are read as ``cache_latents``
reads them.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Decode cached latents to video")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--latents", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--resize", type=int, default=256)
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from video_vae_tpu_torch.cli.cache_latents import load_model
    from video_vae_tpu_torch.core.config import ModelConfig, tiny_config
    from video_vae_tpu_torch.data.video_io import write_video

    model_cfg = tiny_config().model if args.tiny else ModelConfig(height=args.resize, width=args.resize)
    model = load_model(model_cfg, args.model_path, args.device, "decode_latents")

    data = np.load(args.latents)
    with torch.inference_mode():
        mean = torch.from_numpy(data["mean"])[None].to(model.device, torch.bfloat16)
        prob = torch.from_numpy(data["selection_prob"])[None].to(model.device)
        mask = torch.from_numpy(data["mask"])[None].to(model.device)
        keep = (prob >= 0.5).to(mean.dtype)[..., None]
        recon = model.decode(model.blend_fill(mean, keep), mask)[0].float().cpu().numpy()
    write_video({"video": recon, "mask": np.asarray(data["mask"])}, args.out, fps=args.fps)
    print(f"[decode_latents] wrote {args.out}")


if __name__ == "__main__":
    main()
