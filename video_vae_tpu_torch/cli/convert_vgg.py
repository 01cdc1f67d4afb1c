"""Convert a torchvision VGG16 checkpoint to the ``.npz`` the perceptual loss loads.

    python -m video_vae_tpu_torch.cli.convert_vgg vgg16.pth vgg16_features.npz

The ``.pth`` (a torchvision ``vgg16`` state dict, or the model) is the
user's own; the output is the file the JAX package's converter writes.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Convert torchvision vgg16 weights")
    parser.add_argument("src", help="torchvision vgg16 state_dict .pth")
    parser.add_argument("dst", help="output .npz")
    args = parser.parse_args(argv)

    import torch

    from video_vae_tpu_torch.models.vgg import convert_torchvision_state_dict

    state_dict = torch.load(args.src, map_location="cpu", weights_only=True)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    convert_torchvision_state_dict({k: v.numpy() for k, v in state_dict.items()}, args.dst)
    print(f"[convert_vgg] wrote {args.dst}")


if __name__ == "__main__":
    main()
