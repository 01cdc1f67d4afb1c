"""The port's data path: video IO, sources and the batched loader."""

from video_vae_tpu_torch.data.pipeline import create_dataloader
from video_vae_tpu_torch.data.source import SyntheticVideoSource, VideoFileSource, list_video_files
from video_vae_tpu_torch.data.video_io import load_video, write_video

__all__ = [
    "SyntheticVideoSource",
    "VideoFileSource",
    "create_dataloader",
    "list_video_files",
    "load_video",
    "write_video",
]
