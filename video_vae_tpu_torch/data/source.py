"""Data sources: video directories and synthetic clips.

The JAX package's ``data/source.py`` in the port: the same numpy code, so the
same ``(seed, index)`` gives the same bytes in both packages. Videos are
collected from ``base_dir/videos{i}[/videos{i}]`` shards, or from
``base_dir`` itself. ``SyntheticVideoSource`` makes deterministic clips of
16 to 32 true frames (half to all of ``max_frames``) without a codec.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def list_video_files(base_dir: str, max_shards: int = 100) -> List[str]:
    """Collect videos from base_dir/videos{i}[/videos{i}] shards or base_dir itself."""
    paths: List[str] = []
    for i in range(max_shards):
        shard = os.path.join(base_dir, f"videos{i}")
        if not os.path.isdir(shard):
            continue
        nested = os.path.join(shard, f"videos{i}")
        scan_dir = nested if os.path.isdir(nested) else shard
        for filename in sorted(os.listdir(scan_dir)):
            if filename.endswith(VIDEO_EXTENSIONS):
                paths.append(os.path.join(scan_dir, filename))
    if not paths and os.path.isdir(base_dir):
        for filename in sorted(os.listdir(base_dir)):
            if filename.endswith(VIDEO_EXTENSIONS):
                paths.append(os.path.join(base_dir, filename))
    return paths


class VideoFileSource:
    """Random-access source over video files (``len`` and ``__getitem__``).

    Each record is decoded with a per-(index, seed) generator, so augmentation
    (temporal window, crop position) is reproducible.

    ``on_error="skip"`` resamples: a decode failure draws a deterministic
    replacement index (derived from (seed, index, attempt)) and retries, up to
    ``max_resample_attempts``; the epoch keeps its size and no zero clips are
    emitted. "zeros" gives a zero video with an all-ones mask; "raise"
    propagates.
    """

    max_resample_attempts: int = 10

    def __init__(
        self,
        base_dir: str,
        max_frames: int,
        resize: Tuple[int, int],
        crop_size: int = 512,
        seed: int = 0,
        on_error: str = "zeros",
    ):
        from video_vae_tpu_torch.data.video_io import load_video  # lazy (cv2)

        self._load_video = load_video
        self.video_paths = list_video_files(base_dir)
        if not self.video_paths:
            raise FileNotFoundError(f"No video files under {base_dir}")
        self.max_frames = max_frames
        self.resize = resize
        self.crop_size = crop_size
        self.seed = seed
        self.on_error = on_error

    def __len__(self) -> int:
        return len(self.video_paths)

    def __getitem__(self, index: int) -> dict:
        from video_vae_tpu_torch.data.video_io import VideoDecodeError

        last_error = None
        attempts = self.max_resample_attempts if self.on_error == "skip" else 1
        for attempt in range(attempts):
            rng = np.random.default_rng(
                np.random.PCG64(abs(hash((self.seed, index, attempt))))
            )
            if attempt:
                index = int(rng.integers(0, len(self.video_paths)))
            try:
                video, mask = self._load_video(
                    self.video_paths[index % len(self.video_paths)],
                    max_frames=self.max_frames,
                    resize=self.resize,
                    crop_size=self.crop_size,
                    rng=rng,
                    on_error=self.on_error,
                )
                return {"video": video, "mask": mask}
            except VideoDecodeError as e:
                if self.on_error != "skip":
                    raise
                last_error = e
        raise RuntimeError(
            f"{self.max_resample_attempts} consecutive decode failures "
            f"(on_error='skip'); last: {last_error}"
        )


class SyntheticVideoSource:
    """Deterministic random clips with variable true lengths (tests/benchmarks)."""

    def __init__(
        self,
        num_clips: int,
        max_frames: int,
        resize: Tuple[int, int],
        channels: int = 3,
        seed: int = 0,
        min_frames: Optional[int] = None,
    ):
        self.num_clips = num_clips
        self.max_frames = max_frames
        self.resize = resize
        self.channels = channels
        self.seed = seed
        self.min_frames = min_frames if min_frames is not None else max(1, max_frames // 2)

    def __len__(self) -> int:
        return self.num_clips

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(np.random.PCG64(abs(hash((self.seed, index)))))
        h, w = self.resize
        t_real = int(rng.integers(self.min_frames, self.max_frames + 1))
        # Smooth-ish video: low-res noise upsampled + temporal drift, in [0,1].
        base = rng.random((t_real, h // 4 or 1, w // 4 or 1, self.channels), dtype=np.float32)
        video = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)[:, :h, :w, :]
        video = np.pad(
            video,
            ((0, self.max_frames - t_real), (0, max(0, h - video.shape[1])),
             (0, max(0, w - video.shape[2])), (0, 0)),
        )[:, :h, :w, :]
        mask = np.zeros(self.max_frames, np.float32)
        mask[:t_real] = 1.0
        return {"video": video.astype(np.float32), "mask": mask}
