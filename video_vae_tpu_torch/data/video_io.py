"""Video decode and encode at the host boundary.

A copy of the JAX package's ``data/video_io.py`` (numpy and OpenCV, no JAX),
so the port's data path imports nothing of that package. ``load_video``
takes a random temporal window, one random crop position shared by every
frame (upscaling a frame smaller than the crop first), resizes, scales to
[0, 1] and zero-pads to ``max_frames`` with a {0, 1} validity mask; the
error policy is explicit ("zeros": a zero video with an all-ones mask,
"skip": a typed error the source turns into a resample, "raise").
``write_video`` pipes raw RGB to ffmpeg, or writes with OpenCV where there
is no ffmpeg. OpenCV is imported under a guard: where it is missing (the
GPU machine), decoding fails by the error policy and writing needs ffmpeg.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

try:
    import cv2

    HAVE_CV2 = True
except Exception:  # pragma: no cover
    HAVE_CV2 = False


class VideoDecodeError(RuntimeError):
    """Raised by load_video(on_error='skip'|'raise') on any decode failure."""


def get_random_crop_params(
    h: int, w: int, crop_size: int, rng: np.random.Generator
) -> Tuple[int, int, int, int]:
    """(target_h, target_w, start_h, start_w); upscales first if too small."""
    if h < crop_size or w < crop_size:
        scale = max(crop_size / h, crop_size / w)
        h, w = int(h * scale), int(w * scale)
    start_h = int(rng.integers(0, h - crop_size + 1))
    start_w = int(rng.integers(0, w - crop_size + 1))
    return h, w, start_h, start_w


def apply_crop(frame: np.ndarray, crop_size: int, crop_params) -> np.ndarray:
    target_h, target_w, start_h, start_w = crop_params
    h, w = frame.shape[:2]
    if h != target_h or w != target_w:
        frame = cv2.resize(frame, (target_w, target_h))
    return frame[start_h : start_h + crop_size, start_w : start_w + crop_size]


def load_video(
    path: str,
    max_frames: Optional[int] = None,
    resize: Optional[Tuple[int, int]] = None,
    crop_size: int = 512,
    *,
    rng: Optional[np.random.Generator] = None,
    on_error: str = "zeros",
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode → (video (T,H,W,C) float32 in [0,1], mask (T,) float32)."""
    if rng is None:
        rng = np.random.default_rng()
    try:
        if not HAVE_CV2:
            raise VideoDecodeError("OpenCV unavailable")
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise VideoDecodeError(f"Could not open video: {path}")

        total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        start_frame = 0
        if max_frames is not None and total_frames > max_frames:
            start_frame = int(rng.integers(0, total_frames - max_frames + 1))
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)

        frames = []
        crop_params = None
        while True:
            if max_frames is not None and len(frames) >= max_frames:
                break
            ret, frame = cap.read()
            if not ret:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if crop_params is None:
                h, w = frame.shape[:2]
                crop_params = get_random_crop_params(h, w, crop_size, rng)
            frame = apply_crop(frame, crop_size, crop_params)
            if resize is not None:
                rh, rw = resize
                frame = cv2.resize(frame, (rw, rh))
            frames.append(frame)
        cap.release()

        if not frames:
            raise VideoDecodeError(f"No frames decoded from {path}")

        video = np.stack(frames, axis=0).astype(np.float32) / 255.0
        num_real = video.shape[0]
        if max_frames is not None and num_real < max_frames:
            pad = np.zeros((max_frames - num_real, *video.shape[1:]), np.float32)
            video = np.concatenate([video, pad], axis=0)
        mask = np.zeros(video.shape[0], np.float32)
        mask[:num_real] = 1.0
        return video, mask
    except Exception as e:  # noqa: BLE001 — error policy is the point
        if on_error == "raise" or isinstance(e, KeyboardInterrupt):
            raise
        if on_error == "skip":
            raise VideoDecodeError(str(e)) from e
        # "zeros": a zero video with an all-ones mask.
        if resize is None or max_frames is None:
            raise
        h, w = resize
        return (
            np.zeros((max_frames, h, w, 3), np.float32),
            np.ones(max_frames, np.float32),
        )


def write_video(
    batch: dict,
    output_path: str,
    fps: float = 30.0,
    sample_index: int = 0,
) -> None:
    """Write one clip from a batch dict {"video": (b,t,h,w,c) or (t,h,w,c), "mask"}.

    Values in [0,1]; padded (mask==0) frames are dropped. Prefers piping raw RGB
    to ffmpeg (libx264, crf 18); falls back to
    OpenCV's mp4v writer when no ffmpeg binary exists.
    """
    video = np.asarray(batch["video"], dtype=np.float32)
    if video.ndim == 5:
        video = video[sample_index]
    mask = batch.get("mask")
    if mask is not None:
        mask = np.asarray(mask)
        while mask.ndim > 2:
            mask = mask.reshape(mask.shape[0], -1)[:, : video.shape[0]]
        if mask.ndim == 2:
            mask = mask[min(sample_index, mask.shape[0] - 1)]
        keep = mask.astype(bool)[: video.shape[0]]
        if keep.any():
            video = video[keep]
    frames = np.clip(video * 255.0, 0, 255).astype(np.uint8)
    t, h, w, _ = frames.shape

    if shutil.which("ffmpeg"):
        cmd = [
            "ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
            "-s", f"{w}x{h}", "-pix_fmt", "rgb24", "-r", str(fps),
            "-i", "-", "-an", "-vcodec", "libx264", "-pix_fmt", "yuv420p",
            "-crf", "18", output_path,
        ]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stderr=subprocess.DEVNULL)
        proc.stdin.write(frames.tobytes())
        proc.stdin.close()
        if proc.wait() != 0:
            raise RuntimeError("ffmpeg failed")
    elif HAVE_CV2:
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
    else:  # pragma: no cover
        raise RuntimeError("Neither ffmpeg nor OpenCV available for video writing")
