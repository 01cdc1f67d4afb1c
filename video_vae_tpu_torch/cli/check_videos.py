"""Dataset corruption scanner: the JAX package's ``cli/check_videos.py`` in the port.

Probes every video with the real decode path (``data/video_io.py:load_video``,
OpenCV) on a thread pool, prints a ``CORRUPT: <path>: <error>`` line for each
failure and exits 1 if any file failed, else 0.

    python -m video_vae_tpu_torch.cli.check_videos --data_dir /path/videos --workers 32 [--device cpu]

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without
CUDA only ``--device cpu`` runs), the port's rule for its entry points; the
scan itself decodes on the host.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Scan a video dataset for corrupt files")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--workers", type=int, default=32)
    parser.add_argument("--max_frames", type=int, default=4)
    parser.add_argument("--resize", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np

    from video_vae_tpu_torch.core.device import resolve_device
    from video_vae_tpu_torch.data.source import list_video_files
    from video_vae_tpu_torch.data.video_io import load_video

    resolve_device(args.device)
    paths = list_video_files(args.data_dir)
    print(f"[check_videos] probing {len(paths)} files with {args.workers} threads")

    def probe(path):
        try:
            video, mask = load_video(
                path, max_frames=args.max_frames, resize=(args.resize, args.resize),
                crop_size=args.resize, rng=np.random.default_rng(0), on_error="raise",
            )
            assert video.shape[0] == args.max_frames
            return path, None
        except Exception as e:  # noqa: BLE001
            return path, str(e)

    bad = []
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for path, err in pool.map(probe, paths):
            if err is not None:
                bad.append((path, err))
                print(f"CORRUPT: {path}: {err}")
    print(f"[check_videos] {len(paths) - len(bad)} ok, {len(bad)} corrupt")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
