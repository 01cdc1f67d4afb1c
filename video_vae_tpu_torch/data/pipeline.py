"""Batched streaming dataloader: threaded and native backends.

The JAX package's ``data/pipeline.py`` in the port, on the same numpy code:
the same config and seed give the same batches, in the same order, from
both packages (shuffle, ``drop_remainder``, the process sharding and
``independent_shards``). A batch is ``{"video": (b, t, h, w, c) f32,
"mask": (b, t) f32}`` of host numpy arrays; the trainer moves it to the
device.

**Deliberate difference:** there is no ``"grain"`` backend. ``grain.python``
imports JAX and orbax, which the port never imports, so ``backend="grain"``
raises ``NotImplementedError``, and ``"auto"`` takes the synthetic source's
threaded loader, else the native loader where its library loads, else the
threaded one (the JAX ``auto`` tries grain before the threaded loader).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np

from video_vae_tpu_torch.core.config import DataConfig
from video_vae_tpu_torch.data.source import SyntheticVideoSource, VideoFileSource


def _make_source(cfg: DataConfig, seed: int, base_dir: Optional[str] = None):
    if cfg.synthetic:
        return SyntheticVideoSource(
            num_clips=cfg.synthetic_num_clips,
            max_frames=cfg.max_frames,
            resize=cfg.resize,
            seed=seed,
        )
    return VideoFileSource(
        base_dir=base_dir or cfg.base_dir,
        max_frames=cfg.max_frames,
        resize=cfg.resize,
        crop_size=cfg.crop_size,
        seed=seed,
        on_error=cfg.on_error,
    )


def _shard_params(cfg: DataConfig, seed: int, process_index: int, process_count: int):
    """(effective_seed, shard_index, shard_count) under the sharding policy."""
    if process_count > 1 and cfg.independent_shards:
        # each process: its own seed, the full dataset
        return seed * 10000 + process_index, 0, 1
    return seed, process_index, process_count


def _threaded_loader(
    source, cfg: DataConfig, seed: int, process_index: int, process_count: int
) -> Iterator[dict]:
    """Thread-pool prefetching batch iterator (no extra processes).

    A producer-thread exception is re-raised in the consumer: the epoch never
    silently truncates.
    """
    seed, shard_index, shard_count = _shard_params(cfg, seed, process_index, process_count)
    rng = np.random.default_rng(seed)
    indices = np.arange(len(source))
    if cfg.shuffle:
        rng.shuffle(indices)
    if shard_count > 1:
        indices = indices[shard_index::shard_count]
    n_batches = len(indices) // cfg.batch_size
    if not cfg.drop_remainder and len(indices) % cfg.batch_size:
        n_batches += 1

    def collate(batch_indices):
        records = [source[int(i)] for i in batch_indices]
        return {
            key: np.stack([r[key] for r in records], axis=0) for key in records[0]
        }

    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, cfg.prefetch_size))
    sentinel = object()
    failure: list = []

    def producer():
        try:
            for b in range(n_batches):
                chunk = indices[b * cfg.batch_size : (b + 1) * cfg.batch_size]
                if len(chunk) == 0:
                    break
                q.put(collate(chunk))
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            failure.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            break
        yield item


def _native_loader(
    cfg: DataConfig, seed: int, process_index: int, process_count: int,
    base_dir: Optional[str],
) -> Iterator[dict]:
    """Batch iterator over the C++ decode core (native/video_loader.cc):
    whole batches decoded concurrently outside the GIL, double-buffered so the
    next batch decodes while the device consumes the current one."""
    from video_vae_tpu_torch.data import native_loader
    from video_vae_tpu_torch.data.source import list_video_files

    paths = list_video_files(base_dir or cfg.base_dir)
    if not paths:
        raise FileNotFoundError(f"No video files under {base_dir or cfg.base_dir}")
    seed, shard_index, shard_count = _shard_params(cfg, seed, process_index, process_count)
    rng = np.random.default_rng(seed)
    indices = np.arange(len(paths))
    if cfg.shuffle:
        rng.shuffle(indices)
    if shard_count > 1:
        indices = indices[shard_index::shard_count]
    n_batches = len(indices) // cfg.batch_size
    if n_batches == 0:
        return

    def decode_paths(batch_paths, seeds):
        return native_loader.load_batch_native(
            batch_paths, cfg.max_frames, cfg.resize, cfg.crop_size, seeds,
            num_threads=max(1, cfg.num_workers),
        )

    def decode(b):
        chunk = [int(i) for i in indices[b * cfg.batch_size : (b + 1) * cfg.batch_size]]
        batch_paths = [paths[i] for i in chunk]
        seeds = [abs(hash((seed, i))) for i in chunk]
        videos, masks, errors = decode_paths(batch_paths, seeds)
        for attempt in range(1, 11):
            bad = [i for i, rc in enumerate(errors) if rc != 0]
            if not bad:
                break
            if cfg.on_error == "raise":
                raise RuntimeError(
                    f"native decode failed ({errors[bad[0]]}): {batch_paths[bad[0]]}"
                )
            if cfg.on_error == "zeros":
                # zeros + an all-ones mask
                for i in bad:
                    videos[i] = 0.0
                    masks[i] = 1.0
                break
            # "skip": re-decode deterministic replacement indices
            if attempt == 10:
                raise RuntimeError(
                    f"10 consecutive decode failures (on_error='skip'); "
                    f"last: {batch_paths[bad[0]]}"
                )
            re_rng = np.random.default_rng(abs(hash((seed, b, attempt))))
            batch_paths = list(batch_paths)
            for i in bad:
                batch_paths[i] = paths[int(re_rng.integers(0, len(paths)))]
            re_seeds = [abs(hash((seed, b, attempt, i))) for i in bad]
            new_videos, new_masks, new_errors = decode_paths(
                [batch_paths[i] for i in bad], re_seeds
            )
            errors = [0] * len(errors)
            for j, i in enumerate(bad):
                videos[i] = new_videos[j]
                masks[i] = new_masks[j]
                errors[i] = new_errors[j]
        return {"video": videos, "mask": masks}

    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(decode, 0)
        for b in range(n_batches):
            batch = pending.result()
            if b + 1 < n_batches:
                pending = pool.submit(decode, b + 1)
            yield batch


def create_dataloader(
    cfg: DataConfig,
    *,
    seed: Optional[int] = None,
    base_dir: Optional[str] = None,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[dict]:
    """Iterator of {"video": (b,t,h,w,c) f32, "mask": (b,t) f32} host batches."""
    seed = cfg.seed if seed is None else seed
    backend = cfg.backend
    if backend == "grain":
        raise NotImplementedError(
            "the grain backend imports JAX and is not ported; use 'threaded', 'native' or 'auto'"
        )
    if backend == "auto":
        if cfg.synthetic:
            backend = "threaded"
        else:
            from video_vae_tpu_torch.data import native_loader

            backend = "native" if native_loader.available() else "threaded"
    if backend == "native":
        return _native_loader(cfg, seed, process_index, process_count, base_dir)
    source = _make_source(cfg, seed, base_dir)
    return _threaded_loader(source, cfg, seed, process_index, process_count)
