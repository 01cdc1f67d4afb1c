"""The port's data path against the JAX package's: the same bytes, the same batches.

Sources, the threaded and native loaders and the decode-error policies run
the same numpy, OpenCV and native code in both packages, so every array is
held equal exactly. Clips are written into ``tmp_path`` with OpenCV.
"""

import os

import numpy as np
import pytest

from video_vae_tpu.core.config import DataConfig as JaxDataConfig
from video_vae_tpu.data import native_loader as jax_native
from video_vae_tpu.data import source as jax_source
from video_vae_tpu.data.pipeline import create_dataloader as jax_create_dataloader
from video_vae_tpu_torch.core.config import DataConfig
from video_vae_tpu_torch.data import native_loader, source
from video_vae_tpu_torch.data.pipeline import create_dataloader
from video_vae_tpu_torch.data.video_io import HAVE_CV2, load_video, write_video

needs_cv2 = pytest.mark.skipif(not HAVE_CV2, reason="OpenCV unavailable")


def _write_clips(root, frames=(6, 4, 9), size=48, corrupt=False):
    """Clips of ``frames`` frames under root/videos0 (and a corrupt file if asked)."""
    shard = os.path.join(root, "videos0")
    os.makedirs(shard)
    rng = np.random.default_rng(0)
    for i, t in enumerate(frames):
        video = rng.random((t, size, size, 3)).astype(np.float32)
        write_video({"video": video}, os.path.join(shard, f"clip{i}.mp4"))
    if corrupt:
        with open(os.path.join(shard, "zz_bad.mp4"), "wb") as f:
            f.write(b"not a video")
    return str(root)


def _both(**fields):
    return DataConfig(**fields), JaxDataConfig(**fields)


def _assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 5), (3, 2), (17, 11)])
def test_synthetic_source_gives_jax_bytes(seed, index):
    args = dict(num_clips=16, max_frames=12, resize=(24, 20), seed=seed)
    ours = source.SyntheticVideoSource(**args)[index]
    theirs = jax_source.SyntheticVideoSource(**args)[index]
    for key in ("video", "mask"):
        assert ours[key].tobytes() == theirs[key].tobytes()


@needs_cv2
def test_file_source_gives_jax_bytes(tmp_path):
    root = _write_clips(tmp_path)
    assert source.list_video_files(root) == jax_source.list_video_files(root)
    args = dict(base_dir=root, max_frames=8, resize=(16, 16), crop_size=32)
    for seed in (0, 4):
        ours = source.VideoFileSource(seed=seed, **args)
        theirs = jax_source.VideoFileSource(seed=seed, **args)
        for index in range(len(ours)):
            for key in ("video", "mask"):
                assert ours[index][key].tobytes() == theirs[index][key].tobytes()


LOADER_CASES = {
    "shuffle": (dict(shuffle=True), 0, 1),
    "in order": (dict(shuffle=False), 0, 1),
    "remainder kept": (dict(shuffle=True, drop_remainder=False), 0, 1),
    "process 1 of 2": (dict(shuffle=True), 1, 2),
    "process 2 of 3, remainder kept": (dict(shuffle=True, drop_remainder=False), 2, 3),
    "independent shards": (dict(shuffle=True, independent_shards=True), 1, 2),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_threaded_loader_gives_jax_batches(case):
    fields, index, count = LOADER_CASES[case]
    ours, theirs = _both(synthetic=True, synthetic_num_clips=11, batch_size=3, max_frames=6,
                         resize=(16, 16), backend="threaded", prefetch_size=2, **fields)
    for seed in (0, 7):
        _assert_same_batches(
            create_dataloader(ours, seed=seed, process_index=index, process_count=count),
            jax_create_dataloader(theirs, seed=seed, process_index=index, process_count=count),
        )


@needs_cv2
def test_threaded_file_loader_gives_jax_batches(tmp_path):
    root = _write_clips(tmp_path, frames=(6, 4, 9, 7))
    ours, theirs = _both(base_dir=root, batch_size=2, max_frames=8, resize=(16, 16), crop_size=32,
                         backend="threaded", num_workers=2)
    _assert_same_batches(create_dataloader(ours, seed=5), jax_create_dataloader(theirs, seed=5))


@needs_cv2
@pytest.mark.parametrize("on_error", ["zeros", "skip"])
def test_native_loader_gives_jax_batches(tmp_path, on_error):
    if not (native_loader.available() and jax_native.available()):
        pytest.skip("native library not built (make -C native)")
    root = _write_clips(tmp_path, frames=(6, 4, 9), size=64, corrupt=True)
    ours, theirs = _both(base_dir=root, batch_size=2, max_frames=8, resize=(32, 32), crop_size=48,
                         backend="native", num_workers=2, on_error=on_error)
    for seed in (0, 1):
        _assert_same_batches(create_dataloader(ours, seed=seed), jax_create_dataloader(theirs, seed=seed))


@needs_cv2
def test_auto_backend_picks_native_for_files_and_threaded_for_synthetic(tmp_path):
    root = _write_clips(tmp_path)
    cfg = DataConfig(base_dir=root, batch_size=1, max_frames=4, resize=(16, 16), crop_size=32)
    batches = list(create_dataloader(cfg))
    assert len(batches) == 3
    if native_loader.available():
        explicit = cfg.replace(backend="native")
        _assert_same_batches(batches, create_dataloader(explicit))
    synthetic = cfg.replace(synthetic=True, synthetic_num_clips=4)
    _assert_same_batches(create_dataloader(synthetic), create_dataloader(synthetic.replace(backend="threaded")))


@needs_cv2
def test_error_policies_match_jax(tmp_path):
    root = _write_clips(tmp_path, frames=(4,), size=32, corrupt=True)
    args = dict(base_dir=root, max_frames=4, resize=(16, 16), crop_size=16)
    bad = 1  # sorted: clip0.mp4, zz_bad.mp4
    zeros = source.VideoFileSource(on_error="zeros", **args)[bad]
    assert zeros["video"].max() == 0.0 and zeros["mask"].min() == 1.0  # zeros + all-ones mask
    theirs = jax_source.VideoFileSource(on_error="zeros", **args)[bad]
    assert zeros["video"].tobytes() == theirs["video"].tobytes()
    assert zeros["mask"].tobytes() == theirs["mask"].tobytes()

    skipped = source.VideoFileSource(on_error="skip", **args)[bad]  # a resampled real clip
    theirs = jax_source.VideoFileSource(on_error="skip", **args)[bad]
    assert skipped["video"].max() > 0.0 and skipped["mask"].sum() == 4
    assert skipped["video"].tobytes() == theirs["video"].tobytes()

    with pytest.raises(Exception) as ours_raised:
        source.VideoFileSource(on_error="raise", **args)[bad]
    with pytest.raises(Exception) as theirs_raised:
        jax_source.VideoFileSource(on_error="raise", **args)[bad]
    assert type(ours_raised.value).__name__ == type(theirs_raised.value).__name__


@needs_cv2
def test_skip_exhaustion_and_producer_error_propagate(tmp_path):
    shard = os.path.join(tmp_path, "videos0")
    os.makedirs(shard)
    for name in ("a", "b"):
        with open(os.path.join(shard, f"{name}.mp4"), "wb") as f:
            f.write(b"not a video")
    with pytest.raises(RuntimeError, match="consecutive decode failures"):
        source.VideoFileSource(str(tmp_path), max_frames=4, resize=(16, 16), crop_size=16, on_error="skip")[0]
    cfg = DataConfig(base_dir=str(tmp_path), batch_size=2, max_frames=4, resize=(16, 16), crop_size=16,
                     backend="threaded", on_error="skip", shuffle=False)
    with pytest.raises(RuntimeError, match="consecutive decode failures"):
        list(create_dataloader(cfg, seed=0))


@needs_cv2
def test_load_video_round_trip_matches_jax(tmp_path):
    from video_vae_tpu.data.video_io import load_video as jax_load_video

    root = _write_clips(tmp_path, frames=(6,), size=40)
    path = source.list_video_files(root)[0]
    ours = load_video(path, max_frames=8, resize=(16, 16), crop_size=32, rng=np.random.default_rng(3))
    theirs = jax_load_video(path, max_frames=8, resize=(16, 16), crop_size=32, rng=np.random.default_rng(3))
    assert ours[1][:6].sum() == 6 and ours[1][6:].sum() == 0 and ours[0][6:].max() == 0.0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_grain_backend_raises():
    cfg = DataConfig(synthetic=True, synthetic_num_clips=4, batch_size=2, max_frames=4, resize=(16, 16),
                     backend="grain")
    with pytest.raises(NotImplementedError, match="grain"):
        create_dataloader(cfg)
