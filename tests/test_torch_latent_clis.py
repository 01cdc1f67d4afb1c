"""The port's latent CLIs, dataset scanner and small utils against the JAX package's, on the CPU.

``cli/cache_latents.py`` and ``cli/decode_latents.py`` run at ``--tiny`` on two
short videos written with OpenCV (32², 8 frames and 6 frames, the second
padded to ``--max_frames 8``). The JAX CLI gets no checkpoint, so it encodes
with its seeded weights (``nnx.Rngs(0, sampling=1)``); the test builds the
same JAX model, moves its weights across with ``load_jax_params`` and saves
them in the port's checkpoint format for the port's CLI. ``check_videos``
scans a good and a corrupt file with both CLIs; ``hist_diff_indices``,
``param_norm``, ``create_sinusoidal_embeddings`` and ``profile_trace`` are
held to the JAX package's where it has them.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import BF16_TOL

from video_vae_tpu.cli import cache_latents as jax_cache
from video_vae_tpu.cli import check_videos as jax_check
from video_vae_tpu.cli import decode_latents as jax_decode
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.ops.embeddings import create_sinusoidal_embeddings as jax_sinusoidal
from video_vae_tpu.utils.debug import param_norm as jax_param_norm
from video_vae_tpu_torch import VideoVAE, load_jax_params, tiny_config
from video_vae_tpu_torch.cli import cache_latents, check_videos, decode_latents
from video_vae_tpu_torch.ops.embeddings import create_sinusoidal_embeddings
from video_vae_tpu_torch.train.checkpoint import CHECKPOINT_FILE
from video_vae_tpu_torch.utils import param_norm, profile_trace

FRAMES = 8  # --max_frames: tiny_config's clips
CLIPS = {"a": 8, "b": 6}  # name: frames (b is padded)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread beside the other test workers (tests/test_torch_trainer.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_mp4(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, frames.shape[2:0:-1])
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Two videos (a scene cut halfway through each), the JAX model's seeded weights
    as a port checkpoint, and both CLIs' latents."""
    root = tmp_path_factory.mktemp("latents")
    videos = root / "videos"
    videos.mkdir()
    rng = np.random.default_rng(3)
    for name, t in CLIPS.items():
        base = rng.uniform(0, 255, (2, 4, 4, 3))
        frames = np.stack([np.kron(base[i * 2 // t], np.ones((8, 8, 1))) + rng.normal(0, 4, (32, 32, 3))
                           for i in range(t)])
        _write_mp4(videos / f"{name}.mp4", np.clip(frames, 0, 255).astype(np.uint8))

    jax_model = nnx.jit(lambda: JaxVideoVAE(jax_tiny_config().model, nnx.Rngs(0, sampling=1)))()
    params = {"/".join(map(str, p)): np.asarray(v.get_value()) for p, v in nnx.state(jax_model, nnx.Param).flat_state()}
    port = VideoVAE(tiny_config().model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    (root / "ckpt").mkdir()
    torch.save({"model": port.state_dict()}, root / "ckpt" / CHECKPOINT_FILE)

    args = ["--data_dir", str(videos), "--tiny", "--max_frames", str(FRAMES)]
    jax_cache.main(["--model_path", str(root / "no_checkpoint"), "--out_dir", str(root / "jax"), *args])
    cache_latents.main(["--model_path", str(root / "ckpt"), "--out_dir", str(root / "port"), *args,
                        "--device", "cpu"])
    return root, jax_model, port


def _rel(ours, theirs):
    return np.abs(ours - theirs).max() / np.abs(theirs).max()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_cache_latents_matches_jax(workdir, name):
    root, _, _ = workdir
    ours, theirs = np.load(root / "port" / f"{name}.npz"), np.load(root / "jax" / f"{name}.npz")
    assert set(ours.files) == set(theirs.files) == {"mean", "log_variance", "selection_prob", "mask",
                                                    "scene_changes", "source"}
    for key in ("mean", "log_variance", "selection_prob"):
        assert ours[key].dtype == theirs[key].dtype == np.float32 and ours[key].shape == theirs[key].shape
        assert _rel(ours[key], theirs[key]) <= BF16_TOL, key
    for key in ("mask", "scene_changes", "source"):
        assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key]), key
    assert ours["mask"].sum() == CLIPS[name] and ours["scene_changes"].tolist() == [0, CLIPS[name] // 2]


def test_cache_latents_warns_and_runs_without_a_checkpoint(tmp_path, capsys, workdir):
    root, _, _ = workdir
    cache_latents.main(["--model_path", str(tmp_path / "none"), "--data_dir", str(root / "videos"),
                        "--out_dir", str(tmp_path / "out"), "--tiny", "--max_frames", "4", "--device", "cpu"])
    assert "WARNING: checkpoint restore failed" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "out")) == ["a.npz", "b.npz"]


def test_decode_latents_matches_jax(workdir, monkeypatch, tmp_path):
    root, _, _ = workdir
    written = {}

    def capture(tag):
        def write_video(batch, path, fps=30.0, sample_index=0):
            written[tag] = (np.asarray(batch["video"], np.float32), np.asarray(batch["mask"]), fps)
        return write_video

    monkeypatch.setattr("video_vae_tpu.data.video_io.write_video", capture("jax"))
    monkeypatch.setattr("video_vae_tpu_torch.data.video_io.write_video", capture("port"))
    latents = str(root / "jax" / "b.npz")
    jax_decode.main(["--model_path", str(root / "no_checkpoint"), "--latents", latents, "--out", str(tmp_path / "j.mp4"),
                     "--tiny"])
    decode_latents.main(["--model_path", str(root / "ckpt"), "--latents", latents, "--out", str(tmp_path / "p.mp4"),
                         "--tiny", "--device", "cpu"])
    (ours, our_mask, fps), (theirs, their_mask, _) = written["port"], written["jax"]
    assert ours.shape == theirs.shape == (FRAMES, 32, 32, 3) and fps == 30.0
    assert np.array_equal(our_mask, their_mask) and our_mask.sum() == CLIPS["b"]
    assert _rel(ours, theirs) <= BF16_TOL


def _scan(main, data_dir, capsys, *extra):
    with pytest.raises(SystemExit) as exit_info:
        main(["--data_dir", str(data_dir), "--workers", "2", *extra])
    out = capsys.readouterr().out
    return exit_info.value.code, {line.split(": ")[1] for line in out.splitlines() if line.startswith("CORRUPT: ")}


def test_check_videos_matches_jax(tmp_path, capsys):
    _write_mp4(tmp_path / "good.mp4", np.full((5, 32, 32, 3), 128, np.uint8))
    (tmp_path / "broken.mp4").write_bytes(np.random.default_rng(0).bytes(4096))
    theirs = _scan(jax_check.main, tmp_path, capsys)
    ours = _scan(check_videos.main, tmp_path, capsys, "--device", "cpu")
    assert ours == theirs == (1, {str(tmp_path / "broken.mp4")})
    (tmp_path / "broken.mp4").unlink()
    assert _scan(check_videos.main, tmp_path, capsys, "--device", "cpu") == _scan(jax_check.main, tmp_path, capsys) == (
        0, set())


@pytest.mark.parametrize("main,args", [
    (cache_latents.main, ["--model_path", "m", "--data_dir", "d", "--out_dir", "o", "--tiny"]),
    (decode_latents.main, ["--model_path", "m", "--latents", "l.npz", "--out", "o.mp4", "--tiny"]),
    (check_videos.main, ["--data_dir", "d"]),
])
def test_clis_default_to_cuda(main, args):
    """Without a card each CLI raises unless asked for the CPU: none falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)


def test_hist_diff_indices_matches_jax():
    rng = np.random.default_rng(5)
    scenes = [rng.uniform(0, 1, (1, 16, 16, 3)) * rng.uniform(0.2, 1.0) for _ in range(4)]
    frames = np.concatenate([np.repeat(s, n, 0) + rng.normal(0, 0.01, (n, 16, 16, 3))
                             for s, n in zip(scenes, (3, 5, 2, 6))])
    frames = np.clip(frames, 0, 1).astype(np.float32)
    ours = cache_latents.hist_diff_indices(frames)
    assert ours == jax_cache.hist_diff_indices(frames) and ours[0] == 0 and len(ours) > 1
    assert cache_latents.hist_diff_indices(frames, threshold=0.1, bins=8) == jax_cache.hist_diff_indices(
        frames, threshold=0.1, bins=8)


def test_param_norm_matches_jax(workdir):
    _, jax_model, port = workdir
    ours, theirs = float(param_norm(port)), float(jax_param_norm(jax_model))
    assert abs(ours - theirs) <= 1e-6 * theirs and theirs > 0


# atol 1e-6 up to 16 positions; XLA's and torch's f32 exp differ by up to one ulp
# (2^-24 relative) in a frequency, which position p carries into the angle as p ulps:
# at 64 positions the bound is 64 · 2^-24 · 2 (both sides' rounding)
@pytest.mark.parametrize("seq_len,embed_dim,atol", [(16, 64, 1e-6), (8, 6, 1e-6), (64, 128, 64 * 2**-23)])
def test_create_sinusoidal_embeddings_matches_jax(seq_len, embed_dim, atol):
    ours = create_sinusoidal_embeddings(seq_len, embed_dim)
    theirs = np.asarray(jax_sinusoidal(seq_len, embed_dim))
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape == (1, seq_len, embed_dim)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=atol)
    assert np.abs(np.asarray(jax_sinusoidal(seq_len, embed_dim, 100.0)) -
                  create_sinusoidal_embeddings(seq_len, embed_dim, 100.0).numpy()).max() <= atol


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json") and os.path.getsize(tmp_path / "trace" / files[0]) > 0
    with profile_trace(None):  # a no-op
        pass
    with profile_trace(""):
        pass
    assert os.listdir(tmp_path) == ["trace"]
