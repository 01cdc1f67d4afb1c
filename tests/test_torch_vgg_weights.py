"""Pretrained VGG weights in the port: the ``.npz`` converter, ``load_vgg`` and the CLI.

A synthetic torchvision-style VGG16 state dict (no pretrained file can be
fetched) goes through the port's and the JAX package's converters; the
port's ``load_vgg(npz)`` features are held to the JAX ``load_vgg(npz)``
features in float32 on the same input.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_vae_tpu.models.vgg import convert_torchvision_state_dict as jax_convert
from video_vae_tpu.models.vgg import load_vgg as jax_load_vgg
from video_vae_tpu_torch.cli import convert_vgg
from video_vae_tpu_torch.core.config import LossConfig
from video_vae_tpu_torch.losses import make_perceptual_loss_fn
from video_vae_tpu_torch.models.vgg import PERCEPTUAL_LAYERS, convert_torchvision_state_dict, load_vgg
from video_vae_tpu_torch.train.step import build_perceptual

FEATURE_TOL = 1e-5  # max-abs error over max|JAX feature|, float32 on both sides


def _torchvision_state_dict(seed=0):
    """vgg16's ``features`` convs through conv3_1 and one classifier layer, random values."""
    gen = torch.Generator().manual_seed(seed)
    layers = {0: (64, 3), 2: (64, 64), 5: (128, 64), 7: (128, 128), 10: (256, 128)}
    sd = {}
    for idx, (cout, cin) in layers.items():
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{idx}.bias"] = 0.1 * torch.randn(cout, generator=gen)
    sd["classifier.0.weight"] = torch.randn(8, 16, generator=gen)
    return sd


@pytest.fixture(scope="module")
def npz_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("vgg")
    sd = _torchvision_state_dict()
    ours, theirs = str(root / "ours.npz"), str(root / "jax.npz")
    convert_torchvision_state_dict({k: v.numpy() for k, v in sd.items()}, ours)
    jax_convert({k: v.numpy() for k, v in sd.items()}, theirs)
    return ours, theirs, sd


def test_converter_writes_the_jax_arrays(npz_paths):
    ours, theirs, sd = npz_paths
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) == sorted(
        f"{n}.{p}" for n in ("conv1_1", "conv1_2", "conv2_1") for p in ("kernel", "bias"))
    for key in a.files:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(a["conv2_1.kernel"], sd["features.5.weight"].numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("normalize", [True, False])
def test_load_vgg_npz_features_match_jax(npz_paths, normalize):
    ours_path, _, _ = npz_paths
    x = np.random.default_rng(1).uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    port = load_vgg(ours_path, normalize=normalize, dtype=torch.float32, device="cpu")
    theirs = jax_load_vgg(ours_path, normalize=normalize, dtype=jnp.float32)(jnp.asarray(x))
    with torch.no_grad():
        feats = port(torch.from_numpy(x))
    for layer in PERCEPTUAL_LAYERS:
        want = np.asarray(theirs[layer]).transpose(0, 3, 1, 2)  # NHWC → the port's NCHW
        got = feats[layer].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max(), layer
    assert not any(p.requires_grad for p in port.parameters())


def test_load_vgg_checks_its_file(tmp_path, npz_paths):
    with pytest.raises(FileNotFoundError):
        load_vgg(str(tmp_path / "missing.npz"), device="cpu")
    data = dict(np.load(npz_paths[0]))
    data["conv1_2.kernel"] = data["conv1_2.kernel"][..., :32]
    np.savez(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="conv1_2"):
        load_vgg(str(tmp_path / "bad.npz"), device="cpu")
    with pytest.warns(UserWarning, match="RANDOM VGG filters"):
        load_vgg(None, device="cpu")
    # the cf layout reads the same file into the same filters; an unknown layout is refused
    cf, nhwc = (load_vgg(npz_paths[0], layout=layout, device="cpu") for layout in ("cf", "nhwc"))
    assert cf.layout == "cf" and all(torch.equal(a, b) for a, b in zip(cf.parameters(), nhwc.parameters()))
    with pytest.raises(ValueError, match="layout"):
        load_vgg(None, layout="nchw", device="cpu")


def test_build_perceptual_reads_the_npz(npz_paths):
    path = npz_paths[0]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 2, 16, 16, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (1, 2, 16, 16, 3)).astype(np.float32))
    loaded = build_perceptual(LossConfig(), path, device="cpu")(x, target, 2)
    direct = make_perceptual_loss_fn(load_vgg(path, device="cpu"))(x, target, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        random = build_perceptual(LossConfig(), None, device="cpu")(x, target, 2)
    assert torch.equal(loaded, direct) and not torch.equal(loaded, random)


def test_convert_vgg_cli_on_a_pth(tmp_path, npz_paths, capsys):
    _, theirs, sd = npz_paths
    pth, out = str(tmp_path / "vgg16.pth"), str(tmp_path / "out.npz")
    torch.save(sd, pth)
    convert_vgg.main([pth, out])
    assert "wrote" in capsys.readouterr().out and os.path.exists(out)
    a, b = np.load(out), np.load(theirs)
    for key in b.files:
        np.testing.assert_array_equal(a[key], b[key])
