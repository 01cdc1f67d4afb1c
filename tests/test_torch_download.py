"""The port's OpenVid-1M fetcher (``cli/download.py``) against the JAX package's.

A stand-in ``huggingface_hub`` serves small zips from a temporary store: shard
0 as one zip, shard 1 only as two parts (``partaa``, ``partab``), shard 2 not
at all. Both CLIs run into directories of their own; the file trees and the
printed lines must be the same.
"""

from __future__ import annotations

import io
import os
import shutil
import sys
import types
import zipfile

import pytest

from video_vae_tpu.cli import download as jax_download
from video_vae_tpu_torch.cli import download as port_download

SHARDS = ("0", "1", "2")


def _zip_bytes(files: dict) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return buf.getvalue()


@pytest.fixture
def hub(tmp_path, monkeypatch):
    """A stand-in ``huggingface_hub`` whose ``hf_hub_download`` copies from a store."""
    store = tmp_path / "store"
    store.mkdir()
    (store / "OpenVid_part0.zip").write_bytes(
        _zip_bytes({"a.mp4": b"clip a", "sub/b.mp4": b"clip b" * 100})
    )
    split = _zip_bytes({"c.mp4": b"clip c" * 300, "d.mp4": b"clip d"})
    (store / "OpenVid_part1_partaa").write_bytes(split[: len(split) // 2])
    (store / "OpenVid_part1_partab").write_bytes(split[len(split) // 2:])
    calls = []

    def hf_hub_download(repo_id, filename, repo_type, local_dir):
        calls.append((repo_id, filename, repo_type))
        source = store / filename
        if not source.exists():
            raise FileNotFoundError(f"{repo_id}: no {filename}")
        target = os.path.join(local_dir, filename)
        shutil.copyfile(source, target)
        return target

    module = types.ModuleType("huggingface_hub")
    module.hf_hub_download = hf_hub_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", module)
    return calls


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("keep_zips", [False, True])
def test_port_fetches_as_jax(hub, tmp_path, capsys, keep_zips):
    outputs = {}
    for name, cli in (("jax", jax_download), ("port", port_download)):
        out_dir = str(tmp_path / name)
        hub.clear()
        cli.main(["--out_dir", out_dir, "--shards", *SHARDS] + (["--keep_zips"] if keep_zips else []))
        outputs[name] = (_tree(out_dir), capsys.readouterr().out.replace(out_dir, "<out_dir>"), list(hub))
    (jax_tree, jax_out, jax_calls), (port_tree, port_out, port_calls) = outputs["jax"], outputs["port"]
    assert port_tree == jax_tree
    assert port_out == jax_out
    assert port_calls == jax_calls
    videos = {"videos0/a.mp4", "videos0/sub/b.mp4", "videos1/c.mp4", "videos1/d.mp4"}
    zips = {"OpenVid_part0.zip", "OpenVid_part1.zip", "OpenVid_part1_partaa", "OpenVid_part1_partab"}
    assert set(port_tree) == (videos | zips if keep_zips else videos)
    assert "[download] shard 2 unavailable; skipping" in port_out
    assert port_tree["videos1/c.mp4"] == b"clip c" * 300


def test_port_exits_as_jax_without_the_hub(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the import raises ImportError
    messages = []
    for name, cli in (("jax", jax_download), ("port", port_download)):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--out_dir", str(tmp_path / name)])
        messages.append(str(exc.value))
        assert not os.path.exists(tmp_path / name)
    assert messages[1] == messages[0]
    assert "huggingface_hub is not installed" in messages[1]
