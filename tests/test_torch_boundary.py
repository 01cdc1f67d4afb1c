"""The port's boundaries: no JAX inside it, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_vae_tpu_torch import VideoVAE, reconstruct, tiny_config
from video_vae_tpu_torch.cli import train as train_cli
from video_vae_tpu_torch.models import Discriminator, VideoMAE
from video_vae_tpu_torch.models.vgg import load_vgg
from video_vae_tpu_torch.ops.conv3d import conv3d_cf_cuda, conv3d_tapdot_cuda
from video_vae_tpu_torch.ops.flash_attention import fused_qkv_attention_cuda
from video_vae_tpu_torch.ops.fused_block import fused_mlp_sublayer_cuda
from video_vae_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib.util, pkgutil, sys
import video_vae_tpu_torch
for mod in pkgutil.walk_packages(video_vae_tpu_torch.__path__, "video_vae_tpu_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
banned = ("jax", "jaxlib", "flax", "orbax", "video_vae_tpu")
bad = [m for m in sys.modules if m.split(".")[0] in banned]
print("BAD", bad)
missing = [m for m in REQUIRED if m not in sys.modules]
print("MISSING", missing)
sys.exit(1 if bad or missing else 0)
"""
# modules the walk must reach (a package without an __init__ would drop out of it)
REQUIRED = (
    "video_vae_tpu_torch.cli.cache_latents", "video_vae_tpu_torch.cli.decode_latents",
    "video_vae_tpu_torch.cli.check_videos", "video_vae_tpu_torch.ops.embeddings",
    "video_vae_tpu_torch.utils.debug", "video_vae_tpu_torch.utils.metrics", "video_vae_tpu_torch.cli.train",
    "video_vae_tpu_torch.parallel.mesh", "video_vae_tpu_torch.parallel.sharding",
    "video_vae_tpu_torch.parallel.tensor_parallel", "video_vae_tpu_torch.parallel.dryrun",
    "video_vae_tpu_torch.models.classifier", "video_vae_tpu_torch.models.video_mae",
    "video_vae_tpu_torch.train.adversarial", "video_vae_tpu_torch.losses.losses",
)


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", f"REQUIRED = {REQUIRED!r}\n" + _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the rule under test needs a host without CUDA")
    cfg = tiny_config().model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoVAE(cfg)
    model = VideoVAE(cfg, device="cpu")
    video = np.zeros((1, 8, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reconstruct(model, video, np.ones((1, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_config(), install_signal_handlers=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--tiny", "--steps", "1", "--checkpoint_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_vgg(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Discriminator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoMAE(cfg)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it has no fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        fused_qkv_attention_cuda(torch.zeros(1, 4, 3 * 64), torch.ones(64), torch.ones(64), None, 1)
    x = torch.zeros(1, 2, 4, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_cf_cuda(x, None, torch.zeros(3, 3, 3, 4, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_tapdot_cuda(x.bfloat16(), None, torch.zeros(1, 3, 3, 4, 8).bfloat16(), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_sublayer_cuda(torch.zeros(1, 4, 8), torch.ones(8), torch.zeros(8), torch.zeros(8, 16),
                                torch.zeros(16), torch.zeros(16, 8), torch.zeros(8))
