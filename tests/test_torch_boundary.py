"""The port's boundaries: no JAX inside it, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_vae_tpu_torch import VideoVAE, reconstruct, tiny_config
from video_vae_tpu_torch.ops.conv3d import conv3d_cf_cuda, conv3d_tapdot_cuda
from video_vae_tpu_torch.ops.flash_attention import fused_qkv_attention_cuda
from video_vae_tpu_torch.ops.fused_block import fused_mlp_sublayer_cuda

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
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the rule under test needs a host without CUDA")
    cfg = tiny_config().model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VideoVAE(cfg)
    model = VideoVAE(cfg, device="cpu")
    video = np.zeros((1, 8, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reconstruct(model, video, np.ones((1, 8), np.float32))


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
