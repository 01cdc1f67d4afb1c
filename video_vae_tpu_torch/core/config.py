"""Configuration dataclasses of the PyTorch port.

Field names and defaults are those of the JAX package's ``core/config.py``
(a test holds the field sets equal), so one config describes both models.
Layout-only fields (``unet_layout``, ``unet_s2d_full``, ``unet_s2d_last``)
are accepted and change nothing here: the port always computes the unpacked
channels-first math, which those options leave unchanged in the JAX package.
So the environment knob ``VVT_TAPDOT=1`` (read at every conv call) acts on the
unpacked convs only: a kt = 1 conv with at least 128 input channels on a
frame at least 128 wide, in bf16, goes to the tap-dot kernel, forward and
input gradient; the flagship's UNet has none, a ``temporal_kernel=1,
unet_base_features=64`` one has four (and four input gradients).
``VVT_MLP_FUSED=1`` (read at every call) routes each block's two MLP
sublayers through the one-kernel MLP sublayer, and ``VVT_ATTN_SUBLAYER=1``
each attention sublayer through its one-kernel form; both multiply bf16
operands whatever ``dtype`` is.
``attention_impl`` picks the attention chain of every block (``"fused"``,
``"xla"`` or ``"pallas"``) and ``scan_rollout_decode`` decodes the paired
rollouts one at a time, as in the JAX package.
``remat`` acts as in the JAX package: in training, each ``FactoredAttention``
block and each UNet down and up block runs under activation checkpointing
(same math, less memory, a second forward in the backward).

``MeshConfig``, ``DataConfig`` and ``TrainConfig`` carry the JAX package's
fields and defaults for the data pipeline (``data/``) and the trainer
(``train/trainer.py``, ``cli/train.py``). The port trains on one device: a
mesh other than one data-parallel device is refused by the trainer.
``DynamicHParams`` holds the per-step loss weights and the compression-rate
target as plain floats.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the VideoVAE (defaults: the flagship 256² model)."""

    height: int = 256
    width: int = 256
    channels: int = 3
    patch_size: int = 16
    encoder_depth: int = 9
    decoder_depth: int = 12
    mlp_dim: int = 1536
    num_heads: int = 8
    qkv_features: int = 512
    max_temporal_len: int = 64
    spatial_compression_rate: int = 8
    unembedding_upsample_rate: int = 4

    selection_mode: str = "rl"
    selection_logit_bias: float = 1.0
    gumbel_temperature: float = 1.0

    unet_base_features: int = 16
    unet_levels: int = 3
    temporal_kernel: int = 3
    unet_layout: str = "cf"
    unet_s2d_last: bool = False
    unet_s2d_full: bool = True

    rope_max_len: int = 8192
    rope_base: float = 10000.0
    rope_alpha: float = 1.0

    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_rollout_decode: bool = False
    attention_impl: str = "fused"

    def __post_init__(self):
        if self.height % self.patch_size or self.width % self.patch_size:
            raise ValueError("height and width must be multiples of patch_size")
        if self.qkv_features % self.num_heads:
            raise ValueError("qkv_features must be a multiple of num_heads")
        if self.selection_mode not in ("rl", "ste", "none"):
            raise ValueError(f"unknown selection_mode {self.selection_mode!r}")
        if self.attention_impl not in ("xla", "pallas", "fused"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.unet_layout not in ("nhwc", "cf"):
            raise ValueError(f"unknown unet_layout {self.unet_layout!r}")
        if self.dtype not in _DTYPES or self.param_dtype not in _DTYPES:
            raise ValueError("dtype and param_dtype must be 'bfloat16' or 'float32'")

    @property
    def grid_h(self) -> int:
        return self.height // self.patch_size

    @property
    def grid_w(self) -> int:
        return self.width // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def embed_dim(self) -> int:
        """Token embedding width = p*p*c (patch pixels are the embedding)."""
        return self.channels * self.patch_size * self.patch_size

    @property
    def latent_dim(self) -> int:
        return self.embed_dim // self.spatial_compression_rate

    @property
    def head_dim(self) -> int:
        return self.qkv_features // self.num_heads

    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def params_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LossConfig:
    """Loss variant selection (used by the training slice)."""

    selection_penalty: str = "abs"
    rl_objective: str = "log_prob"
    kl_normalizer: str = "kept_frames"
    use_perceptual: bool = True
    use_adversarial: bool = False
    vgg_layout: str = "nhwc"
    perceptual_chunk_frames: int = 32

    def __post_init__(self):
        if self.selection_penalty not in ("square", "abs"):
            raise ValueError(f"unknown selection_penalty {self.selection_penalty!r}")
        if self.rl_objective not in ("normalized_prod", "log_prob"):
            raise ValueError(f"unknown rl_objective {self.rl_objective!r}")
        if self.kl_normalizer not in ("seq_len", "kept_frames"):
            raise ValueError(f"unknown kl_normalizer {self.kl_normalizer!r}")
        if self.vgg_layout not in ("nhwc", "cf"):
            raise ValueError(f"unknown vgg_layout {self.vgg_layout!r}")

    def replace(self, **kw) -> "LossConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer and LR schedule (used by the training slice)."""

    learning_rate: float = 2e-5
    warmup_steps: int = 14142
    decay_steps: int = 1_000_000
    end_value_factor: float = 0.1
    clip_global_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999

    def replace(self, **kw) -> "OptimConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes: data (over the batch), fsdp (parameter shards), tensor.

    The port runs on one device (ROADMAP Queue 1 item 6): the trainer takes
    data ∈ {-1, 1} with fsdp = tensor = 1 and refuses any other mesh.
    """

    data: int = -1  # -1: use all remaining devices
    fsdp: int = 1
    tensor: int = 1

    axis_names: Tuple[str, str, str] = ("data", "fsdp", "tensor")

    def replace(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DataConfig:
    """Video data pipeline (``data/pipeline.py``)."""

    base_dir: str = "/mnt/t9/videos"
    eval_dir: Optional[str] = None
    batch_size: int = 2
    max_frames: int = 32
    resize: Tuple[int, int] = (256, 256)
    crop_size: int = 512
    shuffle: bool = True
    num_workers: int = 4
    prefetch_size: int = 16
    drop_remainder: bool = True
    seed: int = 0
    # a decode failure: "zeros" gives a zero video with an all-ones mask,
    # "skip" resamples another clip, "raise" propagates
    on_error: str = "zeros"
    # multi-process sampling: False partitions every epoch across processes,
    # True has each process sample its full dataset with its own seed
    independent_shards: bool = False
    synthetic: bool = False
    synthetic_num_clips: int = 64
    # "threaded" | "native" | "auto"; "grain" is not available in the port
    backend: str = "auto"

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training driver (``train/trainer.py``)."""

    num_epochs: int = 100
    seed: int = 3
    model_seed: int = 2
    # each epoch halves the batch and doubles the frames, up to these caps
    curriculum: bool = True
    curriculum_max_frames: int = 64
    curriculum_min_batch: int = 1
    # the compression-rate target: initial until this step, then relaxed;
    # a resumed run takes the resume value
    negative_penalty_training_steps: int = 2000
    initial_max_compression_rate: float = 2.0
    relaxed_max_compression_rate: float = 10000.0
    resume_max_compression_rate: float = 100000.0

    log_every: int = 50
    video_every: int = 500
    checkpoint_every_steps: int = 10_000
    checkpoint_dir: str = "checkpoints"
    video_save_dir: str = "outputs"
    # a JAX buffer-donation switch; the port's step updates in place either way
    donate_state: bool = True
    # torch.profiler trace of steps [profile_start_step, + profile_num_steps)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # gs://bucket/run: video dumps and checkpoints mirrored there by gcloud
    gcs_upload_prefix: Optional[str] = None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class VAEConfig:
    """Top-level bundle."""

    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "VAEConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**model_overrides) -> VAEConfig:
    """The CPU-sized config the tests use (same values as the JAX package's)."""
    kwargs = dict(
        height=32,
        width=32,
        channels=3,
        patch_size=8,
        encoder_depth=1,
        decoder_depth=1,
        mlp_dim=64,
        num_heads=2,
        qkv_features=32,
        max_temporal_len=8,
        spatial_compression_rate=4,
        unembedding_upsample_rate=2,
        unet_base_features=4,
        unet_levels=1,
        remat=False,
    )
    kwargs.update(model_overrides)
    return VAEConfig(
        model=ModelConfig(**kwargs),
        data=DataConfig(batch_size=2, max_frames=8, resize=(32, 32), synthetic=True),
        optim=OptimConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=1000),
        loss=LossConfig(use_perceptual=False),
    )


@dataclass(frozen=True)
class DynamicHParams:
    """Per-step loss weights and schedule targets (the JAX ``DynamicHParams``)."""

    gamma_selection: float = 0.2
    gamma_kl: float = 1e-3
    gamma_perceptual: float = 0.1
    gamma_mae: float = 0.05
    rl_loss_weight: float = 0.01
    max_compression_rate: float = 2.0
    magnify_negatives_rate: float = 100.0

    @classmethod
    def default(cls, **overrides) -> "DynamicHParams":
        return cls(**overrides)

    def with_compression_rate(self, rate: float) -> "DynamicHParams":
        return dataclasses.replace(self, max_compression_rate=float(rate))
