#!/usr/bin/env python3
"""Drive the PyTorch port's serving pass and train step on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds the port's nine CUDA kernels from ``video_vae_tpu_torch/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, at every
   shape its path gives it (the fused attention forward and backward, the
   plain masked attention forward and backward, the one-entry-point
   attention sublayer, the one-entry-point MLP sublayer in both variants, the
   conv forward, its input gradient through the same kernel, its pooled
   second output, the filter gradient, and the tap-dot conv; the convs at the
   flagship UNet's shapes and at the tap-dot model's, where the gate decides
   which kernel a shape goes to), and times the kernel, the plain version and
   one library call (or chain of calls) for the same function; every
   "kernel-check" line but the fused attention forward's adds the kernel's and
   the library call's device time per call from ``torch.profiler``
   (``device_ms``, ``library_device_ms``), the convs', the plain attention
   forward's and both attention backwards' the kernel's TFLOP/s too; the fused attention forward has an
   "attention-fwd" line per shape with its and SDPA's device time and its
   TFLOP/s and GB/s; the MLP sublayer's lines add the device time of each of
   its three launches (token LN, xa·W1, a·W2) and each product's TFLOP/s, the
   attention sublayer's of each of its four (token LN, xa·Wqkv, the
   attention, o·Wout; f32 x also the cast of o to bf16) and each product's
   TFLOP/s; the tap-dot conv's of its launches (the channels-last copies,
   the GEMM), with a "tapdot-vs-direct" line per shape beside the direct
   conv's (#2's) device time and TFLOP/s on the same operands.
   The fused attention forward and backward, the plain attention forward
   and backward, the MLP sublayer in both variants, the direct conv, the
   tap-dot conv and the filter gradient give the same bits on two launches,
   and both attention
   forwards and both backwards are held at a sequence whose keys are all
   masked;
2. runs the serving pass (encode → keep/drop → fill-blend → decode) at the
   flagship width and reduced depth in float32 on the card and on the CPU,
   with the same seeded weights, and compares the two, once per path
   (``attention_impl="fused"``, ``"pallas"``, ``"fused"`` with
   ``VVT_ATTN_SUBLAYER=1``, and ``"fused"`` with ``VVT_MLP_FUSED=1``);
3. runs the full-depth flagship serving pass in bfloat16 on a batch of
   2 clips × 16 frames on each of those paths and on the combined one
   (``VVT_ATTN_SUBLAYER=1`` with ``VVT_MLP_FUSED=1``): checks the output (the
   new paths against the default path's), counts the kernels' launches in
   one pass, times the pass, then traces passes with ``torch.profiler`` and
   prints device time per launching torch op (and per kernel for the port's
   own) and the device's idle share;
4. runs one float32 train step (RL forward, the full objective with the VGG
   perceptual loss, backward) at the flagship width and depth 1 on the card
   and on the CPU with the same weights and random draws, and compares the
   loss, every metric and every parameter's gradient; likewise one train
   step with ``selection_mode="ste"``, one with ``scan_rollout_decode=True``
   and the eval step's metrics (``psnr_sampled`` too);
5. runs the full-depth flagship train step in bfloat16 on 1 clip × 16
   frames (remat off) on each of the four paths: counts every kernel's
   launches in one step, checks the loss, the gradient norm and the update,
   times the steps, holds the new paths' loss to the default path's for the
   same draws, checks (default path) that a remat-on step gives the same
   loss and gradients, and profiles a step;
6. runs the serving pass and the train step of the tap-dot path: the model
   with a kt = 1 UNet of base width 64 (``ModelConfig(temporal_kernel=1,
   unet_base_features=64, unet_s2d_full=False)``, the UNet at full size, the
   transformer cut to depth 1) with ``VVT_TAPDOT=1``, held to the same model
   and weights with ``VVT_TAPDOT=0``, launches counted exactly on both;
7. drives the training entry point: ``Trainer`` on the config
   ``cli/train.py --synthetic`` builds (the flagship at full width, the
   transformer cut to ``TRAINER_DEPTH`` blocks, b2 x 32 frames, remat on,
   perceptual on with the random VGG) over 6
   synthetic clips: ``run_epoch(0)`` (3 steps, the video dump on the last, a
   checkpoint) and ``run_eval(0)``, each step's launches counted; checks the
   logged metrics, restores a fresh ``Trainer`` from the checkpoint bit-exactly
   and takes a step, holds step 1 to ``train_step`` called by hand on the same
   state, batch and draws, and prints a "trainer" line (ms per step, device ms
   and idle share from ``torch.profiler``, the host's data wait, checkpoint
   save and restore seconds, peak memory, the parameter count). Kernels #1-#4
   are held to their plain versions at the trainer's shapes beforehand;
8. holds the attention kernels (#1, #3, #5, #6, #7) at head_dim 16 and 32 to
   their plain versions, at the calls of the ``--tiny`` and ``--small``
   presets' train steps (head_dim 16) and at the same shapes with head_dim 32,
   in bf16 and f32, masked, with a fully masked sequence, the same bits twice;
   #2 and #4 at tiny's UNet; and #2 at the ``cf`` VGG's six shapes (three
   convs, three input gradients) beside cuDNN. Then the "tiny" phase runs
   ``cli/train.py``'s ``main`` with ``--synthetic --tiny --steps 5`` under its
   default device (every step's launches counted and held), the float32 tiny
   train step card against CPU ("f32-tiny"), one ``--small`` train step
   ("train-small": launches, device ms, peak memory), and the flagship b1 x 16f
   step with ``LossConfig(vgg_layout="cf")`` held to the ``train`` line's loss,
   perceptual term and keep decisions ("train-vgg-cf": 39 launches of #2, 15 of
   #4, device ms, and the VGG's forward and backward alone in both layouts);
9. holds the attention kernels (#1, #3, #5, #6, #7) at head_dim 128 to their
   plain versions at the calls of a ``ModelConfig(num_heads=4)`` train step
   (the flagship's width in 4 heads of 128), bf16 and f32, masked, with a
   fully masked sequence, the same bits twice, SDPA beside each; #1-#4 at the
   curriculum's second bucket, b1 x 64 frames; runs that model's full-depth
   bf16 b1 x 16f train step ("train-h4": 42 launches of #1 and of #3, device
   ms) and its f32 depth-1 step card against CPU ("f32-h4"); likewise at head
   dims the kernels pad to the next instantiation: the calls of
   ``ModelConfig(qkv_features=768)`` (8 heads of 96, run at 128) and #1, #3,
   #5, #6, #7 at D = 8, 24, 48 and 96 up to S = 1024 (SDPA at the true D and
   the padding's own device ms beside each), then that model's full-depth bf16
   b2 x 16f serving pass and b1 x 16f train step ("serving-d96", "train-d96":
   the flagship's launches, 21 of #3 on its wgmma tile) and its f32 depth-1 step
   card against CPU ("f32-d96"); then
   ``cli/cache_latents.py`` and ``cli/decode_latents.py`` at their defaults on
   two synthetic clips through an in-memory video source ("cache-latents",
   "decode-latents": launches per video, the written latents and video
   equal to a hand-called model's bit for bit, clips/s, device ms a clip,
   peak memory); then #3's wgmma tile kernel (64 < S <= 256 at head dims 64
   and 128) at the spatial calls of those steps, the MAE's S = 196 and S = 65,
   masked with a sequence that keeps no key, the same bits twice ("tile-bwd":
   device ms beside SDPA's backward and the bound; the "kernels" line counts its
   launches as ``wgmma_tile_launches``);
10. runs the trainer of step 7 across ranks. "dist-nccl": a process group of
   one rank on NCCL, in this process with the environment
   ``torch.distributed.run`` gives rank 0 of 1; step 1 must equal step 7's
   one-process step 1 bit for bit; launches held, ms per step, device ms and
   peak memory beside step 7's. "dist-gloo-2": this script relaunches itself
   (``--dist-worker``) under ``python -m torch.distributed.run`` as two ranks
   on the one card on gloo, data=2 (b1 x 32 frames a rank), then fsdp=2 and tensor=2 (4 heads a
   rank), these two stopped after their first step through the trainer's
   shutdown flag: each rank's rows and launches held (tensor=2 launches no fused
   attention: the chain, read from the dispatch log), step 1 held to the
   one-process step 1. #1-#4 are held to their plain versions at the data=2
   run's local shapes beforehand (the ``dist-gloo-2`` path of ``by_path``).

11. holds #1 and #3 at the VideoMAE's b4 x 16f calls at 224² ("mae-kernels": the
   spatial calls at S = 196, a partial last 16-row tile, and the temporal ones under
   clip 1's padding, each with SDPA beside it), then drives ``VideoMAE`` at the
   flagship's width and depth at 224² with mask ratio 0.9 ("mae": a training
   forward with ``torch.autograd.grad`` of ``mae_loss``, 52 launches of #1 and 26 of
   #3, and an eval forward, 26 of #1; device ms, idle share, peak memory) and its
   float32 depth-1 forward and gradients card against CPU with an injected token
   mask ("f32-mae");
12. drives the GAN step (``train/adversarial.py``) on step 5's model and batch with
   a full-width ``Discriminator()`` ("train-gan": the train step's launches of
   #1-#4 exactly, the discriminator's convs being cuDNN's; device ms, idle share,
   peak memory and the discriminator's share of the device ms), and one float32
   GAN step card against CPU at depth 1 with a smaller discriminator ("f32-gan":
   metrics, both models' gradients, every spectral norm's ``u``);
13. imports a reference checkpoint's tree ("reference-import": a seeded flagship's
   parameters as nested dicts, lists and ``.value`` leaves with RoPE caches, into a
   flagship of another seed through ``import_reference_state``: every parameter and
   one bf16 b2 x 16f serving pass the same bits, a changed shape refused with the
   model left as it was), and times the serving pass with the slope timer
   ("slope-serving": ``utils/timing.py:robust_slope`` over chains of 2 and 6 passes,
   beside the "serving" phase's median and device ms). Each pass launches the
   serving path's kernels, counted and held;
14. drives the flagship at 512² (``cli/train.py --resize 512``), whose spatial calls
   (S = 1024) take the attention kernels' split variant; its kernels are held
   beforehand, after step 9's checks ("long-seq-kernels": #1, #3, #5, #6 and #7 at the
   calls of its serving pass and train step, spatial S = 1024 and temporal S = 16,
   counted on the 512² paths, with the flagship's gates; at S = 257 and 576 at head_dim
   64, and also 1024 at 128, masked, bf16 and f32; #1, #5 and #7's split forward at head
   dims 16 to 128, unmasked and masked, device ms beside SDPA's forward, #7's chain and
   the bound ("split-fwd"); #3 and #6's split backward at the same cases, device ms
   beside SDPA's backward and the bound ("split-bwd"); #2 and #4 at its UNet's convs). At
   full width and depth: its bf16 b2 x 16f
   serving pass on the fused, sublayer and pallas paths ("serving-512",
   "serving-512-sublayer", "serving-512-pallas"), its bf16 b1 x 16f train step (remat
   off) on the fused and sublayer paths ("train-512", "train-512-sublayer") and the
   trainer of step 7 on ``--synthetic --resize 512`` ("trainer-512"), every launch
   counted and held.

``python3 chip_smoke.py --four-cards`` (a machine of 4 cards; not part of the
one-card run) runs the parallel dry run on NCCL over 4 ranks and the trainer
of step 7 at the flagship's full depth under data=4, fsdp=4, fsdp=2 x tensor=2
and tensor=4 (or the meshes named after the flag), each held to one rank's
run of the same global batch ("dist-nccl-4" line).

Every failure ends the script with a non-zero exit and no result line. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it holds the per-kernel record (times in ms on this card, summed over
the launches of the kernel's main path; every path's sums under ``by_path``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

# kernel vs plain on the card: max-abs error over max|plain|
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# float32 serving pass, card vs CPU: the same arithmetic in other summation
# orders (cuBLAS, the kernels) through 2 blocks and 15 convs with GroupNorm;
# the bound the CPU test holds the port to against the JAX package
FORWARD_F32_TOL = 1e-4
# float32 train step, card vs CPU: the bounds the CPU test holds the port's
# step to against the JAX package (loss and metrics; the perceptual term,
# whose VGG runs in bf16; every gradient against its leaf's largest value)
TRAIN_F32_TOL, PERCEPTUAL_F32_TOL, GRAD_F32_TOL = 1e-4, 1e-3, 1e-3
# a leaf whose true gradient is 0 (the selection head's biases, some conv biases)
# is rounding noise on both sides: under this share of the step's largest
# gradient on the CPU, it is held to stay under it on the card (the rule of the
# CPU train-step tests)
ZERO_GRAD_TOL = 1e-6
# keep decisions are compared only where no probability sits near its uniform
MIN_MARGIN = 0.02
# published H100 SXM peaks the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BATCH, FRAMES = 2, 16  # the serving batch; the train step's decoder runs 2 rollouts of 1 clip
TRAIN_BATCH = 1
# the default path's timed runs (and TIMED_STEPS): few, so that the script keeps within
# its time limit; the paths' device ms are stable where their medians are not
TIMED_FORWARDS = 5
# calls of a kernel-check's function that one torch.profiler trace averages (device_ms,
# device_launch_ms), few for the same reason
PROFILED_CALLS = 3
TIMED_STEPS, WARMUP_STEPS = 5, 3
# the paths beside the default one time fewer runs, so that the script stays short
NEW_PATH_TIMED_FORWARDS, NEW_PATH_TIMED_STEPS = 5, 3
# bf16 serving pass of a new attention path against the default path's, same weights
PATH_BF16_TOL = 5e-2
# bf16 train step of a new path against the default path's for the same draws: the
# loss is a mean over 1.5 M pixels and 16 frames, so roundings at other places
# average out; 3e-2 relative is the bound the CPU tests hold the port's bf16 step
# to against the JAX package
PATH_LOSS_TOL = 3e-2
REPLACES = {
    "vvt_fused_attention_fwd": "video_vae_tpu/ops/flash_attention.py:425",
    "vvt_conv3d_cf": "video_vae_tpu/ops/conv3d.py:178",
    "vvt_fused_attention_bwd": "video_vae_tpu/ops/flash_attention.py:724",
    "vvt_conv3d_wgrad": "video_vae_tpu/ops/conv3d.py:873",
    "vvt_flash_attention_fwd": "video_vae_tpu/ops/flash_attention.py:39",
    "vvt_flash_attention_bwd": "video_vae_tpu/ops/flash_attention.py:60",
    "vvt_attention_sublayer": "video_vae_tpu/ops/flash_attention.py:448",
    "vvt_fused_mlp": "video_vae_tpu/ops/fused_block.py:84",
    "vvt_conv3d_tapdot": "video_vae_tpu/ops/conv3d.py:419",
}
# the MLP kernel's three launches in order, by a part of each kernel's name
MLP_LAUNCHES = ("token_ln_kernel", "gemm_kernel", "gemm_kernel")
# the tap-dot kernel's launches in order: a channels-last copy of each of up to two
# sources, then the GEMM (a call with one source makes the last two)
TAPDOT_LAUNCHES = ("channels_last_kernel", "channels_last_kernel", "tapdot_kernel")
# the attention sublayer kernel's launches in order, by x's dtype: (label, a part of
# the kernel's name); f32 o is cast to bf16 before the second product
SUBLAYER_LAUNCHES = {
    "bfloat16": (("ln", "token_ln_kernel"), ("qkv", "gemm_kernel"), ("attention", "attention"),
                 ("out", "gemm_kernel")),
    "float32": (("ln", "token_ln_kernel"), ("qkv", "gemm_kernel"), ("attention", "attention"),
                ("cast", "o_to_bf16_kernel"), ("out", "gemm_kernel")),
}
# beside the nine kernels' counts: how many of the MLP kernel's launches wrote the residuals
MLP_TRAINING_VARIANT = "vvt_fused_mlp, training variant"
# the filter gradient's launches of its wgmma kernel (ops/conv3d.py:WGRAD_VARIANT_LAUNCHES)
WGRAD_WGMMA_VARIANT = "vvt_conv3d_wgrad, wgmma variant"
# the fused attention backward's launches of its wgmma tile kernel (64 < S <= 256 at head
# dims 64 and 128; ops/flash_attention.py:BWD_VARIANT_LAUNCHES)
ATTN_BWD_WGMMA_TILE = "vvt_fused_attention_bwd, wgmma tile variant"
# each attention kernel's launches of its wide variant (head dims past 128;
# ops/flash_attention.py:WIDE_LAUNCHES)
ATTN_WIDE = {symbol: f"{symbol}, wide variant" for symbol in (
    "vvt_fused_attention_fwd", "vvt_fused_attention_bwd", "vvt_flash_attention_fwd", "vvt_flash_attention_bwd",
    "vvt_attention_sublayer")}
KNOBS = ("VVT_ATTN_SUBLAYER", "VVT_MLP_FUSED", "VVT_TAPDOT")
# path -> (ModelConfig.attention_impl, the knobs set to 1 on it)
MODEL_PATHS = {
    "fused": ("fused", ()),
    "pallas": ("pallas", ()),
    "sublayer": ("fused", ("VVT_ATTN_SUBLAYER",)),
    "mlp": ("fused", ("VVT_MLP_FUSED",)),
    "sublayer-mlp": ("fused", ("VVT_ATTN_SUBLAYER", "VVT_MLP_FUSED")),
    "tapdot": ("fused", ("VVT_TAPDOT",)),
    "tapdot-off": ("fused", ()),  # the tap-dot path's model with the knob off: its reference
}
# the paths driven on the flagship model, serving and training
FLAGSHIP_PATHS = ("fused", "pallas", "sublayer", "mlp")
PATHS = (
    "train", "serving", "serving-pallas", "serving-sublayer", "train-pallas", "train-sublayer",
    "serving-mlp", "train-mlp", "serving-sublayer-mlp", "serving-tapdot", "train-tapdot", "trainer", "tiny",
    "train-h4", "cache-latents", "decode-latents",  # the last two: launches per video
    "serving-d96", "train-d96",  # the flagship's width in 8 heads of 96, padded to 128
    "serving-d256", "train-d256",  # the flagship's width in 2 heads of 256: the wide variant
    "dist-gloo-2",  # rank 0's step of the 2-rank data=2 run
    "mae", "mae-eval",  # the VideoMAE's gradient step and eval forward
    # the flagship at 512²: spatial S = 1024 on the split variant
    "serving-512", "train-512", "serving-512-sublayer", "train-512-sublayer", "serving-512-pallas",
)
# the path whose sums stand at the top level of a kernel's record
MAIN_PATH = {
    "vvt_flash_attention_fwd": "train-pallas", "vvt_flash_attention_bwd": "train-pallas",
    "vvt_attention_sublayer": "train-sublayer", "vvt_fused_mlp": "train-mlp",
    "vvt_conv3d_tapdot": "train-tapdot",
}
# the tap-dot path times fewer runs: its UNet is several times the flagship's conv work
TAPDOT_TIMED_FORWARDS, TAPDOT_TIMED_STEPS = 3, 2
# the trainer phase: cli/train.py's flagship config (b2 x 32 frames, remat on) on this
# many synthetic clips, so that an epoch is 3 steps; its video dump on the last step
TRAINER_BATCH, TRAINER_FRAMES, TRAINER_CLIPS = 2, 32, 6
TRAINER_STEPS = TRAINER_CLIPS // TRAINER_BATCH
# the one-card trainer and dist phases cut the transformer from the flagship's 9/12
# blocks to these (width, UNet and VGG at full size), so that the script stays short;
# the four-card runs keep the full depth
TRAINER_DEPTH = (3, 3)
# the JAX train step's metrics, which every logged step must carry
TRAIN_METRICS = ("loss", "MSE", "per_sample_MAE", "perceptual_loss", "selection_loss", "kl_loss",
                 "kept_frame_density", "rl_loss", "mean_trajectory_prob", "grad_norm", "max_grad")
# the trainer's step 1 against train_step called by hand on the same state, batch and
# draws: the float32 train-step bounds, scaled for bf16 compute by the ratio of the
# kernel bounds (2e-2 / 1e-4), as the bf16 path checks scale theirs
BF16_SCALE = KERNEL_TOL["bfloat16"] / KERNEL_TOL["float32"]
TRAINER_STEP_TOL, TRAINER_PERCEPTUAL_TOL = TRAIN_F32_TOL * BF16_SCALE, PERCEPTUAL_F32_TOL * BF16_SCALE
# the JAX smoke command's counterpart, run by the "tiny" phase under its default device
TINY_ARGS = ("--synthetic", "--tiny", "--steps", "5")
# the --small preset's train step: cli/train.py's default batch of 2 clips of 32 frames
SMALL_ARGS = ("--synthetic", "--small")
# the frames of one VGG pass (LossConfig().perceptual_chunk_frames): the b1 x 16f step's 2 rollouts
VGG_FRAMES = 32
# cli/cache_latents.py and cli/decode_latents.py at their defaults (--resize 256,
# --max_frames 64) on two synthetic clips: 64 frames and 40 frames (padded to 64)
LATENT_RESIZE, LATENT_FRAMES = 256, 64
LATENT_CLIP_FRAMES = (64, 40)
LATENT_VIDEOS = len(LATENT_CLIP_FRAMES)
H4_CLIPS, H4_FRAMES = 1, 16  # the head_dim-128 train step (ModelConfig(num_heads=4))
# the flagship's 768 features in its 8 heads: head_dim 96, which the kernels run padded to 128
D96_QKV = 768
# the attention kernels at head dims they pad (ops/flash_attention.py:padded_head_dim), each
# at these sequence lengths, PADDED_HEADS heads and PADDED_TOKENS tokens a call (a ragged
# key mask); #7 at width PADDED_WIDTH
PADDED_CASES = ((48, (16, 256, 1024)), (96, (16, 256, 1024)), (8, (16, 256)), (24, (16, 256)))
PADDED_HEADS, PADDED_TOKENS, PADDED_WIDTH = 8, 4096, 768
# the d96 paths time as few runs as the tap-dot path's: their device ms is the stable figure;
# they run the trainer's depth, so that the d256 paths below fit the script's time
D96_TIMED_FORWARDS, D96_TIMED_STEPS = 3, 2
D96_DEPTH = TRAINER_DEPTH
# the flagship's width in 2 heads of 256 (ModelConfig(num_heads=2)): every attention call on
# the kernels' wide variant, full width and depth; as few timed runs as the d96 paths
D256_HEADS = 2
D256_TIMED_FORWARDS, D256_TIMED_STEPS = 3, 2
# the wide variant at head dims past 128 (ops/flash_attention.py:padded_head_dim: 130 and 192
# run at 256, 384 and 512 as they are), each at these sequence lengths, PADDED_HEADS heads and
# PADDED_TOKENS tokens a call, in bf16 and float32
WIDE_CASES = tuple((d, (16, 256, 1024)) for d in (130, 192, 256, 384, 512))
# the "mae" phases: VideoMAE at the BASELINE config's 224 x 224 x 16 (the flagship otherwise:
# 9 + 12 // 3 blocks, remat on), mask ratio 0.9, 4 clips, clip 1 ending in 3 padded frames
MAE_SIDE, MAE_CLIPS, MAE_FRAMES, MAE_PADDED_CLIP = 224, 4, 16, 1
MAE_TIMED = 3
# the JAX GAN step's metrics (train/adversarial.py): the train step's loss metrics, no
# gradient telemetry, and the adversarial terms
GAN_METRICS = TRAIN_METRICS[:-2] + ("generator_adv_loss", "discriminator_loss", "discriminator_accuracy")
# a discriminator leaf whose true gradient is 0 (a conv bias before a GroupNorm of one
# channel a group) is rounding noise under this share of the largest gradient on both
# devices: the GroupNorm backward sums 10^5-10^6 values a group
D_NOISE_TOL = 1e-5
# the 512² phases ("long-seq-kernels", "serving-512*", "train-512*", "trainer-512"): the
# flagship at cli/train.py's --resize 512, a 32 x 32 patch grid, so that its spatial
# attention calls (S = 1024) take the attention kernels' split variant
LONG_SIDE = 512
LONG_ARGS = ("--resize", str(LONG_SIDE))
# beside the 512² calls the split kernels are held at one key past the tile variant and
# at --resize 384's 24² patches, on a b1 x 16f step's 16 spatial sequences
LONG_SEQS = (257, 576)
# the "slope-serving" phase: utils/timing.py's robust_slope over chains of this many
# serving passes, each chain ended by torch.cuda.synchronize(), this many repeats
SLOPE_CHAINS, SLOPE_REPEATS = (2, 6), 5
# the cf VGG's convs on the direct conv kernel: (name, h = w, cin, cout, launches a step),
# each forward run on the reconstruction and the target, each input gradient once
VGG_CONV_CASES = (
    ("conv1_1", 256, 3, 64, 2), ("conv1_2", 256, 64, 64, 2), ("conv2_1", 128, 64, 128, 2),
    ("conv2_1 dgrad", 128, 128, 64, 1), ("conv1_2 dgrad", 256, 64, 64, 1), ("conv1_1 dgrad", 256, 64, 3, 1),
)


def sublayer_launches(dtype: str, seq: int, head_dim: int) -> tuple:
    """The attention sublayer kernel's launches in order (``SUBLAYER_LAUNCHES``); past
    ``TILE_MAX_SEQ`` bf16 x's attention is the split variant's two: its LN + RoPE pass
    and its core (``split_wg_fwd_kernel`` at head dims 64 and 128, ``split_fwd_kernel``
    at 16 and 32); past head dim 128 either dtype's is the wide variant's two
    (``wide_norm_rope_kernel``, then ``wide_fwd_kernel`` or ``wide_f32_fwd_kernel``)."""
    from video_vae_tpu_torch.ops.flash_attention import TILE_MAX_SEQ

    if takes_wide(head_dim):
        ln, qkv, *_, out = SUBLAYER_LAUNCHES[dtype]
        cast = SUBLAYER_LAUNCHES[dtype][3:-1]  # f32 o's cast to bf16
        return ln, qkv, ("norm_rope", "wide_norm_rope_kernel"), ("attention", "_fwd_kernel"), *cast, out
    if dtype == "bfloat16" and seq > TILE_MAX_SEQ:
        ln, qkv, _, out = SUBLAYER_LAUNCHES[dtype]
        return ln, qkv, ("norm_rope", "qk_norm_rope_kernel"), ("attention", "_fwd_kernel"), out
    return SUBLAYER_LAUNCHES[dtype]


def path_name(entry: str, path: str) -> str:
    return entry if path == "fused" else f"{entry}-{path}"


@contextlib.contextmanager
def model_path(cfg, path: str):
    """``cfg`` on that path, with the VVT_* knobs set to the path's values while the block runs."""
    impl, on = MODEL_PATHS[path]
    before = {knob: os.environ.get(knob) for knob in KNOBS}
    for knob in KNOBS:
        os.environ[knob] = "1" if knob in on else "0"
    try:
        yield cfg.replace(attention_impl=impl)
    finally:
        for knob, value in before.items():
            if value is None:
                del os.environ[knob]
            else:
                os.environ[knob] = value


def describe(cfg) -> str:
    """The model a line was measured on, with every cut of depth."""
    unet = f"UNet kt={cfg.temporal_kernel} base {cfg.unet_base_features}"
    return (f"width {cfg.embed_dim}, {cfg.height}x{cfg.width}, encoder/decoder depth "
            f"{cfg.encoder_depth}/{cfg.decoder_depth}, {unet}")


def rounds_to_bf16(path: str) -> bool:
    """Whether the path's fused sublayers multiply bf16 operands inside a float32 model."""
    return bool({"VVT_ATTN_SUBLAYER", "VVT_MLP_FUSED"} & set(MODEL_PATHS[path][1]))


def cli_config(args):
    """The VAEConfig ``cli/train.py`` builds from ``args``."""
    from video_vae_tpu_torch.cli.train import build_parser, config_from_args

    return config_from_args(build_parser().parse_args(list(args)))


def head_dim_configs():
    """(label, ModelConfig, clips, frames) of the presets whose attention runs at
    head_dim 16, ``--tiny`` (tiny_config: 32², 2 heads) and ``--small`` (256², 8
    heads), each with its data's batch, and the same shapes at head_dim 32
    (qkv_features doubled): the kernels' other head dims beside the flagship's 64."""
    out = []
    for label, args in (("tiny", TINY_ARGS), ("small", SMALL_ARGS)):
        cfg = cli_config(args)
        model = cfg.model
        out.append((label, model, cfg.data.batch_size, cfg.data.max_frames))
        out.append((f"{label}-d32", model.replace(qkv_features=2 * model.qkv_features), cfg.data.batch_size,
                    cfg.data.max_frames))
    return out


def h4_config():
    """The flagship at its full width in 4 heads of 128 (``ModelConfig(num_heads=4)``):
    the attention kernels at head_dim 128."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(num_heads=4)


def d96_config():
    """The flagship with ``qkv_features=768`` (``D96_QKV``): 8 heads of 96, which the
    attention kernels run padded to 128, at ``D96_DEPTH`` blocks, the rest the flagship's."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(qkv_features=D96_QKV, encoder_depth=D96_DEPTH[0], decoder_depth=D96_DEPTH[1])


def d256_config():
    """The flagship at its full width and depth in 2 heads of 256 (``ModelConfig(num_heads=2)``):
    every attention call on the kernels' wide variant, at a native head dim (no padding)."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(num_heads=D256_HEADS)


def latent_attention_cases(cfg, frames=LATENT_FRAMES):
    """(name, B, S, padded clip, dtype, launches per entry) of the attention calls of
    one clip of ``frames`` frames through ``cli/cache_latents.py`` (the encoder's,
    under ``"serving"``) and ``cli/decode_latents.py`` (the decoder's, under
    ``"train"``), counted per video; :func:`phase_latent_kernels` names the two
    paths. A padded clip ends in 3 masked frames."""
    hw, enc, dec = cfg.num_patches, cfg.encoder_depth, cfg.decoder_depth
    per = {"serving": enc, "train": dec}
    return [
        (f"temporal b1x{frames}", hw, frames, True, "bfloat16", per),
        (f"spatial b1x{frames}", frames, hw, False, "bfloat16", per),
    ]


def preset_attention_cases(label, cfg, clips, frames, full=True):
    """(name, B, S, padded clip, dtype, {"train": launches a step}) of the attention calls
    of a train step on ``clips`` clips of ``frames`` frames, the last clip ending in 3
    padded frames: the encoder's on the clips, the decoder's on their 2 rollouts, then
    the encoder's again in float32 (counted on no path). ``full=False`` keeps the
    decoder's and one float32 call."""
    hw, enc, dec = cfg.num_patches, cfg.encoder_depth, cfg.decoder_depth
    cases = [
        (f"{label} temporal b{clips}x{frames}", clips * hw, frames, True, "bfloat16", {"train": enc}),
        (f"{label} spatial b{clips}x{frames}", clips * frames, hw, False, "bfloat16", {"train": enc}),
        (f"{label} temporal b{2 * clips}x{frames}", 2 * clips * hw, frames, True, "bfloat16", {"train": dec}),
        (f"{label} spatial b{2 * clips}x{frames}", 2 * clips * frames, hw, False, "bfloat16", {"train": dec}),
    ]
    f32 = [(name, B, S, padded, "float32", {}) for name, B, S, padded, _, _ in cases[:2]]
    return cases + f32 if full else cases[2:] + f32[:1]


def mae_config():
    """The VideoMAE phases' model: the flagship at 224 x 224 (a 14 x 14 patch grid)."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(height=MAE_SIDE, width=MAE_SIDE)


def mae_frame_mask():
    """The MAE batch's (clips, frames) frame mask: clip 1 ends in 3 padded frames."""
    import torch

    mask = torch.ones(MAE_CLIPS, MAE_FRAMES)
    mask[MAE_PADDED_CLIP, MAE_FRAMES - 3:] = 0
    return mask


def mae_attention_cases(cfg):
    """(name, B, S, frame mask, dtype, launches per entry) of the MAE's attention calls on
    b4 x 16f: each of its ``encoder_depth + max(1, decoder_depth // 3)`` blocks makes a
    temporal call under the frame mask and an unmasked spatial one over the 14 x 14 grid
    (S = 196, a partial last 16-row tile); "serving" counts an eval forward's, "train"
    a gradient step's backward (the caller doubles its forwards for remat)."""
    blocks = cfg.encoder_depth + max(1, cfg.decoder_depth // 3)
    per = {"serving": blocks, "train": blocks}
    hw = cfg.num_patches
    return [
        (f"mae temporal b{MAE_CLIPS}x{MAE_FRAMES}", MAE_CLIPS * hw, MAE_FRAMES, mae_frame_mask(), "bfloat16", per),
        (f"mae spatial b{MAE_CLIPS}x{MAE_FRAMES}", MAE_CLIPS * MAE_FRAMES, hw, False, "bfloat16", per),
    ]


def tapdot_model_config():
    """The tap-dot path's model: a kt = 1 UNet of base width 64 at full size
    (unpacked, as the port always computes it), the transformer cut to depth 1."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(temporal_kernel=1, unet_base_features=64, unet_s2d_full=False,
                       encoder_depth=1, decoder_depth=1)


def takes_tapdot(cins, cout, k, w) -> bool:
    """The gate of the tap-dot kernel for a bf16 conv, written out from its rule."""
    cin = sum(cins)
    return (k[0] == 1 and w >= 128 and cin >= 128 and cin % 8 == 0 and cout % 8 == 0
            and all(c % 8 == 0 for c in cins))


def tapdot_launches(cfg) -> tuple[dict, dict]:
    """The UNet's convs the gate sends to the tap-dot kernel with ``VVT_TAPDOT=1``:
    ({(source channels, cout, k, h, w): forward launches}, {...: input-gradient
    launches}); an input gradient is the conv of g (cout channels) to cin channels."""
    forward, dgrad = {}, {}
    for _, h, w, cins, cout, k, dtype in conv_cases(cfg):
        if dtype != "bfloat16":
            continue
        if takes_tapdot(cins, cout, k, w):
            key = (tuple(cins), cout, tuple(k), h, w)
            forward[key] = forward.get(key, 0) + 1
        if takes_tapdot((cout,), sum(cins), k, w):
            key = ((cout,), sum(cins), tuple(k), h, w)
            dgrad[key] = dgrad.get(key, 0) + 1
    return forward, dgrad


def per_path(per: dict, paths: dict) -> dict:
    """Launch counts of ``per`` (by entry point) under other path names (a None name is left out)."""
    return {new: per[entry] for new, entry in paths.items() if new is not None and entry in per}


def log(*parts):
    print(*parts, flush=True)


# wall seconds of each phase_* function over the run, nested calls included in
# their caller's (filled by ``_timed``, printed as the "phase-seconds" line)
PHASE_SECONDS: dict = {}


def _timed(name: str, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        started = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + time.monotonic() - started
    return run


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = PROFILED_CALLS, traces: int = 6) -> float:
    """Device time per call of the kernels ``fn`` launches, from ``torch.profiler``.

    Unlike :func:`time_ms`, whose events also count where the device waits on
    the host to enqueue, it sums only the kernels' own time: a call shorter
    than its Python wrapper is not timed at the host's pace. On the H100 a
    trace now and then lacks a kernel's record, or every record: each kernel
    counts as its mean over the records kept times the launches a call makes
    of it, and a trace with no record is taken again.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us: dict[str, list[float]] = {}  # kernel name -> durations
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
        if us:
            return sum(sum(t) / len(t) * max(1, round(len(t) / iters)) for t in us.values()) / 1e3
    raise AssertionError(f"torch.profiler saw no kernel on the device in {traces} traces")


def device_launch_ms(fn, names: tuple[str, ...], iters: int = PROFILED_CALLS, traces: int = 6) -> list[float]:
    """Device ms of the kernels one call of ``fn`` launches whose names hold one
    of ``names`` (other kernels it launches, such as casts, are left out), in
    launch order: each the mean over ``iters`` calls of one ``torch.profiler``
    trace. A trace that kept other than ``len(names) * iters`` such records is
    taken again (see :func:`device_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((ev.time_range.start, ev.time_range.elapsed_us()) for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and any(name in ev.name for name in names))
        if len(kernels) == len(names) * iters:
            return [sum(us for _, us in kernels[i::len(names)]) / iters / 1e3 for i in range(len(names))]
        kept.append(len(kernels))
    raise AssertionError(f"torch.profiler kept no whole trace of the launches {names} in {traces} traces "
                         f"(records kept {kept}, of {len(names) * iters})")


def device_times(kernel_fn, library_fn, flops: float | None = None) -> dict:
    """A kernel's and its library call's device time per call (:func:`device_ms`),
    and with ``flops`` the kernel's TFLOP/s (a conv's over the taps inside the
    clip and the frame)."""
    ms = device_ms(kernel_fn)
    times = {"device_ms": ms, "library_device_ms": device_ms(library_fn)}
    return times if flops is None else {**times, "tflops": flops / ms / 1e9}


def bound_ms(nbytes: int, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def valid_taps(n: int, k: int) -> int:
    """Taps of a size-k SAME window inside 0..n−1, summed over the n output positions."""
    return sum(n - abs(d) for d in range(-(k // 2), k // 2 + 1))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def check_close(name: str, out, ref, dtype: str) -> float:
    """Raise unless max|out − ref| ≤ tol · max|ref|; returns the max-abs error."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= KERNEL_TOL[dtype] * scale:
        raise AssertionError(f"{name}: max-abs error {err} > {KERNEL_TOL[dtype]} * {scale}")
    return err


def attention_cases(cfg):
    """(name, B, S, padded clip, dtype, launches per path) of every attention call.

    The serving pass runs b = 2 clips through both stacks; the train step
    runs 1 clip through the encoder and its 2 rollouts through the decoder.
    A padded clip ends in 3 padded frames (the temporal key mask).
    """
    hw, enc, dec = cfg.num_patches, cfg.encoder_depth, cfg.decoder_depth
    both = enc + dec
    return [
        ("temporal b2", BATCH * hw, FRAMES, True, "bfloat16", {"serving": both, "train": dec}),
        ("spatial b2", BATCH * FRAMES, hw, False, "bfloat16", {"serving": both, "train": dec}),
        ("temporal b1", TRAIN_BATCH * hw, FRAMES, False, "bfloat16", {"train": enc}),
        ("spatial b1", TRAIN_BATCH * FRAMES, hw, False, "bfloat16", {"train": enc}),
        ("temporal b2", BATCH * hw, FRAMES, True, "float32", {}),
    ]


def conv_cases(cfg):
    """(name, h, w, source channels, cout, kernel size) of the UNet's 15 convs."""
    kt, side = cfg.temporal_kernel, cfg.height
    c0 = cfg.channels * cfg.unembedding_upsample_rate
    cases = [("patch_mixer", side, cfg.width, (c0,), c0, (kt, 7, 7))]
    cin = c0
    for i in range(cfg.unet_levels):
        c, s = cfg.unet_base_features * 2**i, side >> i
        cases += [(f"encoders.{i}.conv1", s, s, (cin,), c, (kt, 3, 3)),
                  (f"encoders.{i}.conv2", s, s, (c,), c, (kt, 3, 3))]
        cin = c
    c, s = cfg.unet_base_features * 2**cfg.unet_levels, side >> cfg.unet_levels
    cases += [("bottleneck1", s, s, (cin,), c, (kt, 3, 3)),
              ("bottleneck2", s, s, (c,), c, (kt, 3, 3))]
    for j, i in enumerate(range(cfg.unet_levels - 1, -1, -1)):
        c, s = cfg.unet_base_features * 2**i, side >> i
        cases += [(f"decoders.{j}.conv1", s, s, (c, c), c, (kt, 3, 3)),
                  (f"decoders.{j}.conv2", s, s, (c,), c, (kt, 3, 3))]
    return [(n, h, w, cins, cout, k, "bfloat16") for n, h, w, cins, cout, k in cases] + [
        (n + " f32", h, w, cins, cout, k, "float32")
        for n, h, w, cins, cout, k in (cases[0], cases[-2])
    ]


def _record(rows, kernel, case, shape, dtype, err, ms, plain_ms, library_ms, library, bound, per, **extra):
    rows.append(dict(
        kernel=kernel.symbol, case=case, shape=shape, dtype=dtype, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, library=library, bound_ms=bound[0],
        bound_by=bound[1], per_pass=per if dtype == "bfloat16" else {}, **extra,
    ))
    log("kernel-check", json.dumps(rows[-1]))


def _key_mask(cfg, dev, name, B, S, padded):
    """(key mask or None, kept keys) of one attention case.

    A temporal call's mask is the clips' frame mask expanded over the patches:
    ``padded`` is that (clips, S) mask itself, or True for clips whose last
    ends in 3 padded frames. A (B, S) ``padded`` is the key mask itself, on any
    call. The bounds count only the keys it leaves in.
    """
    import torch

    if isinstance(padded, torch.Tensor) and tuple(padded.shape) == (B, S):  # a key mask as it is
        mask = padded.bool().to(dev)
        return mask, int(mask.sum())
    if "temporal" not in name:
        return None, B * S
    clips = B // cfg.num_patches
    if isinstance(padded, torch.Tensor):
        frames = padded.bool().cpu()
    else:
        frames = torch.ones(clips, S, dtype=torch.bool)
        if padded:
            frames[-1, S - 3:] = False
    mask = frames[:, None, :].expand(clips, B // clips, S).reshape(B, S).to(dev)
    return mask, int(mask.sum())


def _attention_inputs(cfg, dev, gen, name, B, S, padded, dtype):
    """(qkv, g, q_scale, k_scale, key mask, kept keys) of one attention case."""
    import torch

    H, D = cfg.num_heads, cfg.head_dim
    tdt = getattr(torch, dtype)
    qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(dev, tdt)
    g = torch.randn(B, S, H * D, generator=gen).to(dev, tdt)
    qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(dev)
    ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(dev)
    return (qkv, g, qs, ks, *_key_mask(cfg, dev, name, B, S, padded))


def phase_attention_kernels(cfg, dev, rows, serving="serving", train="train", cases=None, remat=False,
                            masked_rows=None, backward=True, sublayer_train=None):
    """Fused attention forward and backward kernels against their plain versions,
    at the launches of ``cfg``'s serving pass and train step on the paths named
    (``serving=None``: no serving path; ``train=None``: counted on no path either).
    ``cases`` replace ``attention_cases(cfg)``; with ``remat`` each forward runs
    twice in a step (the recompute). ``masked_rows`` (by default on the flagship's
    serving path) also holds each padded case with one sequence's keys all masked.
    ``backward=False``: the backward is held at these shapes but counted on no path
    (both paths named run forwards only). The backward also counts on
    ``sublayer_train`` (the attention sublayer's train step, whose backward is
    this kernel; ``"train-sublayer"`` beside ``"train"``)."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    H, D = cfg.num_heads, cfg.head_dim
    masked_rows = serving == "serving" if masked_rows is None else masked_rows
    if sublayer_train is None and train == "train":
        sublayer_train = "train-sublayer"
    for name, B, S, padded, dtype, per in attention_cases(cfg) if cases is None else cases:
        if not per and cases is None and serving != "serving":
            continue  # a case no path counts is checked once, with the flagship's
        qkv, g, qs, ks, mask, keys = _attention_inputs(cfg, dev, gen, name, B, S, padded, dtype)
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2).contiguous() for t in qkv.split(H * D, -1))
        amask = None if mask is None else mask[:, None, None, :]

        out = fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
        again = fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
        torch.cuda.synchronize()
        err = check_close(f"attention {name} {dtype}", out, fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H), dtype)
        if not torch.equal(out, again):  # no atomics: the same bits on every run
            raise AssertionError(f"attention {name} {dtype}: two launches gave different bits")
        del again
        flops, moved = 4.0 * H * S * keys * D, nbytes(qkv, out, mask)
        ms = time_ms(lambda: fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H), 20)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask), 20)
        dev_ms = device_ms(lambda: fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H))
        log("attention-fwd", json.dumps({
            "case": f"{name} {dtype}", "head_dim": D, "paths": [serving, train], "ms": ms, "sdpa_core_ms": sdpa_ms,
            "device_ms": dev_ms,
            "sdpa_core_device_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask)),
            "tflops": flops / dev_ms / 1e9, "gb_per_s": moved / dev_ms / 1e6,
        }))
        fwd_per = per_path(per, {serving: "serving", train: "train"})
        if remat and train in fwd_per:
            fwd_per[train] *= 2
        _record(
            rows, fa.FUSED_ATTENTION, f"{name} {dtype}", [B, S, 3 * H * D], dtype, err, ms,
            time_ms(lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H), 5), sdpa_ms,
            "scaled_dot_product_attention, core only", bound_ms(moved, flops, dtype), fwd_per,
        )
        if padded is not False and masked_rows:
            # one sequence with every key masked: its rows average all S keys
            empty = mask.clone()
            empty[0] = False
            held = fa.fused_qkv_attention_cuda(qkv, qs, ks, empty, H)
            torch.cuda.synchronize()
            ref = fa.fused_qkv_attention_plain(qkv, qs, ks, empty, H)
            err = max(check_close(f"attention {name} {dtype} all keys masked", held, ref, dtype),
                      check_close(f"attention {name} {dtype} the masked sequence", held[0], ref[0], dtype))
            log("attention-fwd-masked-row", json.dumps({"case": f"{name} {dtype}", "max_abs_err": err}))
            del empty, held, ref

        got = fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
        again = fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
        torch.cuda.synchronize()
        ref = fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
        err = max(check_close(f"attention bwd {name} {dtype} {part}", a, b, dtype)
                  for part, a, b in zip(("dqkv", "dq_scale", "dk_scale"), got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits on every run
            raise AssertionError(f"attention bwd {name} {dtype}: two launches gave different bits")
        del ref, again
        if padded is not False and masked_rows:
            # one sequence with every key masked: its rows spread P over all S keys
            empty = mask.clone()
            empty[0] = False
            held = fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, empty, g, H)
            torch.cuda.synchronize()
            ref = fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, empty, g, H)
            masked_err = max(
                *(check_close(f"attention bwd {name} {dtype} all keys masked {part}", a, b, dtype)
                  for part, a, b in zip(("dqkv", "dq_scale", "dk_scale"), held, ref)),
                check_close(f"attention bwd {name} {dtype} the masked sequence", held[0][0], ref[0][0], dtype),
            )
            log("attention-bwd-masked-row", json.dumps({"case": f"{name} {dtype}", "max_abs_err": masked_err}))
            del empty, held, ref
        # library yardstick: SDPA's backward on already normalised, rotated q/k
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
        g_heads = g.reshape(B, S, H, D).transpose(1, 2).contiguous()
        # recompute of the scores, dv, dP, dq, dk over the kept keys
        bwd_flops = 10.0 * H * S * keys * D
        dev_ms = device_ms(lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H))
        _record(
            rows, fa.FUSED_ATTENTION_BWD, f"{name} {dtype}", [B, S, 3 * H * D], dtype, err,
            time_ms(lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H), 10),
            time_ms(lambda: fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H), 3),
            time_ms(lambda: torch.autograd.grad(o, leaves, g_heads, retain_graph=True), 10),
            "scaled_dot_product_attention backward, core only",
            bound_ms(nbytes(qkv, g, mask) + nbytes(*got), bwd_flops, dtype),
            per_path(per, {train: "train", sublayer_train: "train"}) if backward else {},
            device_ms=dev_ms,
            library_device_ms=device_ms(lambda: torch.autograd.grad(o, leaves, g_heads, retain_graph=True)),
            tflops=bwd_flops / dev_ms / 1e9,
        )
        del qkv, g, out, got, q, k, v, leaves, o, g_heads
    torch.cuda.empty_cache()


def phase_flash_kernels(cfg, dev, rows, cases=None, paths=True):
    """Plain masked attention forward and backward kernels against their plain versions,
    at ``attention_cases(cfg)`` or ``cases``, counted on the ``"pallas"`` paths
    (``paths=False``: on none; a dict: on its paths, {path: "serving" or "train"}).

    q and k are contiguous (B, S, H, D) tensors and v a view into a fused QKV
    projection, as the model's ``"pallas"`` path hands them over.
    """
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(10)
    H, D = cfg.num_heads, cfg.head_dim
    paths = {"serving-pallas": "serving", "train-pallas": "train"} if paths is True else paths or {}
    for name, B, S, padded, dtype, per in attention_cases(cfg) if cases is None else cases:
        qkv, g, _, _, mask, keys = _attention_inputs(cfg, dev, gen, name, B, S, padded, dtype)
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
        q, k, g = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)
        amask = None if mask is None else mask[:, None, None, :]
        lq, lk, lv, lg = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))  # SDPA's (B,H,S,D)

        out = fa.flash_attention_cuda(q, k, v, mask)
        again = fa.flash_attention_cuda(q, k, v, mask)
        torch.cuda.synchronize()
        err = check_close(f"flash {name} {dtype}", out, fa.flash_attention_plain(q, k, v, mask), dtype)
        if not torch.equal(out, again):  # no atomics: the same bits on every run
            raise AssertionError(f"flash {name} {dtype}: two launches gave different bits")
        del again
        flops = 4.0 * H * S * keys * D  # q·kᵀ and P·V over the kept keys
        _record(
            rows, fa.FLASH_ATTENTION, f"{name} {dtype}", [B, S, H, D], dtype, err,
            time_ms(lambda: fa.flash_attention_cuda(q, k, v, mask), 20),
            time_ms(lambda: fa.flash_attention_plain(q, k, v, mask), 5),
            time_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask), 20),
            "scaled_dot_product_attention",
            bound_ms(nbytes(q, k, v, out, mask), flops, dtype), per_path(per, paths),
            **device_times(lambda: fa.flash_attention_cuda(q, k, v, mask),
                           lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask), flops),
        )
        if padded is not False:
            # one sequence with every key masked: its rows average all S keys
            empty = mask.clone()
            empty[0] = False
            held = fa.flash_attention_cuda(q, k, v, empty)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, empty)
            masked_err = max(check_close(f"flash {name} {dtype} all keys masked", held, ref, dtype),
                             check_close(f"flash {name} {dtype} the masked sequence", held[0], ref[0], dtype))
            log("flash-fwd-masked-row", json.dumps({"case": f"{name} {dtype}", "max_abs_err": masked_err}))
            del empty, held, ref

        got = fa.flash_attention_bwd_cuda(q, k, v, mask, g)
        again = fa.flash_attention_bwd_cuda(q, k, v, mask, g)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, mask, g)
        err = max(check_close(f"flash bwd {name} {dtype} {part}", a, b, dtype)
                  for part, a, b in zip(("dq", "dk", "dv"), got, ref))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits on every run
            raise AssertionError(f"flash bwd {name} {dtype}: two launches gave different bits")
        del ref, again
        if padded is not False:
            # one sequence with every key masked: its rows spread P over all S keys
            empty = mask.clone()
            empty[0] = False
            held = fa.flash_attention_bwd_cuda(q, k, v, empty, g)
            torch.cuda.synchronize()
            ref = fa.flash_attention_bwd_plain(q, k, v, empty, g)
            masked_err = max(
                *(check_close(f"flash bwd {name} {dtype} all keys masked {part}", a, b, dtype)
                  for part, a, b in zip(("dq", "dk", "dv"), held, ref)),
                *(check_close(f"flash bwd {name} {dtype} the masked sequence {part}", a[0], b[0], dtype)
                  for part, a, b in zip(("dq", "dk", "dv"), held, ref)),
            )
            log("flash-bwd-masked-row", json.dumps({"case": f"{name} {dtype}", "max_abs_err": masked_err}))
            del empty, held, ref
        leaves = [t.detach().requires_grad_() for t in (lq, lk, lv)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
        # recompute of the scores, dv, dP, dq, dk over the kept keys
        bwd_flops = 10.0 * H * S * keys * D
        _record(
            rows, fa.FLASH_ATTENTION_BWD, f"{name} {dtype}", [B, S, H, D], dtype, err,
            time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, mask, g), 10),
            time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, mask, g), 3),
            time_ms(lambda: torch.autograd.grad(o, leaves, lg, retain_graph=True), 10),
            "scaled_dot_product_attention backward",
            bound_ms(nbytes(q, k, v, g, mask) + nbytes(*got), bwd_flops, dtype),
            per_path(per, {path: entry for path, entry in paths.items() if entry == "train"}),
            **device_times(lambda: fa.flash_attention_bwd_cuda(q, k, v, mask, g),
                           lambda: torch.autograd.grad(o, leaves, lg, retain_graph=True), bwd_flops),
        )
        del qkv, g, out, got, q, k, v, lq, lk, lv, lg, leaves, o
    torch.cuda.empty_cache()


def phase_sublayer_kernel(cfg, dev, rows, cases=None, paths=True):
    """The attention sublayer kernel against its plain version, both variants, at
    ``attention_cases(cfg)`` or ``cases``, counted on the sublayer paths
    (``paths=False``: on none; a dict: on its paths, {path: "serving" or "train"}).

    The training variant returns y and the qkv and o residuals; the inference
    variant (the autograd wrapper under ``no_grad``) must give the same y. The
    library yardstick is the chain LayerNorm -> matmul -> SDPA -> matmul on
    bf16 weights. The bound counts x in, y out and the weights once (the
    inference variant) and the two projections plus the attention's products
    at the bf16 tensor-core peak, whatever x's dtype: the kernel's products
    run on bf16 operands either way. Each line adds the device ms of each of
    the kernel's launches from one profiler trace (``SUBLAYER_LAUNCHES``) and
    each product's TFLOP/s.
    """
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import flash_attention as fa

    paths = {"serving-sublayer": "serving", "train-sublayer": "train"} if paths is True else paths or {}
    gen = torch.Generator().manual_seed(20)
    H, D, C = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    HD = H * D
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    params = [t.to(dev) for t in (
        1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, 3 * HD) / C**0.5, 0.2 * rn(3 * HD),
        1 + 0.2 * rn(D), 1 + 0.2 * rn(D), 0.1 * rn(HD, C) / HD**0.5, 0.2 * rn(C),
    )]
    lng, lnb, wqkv, bqkv, qs, ks, wout, bout = params
    w16 = [t.to(torch.bfloat16) for t in (wqkv, bqkv, wout, bout)]
    for name, B, S, padded, dtype, per in attention_cases(cfg) if cases is None else cases:
        tdt = getattr(torch, dtype)
        mask, keys = _key_mask(cfg, dev, name, B, S, padded)
        x = rn(B, S, C).to(dev, tdt)
        amask = None if mask is None else mask[:, None, None, :]

        def run():
            return fa.fused_attention_sublayer_cuda(x, lng, lnb, wqkv, bqkv, qs, ks, wout, bout, mask, H)

        def plain():
            return fa.fused_attention_sublayer_plain(x, lng, lnb, wqkv, bqkv, qs, ks, wout, bout, mask, H)

        def library():
            xa = F.layer_norm(x, (C,), lng.to(tdt), lnb.to(tdt), 1e-6).to(torch.bfloat16)
            q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                       for t in (torch.matmul(xa, w16[0]) + w16[1]).split(HD, -1))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=amask)
            return x + (torch.matmul(o.transpose(1, 2).reshape(B, S, HD), w16[2]) + w16[3]).to(tdt)

        got = run()
        torch.cuda.synchronize()
        # bf16 GEMM operands on both sides whatever x's dtype: the bf16 bound
        err = max(check_close(f"sublayer {name} {dtype} {part}", a, b, "bfloat16")
                  for part, a, b in zip(("y", "qkv", "o"), got, plain()))
        with torch.no_grad():
            y = fa.fused_attention_sublayer(x, lng, lnb, wqkv, bqkv, qs, ks, wout, bout, mask, H)
        torch.cuda.synchronize()
        if not torch.equal(y, got[0]):
            raise AssertionError(f"sublayer {name} {dtype}: the inference variant's y differs")
        qkv_flops, out_flops = 2.0 * B * S * C * 3 * HD, 2.0 * B * S * HD * C
        flops = qkv_flops + out_flops + 4.0 * H * S * keys * D
        labels, names = zip(*sublayer_launches(dtype, S, D))
        # the wrapper's casts of the f32 weights to bf16 count in device_ms only
        launch_ms = dict(zip(labels, device_launch_ms(run, names)))
        _record(
            rows, fa.ATTENTION_SUBLAYER, f"{name} {dtype}", [B, S, C], dtype, err,
            time_ms(run, 10), time_ms(plain, 2), time_ms(library, 10),
            "layer_norm -> matmul -> scaled_dot_product_attention -> matmul, bf16 weights",
            bound_ms(nbytes(x, x, *w16, lng, lnb, mask), flops, "bfloat16"),
            per_path(per, paths), **device_times(run, library), launch_device_ms=launch_ms,
            tflops={"qkv": qkv_flops / launch_ms["qkv"] / 1e9, "out": out_flops / launch_ms["out"] / 1e9},
        )
        del x, got, y
    torch.cuda.empty_cache()


def phase_conv_kernels(cfg, dev, rows, serving="serving", train="train", tapdot=False,
                       batch=BATCH, frames=FRAMES, remat=False, f32=True):
    """Conv forward, input gradient (same kernel) and filter gradient against plain,
    at every conv of ``cfg``'s UNet on ``batch`` clips of ``frames`` frames, counted
    on the paths named (``serving=None``: no serving path; then the float32 cases
    are left out). With ``tapdot`` (the bf16 path with ``VVT_TAPDOT=1``) a forward
    conv or an input gradient that passes the tap-dot gate is left to
    :func:`phase_tapdot_kernel`: the direct kernel is held at the shapes this path
    gives it and no other. With ``remat`` the down and up blocks' convs run their
    forward twice in a step (the recompute). ``f32=False`` leaves the float32
    cases out (held at the flagship's shapes already)."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(1)
    for name, h, w, cins, cout, k, dtype in conv_cases(cfg):
        if (tapdot or serving is None or not f32) and dtype != "bfloat16":
            continue
        forward_per = per_path({"serving": 1, "train": 2 if remat and name.startswith(("encoders", "decoders")) else 1},
                               {serving: "serving", train: "train"})
        tdt = getattr(torch, dtype)
        cin = sum(cins)
        xs = [torch.randn(batch, frames, c, h, w, generator=gen).to(dev, tdt) for c in cins]
        x2 = xs[1] if len(xs) == 2 else None
        kernel = (torch.randn(*k, cin, cout, generator=gen) / (cin * k[0] * k[1] * k[2]) ** 0.5).to(dev, tdt)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        g = torch.randn(batch, frames, cout, h, w, generator=gen).to(dev, tdt)
        pad = (k[0] // 2, k[1] // 2, k[2] // 2)
        # only the taps that land inside the clip and the frame: SAME padding adds zeros
        flops = 2.0 * batch * cout * cin * valid_taps(frames, k[0]) * valid_taps(h, k[1]) * valid_taps(w, k[2])
        x_ncdhw = torch.cat(xs, dim=2).transpose(1, 2).contiguous()
        g_ncdhw = g.transpose(1, 2).contiguous()
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()

        if not (tapdot and takes_tapdot(cins, cout, k, w)):
            out = conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias)
            again = conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias)
            torch.cuda.synchronize()
            err = check_close(f"conv {name}", out, conv3d.conv3d_cf_plain(xs[0], x2, kernel, bias), dtype)
            if not torch.equal(out, again):  # no split-K, no atomics: the same bits on every run
                raise AssertionError(f"conv {name}: two launches gave different bits")
            lib_bias = bias.to(tdt)
            _record(
                rows, conv3d.CONV3D, name, [batch, frames, list(cins), h, w, cout, list(k)], dtype, err,
                time_ms(lambda: conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias), 5),
                time_ms(lambda: conv3d.conv3d_cf_plain(xs[0], x2, kernel, bias), 1, warmup=0),
                time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), 5),
                "torch.nn.functional.conv3d (cuDNN), concatenated input",
                bound_ms(nbytes(*xs, kernel, bias, out), flops, dtype), forward_per,
                **device_times(lambda: conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias),
                               lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), flops),
            )
            del out, again

        # input gradient: the forward kernel on g with the flipped, IO-swapped kernel
        flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
        if not (tapdot and takes_tapdot((cout,), cin, k, w)):
            zero = torch.zeros(cin, dtype=torch.float32, device=dev)
            dx = conv3d.conv3d_cf_cuda(g, None, flipped, zero)
            again = conv3d.conv3d_cf_cuda(g, None, flipped, zero)
            torch.cuda.synchronize()
            err = check_close(f"conv dgrad {name}", dx, conv3d.conv3d_cf_plain(g, None, flipped, zero), dtype)
            if not torch.equal(dx, again):
                raise AssertionError(f"conv dgrad {name}: two launches gave different bits")
            w_flip = flipped.permute(4, 3, 0, 1, 2).contiguous()
            _record(
                rows, conv3d.CONV3D, f"{name} dgrad", [batch, frames, cout, h, w, cin, list(k)], dtype, err,
                time_ms(lambda: conv3d.conv3d_cf_cuda(g, None, flipped, zero), 5),
                time_ms(lambda: conv3d.conv3d_cf_plain(g, None, flipped, zero), 1, warmup=0),
                time_ms(lambda: F.conv3d(g_ncdhw, w_flip, padding=pad), 5),
                "torch.nn.functional.conv3d (cuDNN) of g, flipped kernel",
                bound_ms(nbytes(g, flipped, dx), flops, dtype), per_path({"train": 1}, {train: "train"}),
                **device_times(lambda: conv3d.conv3d_cf_cuda(g, None, flipped, zero),
                               lambda: F.conv3d(g_ncdhw, w_flip, padding=pad), flops),
            )
            del dx, again

        dw = conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k)
        again = conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k)
        torch.cuda.synchronize()
        err = check_close(f"conv wgrad {name}", dw, conv3d.conv3d_wgrad_plain(xs[0], x2, g, *k), "float32")
        if not torch.equal(dw, again):  # no atomics: the same bits on every run
            raise AssertionError(f"conv wgrad {name}: two launches gave different bits")
        del again
        w_shape = (cout, cin, *k)
        ms = time_ms(lambda: conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k), 5)
        cudnn_ms = time_ms(lambda: torch.nn.grad.conv3d_weight(x_ncdhw, w_shape, g_ncdhw, padding=pad), 5)
        log("wgrad-vs-cudnn", json.dumps({
            "case": name, "dtype": dtype, "variant": conv3d.wgrad_variant(tdt, w), "ms": ms, "cudnn_ms": cudnn_ms,
            "tflops": flops / ms / 1e9,
        }))
        _record(
            rows, conv3d.CONV3D_WGRAD, name, [batch, frames, list(cins), h, w, cout, list(k)], dtype, err,
            ms, time_ms(lambda: conv3d.conv3d_wgrad_plain(xs[0], x2, g, *k), 1, warmup=0), cudnn_ms,
            "torch.nn.grad.conv3d_weight (cuDNN), concatenated input",
            bound_ms(nbytes(*xs, g, dw), flops, dtype), per_path({"train": 1}, {train: "train"}),
            **device_times(lambda: conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k),
                           lambda: torch.nn.grad.conv3d_weight(x_ncdhw, w_shape, g_ncdhw, padding=pad), flops),
        )
        del xs, x2, g, dw, x_ncdhw, g_ncdhw, flipped
    torch.cuda.empty_cache()


def phase_mlp_kernel(cfg, dev, rows):
    """The MLP sublayer kernel against its plain version, both variants.

    N = 8192 rows is a b2 x 16f serving pass (or the train step's decoder, 2
    rollouts of 1 clip), N = 4096 the train step's encoder; a float32 x and a
    ragged row count are checked as well. The training variant returns y and
    the bf16 residuals xa and h, the inference variant y alone, and the two
    must give the same y; two launches of either variant give the same bits.
    Each line adds the device ms of the three launches from one profiler
    trace and each product's TFLOP/s. The library yardstick is the chain
    layer_norm -> linear -> silu -> linear -> add on bf16 weights. The bound counts x in, y
    out, the weights once (and the residuals written by the training variant)
    against the two products at the bf16 peak, whatever x's dtype.
    """
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import fused_block as fb

    gen = torch.Generator().manual_seed(30)
    C, Fd = cfg.embed_dim, cfg.mlp_dim
    enc, dec = 2 * cfg.encoder_depth, 2 * cfg.decoder_depth  # MLP sublayers per stack
    tokens = FRAMES * cfg.num_patches
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    lng, lnb, w1, b1, w2, b2 = (t.to(dev) for t in (
        1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, Fd) / C**0.5, 0.2 * rn(Fd), 0.1 * rn(Fd, C) / Fd**0.5,
        0.2 * rn(C),
    ))
    w16 = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
    cases = [  # (rows, dtype, launches per path of the inference variant, of the training variant)
        ((BATCH * tokens,), "bfloat16", {"serving-mlp": enc + dec, "serving-sublayer-mlp": enc + dec},
         {"train-mlp": dec}),
        ((TRAIN_BATCH * tokens,), "bfloat16", {}, {"train-mlp": enc}),
        ((BATCH * tokens,), "float32", {}, {}),
        ((1, 13), "bfloat16", {}, {}),
    ]
    for lead, dtype, per_inference, per_training in cases:
        tdt = getattr(torch, dtype)
        x = rn(*lead, C).to(dev, tdt)
        n = x.numel() // C

        def run(save):
            return fb.fused_mlp_sublayer_cuda(x, lng, lnb, w1, b1, w2, b2, save_residuals=save)

        def plain():
            return fb.fused_mlp_sublayer_plain(x, lng, lnb, w1, b1, w2, b2)

        def library():
            xa = F.layer_norm(x, (C,), lng.to(tdt), lnb.to(tdt), 1e-6).to(torch.bfloat16)
            return x + F.linear(F.silu(F.linear(xa, w16[0].t(), w16[1])), w16[2].t(), w16[3]).to(tdt)

        got = run(True)
        again, y_only, y_again = run(True), run(False), run(False)
        torch.cuda.synchronize()
        # bf16 GEMM operands on both sides whatever x's dtype: the bf16 bound
        err = max(check_close(f"mlp N={n} {dtype} {part}", a, b, "bfloat16")
                  for part, a, b in zip(("y", "xa", "h"), got, plain()))
        # no split-K, no atomics: the same bits on every launch of either variant
        if not (all(torch.equal(a, b) for a, b in zip(got, again)) and torch.equal(y_only[0], y_again[0])):
            raise AssertionError(f"mlp N={n} {dtype}: two launches gave different bits")
        del again, y_only, y_again
        # the autograd wrapper without a graph takes the inference variant, even
        # where its parameters require gradients, as a model's do
        leaves = [t.detach().requires_grad_() for t in (lng, lnb, w1, b1, w2, b2)]
        variants = dict(fb.VARIANT_LAUNCHES)
        with torch.no_grad():
            y = fb.fused_mlp_sublayer(x.reshape(1, n, C), *leaves).reshape(x.shape)
        torch.cuda.synchronize()
        if fb.VARIANT_LAUNCHES != {**variants, "inference": variants["inference"] + 1}:
            raise AssertionError(f"mlp N={n} {dtype}: no_grad launched {fb.VARIANT_LAUNCHES} after {variants}")
        if not torch.equal(y, got[0]):
            raise AssertionError(f"mlp N={n} {dtype}: the inference variant's y differs")
        plain_ms, library_ms = time_ms(plain, 2), time_ms(library, 10)
        library_device_ms = device_ms(library)
        product_flops = 2.0 * n * C * Fd
        for variant, save, per in (("inference", False, per_inference), ("training", True, per_training)):
            written = (x, *got[1:]) if save else (x,)
            # the kernel's three launches: token LN, xa·W1 with the SiLU epilogue, a·W2 + x;
            # the wrapper's casts of the f32 weights to bf16 count in device_ms only
            ln_ms, up_ms, down_ms = device_launch_ms(lambda: run(save), MLP_LAUNCHES)
            _record(
                rows, fb.FUSED_MLP, f"N={n} {variant} {dtype}", [n, C, Fd], dtype, err,
                time_ms(lambda: run(save), 10), plain_ms, library_ms,
                "layer_norm -> linear -> silu -> linear -> add, bf16 weights",
                bound_ms(nbytes(x, *written, *w16, lng, lnb), 2 * product_flops, "bfloat16"), per,
                device_ms=device_ms(lambda: run(save)), library_device_ms=library_device_ms,
                launch_device_ms={"ln": ln_ms, "up": up_ms, "down": down_ms},
                tflops={"up": product_flops / up_ms / 1e9, "down": product_flops / down_ms / 1e9},
            )
        del x, got, y
    torch.cuda.empty_cache()


def phase_tapdot_kernel(cfg, dev, rows):
    """The tap-dot conv against its plain version at every shape the gate sends
    it on the tap-dot path (forward convs, one and two sources, and input
    gradients), and once with the pooled second output; two launches give the
    same bits. The library yardstick is ``F.conv3d`` on the concatenated input.
    Each line adds the device ms of the kernel's launches (the channels-last
    copy of each source, then the GEMM; the wrapper's weight layout counts in
    ``device_ms`` only) and, on a "tapdot-vs-direct" line, the direct conv
    kernel's (#2, which the gate would take with the knob off) device ms and
    TFLOP/s on the same operands."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(31)
    forward, dgrad = tapdot_launches(cfg)
    shapes = list(dict.fromkeys([*forward, *dgrad]))
    dtype, tdt = "bfloat16", torch.bfloat16
    for i, key in enumerate(shapes):
        cins, cout, k, h, w = key
        cin = sum(cins)
        pool = i == 0  # the first shape also with the pooled output
        xs = [torch.randn(BATCH, FRAMES, c, h, w, generator=gen).to(dev, tdt) for c in cins]
        x2 = xs[1] if len(xs) == 2 else None
        kernel = (torch.randn(*k, cin, cout, generator=gen) / (cin * k[1] * k[2]) ** 0.5).to(dev, tdt)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        flops = 2.0 * BATCH * FRAMES * cout * cin * valid_taps(h, k[1]) * valid_taps(w, k[2])
        x_ncdhw = torch.cat(xs, dim=2).transpose(1, 2).contiguous()
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
        lib_bias = bias.to(tdt)
        per = {}
        if key in forward:
            per.update({"serving-tapdot": forward[key], "train-tapdot": forward[key]})
        if key in dgrad:
            per["train-tapdot"] = per.get("train-tapdot", 0) + dgrad[key]

        out = conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias)
        again = conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias)
        torch.cuda.synchronize()
        ref = conv3d.conv3d_tapdot_plain(xs[0], x2, kernel, bias, pool=pool)
        name = f"{'+'.join(map(str, cins))}->{cout} @{h}x{w}"
        err = check_close(f"tapdot {name}", out, ref[0] if pool else ref, dtype)
        if not torch.equal(out, again):  # no split-K, no atomics: the same bits on every run
            raise AssertionError(f"tapdot {name}: two launches gave different bits")
        del again
        times = device_times(lambda: conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias),
                             lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=(0, k[1] // 2, k[2] // 2)), flops)
        *copies, gemm = device_launch_ms(lambda: conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias),
                                         TAPDOT_LAUNCHES[-len(xs) - 1:])
        direct_ms = device_ms(lambda: conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias))
        log("tapdot-vs-direct", json.dumps({
            "case": name, "launches_per_step": per.get("train-tapdot", 0), "tapdot_device_ms": times["device_ms"],
            "tapdot_tflops": times["tflops"], "direct_device_ms": direct_ms, "direct_tflops": flops / direct_ms / 1e9,
            "cudnn_device_ms": times["library_device_ms"],
            "cudnn_tflops": flops / times["library_device_ms"] / 1e9,
        }))
        _record(
            rows, conv3d.CONV3D_TAPDOT, name, [BATCH, FRAMES, list(cins), h, w, cout, list(k)], dtype, err,
            time_ms(lambda: conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias), 5),
            time_ms(lambda: conv3d.conv3d_tapdot_plain(xs[0], x2, kernel, bias), 1, warmup=0),
            time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=(0, k[1] // 2, k[2] // 2)), 5),
            "torch.nn.functional.conv3d (cuDNN), concatenated input",
            bound_ms(nbytes(*xs, kernel, bias, out), flops, dtype), per, **times,
            launch_device_ms={"copy": sum(copies), "gemm": gemm}, direct_device_ms=direct_ms,
        )
        if pool:
            full, pooled = conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=True)
            torch.cuda.synchronize()
            if not torch.equal(full, out):
                raise AssertionError(f"tapdot {name}: the pooled variant's full output differs")
            err = check_close(f"tapdot {name} pooled", pooled, ref[1], dtype)
            _record(
                rows, conv3d.CONV3D_TAPDOT, f"{name} pooled", [BATCH, FRAMES, list(cins), h, w, cout, list(k)],
                dtype, err,
                time_ms(lambda: conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=True), 5),
                time_ms(lambda: conv3d.conv3d_tapdot_plain(xs[0], x2, kernel, bias, pool=True), 1, warmup=0),
                time_ms(lambda: F.max_pool3d(F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=(0, k[1] // 2, k[2] // 2)),
                                             (1, 2, 2)), 5),
                "conv3d (cuDNN) then max_pool3d",
                bound_ms(nbytes(*xs, kernel, bias, full, pooled), flops, dtype), {},
                **device_times(lambda: conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias, pool=True),
                               lambda: F.max_pool3d(F.conv3d(x_ncdhw, w_oidhw, lib_bias,
                                                             padding=(0, k[1] // 2, k[2] // 2)), (1, 2, 2)), flops),
            )
            del full, pooled
        del xs, x2, out, ref, x_ncdhw
    torch.cuda.empty_cache()


def phase_pooled_conv(cfg, dev, rows):
    """``conv3d_cf_pooled`` through the direct conv kernel at the flagship's first
    level-0 shape (12 -> 16 at 256 x 256), bf16 and f32: both outputs against the
    plain version, the full output against the kernel without the pool, and the
    float32 gradients of a loss on both outputs against the CPU's at a cut frame."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(32)
    name, h, w, cins, cout, k, _ = conv_cases(cfg)[1]
    cin = cins[0]
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        x = torch.randn(BATCH, FRAMES, cin, h, w, generator=gen).to(dev, tdt)
        kernel = (torch.randn(*k, cin, cout, generator=gen) / (cin * k[0] * k[1] * k[2]) ** 0.5).to(dev, tdt)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        flops = 2.0 * BATCH * cout * cin * valid_taps(FRAMES, k[0]) * valid_taps(h, k[1]) * valid_taps(w, k[2])
        before = conv3d.CONV3D.launches
        full, pooled = conv3d.conv3d_cf_pooled(x, kernel, bias)
        torch.cuda.synchronize()
        if conv3d.CONV3D.launches != before + 1:
            raise AssertionError("conv3d_cf_pooled did not launch the direct conv kernel once")
        ref_full, ref_pooled = conv3d.conv3d_cf_plain(x, None, kernel, bias, pool=True)
        err = max(check_close(f"pooled conv {dtype} full", full, ref_full, dtype),
                  check_close(f"pooled conv {dtype} pooled", pooled, ref_pooled, dtype))
        if not torch.equal(full, conv3d.conv3d_cf_cuda(x, None, kernel, bias)):
            raise AssertionError(f"pooled conv {dtype}: the full output differs from the unpooled kernel's")
        x_ncdhw = x.transpose(1, 2).contiguous()
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
        lib_bias, pad = bias.to(tdt), tuple(s // 2 for s in k)
        if dtype == "bfloat16":  # no split-K, no atomics: the same bits on every run
            again = conv3d.conv3d_cf_cuda(x, None, kernel, bias, pool=True)
            torch.cuda.synchronize()
            if not (torch.equal(full, again[0]) and torch.equal(pooled, again[1])):
                raise AssertionError("pooled conv: two launches gave different bits")
            del again
        _record(
            rows, conv3d.CONV3D, f"{name} pooled {dtype}", [BATCH, FRAMES, [cin], h, w, cout, list(k)], dtype, err,
            time_ms(lambda: conv3d.conv3d_cf_cuda(x, None, kernel, bias, pool=True), 5),
            time_ms(lambda: conv3d.conv3d_cf_plain(x, None, kernel, bias, pool=True), 1, warmup=0),
            time_ms(lambda: F.max_pool3d(F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), (1, 2, 2)), 5),
            "conv3d (cuDNN) then max_pool3d",
            bound_ms(nbytes(x, kernel, bias, full, pooled), flops, dtype), {},
            **device_times(lambda: conv3d.conv3d_cf_cuda(x, None, kernel, bias, pool=True),
                           lambda: F.max_pool3d(F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), (1, 2, 2)),
                           flops),
        )
        del full, pooled, ref_full, ref_pooled, x_ncdhw
        if dtype != "float32":
            continue
        # The backward at a cut frame, against the CPU's (the plain versions), in
        # float32 only: the pool's VJP follows the argmax of the saved output, and
        # a bf16 rounding that differs between card and CPU would move it.
        leaves = [t[:1, :2, :, :32, :64].contiguous().requires_grad_() if t is x else t.clone().requires_grad_()
                  for t in (x, kernel, bias)]
        outs = conv3d.conv3d_cf_pooled(*leaves)
        gs = [torch.randn(o.shape, generator=gen).to(dev, tdt) for o in outs]
        grads = torch.autograd.grad(outs, leaves, gs)
        cpu = [t.detach().cpu().requires_grad_() for t in leaves]
        refs = torch.autograd.grad(conv3d.conv3d_cf_pooled(*cpu), cpu, [g.cpu() for g in gs])
        worst = max(check_close(f"pooled conv {dtype} d{part}", a.cpu(), b, dtype)
                    for part, a, b in zip(("x", "kernel", "bias"), grads, refs))
        log("pooled-conv-backward", json.dumps({"dtype": dtype, "max_abs_err": worst}))
        del x
    torch.cuda.empty_cache()


def random_final_conv(model, gen):
    """Redraw the UNet's zero-initialised final conv, which would hide the whole UNet."""
    import torch

    with torch.no_grad():
        fc = model.decoder.unet.final_conv.kernel
        fc.copy_((torch.randn(fc.shape, generator=gen) / fc.shape[-2] ** 0.5).to(fc.device))


def phase_f32_forward(dev, path="fused"):
    """Flagship width, depth 1: the float32 serving pass on the card against the CPU.

    The fused sublayers round their GEMM operands to bf16 by design, on both
    devices, so there a rounding that flips is a bf16 step: those paths are
    held to the bf16 bound instead.
    """
    import torch

    from video_vae_tpu_torch import ModelConfig, VideoVAE, reconstruct

    tol = KERNEL_TOL["bfloat16"] if rounds_to_bf16(path) else FORWARD_F32_TOL
    with model_path(ModelConfig(dtype="float32", encoder_depth=1, decoder_depth=1), path) as cfg:
        cpu_model = VideoVAE(cfg, device="cpu", seed=1)
        gen = torch.Generator().manual_seed(2)
        random_final_conv(cpu_model, gen)
        gpu_model = VideoVAE(cfg, device=dev, seed=1)
        gpu_model.load_state_dict(cpu_model.state_dict())
        video = torch.rand(1, 8, cfg.height, cfg.width, cfg.channels, generator=gen)
        mask = torch.ones(1, 8)
        mask[0, 6:] = 0
        with torch.inference_mode():
            keep_cpu = cpu_model.encode(video, mask)[2] >= 0.5
            keep_gpu = (gpu_model.encode(video.to(dev), mask.to(dev))[2] >= 0.5).cpu()
        if not torch.equal(keep_cpu, keep_gpu):
            raise AssertionError(f"keep decisions differ: cpu {keep_cpu.ravel()} gpu {keep_gpu.ravel()}")
        ref = reconstruct(cpu_model, video, mask, device="cpu")
        out = reconstruct(gpu_model, video.to(dev), mask.to(dev), device=dev).cpu()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"f32 forward: shape {tuple(out.shape)} or non-finite values")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    if not rel <= tol:
        raise AssertionError(f"f32 forward ({path}) card vs CPU: relative max-abs error {rel} > {tol}")
    log("f32-forward", json.dumps({
        "path": path,
        "config": "flagship width, encoder/decoder depth 1, b1 x 8 frames (2 padded)",
        "rel_max_abs_err": rel, "tol": tol, "kept_frames": int(keep_cpu.sum()),
    }))


def reset_launches():
    from video_vae_tpu_torch.ops import KERNELS, conv3d, fused_block
    from video_vae_tpu_torch.ops import flash_attention as fa

    for kernel in KERNELS:
        kernel.launches = 0
    for counts in (fused_block.VARIANT_LAUNCHES, conv3d.WGRAD_VARIANT_LAUNCHES, fa.FWD_VARIANT_LAUNCHES,
                   fa.BWD_VARIANT_LAUNCHES, fa.WIDE_LAUNCHES):
        for variant in counts:
            counts[variant] = 0


def read_launches() -> dict:
    from video_vae_tpu_torch.ops import KERNELS, conv3d, fused_block
    from video_vae_tpu_torch.ops import flash_attention as fa

    counts = {kernel.symbol: kernel.launches for kernel in KERNELS}
    for variants, symbol in ((fused_block.VARIANT_LAUNCHES, "vvt_fused_mlp"),
                             (conv3d.WGRAD_VARIANT_LAUNCHES, "vvt_conv3d_wgrad"),
                             (fa.FWD_VARIANT_LAUNCHES, "vvt_fused_attention_fwd"),
                             (fa.BWD_VARIANT_LAUNCHES, "vvt_fused_attention_bwd")):
        if sum(variants.values()) != counts[symbol]:
            raise AssertionError(f"{symbol}'s variants {variants} do not add up to its {counts[symbol]}")
    return {**counts, MLP_TRAINING_VARIANT: fused_block.VARIANT_LAUNCHES["training"],
            WGRAD_WGMMA_VARIANT: conv3d.WGRAD_VARIANT_LAUNCHES["wgmma"],
            ATTN_BWD_WGMMA_TILE: fa.BWD_VARIANT_LAUNCHES["tile_wg"],
            **{ATTN_WIDE[symbol]: fa.WIDE_LAUNCHES[symbol] for symbol in ATTN_WIDE}}


def no_launches() -> dict:
    """Every key :func:`read_launches` returns, at 0."""
    from video_vae_tpu_torch.ops import KERNELS

    return {**{kernel.symbol: 0 for kernel in KERNELS}, MLP_TRAINING_VARIANT: 0, WGRAD_WGMMA_VARIANT: 0,
            ATTN_BWD_WGMMA_TILE: 0, **{key: 0 for key in ATTN_WIDE.values()}}


def takes_wide(head_dim: int) -> bool:
    """Whether the attention kernels run a call at ``head_dim`` on their wide variant."""
    from video_vae_tpu_torch.ops import flash_attention as fa

    return fa.is_wide(fa.padded_head_dim(head_dim))


def takes_wgmma_tile(seq: int, head_dim: int) -> bool:
    """Whether a bf16 fused attention backward at (S, D) runs the wgmma tile kernel
    (at the instantiation D pads to)."""
    from video_vae_tpu_torch.ops import flash_attention as fa

    return fa.fused_attention_bwd_plan(1, seq, 1, fa.padded_head_dim(head_dim))[0] == "tile_wg"


def expected_launches(cfg, entry: str, path: str) -> dict:
    """Launches of every kernel in one serving pass or one train step on a path.

    Two attention calls and two MLP sublayers per block; the mixer, 2 convs
    per down and up block and 2 bottleneck convs. A train step adds each
    conv's input gradient (a forward kernel again) and filter gradient, and
    each attention's backward; the attention sublayer's backward is the fused
    attention backward, the MLP sublayer's has no kernel. The fused attention
    backward's spatial calls run its wgmma tile kernel where the plan gives it
    (``takes_wgmma_tile``: S = 196 or 256 at head dims 64 and 128); its temporal
    ones (S = the frames, at most 64 at every entry here) the slab. Past head dim
    128 every attention launch is on the kernel's wide variant (``takes_wide``),
    counted under ``ATTN_WIDE``. Every filter gradient
    of a bf16 step whose frame width is a multiple of 8 runs the wgmma kernel
    (``conv3d.wgrad_variant``). The MLP kernel runs
    its training variant (the residuals written) in a train step and its
    inference variant in a serving pass, whose parameters require gradients
    all the same. With ``VVT_TAPDOT`` the convs and input gradients that pass
    its gate go to the tap-dot kernel.
    """
    import torch

    from video_vae_tpu_torch.ops import conv3d

    impl, knobs = MODEL_PATHS[path]
    attn = 2 * (cfg.encoder_depth + cfg.decoder_depth)
    convs = 1 + 4 * cfg.unet_levels + 2
    train = entry == "train"
    forward, backward = {
        "fused": ("vvt_fused_attention_fwd", "vvt_fused_attention_bwd"),
        "pallas": ("vvt_flash_attention_fwd", "vvt_flash_attention_bwd"),
    }[impl]
    if "VVT_ATTN_SUBLAYER" in knobs:
        forward = "vvt_attention_sublayer"
    want = no_launches()
    wide = takes_wide(cfg.head_dim)
    want["vvt_conv3d_cf"] = 2 * convs if train else convs
    want[forward] = attn
    if wide:
        want[ATTN_WIDE[forward]] = attn
    if "VVT_MLP_FUSED" in knobs:
        want["vvt_fused_mlp"] = attn
        want[MLP_TRAINING_VARIANT] = attn if train else 0
    if train:
        want["vvt_conv3d_wgrad"] = convs
        want[WGRAD_WGMMA_VARIANT] = sum(conv3d.wgrad_variant(torch.bfloat16, w) == "wgmma"
                                        for _, _, w, _, _, _, dtype in conv_cases(cfg) if dtype == "bfloat16")
        want[backward] = attn
        if wide:
            want[ATTN_WIDE[backward]] = attn
        if backward == "vvt_fused_attention_bwd" and takes_wgmma_tile(cfg.num_patches, cfg.head_dim):
            want[ATTN_BWD_WGMMA_TILE] = attn // 2  # one spatial call a block
    if "VVT_TAPDOT" in knobs:
        fwd, dgrad = (sum(d.values()) for d in tapdot_launches(cfg))
        want["vvt_conv3d_tapdot"] = fwd + dgrad if train else fwd
        want["vvt_conv3d_cf"] -= want["vvt_conv3d_tapdot"]
    return want


# each serving phase's median ms and device ms a pass, by label (the "slope-serving" line
# prints the default path's beside its slope)
SERVING_RECORD: dict = {}


def phase_serving(cfg, dev, path="fused", reference=None, timed=TIMED_FORWARDS, redraw_final_conv=False,
                  label=None):
    """The bf16 b2 x 16f serving pass of ``cfg`` on one path: launch counts of
    one pass, its time, its profile. ``reference`` is the (output, keep
    probabilities) of the path this one is held to: the default path's on the
    flagship, the knob-off run's on the tap-dot model (whose final conv is
    redrawn, or the zero-initialised one would hide the UNet from the
    comparison). ``label`` names a model other than the path's. Returns
    (launches, (output, probabilities))."""
    import torch

    from video_vae_tpu_torch import VideoVAE, reconstruct

    label = label or path_name("serving", path)
    with model_path(cfg, path) as cfg:
        model = VideoVAE(cfg, device=dev, seed=0)
        if redraw_final_conv:
            random_final_conv(model, torch.Generator().manual_seed(33))
        video, mask = _serving_batch(cfg, dev)

        reset_launches()
        out = reconstruct(model, video, mask, device=dev)
        torch.cuda.synchronize()
        launches = read_launches()

        want = (BATCH, FRAMES, cfg.height, cfg.width, cfg.channels)
        if tuple(out.shape) != want or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{label} pass: shape {tuple(out.shape)} (want {want}) or non-finite")
        expected = expected_launches(cfg, "serving", path)
        if launches != expected:
            raise AssertionError(f"launches per {label} pass {launches}, expected {expected}")
        with torch.inference_mode():
            prob = model.encode(video.to(cfg.compute_dtype()), mask)[2].float()
        versus = {}
        if reference is not None:
            ref_out, ref_prob = reference
            rel = ((out.float() - ref_out.float()).abs().max() / ref_out.float().abs().max()).item()
            clear = ((ref_prob - 0.5).abs() > MIN_MARGIN) & ((prob - 0.5).abs() > MIN_MARGIN)
            if not rel <= PATH_BF16_TOL:
                raise AssertionError(f"{label} vs its reference path: relative max-abs error {rel} > {PATH_BF16_TOL}")
            if not torch.equal((prob >= 0.5)[clear], (ref_prob >= 0.5)[clear]):
                raise AssertionError(f"{label}: keep decisions differ from its reference path's")
            versus = {"rel_max_abs_err_vs_reference": rel, "tol": PATH_BF16_TOL,
                      "keep_decisions_compared": int(clear.sum()), "kept": int((prob >= 0.5).sum())}

        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            reconstruct(model, video, mask, device=dev)
        times = []
        for _ in range(timed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            reconstruct(model, video, mask, device=dev)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        log(label, json.dumps({
            "config": f"{describe(cfg)}, bf16, b{BATCH} x {FRAMES} frames, path {path}",
            "launches": launches, "ms_per_forward_median": ms, "clips_per_s": BATCH / (ms / 1e3),
            "ms_per_forward_all": times,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30, **versus,
        }))
        profile = profile_device(label, lambda: reconstruct(model, video, mask, device=dev), ms,
                                 passes=3 if path == "fused" else 2)
        SERVING_RECORD[label] = {"ms_per_forward_median": ms, "device_ms": profile["device_busy_ms_per_run"]}
    del model
    torch.cuda.empty_cache()
    return launches, (out, prob)


def profile_device(label: str, run, ms_per_run: float, passes: int = 3):
    """torch.profiler over ``passes`` runs: device time per launching op, idle share.

    Each device kernel is charged to the innermost torch op that launched it
    (the profiler's launch correlation), keyed by the op's name and input
    shapes. The port's kernels launch through ctypes, outside any torch op:
    they are the device time that no op claims, listed by kernel name.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        start.record()
        for _ in range(passes):
            run()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / passes
    by_kernel: dict[str, float] = {}  # device ms per kernel name, all launches
    claimed: dict[str, float] = {}  # device ms per kernel name launched inside a torch op
    by_op: dict[str, list] = {}  # "op shapes" -> [device ms, kernels]
    by_op_name: dict[str, float] = {}
    by_rank: dict[str, float] = {}  # rank 3: the blocks' (B,S,·) tokens; 5-6: the UNet's (b,t,c,h,w)
    count = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            count += 1
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / passes
        elif ev.kernels:
            ms = sum(k.duration for k in ev.kernels) / 1e3 / passes
            for k in ev.kernels:
                claimed[k.name] = claimed.get(k.name, 0.0) + k.duration / 1e3 / passes
            entry = by_op.setdefault(f"{ev.name} {ev.input_shapes}"[:120], [0.0, 0])
            entry[0] += ms
            entry[1] += len(ev.kernels) / passes
            by_op_name[ev.name] = by_op_name.get(ev.name, 0.0) + ms
            rank = f"rank {len(ev.input_shapes[0]) if ev.input_shapes else 0}"
            by_rank[rank] = by_rank.get(rank, 0.0) + ms
    busy = sum(by_kernel.values())
    unclaimed = {name: ms - claimed.get(name, 0.0) for name, ms in by_kernel.items()}
    unclaimed = {name[:90]: ms for name, ms in sorted(unclaimed.items(), key=lambda kv: -kv[1]) if ms > 1e-3}
    log(f"profile-{label}", json.dumps({
        "ms_per_run_window": window_ms, "device_busy_ms_per_run": busy,
        "device_ops_per_run": count / passes,
        "idle_share_profiled": 1.0 - busy / window_ms,
        "idle_share_vs_median": 1.0 - busy / ms_per_run,
        "claimed_by_torch_ops_ms": sum(by_op_name.values()),
        "op_ms_per_run": dict(sorted(by_op_name.items(), key=lambda kv: -kv[1])),
        "op_ms_by_first_input_rank": dict(sorted(by_rank.items())),
        "unclaimed_ms_per_run": unclaimed,
    }))
    for key, (ms, kernels) in sorted(by_op.items(), key=lambda kv: -kv[1][0]):
        if ms >= 0.05:
            log(f"profile-{label}-op {ms:9.4f} ms/run {kernels:6.1f} kernels  {key}")
    return {"device_busy_ms_per_run": busy, "device_ops_per_run": count / passes,
            "idle_share_vs_median": 1.0 - busy / ms_per_run}


def _draws(model, video, mask, seed, rollouts_differ=False):
    """Latent noise and Bernoulli uniforms from ``seed``, with no near-tie keep decision.

    With ``rollouts_differ`` the two rollouts of a clip also keep different
    frames of the clip: where they keep the same ones, the REINFORCE advantage
    is 0 and the selection head's gradient is exactly 0, which leaves a
    card-vs-CPU comparison of that gradient nothing but rounding to compare.
    """
    import torch

    with torch.no_grad():
        mean, _, prob = model.encode(video, mask)
    p = prob.float().repeat_interleave(2, dim=0)[..., None].cpu()
    valid = mask.cpu()[..., None, None] > 0
    for s in range(seed, seed + 100):
        gen = torch.Generator().manual_seed(s)
        noise = torch.randn(mean.shape, generator=gen)
        uniforms = torch.rand(p.shape, generator=gen)
        keep = uniforms < p
        if rollouts_differ and torch.equal(keep[0::2][valid], keep[1::2][valid]):
            continue
        if (uniforms - p).abs().min() > MIN_MARGIN:
            return noise, uniforms
    raise AssertionError("no draw without a near-tie keep decision")


def _hold_grads(label: str, names, card, cpu, noise: dict) -> tuple[float, str]:
    """Each card gradient within ``GRAD_F32_TOL`` of its CPU leaf's largest value; a leaf
    named in ``noise`` (its bound's share of the largest gradient) is rounding noise on
    both devices and held under that. Returns the worst (relative error, leaf)."""
    worst = (0.0, "")
    scale = max((float(b.abs().max()) for b in cpu), default=0.0)
    for name, a, b in zip(names, card, cpu):
        if name in noise:
            if not max(float(a.abs().max()), float(b.abs().max())) <= noise[name] * scale:
                raise AssertionError(f"{label} gradient {name}: {float(a.abs().max())} on the card, "
                                     f"{float(b.abs().max())} on the CPU, over {noise[name]} * {scale}")
            continue
        rel = ((a - b).abs().max() / b.abs().max()).item()
        if not (a - b).abs().max() <= GRAD_F32_TOL * b.abs().max():
            raise AssertionError(f"{label} gradient {name}: relative error {rel} > {GRAD_F32_TOL}")
        worst = max(worst, (rel, name))
    return worst


def _noise_leaves(names, cpu) -> dict:
    """{name: ZERO_GRAD_TOL} of the leaves whose CPU gradient is rounding noise, under
    ``ZERO_GRAD_TOL`` of the largest: a true gradient of 0 (the selection head's biases,
    some conv biases), held to stay noise on the card."""
    scale = max(float(b.abs().max()) for b in cpu)
    return {name: ZERO_GRAD_TOL for name, b in zip(names, cpu) if float(b.abs().max()) <= ZERO_GRAD_TOL * scale}


def _hold_metrics(label: str, card: dict, cpu: dict) -> dict:
    """Card metrics against the CPU's (perceptual 1e-3, the others 1e-4); ``rl_loss``,
    0 up to rounding, is held absolutely. Returns the errors."""
    if set(card) != set(cpu):
        raise AssertionError(f"{label}: metrics {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    errs = {}
    for key, ref in cpu.items():
        tol = PERCEPTUAL_F32_TOL if key == "perceptual_loss" else TRAIN_F32_TOL
        scale = 1.0 if key == "rl_loss" else abs(ref)
        errs[key] = abs(card[key] - ref) / scale if scale else abs(card[key] - ref)
        if not abs(card[key] - ref) <= tol * scale:
            raise AssertionError(f"{label} {key}: card {card[key]} vs CPU {ref}")
    return errs


def phase_f32_train(dev, tiny=False, h4=False, d96=False, d256=False):
    """Flagship width, depth 1, b1 x 4 frames: one f32 train step, card against CPU.

    ``tiny``: ``tiny_config`` itself in float32 (head_dim 16, no perceptual term, as
    its LossConfig) on 2 clips of 8 frames; a gradient that is rounding noise on the
    CPU (``ZERO_GRAD_TOL``) is held to stay noise, as :func:`phase_f32_modes` holds it.
    ``h4``: the flagship's width in 4 heads of 128 (:func:`h4_config`), otherwise as
    the default ("f32-h4"); ``d96``: in 8 heads of 96 (:func:`d96_config`, the
    kernels padded to 128; "f32-d96"); ``d256``: in 2 heads of 256
    (:func:`d256_config`, the kernels' wide variant; "f32-d256").
    """
    import torch

    from video_vae_tpu_torch import DynamicHParams, LossConfig, ModelConfig, VideoVAE
    from video_vae_tpu_torch.losses import make_perceptual_loss_fn
    from video_vae_tpu_torch.models.vgg import load_vgg
    from video_vae_tpu_torch.train.step import loss_and_grads

    if tiny:
        tiny_cfg = cli_config(TINY_ARGS)
        cfg, loss_cfg, clips, frames = (tiny_cfg.model.replace(dtype="float32"), tiny_cfg.loss,
                                        tiny_cfg.data.batch_size, tiny_cfg.data.max_frames)
        label, text = "f32-tiny", f"tiny_config, float32, b{clips} x {frames} frames (3 padded), perceptual off"
    else:
        base = h4_config() if h4 else d96_config() if d96 else d256_config() if d256 else ModelConfig()
        cfg = base.replace(dtype="float32", encoder_depth=1, decoder_depth=1, remat=False)
        loss_cfg, clips, frames = LossConfig(), 1, 4
        label, text = "f32-train", "flagship width, encoder/decoder depth 1, b1 x 4 frames (1 padded), perceptual on"
        if h4:
            label, text = "f32-h4", text.replace("flagship width", "flagship width in 4 heads of 128")
        if d96:
            label, text = "f32-d96", text.replace("flagship width", "flagship width in 8 heads of 96")
        if d256:
            label, text = "f32-d256", text.replace("flagship width", "flagship width in 2 heads of 256")
    hp = DynamicHParams.default()
    cpu_model = VideoVAE(cfg, device="cpu", seed=4)
    gen = torch.Generator().manual_seed(5)
    random_final_conv(cpu_model, gen)  # the zero-initialised one would cut the UNet's gradients
    gpu_model = VideoVAE(cfg, device=dev, seed=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    video = torch.rand(clips, frames, cfg.height, cfg.width, cfg.channels, generator=gen)
    mask = torch.ones(clips, frames)
    mask[-1, frames - 1 if not tiny else frames - 3:] = 0
    noise, uniforms = _draws(cpu_model, video, mask, seed=6)

    results = {}
    for name, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        perceptual = make_perceptual_loss_fn(load_vgg(None, device=device)) if loss_cfg.use_perceptual else None
        loss, metrics, grads = loss_and_grads(
            model, video.to(device), mask.to(device), hp, loss_cfg, perceptual,
            noise=noise.to(device), uniforms=uniforms.to(device),
        )
        results[name] = ({k: float(v.detach()) for k, v in metrics.items()}, [g.cpu() for g in grads])
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results["gpu"]
    errs = _hold_metrics(f"{label} step", m_gpu, m_cpu)
    names = [name for name, _ in cpu_model.named_parameters()]
    noise = _noise_leaves(names, g_cpu) if tiny else {}
    worst = _hold_grads(f"{label} step", names, g_gpu, g_cpu, noise)
    log(label, json.dumps({
        "config": text,
        "metrics_cpu": m_cpu, "metric_rel_err": errs, "worst_grad_rel_err": worst[0],
        "worst_grad_leaf": worst[1], "leaves": len(g_cpu), "leaves_at_rounding_noise": len(noise),
        "tols": [TRAIN_F32_TOL, PERCEPTUAL_F32_TOL, GRAD_F32_TOL] + ([ZERO_GRAD_TOL] if tiny else []),
    }))
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def _ste_uniforms(model, video, mask, seed):
    """(b, t, 1) uniforms for the ``"ste"`` gate whose noisy sigmoid stays clear of 0.5."""
    import torch

    with torch.no_grad():
        logits = torch.logit(model.encode(video, mask)[2].float().cpu())
    for s in range(seed, seed + 100):
        uniforms = torch.rand(logits.shape, generator=torch.Generator().manual_seed(s))
        gate = torch.sigmoid(logits + torch.log(uniforms / (1 - uniforms)))
        if (gate - 0.5).abs().min() > MIN_MARGIN:
            return uniforms
    raise AssertionError("no draw without a near-tie ste gate")


def phase_f32_modes(dev):
    """Flagship width, depth 1, b1 x 4 frames, float32, card against CPU: one train
    step with ``selection_mode="ste"``, one with ``scan_rollout_decode=True``
    (each: loss, metrics, every gradient), and the eval step's metrics with
    ``psnr_sampled``, under :func:`phase_f32_train`'s bounds; a gradient that
    is rounding noise on the CPU (``ZERO_GRAD_TOL``) is held to stay noise."""
    import torch

    from video_vae_tpu_torch import DynamicHParams, LossConfig, ModelConfig, VideoVAE, eval_step
    from video_vae_tpu_torch.losses import make_perceptual_loss_fn
    from video_vae_tpu_torch.models.vgg import load_vgg
    from video_vae_tpu_torch.train.step import loss_and_grads

    loss_cfg, hp = LossConfig(), DynamicHParams.default()
    modes = (("ste", {"selection_mode": "ste"}), ("scan_rollout_decode", {"scan_rollout_decode": True}),
             ("eval_step", {}))
    for label, overrides in modes:
        cfg = ModelConfig(dtype="float32", encoder_depth=1, decoder_depth=1, remat=False, **overrides)
        cpu_model = VideoVAE(cfg, device="cpu", seed=11)
        gen = torch.Generator().manual_seed(12)
        random_final_conv(cpu_model, gen)
        gpu_model = VideoVAE(cfg, device=dev, seed=11)
        gpu_model.load_state_dict(cpu_model.state_dict())
        video = torch.rand(1, 4, cfg.height, cfg.width, cfg.channels, generator=gen)
        mask = torch.ones(1, 4)
        mask[0, 3:] = 0
        if label == "ste":
            noise, _ = _draws(cpu_model, video, mask, seed=13)
            uniforms = _ste_uniforms(cpu_model, video, mask, seed=13)
        else:
            noise, uniforms = _draws(cpu_model, video, mask, seed=13, rollouts_differ=True)
        results = {}
        for name, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
            perceptual = make_perceptual_loss_fn(load_vgg(None, device=device))
            draws = {"noise": noise.to(device), "uniforms": uniforms.to(device)}
            if label == "eval_step":
                metrics = eval_step(model, video.to(device), mask.to(device), hp, loss_cfg, perceptual, **draws)
                grads = []
            else:
                _, metrics, grads = loss_and_grads(model, video.to(device), mask.to(device), hp, loss_cfg,
                                                   perceptual, **draws)
            results[name] = ({k: float(v.detach()) for k, v in metrics.items()}, [g.cpu() for g in grads])
        (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results["gpu"]
        errs = _hold_metrics(f"f32 {label}", m_gpu, m_cpu)
        names = [name for name, _ in cpu_model.named_parameters()]
        noise = _noise_leaves(names, g_cpu) if g_cpu else {}
        worst = _hold_grads(f"f32 {label}", names, g_gpu, g_cpu, noise)
        log(f"f32-{label}", json.dumps({
            "config": f"flagship width, encoder/decoder depth 1, b1 x 4 frames (1 padded), perceptual on, {overrides}",
            "metrics_cpu": m_cpu, "metric_rel_err": errs, "worst_grad_rel_err": worst[0],
            "worst_grad_leaf": worst[1], "leaves": len(g_cpu), "leaves_at_rounding_noise": len(noise),
            "tols": [TRAIN_F32_TOL, PERCEPTUAL_F32_TOL, GRAD_F32_TOL, ZERO_GRAD_TOL],
        }))
        del cpu_model, gpu_model
    torch.cuda.empty_cache()


def _set_remat(model, on: bool):
    for module in model.modules():
        if hasattr(module, "remat"):
            module.remat = on


def phase_train(cfg, dev, path="fused", reference=None, timed=TIMED_STEPS, redraw_final_conv=False, label=None):
    """The bf16 b1 x 16f train step of ``cfg`` on one path.

    Launch counts of one step, checks of the metrics and the update, the step
    time and peak memory, then the loss for fixed draws. Without a
    ``reference`` those draws are made here (and on the default path the
    remat-on step is held to the remat-off one); a path with a ``reference``
    (draws, loss, kept-frame density of the path it is held to) is compared
    with it. The tap-dot model's final conv is redrawn, or the
    zero-initialised one would cut the UNet's gradients. ``label`` names a
    model other than the path's (no remat comparison, one profiled step).
    Returns (launches, reference).
    """
    import torch

    from video_vae_tpu_torch import (
        DynamicHParams,
        LossConfig,
        OptimConfig,
        VideoVAE,
        build_perceptual,
        create_optimizer,
        train_step,
    )
    from video_vae_tpu_torch.train.step import loss_and_grads

    default = path == "fused" and label is None
    label = label or path_name("train", path)
    with model_path(cfg, path) as cfg:
        model = VideoVAE(cfg, device=dev, seed=0)
        if redraw_final_conv:
            random_final_conv(model, torch.Generator().manual_seed(33))
        opt = create_optimizer(model, OptimConfig())
        loss_cfg, hp = LossConfig(), DynamicHParams.default()
        perceptual = build_perceptual(loss_cfg, device=dev)
        gen = torch.Generator().manual_seed(8)
        video = torch.rand(TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
        mask = torch.ones(TRAIN_BATCH, FRAMES, device=dev)
        draws = torch.Generator(device=dev).manual_seed(9)
        video_c = video.to(cfg.compute_dtype())

        # the loss for fixed draws, before any update: what the paths are compared on
        if reference is None:
            noise, uniforms = _draws(model, video_c, mask, seed=10)
        else:
            noise, uniforms = reference["draws"]
        torch.backends.cudnn.deterministic = True  # the VGG's cuDNN algorithms, run to run
        loss0, metrics0, grads0 = loss_and_grads(model, video_c, mask, hp, loss_cfg, perceptual,
                                                 noise=noise.to(dev), uniforms=uniforms.to(dev))
        fixed = {"loss": float(loss0.detach()), "kept_frame_density": float(metrics0["kept_frame_density"]),
                 "perceptual_loss": float(metrics0["perceptual_loss"].detach())}
        versus = {}
        if default:
            # remat on and off: the same loss and gradients for the same draws
            _set_remat(model, True)
            loss1, _, grads1 = loss_and_grads(model, video_c, mask, hp, loss_cfg, perceptual,
                                              noise=noise.to(dev), uniforms=uniforms.to(dev))
            _set_remat(model, False)
            l0, l1 = fixed["loss"], float(loss1.detach())
            worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                        for a, b in zip(grads1, grads0))
            if not (abs(l0 - l1) <= 1e-6 * abs(l0) and worst <= 1e-5):
                raise AssertionError(f"remat on vs off: loss {l1} vs {l0}, worst gradient error {worst}")
            log("train-remat", json.dumps({"loss_remat_off": l0, "loss_remat_on": l1, "worst_grad_rel_err": worst}))
            del grads1
        if reference is not None:
            ref_loss = reference["loss"]
            if fixed["kept_frame_density"] != reference["kept_frame_density"]:
                raise AssertionError(f"{label}: keep decisions differ from its reference path's for the same draws")
            if not abs(fixed["loss"] - ref_loss) <= PATH_LOSS_TOL * abs(ref_loss):
                raise AssertionError(f"{label}: loss {fixed['loss']} vs its reference path's {ref_loss}")
            versus = {"loss_fixed_draws": fixed["loss"], "reference_path_loss": ref_loss,
                      "rel_err": abs(fixed["loss"] - ref_loss) / abs(ref_loss), "tol": PATH_LOSS_TOL}
        torch.backends.cudnn.deterministic = False
        del grads0, loss0, metrics0

        def step():
            return train_step(model, opt, video, mask, hp, loss_cfg, perceptual, generator=draws)

        initial = [p.detach().clone() for p in model.parameters()]
        reset_launches()
        first = step()
        torch.cuda.synchronize()
        launches = read_launches()
        expected = expected_launches(cfg, "train", path)
        if launches != expected:
            raise AssertionError(f"launches per {label} step {launches}, expected {expected}")
        metrics = {k: float(v) for k, v in first.items()}
        if not all(map(lambda v: v == v and abs(v) != float("inf"), metrics.values())):
            raise AssertionError(f"{label} step: non-finite metrics {metrics}")
        if not metrics["grad_norm"] > 0:
            raise AssertionError(f"{label} step: grad_norm {metrics['grad_norm']}")
        if any(not torch.equal(p, q) for p, q in zip(model.parameters(), initial)):
            raise AssertionError("the first step (lr 0) changed a parameter")
        second = {k: float(v) for k, v in step().items()}
        changed = sum(not torch.equal(p, q) for p, q in zip(model.parameters(), initial))
        if changed == 0:
            raise AssertionError("no parameter changed by step 2")
        del initial

        for _ in range(WARMUP_STEPS - 2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(timed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        log(label, json.dumps({
            "config": f"{describe(cfg)}, {cfg.num_heads} heads of {cfg.head_dim}, bf16 compute, f32 params, "
                      f"b{TRAIN_BATCH} x {FRAMES} frames, rl (2 rollouts), perceptual on, remat off, path {path}",
            "launches": launches, "ms_per_step_median": ms, "ms_per_step_all": times,
            "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "step1_metrics": metrics, "step2_metrics": second, "leaves_changed_by_step2": changed,
            "leaves": len(list(model.parameters())), **versus,
        }))
        profile_device(label, step, ms, passes=2 if default else 1)
    del model, opt, perceptual
    torch.cuda.empty_cache()
    return launches, {"draws": (noise, uniforms), **fixed}


def trainer_config(checkpoint_dir: str, clips: int = TRAINER_CLIPS, args=(), depth=TRAINER_DEPTH):
    """The config ``python -m video_vae_tpu_torch.cli.train --synthetic`` trains (the
    flagship at full width, b2 x 32 frames, remat on, bf16, perceptual on with the
    random VGG), its (encoder, decoder) ``depth`` cut (None: the flagship's), on
    ``clips`` clips, every step logged, the video dump and a checkpoint on the epoch's
    last step, everything written under ``checkpoint_dir``. ``args``: more of the
    CLI's flags (``--fsdp``, ``--tensor``)."""
    from video_vae_tpu_torch.cli.train import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(["--synthetic", "--checkpoint_dir", checkpoint_dir, *args]))
    if depth is not None:
        cfg = cfg.replace(model=cfg.model.replace(encoder_depth=depth[0], decoder_depth=depth[1]))
    steps = clips // TRAINER_BATCH
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_clips=clips),
        train=cfg.train.replace(log_every=1, video_every=steps, checkpoint_every_steps=steps,
                                video_save_dir=os.path.join(checkpoint_dir, "videos")),
    )


def trainer_frame_mask(cfg):
    """The (b, t) frame mask of the trainer's first batch: its clips' true lengths."""
    import torch

    from video_vae_tpu_torch.data.pipeline import create_dataloader
    from video_vae_tpu_torch.train.trainer import curriculum_plan

    plan = curriculum_plan(cfg, 0)
    data_cfg = cfg.data.replace(batch_size=plan.batch_size, max_frames=plan.max_frames)
    return torch.from_numpy(next(iter(create_dataloader(data_cfg, seed=cfg.data.seed)))["mask"]).bool()


def trainer_attention_cases(cfg, frame_mask=None):
    """(name, B, S, frame mask, dtype, {"train": backward launches}) of each attention call
    of a trainer step on b clips of t frames (``frame_mask`` (b, t), else b2 x 32f): the
    encoder's on the clips, the decoder's on their 2 rollouts."""
    b, t = (TRAINER_BATCH, TRAINER_FRAMES) if frame_mask is None else tuple(frame_mask.shape)
    rollouts = None if frame_mask is None else frame_mask.repeat_interleave(2, dim=0)
    hw, enc, dec = cfg.num_patches, cfg.encoder_depth, cfg.decoder_depth
    return [
        (f"trainer temporal b{b}x{t}", b * hw, t, frame_mask, "bfloat16", {"train": enc}),
        (f"trainer spatial b{b}x{t}", b * t, hw, False, "bfloat16", {"train": enc}),
        (f"trainer temporal b{2 * b}x{t}", 2 * b * hw, t, rollouts, "bfloat16", {"train": dec}),
        (f"trainer spatial b{2 * b}x{t}", 2 * b * t, hw, False, "bfloat16", {"train": dec}),
    ]


def trainer_launches(cfg) -> dict:
    """Launches of every kernel in one trainer step: the default path's train step, plus
    with remat the recompute of each attention forward and of the down and up blocks' convs."""
    want = expected_launches(cfg, "train", "fused")
    if cfg.remat:
        want["vvt_fused_attention_fwd"] *= 2
        want["vvt_conv3d_cf"] += 4 * cfg.unet_levels
    return want


def phase_trainer_kernels(dev, rows):
    """Kernels #1-#4 against their plain versions at the trainer's shapes: the attention
    calls with the first batch's padding, the convs on its 2 x 2 rollout clips of 32 frames."""
    cfg = trainer_config("checkpoints")  # only its shapes are read: nothing is written
    mask = trainer_frame_mask(cfg)
    model = cfg.model
    phase_attention_kernels(model, dev, rows, None, "trainer", trainer_attention_cases(model, mask), remat=model.remat)
    phase_conv_kernels(model, dev, rows, None, "trainer", batch=2 * mask.shape[0], frames=mask.shape[1],
                       remat=model.remat)
    log("trainer-frames", json.dumps({"true_frames": mask.sum(dim=1).tolist(), "of": mask.shape[1]}))


def _host_state(model, optimizer) -> dict:
    """A copy of the model's and the optimizer's state, to load back later."""
    return {
        "model": {k: v.detach().clone() for k, v in model.state_dict().items()},
        "optimizer": {"count": optimizer.count, "mu": [t.clone() for t in optimizer.mu],
                      "nu": [t.clone() for t in optimizer.nu]},
    }


def _same_state(a, b) -> bool:
    """Whether two trainers' parameters, moments and counts are bit-equal."""
    import torch

    pairs = [*zip(a.model.parameters(), b.model.parameters()), *zip(a.optimizer.mu, b.optimizer.mu),
             *zip(a.optimizer.nu, b.optimizer.nu)]
    return a.optimizer.count == b.optimizer.count and all(torch.equal(x, y) for x, y in pairs)


def _finite(values: dict) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values.values())


def phase_trainer(dev, args=(), label="trainer"):
    """The training entry point at the flagship's full width on the card (the
    transformer cut to ``TRAINER_DEPTH``), on the config ``cli/train.py
    --synthetic`` with ``args`` builds (``--resize 512``: the "trainer-512" line).

    ``Trainer(cfg)`` on :func:`trainer_config` runs ``run_epoch(0)`` (3 steps, the
    video dump on the last, a checkpoint) and ``run_eval(0)``; every launch is
    counted, each step's alone. Then a fresh ``Trainer`` restores the checkpoint
    bit-exactly and takes one more step, and the first step is held to
    ``train_step`` called by hand from the same state, batch and draws. Returns the
    launches of one step.
    """
    import tempfile

    import torch

    from video_vae_tpu_torch.train.checkpoint import load_checkpoint
    from video_vae_tpu_torch.train.step import train_step
    from video_vae_tpu_torch.train.trainer import Trainer
    from video_vae_tpu_torch.utils.metrics import count_params

    with tempfile.TemporaryDirectory(prefix="vvt-trainer-") as tmp:
        cfg = trainer_config(tmp, args=args)
        started = time.perf_counter()
        trainer = Trainer(cfg, device=dev, install_signal_handlers=False)
        build_s = time.perf_counter() - started
        model, opt = trainer.model, trainer.optimizer
        if not all(t.device.type == dev.type for t in [*model.parameters(), *opt.mu, *opt.nu]):
            raise AssertionError("trainer: a parameter or an Adam moment is not on the card")
        initial, draws = _host_state(model, opt), trainer.generator.get_state()

        steps, first = [], {}
        inner = trainer.train_step

        def counted_step(model, optimizer, video, mask, hp, **kw):
            if not first:
                first.update(video=video.clone(), mask=mask.clone(), hp=hp)
            before = read_launches()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = inner(model, optimizer, video, mask, hp, **kw)
            end.record()
            after = read_launches()
            steps.append({"launches": {k: after[k] - before[k] for k in after}, "events": (start, end),
                          "metrics": metrics})
            return metrics

        trainer.train_step = counted_step
        save_s = [0.0]
        for name in ("save", "wait"):  # the snapshot to the host, then the write on its thread
            def timed(*args, _fn=getattr(trainer.ckpt, name), **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    save_s[0] += time.perf_counter() - t0
            setattr(trainer.ckpt, name, timed)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        started = time.perf_counter()
        if not trainer.run_epoch(0):
            raise AssertionError("trainer: run_epoch(0) stopped early")
        epoch_s = time.perf_counter() - started
        evaluated = trainer.run_eval(0)
        torch.cuda.synchronize()
        launches = read_launches()
        eval_s = time.perf_counter() - started - epoch_s
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

        per_step = trainer_launches(cfg.model)
        if len(steps) != TRAINER_STEPS or trainer.global_step != TRAINER_STEPS:
            raise AssertionError(f"trainer: {len(steps)} steps, global_step {trainer.global_step}")
        for i, step in enumerate(steps):
            if step["launches"] != per_step:
                raise AssertionError(f"trainer step {i + 1} launches {step['launches']}, expected {per_step}")
        # the eval's 3 batches and the dump's reconstruct: a forward pass each, no recompute
        forward = expected_launches(cfg.model, "serving", "fused")
        passes = TRAINER_CLIPS // TRAINER_BATCH + 1
        total = {k: TRAINER_STEPS * per_step[k] + passes * forward[k] for k in per_step}
        if launches != total:
            raise AssertionError(f"trainer run launches {launches}, expected {total}")

        with open(os.path.join(tmp, "train.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        logged = [line for line in lines if "loss" in line]
        if [line["step"] for line in logged] != list(range(1, TRAINER_STEPS + 1)):
            raise AssertionError(f"trainer: logged steps {[line['step'] for line in logged]}")
        for line in logged:
            metrics = {k: line[k] for k in TRAIN_METRICS}
            if not _finite(metrics) or not metrics["grad_norm"] > 0:
                raise AssertionError(f"trainer step {line['step']}: metrics {metrics}")
        dumps = [line for line in lines if "dump_psnr_det" in line]
        if [line["step"] for line in dumps] != [TRAINER_STEPS] or not _finite({"p": dumps[0]["dump_psnr_det"]}):
            raise AssertionError(f"trainer: video dump lines {dumps}")
        if evaluated is None or not _finite(evaluated) or "psnr_sampled" not in evaluated:
            raise AssertionError(f"trainer: eval {evaluated}")
        times = [start.elapsed_time(end) for start, end in (step["events"] for step in steps)]
        step1 = {k: float(v) for k, v in steps[0]["metrics"].items()}

        # restore a fresh trainer from the checkpoint directory, then take one more step
        started = time.perf_counter()
        fresh = Trainer(cfg, device=dev, install_signal_handlers=False)
        torch.cuda.synchronize()
        trainer_restore_s = time.perf_counter() - started
        if fresh.global_step != TRAINER_STEPS or not _same_state(trainer, fresh):
            raise AssertionError(f"trainer: restored step {fresh.global_step} or state differs from the saved one")
        started = time.perf_counter()
        load_checkpoint(fresh.model, fresh.optimizer, fresh.ckpt.step_dir(TRAINER_STEPS))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - started
        before = [p.detach().clone() for p in fresh.model.parameters()]
        reset_launches()
        resumed = fresh.train_step(fresh.model, fresh.optimizer, first["video"], first["mask"],
                                   fresh.hparams_for_step(fresh.global_step), generator=fresh.generator)
        torch.cuda.synchronize()
        if read_launches() != per_step:
            raise AssertionError(f"trainer: the restored trainer's step launched {read_launches()}")
        resumed = {k: float(v) for k, v in resumed.items()}
        changed = sum(not torch.equal(p, q) for p, q in zip(fresh.model.parameters(), before))
        if not _finite(resumed) or fresh.optimizer.count != TRAINER_STEPS + 1 or changed == 0:
            raise AssertionError(f"trainer: the restored step gave {resumed}, {changed} leaves changed")
        del before

        # step 1 against train_step called by hand from the same state, batch and draws
        fresh.model.load_state_dict(initial["model"])
        fresh.optimizer.load_state_dict(initial["optimizer"])
        generator = torch.Generator(dev)
        generator.set_state(draws)
        hand = train_step(fresh.model, fresh.optimizer, first["video"], first["mask"], first["hp"], cfg.loss,
                          fresh.perceptual_fn, generator=generator)
        hand = {k: float(v) for k, v in hand.items()}
        errs = {}
        for key, ref in hand.items():
            tol = TRAINER_PERCEPTUAL_TOL if key == "perceptual_loss" else TRAINER_STEP_TOL
            scale = 1.0 if key == "rl_loss" else abs(ref)  # rl_loss is 0 up to rounding
            errs[key] = abs(step1[key] - ref) / scale if scale else abs(step1[key] - ref)
            if not abs(step1[key] - ref) <= tol * scale:
                raise AssertionError(f"trainer step 1 {key}: {step1[key]} vs train_step by hand {ref}")

        ms = statistics.median(times[1:])
        profile = profile_device(
            label,
            lambda: inner(model, opt, first["video"], first["mask"], first["hp"], generator=trainer.generator),
            ms, passes=2,
        )
        log(label, json.dumps({
            "config": f"{describe(cfg.model)}, bf16 compute, f32 params, b{TRAINER_BATCH} x {TRAINER_FRAMES} frames, "
                      f"rl (2 rollouts), perceptual on (random VGG), remat on, {TRAINER_CLIPS} synthetic clips; "
                      f"cli/train.py {' '.join(('--synthetic', *args))}",
            "params": count_params(model), "steps": TRAINER_STEPS,
            "ms_per_step": ms, "ms_per_step_all": times,
            "device_ms_per_step": profile["device_busy_ms_per_run"],
            "device_ops_per_step": profile["device_ops_per_run"],
            "idle_share": profile["idle_share_vs_median"],
            "data_wait_ms_per_step": trainer.data_wait_s * 1e3 / TRAINER_STEPS,
            "checkpoint_save_s": save_s[0], "checkpoint_restore_s": restore_s,
            "trainer_build_s": build_s, "trainer_build_and_restore_s": trainer_restore_s,
            "epoch_s": epoch_s, "eval_s": eval_s, "peak_memory_gib": peak_gib,
            "launches_per_step": per_step, "launches_run": launches,
            "step1_metrics": step1, "step1_vs_hand_rel_err": errs,
            "tols": [TRAINER_STEP_TOL, TRAINER_PERCEPTUAL_TOL],
            "eval": evaluated, "dump_psnr_det": dumps[0]["dump_psnr_det"], "restored_step_metrics": resumed,
        }))
        del trainer, fresh, model, opt, initial, first, steps
    torch.cuda.empty_cache()
    return per_step, {"step1": step1, "ms_per_step": ms, "device_ms_per_step": profile["device_busy_ms_per_run"],
                      "peak_memory_gib": peak_gib}




def dist_mesh(label: str, shape, batch: int = TRAINER_BATCH, full: bool = True, clips: int = TRAINER_CLIPS,
              profile: bool = True, dump: bool = True, depth=TRAINER_DEPTH) -> dict:
    """One run of the trainer across ranks: the (data, fsdp, tensor) ``shape`` as
    ``cli/train.py`` flags, the global ``batch``, ``clips`` synthetic clips, the
    model's ``depth`` (see :func:`trainer_config`), and
    whether the whole epoch runs (else it stops after ``DIST_SHORT_STEPS`` steps
    through the trainer's agreed shutdown, the stop raised on every rank); a whole
    epoch ends with the video dump where ``dump``, and a step is profiled where
    ``profile``."""
    _, fsdp, tensor = shape
    args = ["--batch_size", str(batch), "--fsdp", str(fsdp), "--tensor", str(tensor)]
    return {"label": label, "shape": list(shape), "batch": batch, "args": args, "full": full, "clips": clips,
            "profile": full and profile, "dump": full and dump, "depth": depth}


DIST_SHORT_STEPS = 1
# "dist-nccl": the trainer's config on a process group of one rank, NCCL, in this
# process (the environment torchrun gives rank 0 of 1), without the dump
DIST_NCCL_MESH = dist_mesh("data=1", (1, 1, 1), dump=False)
# the 2-rank runs on the one card: gloo (NCCL takes one rank a card), each on the
# trainer's config and clips (b2 x 32 frames global, 3 steps): data=2 (b1 a rank),
# fsdp=2 (b1 a rank) and tensor=2 (both ranks b2, the flagship's 8 heads, 4 a rank);
# the later two short, and no step profiled (gloo's collectives through host memory
# are not what a card's time is read from), to keep the phase short
DIST_GLOO_MESHES = (dist_mesh("data=2", (2, 1, 1), profile=False), dist_mesh("fsdp=2", (1, 2, 1), full=False),
                    dist_mesh("tensor=2", (1, 1, 2), full=False))
# ``python3 chip_smoke.py --four-cards`` (not part of the one-card run): the trainer on
# NCCL over 4 cards, 3 steps of each; held to one rank's run of the same global batch
FOUR_CARD_MESHES = (dist_mesh("data=4", (4, 1, 1), batch=4, clips=12, depth=None),
                    dist_mesh("fsdp=4", (1, 4, 1), batch=4, clips=12, depth=None),
                    dist_mesh("fsdp=2,tensor=2", (1, 2, 2), depth=None), dist_mesh("tensor=4", (1, 1, 4), depth=None))
DIST_TIMEOUT_S = 420
ATTENTION_KERNELS = ("vvt_fused_attention_fwd", "vvt_fused_attention_bwd")


def dist_worker(spec: dict) -> int:
    """One rank of a ``torch.distributed.run`` launch of this script (``--dist-worker``):
    :func:`dist_record` for each mesh of ``spec``, written to ``<spec["out"]>.rank<N>``.
    Rank 0 alone prints."""
    import torch
    import torch.distributed as dist

    global log
    warnings.filterwarnings("ignore", message="Perceptual loss is using RANDOM")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    if rank:
        log = lambda *parts: None  # noqa: E731  (rank 0 speaks for the run)
    records = [dist_record(spec, mesh) for mesh in spec["meshes"]]
    with open(f"{spec['out']}.rank{rank}", "w") as f:
        json.dump(records, f)
    dist.destroy_process_group()
    return 0


def dist_record(spec: dict, mesh: dict) -> dict:
    """One rank's run of ``mesh``: ``Trainer`` on :func:`trainer_config` with the
    mesh's CLI flags (joining the process group its environment names, on
    ``spec["backend"]``), ``run_epoch(0)`` with every step's launches counted, the
    dispatch log read, ms per step timed and, where the mesh asks, one step profiled."""
    import torch
    import torch.distributed as dist

    from video_vae_tpu_torch.parallel.sharding import clear_dispatch_log, dispatch_log
    from video_vae_tpu_torch.train.trainer import Trainer

    rank = int(os.environ["RANK"])
    label, full = mesh["label"], mesh["full"]
    cfg = trainer_config(os.path.join(spec["dir"], label), mesh["clips"], mesh["args"], mesh["depth"])
    if not mesh["dump"]:
        cfg = cfg.replace(train=cfg.train.replace(video_every=0))
    started = time.perf_counter()
    trainer = Trainer(cfg, device="cuda", dist_backend=spec["backend"], install_signal_handlers=False)
    build_s = time.perf_counter() - started
    dev = trainer.device
    steps, first = [], {}
    inner = trainer.train_step

    def counted_step(model, optimizer, video, mask, hp, **kw):
        if not first:
            first.update(video=video.clone(), mask=mask.clone(), hp=hp)
        before = read_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = inner(model, optimizer, video, mask, hp, **kw)
        end.record()
        after = read_launches()
        steps.append({"launches": {k: after[k] - before[k] for k in after}, "events": (start, end),
                      "metrics": metrics})
        if not full and len(steps) == DIST_SHORT_STEPS:
            trainer.shutdown.should_stop = True
        return metrics

    trainer.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    clear_dispatch_log()
    started = time.perf_counter()
    if trainer.run_epoch(0) != full:
        raise AssertionError(f"{label}: run_epoch(0) after {len(steps)} steps, asked to stop: {not full}")
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - started
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    dispatch = sorted({f"{op}:{impl}" for op, impl, _ in dispatch_log()})
    times = [start.elapsed_time(end) for start, end in (step["events"] for step in steps)]
    ms = statistics.median(times[1:] or times)  # a one-step run: its first step, warm-up and all
    rows, _, _, _ = trainer._shard(cfg.data.batch_size)

    def one_step():
        with trainer._mesh_and_rows(rows, cfg.data.batch_size):
            inner(trainer.model, trainer.optimizer, first["video"], first["mask"], first["hp"],
                  generator=trainer.generator)

    profile = (profile_device(f"{spec['phase']}-{label}", one_step, ms, passes=1) if mesh["profile"]
               else {"device_busy_ms_per_run": None, "idle_share_vs_median": None})
    record = {
        "label": label, "rank": rank, "world": dist.get_world_size(), "device": str(dev),
        "rows": [rows.start, rows.stop], "steps": len(steps),
        "launches": [step["launches"] for step in steps],
        "step1": {k: float(v) for k, v in steps[0]["metrics"].items()},
        "ms_per_step": ms, "ms_per_step_all": times,
        "device_ms_per_step": profile["device_busy_ms_per_run"],
        "idle_share": profile["idle_share_vs_median"], "peak_memory_gib": peak_gib,
        "dispatch": dispatch, "trainer_build_s": build_s, "epoch_s": epoch_s, "backend": dist.get_backend(),
        "checkpoint": sorted(os.listdir(cfg.train.checkpoint_dir)) if rank == 0 else None,
    }
    del trainer, first, steps, inner
    torch.cuda.empty_cache()
    return record


def run_dist(phase: str, nproc: int, backend: str, meshes) -> list[list[dict]]:
    """This script's ``dist_worker`` on ``nproc`` ranks under ``torch.distributed.run``
    (a local rendezvous); each rank's records, by rank."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=f"vvt-{phase}-") as tmp:
        spec = {"phase": phase, "backend": backend, "meshes": meshes, "dir": tmp,
                "out": os.path.join(tmp, "records")}
        subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
             os.path.abspath(__file__), "--dist-worker", json.dumps(spec)],
            check=True, timeout=DIST_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        out = []
        for rank in range(nproc):
            with open(f"{spec['out']}.rank{rank}") as f:
                out.append(json.load(f))
    return out


def _rel_errs(ours: dict, ref: dict) -> dict:
    return {k: abs(ours[k] - ref[k]) / (1.0 if k == "rl_loss" or not ref[k] else abs(ref[k])) for k in ref}


def _hold_step1(label: str, ours: dict, ref: dict, tol: float, perceptual_tol: float) -> dict:
    errs = _rel_errs(ours, ref)
    for key, err in errs.items():
        if not err <= (perceptual_tol if key == "perceptual_loss" else tol):
            raise AssertionError(f"{label} step 1 {key}: {ours[key]} vs the one-process trainer's {ref[key]}")
    return errs


def _hold_launches(label: str, record: dict, want: dict) -> None:
    for i, got in enumerate(record["launches"]):
        if got != want:
            raise AssertionError(f"{label} rank {record['rank']} step {i + 1} launches {got}, expected {want}")


def phase_dist_kernels(dev, rows):
    """#1-#4 against their plain versions at the rank-local shapes of the 2-rank
    data=2 run (b1 x 32 frames a rank, remat on), with rank 0's first clip's
    padding (rank 1's calls have the same shapes), counted on the ``dist-gloo-2``
    path."""
    cfg = trainer_config("checkpoints")  # only its shapes are read: nothing is written
    mask = trainer_frame_mask(cfg)
    model = cfg.model
    phase_attention_kernels(model, dev, rows, None, "dist-gloo-2", trainer_attention_cases(model, mask[:1]),
                            remat=model.remat)
    phase_conv_kernels(model, dev, rows, None, "dist-gloo-2", batch=2, frames=mask.shape[1], remat=model.remat)


def _hold_dist(phase: str, mesh: dict, records: list[dict], ref_step1: dict, backend: str) -> dict:
    """Every rank's backend, rows, steps, launches and attention dispatch for ``mesh``, and
    rank 0's step 1 against the one-process ``ref_step1``: the rank's rows are its
    (data, fsdp) block (ranks are data-major, tensor-minor), the whole batch where
    data·fsdp does not divide it; under tensor > 1 the fused attention is the chain
    (0 launches of #1 and #3). Returns the summary for the phase's line."""
    label, (data, fsdp, tensor), batch = f"{phase} {mesh['label']}", mesh["shape"], mesh["batch"]
    per_step = trainer_launches(trainer_config("checkpoints", depth=mesh["depth"]).model)  # nothing is written
    if tensor > 1:
        per_step = {**per_step, **{k: 0 for k in (*ATTENTION_KERNELS, ATTN_BWD_WGMMA_TILE)}}
    shards = data * fsdp
    local = batch // shards if batch % shards == 0 else batch
    steps = mesh["clips"] // batch if mesh["full"] else DIST_SHORT_STEPS
    for rank, record in enumerate(records):
        if record["backend"] != backend:
            raise AssertionError(f"{label} rank {rank}: backend {record['backend']}, expected {backend}")
        block = rank // tensor if local < batch else 0
        if record["rows"] != [block * local, (block + 1) * local] or record["steps"] != steps:
            raise AssertionError(f"{label} rank {rank}: rows {record['rows']}, steps {record['steps']}")
        _hold_launches(label, record, per_step)
        attention = {d.split(":")[1] for d in record["dispatch"] if d.startswith("fused_attention:")}
        if attention != ({"chain"} if tensor > 1 else {"kernel"}):
            raise AssertionError(f"{label}: fused attention dispatches {record['dispatch']}")
    if data * fsdp * tensor == 1 and records[0]["step1"] != ref_step1:
        raise AssertionError(f"{label}: step 1 {records[0]['step1']} is not the one-process trainer's "
                             f"{ref_step1} bit for bit")
    # the tensor ranks' sums round in bf16 before the all-reduce, and the chain
    # replaces the fused kernel: the bound of a path against the default path
    tol = PATH_LOSS_TOL if tensor > 1 else TRAINER_STEP_TOL
    errs = _hold_step1(label, records[0]["step1"], ref_step1, tol, max(tol, TRAINER_PERCEPTUAL_TOL))
    return {
        "ms_per_step": [r["ms_per_step"] for r in records],
        "device_ms_per_step": [r["device_ms_per_step"] for r in records],
        "peak_memory_gib": [r["peak_memory_gib"] for r in records],
        "launches_per_step_per_rank": records[0]["launches"][0], "dispatch": records[0]["dispatch"],
        "step1_equals_reference_bits": records[0]["step1"] == ref_step1, "step1_vs_reference_rel_err": errs,
        "tol": tol, "checkpoint": records[0]["checkpoint"], "steps": records[0]["steps"],
        "trainer_build_s": records[0]["trainer_build_s"],
    }


def phase_dist_nccl(trainer: dict) -> None:
    """``Trainer`` on a process group of one rank, NCCL, at the trainer phase's
    config, in this process, with the environment ``torch.distributed.run`` gives
    rank 0 of 1 (the 2-rank phase runs under the launcher itself, and a fresh
    process would pay its warm-up again). Its step 1 must equal the one-process
    trainer's bit for bit: a (1, 1, 1) mesh leaves the model as built and a mean
    over one rank is the identity. Its launches, times and peak memory."""
    import socket
    import tempfile

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="vvt-dist-nccl-") as tmp:
            record = dist_record({"phase": "dist-nccl", "backend": "nccl", "dir": tmp}, DIST_NCCL_MESH)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("dist-nccl", json.dumps({
        "config": "Trainer on a one-rank NCCL process group (torchrun's environment for rank 0 of 1), "
                  f"the trainer phase's config, {TRAINER_CLIPS} clips, no dump",
        **_hold_dist("dist-nccl", DIST_NCCL_MESH, [record], trainer["step1"], "nccl"),
        "ms_per_step_all": record["ms_per_step_all"], "idle_share": record["idle_share"],
        "epoch_s": record["epoch_s"],
        "trainer": {k: trainer[k] for k in ("ms_per_step", "device_ms_per_step", "peak_memory_gib")},
    }))


def phase_dist_gloo(trainer: dict) -> dict:
    """Two ranks on the one card under gloo: data=2 (step 1 held to the one-process
    trainer's on the same global batch and draws, the kernels' launches per rank),
    then fsdp=2 and tensor=2 (no fused attention launch: the chain). Returns rank 0's
    launches of one data=2 step."""
    ranks = run_dist("dist-gloo-2", 2, "gloo", DIST_GLOO_MESHES)
    out = {mesh["label"]: _hold_dist("dist-gloo-2", mesh, [r[i] for r in ranks], trainer["step1"], "gloo")
           for i, mesh in enumerate(DIST_GLOO_MESHES)}
    log("dist-gloo-2", json.dumps({
        "config": "the trainer phase's config over 2 ranks on one card, gloo (its all-reduce of the "
                  "f32 gradients goes through host memory); data=2: b1 x 32 frames a rank; fsdp=2; "
                  "tensor=2: 4 heads a rank", "meshes": out,
        "trainer": {k: trainer[k] for k in ("ms_per_step", "device_ms_per_step", "peak_memory_gib")},
    }))
    return ranks[0][0]["launches"][0]


def four_cards(labels=()) -> int:
    """``python3 chip_smoke.py --four-cards [LABEL ...]``: what exists only across cards.

    On a machine of 4 cards: the parallel dry run on NCCL (one tiny step under
    each factorization of 4, the dispatch asserted), then the flagship trainer
    under :data:`FOUR_CARD_MESHES` (those ``labels`` name, or all), each rank's
    rows, launches and dispatch held and step 1 held to one rank's run of the same
    global batch (b4 or b2), with ms per step, device ms and peak memory beside
    that run's.
    """
    import torch

    from video_vae_tpu_torch.ops import KERNELS
    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --four-cards: needs 4 CUDA cards", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line)
    build([k.source for k in KERNELS])
    started = time.monotonic()
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
                    "-m", "video_vae_tpu_torch.parallel.dryrun"], check=True, timeout=DIST_TIMEOUT_S)
    meshes = [m for m in FOUR_CARD_MESHES if not labels or m["label"] in labels]
    if len(meshes) != (len(labels) or len(FOUR_CARD_MESHES)):
        raise ValueError(f"--four-cards {list(labels)}: the meshes are {[m['label'] for m in FOUR_CARD_MESHES]}")
    batches = sorted({m["batch"] for m in meshes})
    reference = run_dist("dist-reference", 1, "nccl", [
        dist_mesh(f"b{b}", (1, 1, 1), batch=b, clips=3 * b, depth=None) for b in batches])[0]
    one_card = {r["label"]: r for r in reference}
    ranks = run_dist("dist-nccl-4", 4, "nccl", meshes)
    out = {}
    for i, mesh in enumerate(meshes):
        base = one_card[f"b{mesh['batch']}"]
        out[mesh["label"]] = {
            **_hold_dist("dist-nccl-4", mesh, [r[i] for r in ranks], base["step1"], "nccl"),
            "one_card": {k: base[k] for k in ("ms_per_step", "device_ms_per_step", "peak_memory_gib")},
        }
    log("dist-nccl-4", json.dumps({
        "config": "the trainer phase's config (flagship, b x 32 frames, remat on) under torch.distributed.run "
                  "over 4 cards, NCCL; 3 steps a mesh; one_card: the same global batch on one rank",
        "meshes": out, "seconds": time.monotonic() - started,
    }))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_head_dim_kernels(dev, rows):
    """Kernels #1, #3, #5, #6 and #7 against their plain versions at head_dim 16 and
    32: at the calls of a ``--tiny`` and a ``--small`` train step and at the same
    shapes with head_dim 32 (:func:`head_dim_configs`), bf16 and f32, masked and with
    a sequence whose keys are all masked, the same bits twice. The tiny preset's
    fused attention launches are counted on the ``"tiny"`` path (its UNet's convs,
    #2 and #4, are held at its shapes here too), the small preset's on
    ``"train-small"``; #5, #6 and #7 on no path (those presets run
    ``attention_impl="fused"``)."""
    for label, cfg, clips, frames in head_dim_configs():
        full = not label.endswith("-d32")
        cases = preset_attention_cases(label, cfg, clips, frames, full=full)
        path = {"tiny": "tiny", "small": "train-small"}.get(label)
        phase_attention_kernels(cfg, dev, rows, None, path, cases, remat=cfg.remat, masked_rows=True)
        side = cases if not full else cases[2:4] + cases[4:5]  # the decoder's calls and one float32 call
        phase_flash_kernels(cfg, dev, rows, side, paths=False)
        phase_sublayer_kernel(cfg, dev, rows, side, paths=False)
        if label == "tiny":  # the rollouts' clips through the UNet
            phase_conv_kernels(cfg, dev, rows, None, "tiny", batch=2 * clips, frames=frames)


def phase_h4_kernels(dev, rows):
    """Kernels #1, #3, #5, #6 and #7 against their plain versions at head_dim 128: at
    the calls of a ``ModelConfig(num_heads=4)`` b1 x 16f train step (its encoder's
    on the clip, its decoder's on the 2 rollouts, the last clip padded; counted on
    ``"train-h4"``) and the same in float32, masked and with a sequence whose keys
    are all masked, the same bits twice, SDPA (or #7's LN → matmul → SDPA → matmul
    chain) beside each; #5, #6 and #7 at the decoder's calls and one float32 call
    (counted on no path: the model runs ``attention_impl="fused"``)."""
    cfg = h4_config()
    cases = preset_attention_cases("h4", cfg, H4_CLIPS, H4_FRAMES)
    phase_attention_kernels(cfg, dev, rows, None, "train-h4", cases, masked_rows=True)
    side = cases[2:4] + cases[4:5]
    phase_flash_kernels(cfg, dev, rows, side, paths=False)
    phase_sublayer_kernel(cfg, dev, rows, side, paths=False)


def phase_d96_kernels(dev, rows):
    """Kernels #1, #3, #5, #6 and #7 against their plain versions at head_dim 96,
    which they run padded to 128: at the calls of the :func:`d96_config` serving
    pass and train step (counted on ``"serving-d96"`` and ``"train-d96"``) and the
    temporal b2 call in float32, masked and with a sequence whose keys are all
    masked, the same bits twice, SDPA at D = 96 beside each; #5, #6 and #7 at the
    b2 calls and the float32 one (counted on no path: the model runs
    ``attention_impl="fused"``). Padded, a temporal call's sequence is 3 x 8 x 16
    rows of 272 bytes (104 KB, over ``MMA_SLAB_MAX_SMEM``): #1 and #5 take their
    tile variant there, one warp a block."""
    cfg = d96_config()
    cases = attention_cases(cfg)
    phase_attention_kernels(cfg, dev, rows, "serving-d96", "train-d96", cases, masked_rows=True)
    side = cases[:2] + cases[4:5]
    phase_flash_kernels(cfg, dev, rows, side, paths=False)
    phase_sublayer_kernel(cfg, dev, rows, side, paths=False)


def phase_d256_kernels(dev, rows):
    """Kernels #1 and #3 against their plain versions at head_dim 256, which they run
    on their wide variant: at the calls of the :func:`d256_config` serving pass and
    train step (counted on ``"serving-d256"`` and ``"train-d256"``) and the temporal
    b2 call in float32, masked and with a sequence whose keys are all masked, the same
    bits twice, SDPA at D = 256 beside each. #5, #6 and #7, which the model does not
    run, are held at D = 256 by :func:`phase_wide_head_dim_kernels`."""
    cfg = d256_config()
    phase_attention_kernels(cfg, dev, rows, "serving-d256", "train-d256", attention_cases(cfg), masked_rows=True)


def _padded_check(rows, kernel, dims, shape, dtype, run, plain, library, library_name, glue, moved, flops,
                  label="padded"):
    """One kernel at a padded head dim (``dims``: D and its Dp) against its plain
    version (``moved`` and ``flops``: functions of the head dim, for the bound at
    D and at Dp); records a "kernel-check" line with the bf16 call's device ms,
    the library's and the glue's (see :func:`phase_padded_head_dim_kernels`).
    Past 128 each run must launch the kernel's wide variant."""
    import torch

    from video_vae_tpu_torch.ops import flash_attention as fa

    D, Dp = dims
    wide = fa.WIDE_LAUNCHES[kernel.symbol]
    got, again = run(), run()
    torch.cuda.synchronize()
    if fa.is_wide(Dp) and fa.WIDE_LAUNCHES[kernel.symbol] - wide != 2:
        raise AssertionError(f"{kernel.symbol} D = {D} {shape} {dtype}: not launched on its wide variant")
    got, again = (t if isinstance(t, tuple) else (t,) for t in (got, again))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits on every run
        raise AssertionError(f"{kernel.symbol} D = {D} {shape} {dtype}: two launches gave different bits")
    ref = plain()
    ref = ref if isinstance(ref, tuple) else (ref,)
    # #7's products take bf16 operands whatever x's dtype: its tolerance and its bound's peak
    bf16_ops = "bfloat16" if kernel is fa.ATTENTION_SUBLAYER else dtype
    err = max(check_close(f"{kernel.symbol} D = {D} {shape} {dtype} part {i}", a, b, bf16_ops)
              for i, (a, b) in enumerate(zip(got, ref)))
    del got, again, ref
    padded = bound_ms(moved(Dp), flops(Dp), bf16_ops)
    extra = {"head_dim": D, "padded_head_dim": Dp, "bound_ms_padded": padded[0], "bound_by_padded": padded[1]}
    iters = 2  # float32: held, timed briefly
    if dtype == "bfloat16":
        iters = 5
        # at a native Dp (D = 256, 384, 512) nothing is padded: no glue launches
        extra.update(device_ms=device_ms(run), library_device_ms=device_ms(library),
                     glue_device_ms=device_ms(glue) if Dp != D else 0.0)
    _record(rows, kernel, f"{label} D{D} S{shape[1]} {dtype}", list(shape), dtype, err, time_ms(run, iters),
            time_ms(plain, 1), time_ms(library, iters), library_name, bound_ms(moved(D), flops(D), bf16_ops), {},
            **extra)


def phase_padded_head_dim_kernels(dev, rows, cases=PADDED_CASES, label="padded", f32_every_seq=False):
    """#1, #3, #5, #6 and #7 against their plain versions at head dims the kernels
    pad (``PADDED_CASES``: D = 48 and 96 at S = 16, 256 and 1024, D = 8 and 24 at
    16 and 256; ``PADDED_HEADS`` heads, ``PADDED_TOKENS`` tokens a call, a key mask
    that keeps a ragged prefix of each sequence and none of the first), bf16 at
    every case and float32 up to 256 tokens (at every case with
    ``f32_every_seq``), the same bits twice; ``label`` names the lines. Each
    "kernel-check" line holds beside the kernel's times the library call's at the
    true D (SDPA's forward or backward on q, k, v at D; #7's LN -> matmul -> SDPA
    -> matmul chain), the device ms of the wrapper's padding and unpadding alone
    (``glue_device_ms``: the heads and their gradients, the weights for #7, the
    RoPE tables) and the bound at D and at the padded Dp (``bound_ms``,
    ``bound_ms_padded``). Counted on no path."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import flash_attention as fa
    from video_vae_tpu_torch.ops.rope import rope_tables

    gen = torch.Generator().manual_seed(40)
    H, C = PADDED_HEADS, PADDED_WIDTH
    rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    for D, seqs in cases:
        Dp = fa.padded_head_dim(D)
        HD = H * D

        def pad(t, heads, D=D, Dp=Dp):
            return fa.pad_heads(t, heads, D, Dp)

        def unpad(t, heads, D=D, Dp=Dp):
            return fa.unpad_heads(t, heads, D, Dp)

        for S in seqs:
            B = PADDED_TOKENS // S
            lengths = torch.randint(1, S + 1, (B,), generator=gen)
            lengths[0] = 0
            mask = (torch.arange(S)[None, :] < lengths[:, None]).to(dev)
            keys, amask = int(mask.sum()), mask[:, None, None, :]
            cos, sin = rope_tables(S, D, device=str(dev))
            for dtype in ("bfloat16", "float32") if S <= fa.TILE_MAX_SEQ or f32_every_seq else ("bfloat16",):
                tdt = getattr(torch, dtype)
                e = torch.finfo(tdt).bits // 8
                qkv, g = rn(B, S, 3 * HD).to(dev, tdt), rn(B, S, HD).to(dev, tdt)
                qs, ks = (1 + 0.2 * rn(D)).to(dev), (1 + 0.2 * rn(D)).to(dev)
                q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(HD, -1))
                q, k, g4 = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)
                lq, lk, lv, lg = (t.transpose(1, 2).contiguous() for t in (q, k, v, g4))
                leaves = [t.detach().requires_grad_() for t in (lq, lk, lv)]
                o_lib = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
                x = rn(B, S, C).to(dev, tdt)
                lng, lnb, wqkv, bqkv, wout, bout = (t.to(dev) for t in (
                    1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, 3 * HD) / C**0.5, 0.2 * rn(3 * HD),
                    0.1 * rn(HD, C) / HD**0.5, 0.2 * rn(C)))
                w16 = [t.to(torch.bfloat16) for t in (wqkv, bqkv, wout, bout)]
                # outputs at Dp, for the unpadding's share of the glue
                qkv_p, o_p = pad(qkv, 3 * H), torch.empty(B, S, H * Dp, dtype=tdt, device=dev)
                q_p = torch.empty(B, S, H, Dp, dtype=tdt, device=dev)

                def tables():
                    return pad(cos, 1), pad(sin, 1)

                def sdpa():
                    return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)

                def sdpa_bwd():
                    return torch.autograd.grad(o_lib, leaves, lg, retain_graph=True)

                def chain():
                    xa = F.layer_norm(x, (C,), lng.to(tdt), lnb.to(tdt), 1e-6).to(torch.bfloat16)
                    qh, kh, vh = (t.reshape(B, S, H, D).transpose(1, 2)
                                  for t in (torch.matmul(xa, w16[0]) + w16[1]).split(HD, -1))
                    o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask)
                    return x + (torch.matmul(o.transpose(1, 2).reshape(B, S, HD), w16[2]) + w16[3]).to(tdt)

                mb, tok = mask.numel(), B * S
                attn = lambda d, n=4.0: n * H * S * keys * d  # noqa: E731
                sub_args = (x, lng, lnb, wqkv, bqkv, qs, ks, wout, bout, mask, H)
                checks = (
                    (fa.FUSED_ATTENTION, [B, S, 3 * HD],
                     lambda: fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H),
                     lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H),
                     sdpa, "scaled_dot_product_attention, core only",
                     lambda: (pad(qkv, 3 * H), unpad(o_p, H), tables()),
                     lambda d: 4 * tok * H * d * e + mb, attn),
                    (fa.FUSED_ATTENTION_BWD, [B, S, 3 * HD],
                     lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H),
                     lambda: fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H),
                     sdpa_bwd, "scaled_dot_product_attention backward, core only",
                     lambda: (pad(qkv, 3 * H), pad(g, H), unpad(qkv_p, 3 * H), tables()),
                     lambda d: 7 * tok * H * d * e + mb, lambda d: attn(d, 10.0)),
                    (fa.FLASH_ATTENTION, [B, S, H, D],
                     lambda: fa.flash_attention_cuda(q, k, v, mask),
                     lambda: fa.flash_attention_plain(q, k, v, mask),
                     sdpa, "scaled_dot_product_attention",
                     lambda: (pad(q, 1), pad(k, 1), pad(v, 1), unpad(q_p, 1)),
                     lambda d: 4 * tok * H * d * e + mb, attn),
                    (fa.FLASH_ATTENTION_BWD, [B, S, H, D],
                     lambda: fa.flash_attention_bwd_cuda(q, k, v, mask, g4),
                     lambda: fa.flash_attention_bwd_plain(q, k, v, mask, g4),
                     sdpa_bwd, "scaled_dot_product_attention backward",
                     lambda: (*(pad(t, 1) for t in (q, k, v, g4)), *(unpad(q_p, 1) for _ in range(3))),
                     lambda d: 7 * tok * H * d * e + mb, lambda d: attn(d, 10.0)),
                    (fa.ATTENTION_SUBLAYER, [B, S, C],
                     lambda: fa.fused_attention_sublayer_cuda(*sub_args),
                     lambda: fa.fused_attention_sublayer_plain(*sub_args),
                     chain, "layer_norm -> matmul -> scaled_dot_product_attention -> matmul, bf16 weights",
                     lambda: (pad(wqkv, 3 * H), pad(bqkv, 3 * H), pad(wout.t(), H), unpad(qkv_p, 3 * H),
                              unpad(o_p, H), tables()),
                     lambda d: 2 * tok * C * e + 4 * C * H * d * 2 + mb,
                     lambda d: 8.0 * tok * C * H * d + attn(d)),
                )
                for kernel, shape, run, plain, library, name, glue, moved, flops in checks:
                    _padded_check(rows, kernel, (D, Dp), shape, dtype, run, plain, library, name, glue, moved, flops,
                                  label)
                del qkv, g, q, k, v, g4, lq, lk, lv, lg, leaves, o_lib, x, qkv_p, o_p, q_p
    torch.cuda.empty_cache()


def phase_wide_head_dim_kernels(dev, rows):
    """#1, #3, #5, #6 and #7 against their plain versions on their wide variant
    (``WIDE_CASES``: D = 130, 192, 256, 384 and 512, padded to 256, 256, 256, 384
    and 512, at S = 16, 256 and 1024), bf16 and float32 at every case, as
    :func:`phase_padded_head_dim_kernels` holds the padded head dims (a ragged key
    mask, a sequence with no key, the same bits twice, SDPA at the true D, the
    glue's device ms, the bound at D and at Dp); each run must launch the wide
    variant. Counted on no path."""
    phase_padded_head_dim_kernels(dev, rows, WIDE_CASES, "wide", f32_every_seq=True)


def phase_latent_kernels(cfg, dev, rows):
    """Kernels #1-#4 at the curriculum's second bucket, b1 x 64 frames, which
    ``cli/cache_latents.py`` and ``cli/decode_latents.py`` run at their defaults:
    #1 at the encoder's and decoder's calls (counted per video on
    ``"cache-latents"`` and ``"decode-latents"``) and #3 there; #2 at the UNet's
    convs and input gradients (its forward counted per video on
    ``"decode-latents"``) and #4 there. The backward kernels are counted on no
    path: no train step at b1 x 64f is driven."""
    phase_attention_kernels(cfg, dev, rows, "cache-latents", "decode-latents", latent_attention_cases(cfg),
                            masked_rows=True, backward=False)
    phase_conv_kernels(cfg, dev, rows, "decode-latents", None, batch=1, frames=LATENT_FRAMES, f32=False)


def _latent_clip(frames: int, total: int, side: int, gen):
    """(video (total, side, side, 3) f32 in [0, 1], mask) of a synthetic clip of
    ``frames`` true frames, zero-padded as ``load_video`` pads: two scenes of 8 x 8
    smooth colour blocks with a little noise, a dark one and a bright one (their
    value histograms do not overlap, so the cut halfway is a scene change)."""
    import numpy as np

    scenes = np.stack([gen.uniform(0.05, 0.3, (8, 8, 3)), gen.uniform(0.6, 0.95, (8, 8, 3))])
    video = np.zeros((total, side, side, 3), np.float32)
    for i in range(frames):
        video[i] = np.kron(scenes[2 * i // frames], np.ones((side // 8, side // 8, 1))) + gen.normal(
            0, 0.02, (side, side, 3))
    mask = np.zeros(total, np.float32)
    mask[:frames] = 1.0
    return np.clip(video, 0.0, 1.0), mask


def phase_latent_clis(dev, resize=LATENT_RESIZE, frames=LATENT_FRAMES, clip_frames=LATENT_CLIP_FRAMES):
    """``cli/cache_latents.py``'s and ``cli/decode_latents.py``'s ``main`` at their
    defaults (the flagship at 256², ``--max_frames 64``) under their default device,
    on ``LATENT_VIDEOS`` synthetic clips (64 frames, and 40 padded to 64), with no
    checkpoint (the CLIs warn and run the seeded weights). The card machine has no
    OpenCV, so ``list_video_files``, ``load_video`` and ``write_video`` are replaced by
    in-memory stand-ins for the run. Each video's launches are held to one encode
    (decode) of the model; each written ``mean`` and ``selection_prob`` to a
    hand-called ``model.encode`` on the same clip, and each decoded video to a
    hand-called decode of its ``.npz``, bit for bit. Prints clips/s, device ms a clip
    (torch.profiler) and peak memory; returns the launches of one video of each.
    ``resize`` and ``frames`` other than the defaults are passed as flags."""
    import tempfile

    import numpy as np
    import torch

    from video_vae_tpu_torch import ModelConfig, VideoVAE
    from video_vae_tpu_torch.cli import cache_latents, decode_latents
    from video_vae_tpu_torch.data import source, video_io

    cfg = ModelConfig(height=resize, width=resize)  # what both CLIs build
    flags = [] if (resize, frames) == (LATENT_RESIZE, LATENT_FRAMES) else [
        "--resize", str(resize), "--max_frames", str(frames)]
    gen = np.random.default_rng(50)
    clips = {f"clip{i}.mp4": _latent_clip(n, frames, resize, gen) for i, n in enumerate(clip_frames)}
    convs = 1 + 4 * cfg.unet_levels + 2
    want = {
        "cache-latents": {**{k: 0 for k in read_launches()}, "vvt_fused_attention_fwd": 2 * cfg.encoder_depth},
        "decode-latents": {**{k: 0 for k in read_launches()}, "vvt_fused_attention_fwd": 2 * cfg.decoder_depth,
                           "vvt_conv3d_cf": convs},
    }
    marks, written = [], {}

    def fake_list(data_dir, max_shards=100):
        return [os.path.join(data_dir, name) for name in sorted(clips)]

    def fake_load(path, max_frames=None, resize=None, crop_size=512, *, rng=None, on_error="zeros"):
        if (max_frames, resize, on_error) != (frames, (cfg.height, cfg.width), "skip"):
            raise AssertionError(f"load_video called with {max_frames}, {resize}, {on_error}")
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), read_launches()))
        video, mask = clips[os.path.basename(path)]
        return video.copy(), mask.copy()

    def fake_write(batch, output_path, fps=30.0, sample_index=0):
        written[os.path.basename(output_path)] = (np.asarray(batch["video"], np.float32), np.asarray(batch["mask"]))

    def per_video(end):
        """(seconds, launches) of each video between the marks, the last ending at ``end``."""
        stops = marks[1:] + [end]
        return [(b[0] - a[0], {k: b[1][k] - a[1][k] for k in a[1]}) for a, b in zip(marks, stops)]

    saved = source.list_video_files, video_io.load_video, video_io.write_video
    source.list_video_files, video_io.load_video, video_io.write_video = fake_list, fake_load, fake_write
    results = {}
    try:
        with tempfile.TemporaryDirectory(prefix="vvt-latents-") as tmp:
            missing = os.path.join(tmp, "no_checkpoint")
            torch.cuda.reset_peak_memory_stats(dev)
            started = time.perf_counter()
            cache_latents.main(["--model_path", missing, "--data_dir", tmp, "--out_dir", os.path.join(tmp, "latents"),
                                *flags])
            torch.cuda.synchronize()
            encoded = per_video((time.perf_counter(), read_launches()))
            results["cache-latents"] = (encoded, time.perf_counter() - started,
                                        torch.cuda.max_memory_allocated(dev) / 2**30)
            latents = {name: dict(np.load(os.path.join(tmp, "latents", name.replace(".mp4", ".npz"))))
                       for name in clips}
            decoded = []
            torch.cuda.reset_peak_memory_stats(dev)
            started = time.perf_counter()
            for name in sorted(clips):
                before = (time.perf_counter(), read_launches())
                decode_latents.main(["--model_path", missing, "--latents",
                                     os.path.join(tmp, "latents", name.replace(".mp4", ".npz")),
                                     "--out", os.path.join(tmp, name), *flags[:2]])
                torch.cuda.synchronize()
                after = (time.perf_counter(), read_launches())
                decoded.append((after[0] - before[0], {k: after[1][k] - before[1][k] for k in after[1]}))
            results["decode-latents"] = (decoded, time.perf_counter() - started,
                                         torch.cuda.max_memory_allocated(dev) / 2**30)
    finally:
        source.list_video_files, video_io.load_video, video_io.write_video = saved

    model = VideoVAE(cfg, device=dev)  # the CLIs' seeded weights
    model.eval()
    inputs = {}
    for name, (video, mask) in clips.items():
        npz = latents[name]
        x = torch.from_numpy(video)[None].to(dev, torch.bfloat16)
        m = torch.from_numpy(mask)[None].to(dev)
        with torch.inference_mode():
            mean, logvar, prob = model.encode(x, m)
            z = torch.from_numpy(npz["mean"])[None].to(dev, torch.bfloat16)
            keep = (torch.from_numpy(npz["selection_prob"])[None].to(dev) >= 0.5).to(z.dtype)[..., None]
            recon = model.decode(model.blend_fill(z, keep), m)[0].float().cpu().numpy()
        same = {key: np.array_equal(npz[key], ours[0].float().cpu().numpy())
                for key, ours in (("mean", mean), ("log_variance", logvar), ("selection_prob", prob))}
        same["video"] = np.array_equal(written[name][0], recon)
        same["mask"] = np.array_equal(npz["mask"], mask) and np.array_equal(written[name][1], mask)
        if not all(same.values()):
            raise AssertionError(f"latent CLIs on {name}: not the hand-called model's bits: {same}")
        if npz["scene_changes"].tolist() != [0, (int(mask.sum()) + 1) // 2] or str(npz["source"]) != os.path.join(
                tmp, name):
            raise AssertionError(f"latent CLIs on {name}: scene changes {npz['scene_changes']}, source {npz['source']}")
        inputs[name] = (x, m, z, keep)
    x, m, z, keep = inputs[sorted(clips)[0]]

    def encode():
        with torch.inference_mode():
            return model.encode(x, m)

    def decode():
        with torch.inference_mode():
            return model.decode(model.blend_fill(z, keep), m)

    for label, run in (("cache-latents", encode), ("decode-latents", decode)):
        videos, run_s, peak = results[label]
        for i, (_, launches) in enumerate(videos):
            if launches != want[label]:
                raise AssertionError(f"{label} video {i}: launches {launches}, expected {want[label]}")
        seconds = [t for t, _ in videos]
        profile = profile_device(label, run, 1e3 * seconds[-1], passes=2)
        log(label, json.dumps({
            "config": f"{describe(cfg)}, cli/{label.replace('-', '_')}.py --resize {resize} --max_frames {frames}"
                      f"{'' if flags else ' (its defaults)'}, seeded weights, {len(clips)} synthetic clips of "
                      f"{list(clip_frames)} frames (padded to {frames}), in-memory video source",
            "videos": len(videos), "run_s": run_s, "s_per_video": seconds,
            "clips_per_s": len(videos) / sum(seconds), "device_ms_per_clip": profile["device_busy_ms_per_run"],
            "device_ops_per_clip": profile["device_ops_per_run"], "peak_memory_gib": peak,
            "launches_per_video": want[label], "same_bits_as_hand_called_model": True,
        }))
    del model, inputs, x, m, z, keep
    torch.cuda.empty_cache()
    return want


def phase_vgg_conv_kernels(dev, rows):
    """The direct conv kernel (#2) at the cf VGG's six shapes against its plain version,
    on one VGG pass of ``VGG_FRAMES`` frames: the three convs and the three input
    gradients a train step runs (conv1_1's into the reconstruction), with cuDNN's
    ``F.conv3d`` on the same operands beside each and the same bits twice."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(40)
    for name, side, cin, cout, launches in VGG_CONV_CASES:
        x = torch.randn(1, VGG_FRAMES, cin, side, side, generator=gen).to(dev, torch.bfloat16)
        kernel = (torch.randn(1, 3, 3, cin, cout, generator=gen) / (9 * cin) ** 0.5).to(dev, torch.bfloat16)
        bias = (torch.zeros(cout) if "dgrad" in name else 0.1 * torch.randn(cout, generator=gen)).to(dev)
        out = conv3d.conv3d_cf_cuda(x, None, kernel, bias)
        again = conv3d.conv3d_cf_cuda(x, None, kernel, bias)
        torch.cuda.synchronize()
        err = check_close(f"vgg conv {name}", out, conv3d.conv3d_cf_plain(x, None, kernel, bias), "bfloat16")
        if not torch.equal(out, again):
            raise AssertionError(f"vgg conv {name}: two launches gave different bits")
        x_ncdhw = x.transpose(1, 2).contiguous()
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
        lib_bias = bias.to(torch.bfloat16)
        flops = 2.0 * VGG_FRAMES * cout * cin * valid_taps(side, 3) ** 2

        def run():
            return conv3d.conv3d_cf_cuda(x, None, kernel, bias)

        def library():
            return F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=(0, 1, 1))

        _record(
            rows, conv3d.CONV3D, f"vgg {name}", [1, VGG_FRAMES, cin, side, side, cout, [1, 3, 3]], "bfloat16", err,
            time_ms(run, 5), time_ms(lambda: conv3d.conv3d_cf_plain(x, None, kernel, bias), 1, warmup=0),
            time_ms(library, 5), "torch.nn.functional.conv3d (cuDNN), (1, 3, 3) kernel",
            bound_ms(nbytes(x, kernel, bias, out), flops, "bfloat16"), {"train-vgg-cf": launches},
            **device_times(run, library, flops),
        )
        del x, out, again, x_ncdhw
    torch.cuda.empty_cache()


def phase_tiny(dev):
    """The JAX smoke command's counterpart: ``cli/train.py``'s ``main`` with
    ``--synthetic --tiny --steps 5`` under its default device, checkpoints in a
    temporary directory (the working directory while it runs). Every step's
    launches are counted and held to a tiny train step's; the run's metrics are
    finite and its checkpoint is written. Returns the launches of one step."""
    import tempfile

    import torch

    from video_vae_tpu_torch.cli import train as cli_train
    from video_vae_tpu_torch.train import trainer as trainer_module

    cfg = cli_config(TINY_ARGS)
    want = expected_launches(cfg.model, "train", "fused")
    steps, last = [], {}
    inner = trainer_module.train_step

    def counted(*args, **kw):
        before = read_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = inner(*args, **kw)
        end.record()
        after = read_launches()
        steps.append({"launches": {k: after[k] - before[k] for k in after}, "events": (start, end),
                      "metrics": metrics})
        last.update(args=args, kw=kw)
        return metrics

    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="vvt-tiny-") as tmp:
        trainer_module.train_step = counted  # the Trainer binds it when it is built
        os.chdir(tmp)
        try:
            reset_launches()
            started = time.perf_counter()
            cli_train.main([*TINY_ARGS, "--checkpoint_dir", os.path.join(tmp, "checkpoints")])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - started
        finally:
            os.chdir(here)
            trainer_module.train_step = inner
        launches = read_launches()
        n = len(steps)
        saved = os.path.exists(os.path.join(tmp, "checkpoints", str(n), "state.pt"))
    epoch = cfg.data.synthetic_num_clips // cfg.data.batch_size  # --steps is checked between epochs
    if n != epoch or not saved:
        raise AssertionError(f"tiny: {n} steps (want {epoch}), checkpoint written: {saved}")
    for i, step in enumerate(steps):
        if step["launches"] != want:
            raise AssertionError(f"tiny step {i + 1} launches {step['launches']}, expected {want}")
        metrics = {k: float(v) for k, v in step["metrics"].items()}
        if not _finite(metrics) or not metrics["grad_norm"] > 0:
            raise AssertionError(f"tiny step {i + 1}: metrics {metrics}")
    if launches != {k: n * v for k, v in want.items()}:
        raise AssertionError(f"tiny run launches {launches}, expected {n} x {want}")
    times = [start.elapsed_time(end) for start, end in (step["events"] for step in steps)]
    ms = statistics.median(times[2:])
    profile = profile_device("tiny", lambda: inner(*last["args"], **last["kw"]), ms, passes=3)
    log("tiny", json.dumps({
        "config": f"{describe(cfg.model)}, head_dim {cfg.model.head_dim}, b{cfg.data.batch_size} x "
                  f"{cfg.data.max_frames} frames, synthetic; cli/train.py {' '.join(TINY_ARGS)}",
        "steps": n, "run_s": run_s, "ms_per_step_median": ms, "ms_per_step_all": times,
        "device_ms_per_step": profile["device_busy_ms_per_run"],
        "device_ops_per_step": profile["device_ops_per_run"], "idle_share": profile["idle_share_vs_median"],
        "launches_per_step": want, "launches_run": launches,
        "last_step_metrics": {k: float(v) for k, v in steps[-1]["metrics"].items()},
    }))
    del steps, last
    torch.cuda.empty_cache()
    return want


def phase_train_small(dev):
    """One train step of the ``--small`` preset (256², 2 + 2 blocks of 8 heads of 16,
    remat on, perceptual on with the random VGG) on cli/train.py's default batch,
    2 clips of 32 frames: launches held to the step's, finite metrics, its device ms
    and peak memory ("train-small" line)."""
    import torch

    from video_vae_tpu_torch import DynamicHParams, VideoVAE, build_perceptual, create_optimizer, train_step

    vae_cfg = cli_config(SMALL_ARGS)
    cfg, clips, frames = vae_cfg.model, vae_cfg.data.batch_size, vae_cfg.data.max_frames
    model = VideoVAE(cfg, device=dev, seed=0)
    opt = create_optimizer(model, vae_cfg.optim)
    perceptual = build_perceptual(vae_cfg.loss, device=dev)
    gen = torch.Generator().manual_seed(50)
    video = torch.rand(clips, frames, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(clips, frames, device=dev)
    mask[-1, frames - 3:] = 0
    hp, draws = DynamicHParams.default(), torch.Generator(device=dev).manual_seed(51)

    def step():
        return train_step(model, opt, video, mask, hp, vae_cfg.loss, perceptual, generator=draws)

    reset_launches()
    first = {k: float(v) for k, v in step().items()}
    torch.cuda.synchronize()
    launches, want = read_launches(), trainer_launches(cfg)
    if launches != want:
        raise AssertionError(f"train-small launches {launches}, expected {want}")
    if not _finite(first) or not first["grad_norm"] > 0:
        raise AssertionError(f"train-small step: metrics {first}")
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    profile = profile_device("train-small", step, ms, passes=1)
    log("train-small", json.dumps({
        "config": f"{describe(cfg)}, head_dim {cfg.head_dim}, bf16 compute, f32 params, b{clips} x {frames} "
                  f"frames, rl (2 rollouts), perceptual on (random VGG), remat on; cli/train.py {' '.join(SMALL_ARGS)}",
        "launches": launches, "ms_per_step_median": ms, "ms_per_step_all": times,
        "device_ms_per_step": profile["device_busy_ms_per_run"],
        "device_ops_per_step": profile["device_ops_per_run"], "idle_share": profile["idle_share_vs_median"],
        "peak_memory_gib": peak, "step1_metrics": first,
    }))
    del model, opt, perceptual
    torch.cuda.empty_cache()


def phase_train_vgg_cf(cfg, dev, reference):
    """The flagship b1 x 16f train step with ``LossConfig(vgg_layout="cf")``: the
    ``train`` line's model (seed 0), batch and draws, its loss, perceptual term and
    keep decisions held to that line's (nhwc) ones; the launches of a step (#2 runs
    the VGG's 6 forward convs and 3 input gradients besides the UNet's 30, #4 the
    UNet's 15 and no VGG filter gradient); the step's device ms, and the VGG's
    forward and backward alone on both layouts with their device ms by op."""
    import torch

    from video_vae_tpu_torch import (
        DynamicHParams,
        LossConfig,
        OptimConfig,
        VideoVAE,
        build_perceptual,
        create_optimizer,
        train_step,
    )
    from video_vae_tpu_torch.train.step import loss_and_grads

    cfg = cfg.replace(remat=False)
    model = VideoVAE(cfg, device=dev, seed=0)
    opt = create_optimizer(model, OptimConfig())
    loss_cfg, hp = LossConfig(vgg_layout="cf"), DynamicHParams.default()
    perceptual = build_perceptual(loss_cfg, device=dev)
    gen = torch.Generator().manual_seed(8)
    video = torch.rand(TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(TRAIN_BATCH, FRAMES, device=dev)
    noise, uniforms = reference["draws"]
    loss0, metrics0, grads0 = loss_and_grads(model, video.to(cfg.compute_dtype()), mask, hp, loss_cfg, perceptual,
                                             noise=noise.to(dev), uniforms=uniforms.to(dev))
    got = {"loss": float(loss0.detach()), "perceptual_loss": float(metrics0["perceptual_loss"]),
           "kept_frame_density": float(metrics0["kept_frame_density"])}
    del loss0, metrics0, grads0
    if got["kept_frame_density"] != reference["kept_frame_density"]:
        raise AssertionError("train-vgg-cf: keep decisions differ from the train line's for the same draws")
    errs = {k: abs(got[k] - reference[k]) / abs(reference[k]) for k in ("loss", "perceptual_loss")}
    if not max(errs.values()) <= PATH_LOSS_TOL:
        raise AssertionError(f"train-vgg-cf: {got} vs the train line's {reference} (tol {PATH_LOSS_TOL})")

    draws = torch.Generator(device=dev).manual_seed(9)

    def step():
        return train_step(model, opt, video, mask, hp, loss_cfg, perceptual, generator=draws)

    reset_launches()
    first = {k: float(v) for k, v in step().items()}
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches(cfg, "train", "fused")
    want["vvt_conv3d_cf"] += sum(n for *_, n in VGG_CONV_CASES)
    if launches != want:
        raise AssertionError(f"train-vgg-cf launches {launches}, expected {want}")
    if not _finite(first) or not first["grad_norm"] > 0:
        raise AssertionError(f"train-vgg-cf step: metrics {first}")
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    profile = profile_device("train-vgg-cf", step, ms, passes=1)
    del model, opt
    # the VGG alone, forward and backward on a step's reconstructions, in each layout
    x = torch.rand(2 * TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    target = torch.rand(TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    x.requires_grad_()
    vgg = {}
    for layout in ("cf", "nhwc"):
        fn = build_perceptual(LossConfig(vgg_layout=layout), device=dev)

        def run(fn=fn):
            return torch.autograd.grad(fn(x, target, 2).sum(), [x])

        vgg_ms = device_ms(run, iters=3)
        vgg[layout] = {"device_ms": vgg_ms, **profile_device(f"vgg-{layout}", run, vgg_ms, passes=2)}
    log("train-vgg-cf", json.dumps({
        "config": f"{describe(cfg)}, bf16 compute, f32 params, b{TRAIN_BATCH} x {FRAMES} frames, rl (2 rollouts), "
                  "perceptual on with vgg_layout='cf' (random VGG), remat off, path fused",
        "launches": launches, "fixed_draws": got, "train_line": {k: reference[k] for k in got},
        "rel_err": errs, "tol": PATH_LOSS_TOL, "ms_per_step_median": ms, "ms_per_step_all": times,
        "device_ms_per_step": profile["device_busy_ms_per_run"],
        "device_ops_per_step": profile["device_ops_per_run"], "idle_share": profile["idle_share_vs_median"],
        "peak_memory_gib": peak, "vgg_fwd_bwd_device_ms": {layout: v["device_ms"] for layout, v in vgg.items()}, "step1_metrics": first,
    }))
    del x, target
    torch.cuda.empty_cache()


def phase_mae_kernels(dev, rows):
    """Kernels #1 and #3 against their plain versions at the MAE's b4 x 16f calls
    (:func:`mae_attention_cases`): the spatial calls at S = 196 (unmasked) and the
    temporal ones at S = 16 under clip 1's padding, a sequence with every key masked,
    the same bits twice, SDPA beside each; counted on ``"mae"`` (a gradient step,
    remat on: each forward twice) and ``"mae-eval"`` (an eval forward)."""
    cfg = mae_config()
    phase_attention_kernels(cfg, dev, rows, "mae-eval", "mae", mae_attention_cases(cfg), remat=cfg.remat,
                            masked_rows=True)


def _mae_launches(cfg, train: bool) -> dict:
    """Launches of every kernel in one MAE gradient step (``train``) or eval forward:
    #1 twice per block (temporal, spatial), again under remat in a step, and #3 once
    per forward call in a step (its spatial calls, S = 196, on the wgmma tile kernel);
    nothing else."""
    calls = 2 * (cfg.encoder_depth + max(1, cfg.decoder_depth // 3))
    want = no_launches()
    want["vvt_fused_attention_fwd"] = calls * (2 if train and cfg.remat else 1)
    want["vvt_fused_attention_bwd"] = calls if train else 0
    if train and takes_wgmma_tile(cfg.num_patches, cfg.head_dim):
        want[ATTN_BWD_WGMMA_TILE] = calls // 2
    return want


def phase_mae(dev):
    """``VideoMAE(mae_config())`` at full width and depth, mask ratio 0.9, bf16, b4 x 16f
    with clip 1 padded: a training forward plus ``torch.autograd.grad`` of ``mae_loss``
    (launches held: 52 of #1 and 26 of #3 on the flagship's 13 blocks), an eval
    forward (26 of #1, no token masked), each timed ``MAE_TIMED`` times after a
    warm-up and profiled (device ms, idle share), peak memory beside. Returns the
    launches of (a step, an eval forward)."""
    import torch

    from video_vae_tpu_torch.models import VideoMAE, mae_loss

    cfg = mae_config()
    model = VideoMAE(cfg, device=dev, seed=0)
    params = list(model.parameters())
    gen = torch.Generator().manual_seed(41)
    video = torch.rand(MAE_CLIPS, MAE_FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = mae_frame_mask().to(dev)
    draws = torch.Generator(device=dev).manual_seed(42)

    def grad_step():
        out = model(video, mask, generator=draws)
        loss, metrics = mae_loss(out, mask)
        return out, metrics, torch.autograd.grad(loss, params)

    def eval_forward():
        with torch.no_grad():
            return model(video, mask, train=False)

    launches = {}
    for label, run, train in (("mae", grad_step, True), ("mae-eval", eval_forward, False)):
        reset_launches()
        result = run()
        torch.cuda.synchronize()
        launches[label] = read_launches()
        if launches[label] != _mae_launches(cfg, train):
            raise AssertionError(f"launches per {label} run {launches[label]}, expected {_mae_launches(cfg, train)}")
        out = result[0] if train else result
        want = (MAE_CLIPS, MAE_FRAMES, cfg.num_patches, cfg.embed_dim)
        if tuple(out.prediction.shape) != want or not torch.isfinite(out.prediction).all():
            raise AssertionError(f"{label}: prediction of shape {tuple(out.prediction.shape)} (want {want}) "
                                 "or non-finite")
        masked = float(out.token_mask.float().mean())
        if train:
            metrics = {k: float(v.detach()) for k, v in result[1].items()}
            if not (0.85 < masked < 0.95 and _finite(metrics) and metrics["loss"] > 0
                    and all(torch.isfinite(g).all() for g in result[2])):
                raise AssertionError(f"mae step: masked share {masked}, metrics {metrics}, or non-finite gradients")
        elif masked != 0.0:
            raise AssertionError(f"mae eval forward masked {masked} of the tokens")
        del result, out
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(MAE_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        profile = profile_device(label, run, ms, passes=1)
        log(label, json.dumps({
            "config": f"VideoMAE {describe(cfg)}, {cfg.num_heads} heads of {cfg.head_dim}, "
                      f"{cfg.encoder_depth} + {max(1, cfg.decoder_depth // 3)} blocks, remat {cfg.remat}, bf16 "
                      f"compute, f32 params, mask ratio {model.mask_ratio}, b{MAE_CLIPS} x {MAE_FRAMES} frames "
                      f"(clip {MAE_PADDED_CLIP} ends in 3 padded), "
                      + ("training forward + autograd.grad of mae_loss" if train else "eval forward"),
            "launches": launches[label], "ms_median": ms, "ms_all": times, "peak_memory_gib": peak,
            "device_ms": profile["device_busy_ms_per_run"], "device_ops": profile["device_ops_per_run"],
            "idle_share": profile["idle_share_vs_median"], "masked_token_share": masked,
            **({"step_metrics": metrics} if train else {}),
        }))
    del model, params, video
    torch.cuda.empty_cache()
    return launches["mae"], launches["mae-eval"]


def phase_f32_mae(dev):
    """The MAE at 224² and the flagship's width, depth 1 + 1, float32, b1 x 4 frames (the
    last padded), with an injected token mask: prediction, loss metrics and every
    parameter's gradient on the card against the CPU."""
    import torch

    from video_vae_tpu_torch.models import VideoMAE, mae_loss

    cfg = mae_config().replace(dtype="float32", encoder_depth=1, decoder_depth=1, remat=False)
    cpu_model = VideoMAE(cfg, device="cpu", seed=43)
    gpu_model = VideoMAE(cfg, device=dev, seed=43)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(44)
    video = torch.rand(1, 4, cfg.height, cfg.width, cfg.channels, generator=gen)
    mask = torch.ones(1, 4)
    mask[0, 3:] = 0
    token_mask = torch.rand(1, 4, cfg.num_patches, generator=gen) < cpu_model.mask_ratio
    results = {}
    for name, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        out = model(video.to(device), mask.to(device), token_mask=token_mask.to(device))
        loss, metrics = mae_loss(out, mask.to(device))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results[name] = (out.prediction.detach().cpu(), {k: float(v.detach()) for k, v in metrics.items()},
                         [g.cpu() for g in grads])
    (p_cpu, m_cpu, g_cpu), (p_gpu, m_gpu, g_gpu) = results["cpu"], results["gpu"]
    rel = ((p_gpu - p_cpu).abs().max() / p_cpu.abs().max()).item()
    if not rel <= FORWARD_F32_TOL:
        raise AssertionError(f"f32 mae prediction card vs CPU: relative max-abs error {rel} > {FORWARD_F32_TOL}")
    errs = _hold_metrics("f32 mae", m_gpu, m_cpu)
    worst = _hold_grads("f32 mae", [n for n, _ in cpu_model.named_parameters()], g_gpu, g_cpu, {})
    log("f32-mae", json.dumps({
        "config": f"VideoMAE {describe(cfg)}, depth 1 + 1, float32, b1 x 4 frames (1 padded), injected token mask "
                  f"({int(token_mask.sum())} of {token_mask.numel()} masked)",
        "prediction_rel_max_abs_err": rel, "metrics_cpu": m_cpu, "metric_rel_err": errs,
        "worst_grad_rel_err": worst[0], "worst_grad_leaf": worst[1], "leaves": len(g_cpu),
        "tols": [FORWARD_F32_TOL, TRAIN_F32_TOL, GRAD_F32_TOL],
    }))
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def _recording(optimizer, into: dict, key: str):
    """Make ``optimizer.update`` keep a host copy of the gradients it is handed under ``key``."""
    update = optimizer.update

    def record(grads):
        into[key] = [g.detach().float().cpu() for g in grads]
        return update(grads)

    optimizer.update = record


def _discriminator_noise(disc) -> dict:
    """{path: bound} of the discriminator's conv biases whose GroupNorm has one channel a
    group: the norm removes them, so their true gradient is 0 (``D_NOISE_TOL``)."""
    from video_vae_tpu_torch.models.classifier import SNConvBlock3D

    return {f"{n}.conv.layer.bias": D_NOISE_TOL for n, m in disc.named_modules()
            if isinstance(m, SNConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()}


def phase_f32_gan(dev):
    """One float32 GAN step (``train/adversarial.py``) on the card against the CPU: the
    flagship's width at depth 1, b1 x 4 frames (1 padded), perceptual on, the same draws,
    and a ``Discriminator(base_features=8, num_levels=2)``: every metric, the gradients
    each optimizer is handed (the VAE's and the discriminator's), and every ``u`` after
    the step's three discriminator calls."""
    import torch

    from video_vae_tpu_torch import DynamicHParams, LossConfig, ModelConfig, OptimConfig, VideoVAE, create_optimizer
    from video_vae_tpu_torch.losses import make_perceptual_loss_fn
    from video_vae_tpu_torch.models import Discriminator
    from video_vae_tpu_torch.models.vgg import load_vgg
    from video_vae_tpu_torch.train import make_adversarial_train_step

    cfg = ModelConfig(dtype="float32", encoder_depth=1, decoder_depth=1, remat=False)
    loss_cfg, hp = LossConfig(), DynamicHParams.default()
    cpu_model = VideoVAE(cfg, device="cpu", seed=45)
    gen = torch.Generator().manual_seed(46)
    random_final_conv(cpu_model, gen)
    gpu_model = VideoVAE(cfg, device=dev, seed=45)
    gpu_model.load_state_dict(cpu_model.state_dict())
    d_kw = dict(base_features=8, num_levels=2, dtype=torch.float32, seed=47)
    cpu_disc = Discriminator(device="cpu", **d_kw)
    gpu_disc = Discriminator(device=dev, **d_kw)
    gpu_disc.load_state_dict(cpu_disc.state_dict())
    video = torch.rand(1, 4, cfg.height, cfg.width, cfg.channels, generator=gen)
    mask = torch.ones(1, 4)
    mask[0, 3:] = 0
    noise, uniforms = _draws(cpu_model, video, mask, seed=48, rollouts_differ=True)
    results = {}
    for name, model, disc, device in (("cpu", cpu_model, cpu_disc, "cpu"), ("gpu", gpu_model, gpu_disc, dev)):
        perceptual = make_perceptual_loss_fn(load_vgg(None, device=device))
        opt, d_opt = create_optimizer(model, OptimConfig()), create_optimizer(disc, OptimConfig())
        grads = {}
        _recording(opt, grads, "vae")
        _recording(d_opt, grads, "discriminator")
        metrics = make_adversarial_train_step(loss_cfg, perceptual)(
            model, opt, disc, d_opt, video.to(device), mask.to(device), hp, 0,
            noise=noise.to(device), uniforms=uniforms.to(device),
        )
        results[name] = ({k: float(v) for k, v in metrics.items()}, grads,
                         {n: b.cpu() for n, b in disc.named_buffers()})
    (m_cpu, g_cpu, u_cpu), (m_gpu, g_gpu, u_gpu) = results["cpu"], results["gpu"]
    if set(m_cpu) != set(GAN_METRICS):
        raise AssertionError(f"f32 gan metrics {sorted(m_cpu)}, expected {sorted(GAN_METRICS)}")
    errs = _hold_metrics("f32 gan", m_gpu, m_cpu)
    vae_names = [n for n, _ in cpu_model.named_parameters()]
    vae_noise = _noise_leaves(vae_names, g_cpu["vae"])
    worst = {
        "vae": _hold_grads("f32 gan vae", vae_names, g_gpu["vae"], g_cpu["vae"], vae_noise),
        "discriminator": _hold_grads("f32 gan discriminator", [n for n, _ in cpu_disc.named_parameters()],
                                     g_gpu["discriminator"], g_cpu["discriminator"], _discriminator_noise(cpu_disc)),
    }
    u_err = 0.0
    for key, ref in u_cpu.items():
        u_err = max(u_err, ((u_gpu[key] - ref).abs().max() / ref.abs().max()).item())
        if not u_err <= TRAIN_F32_TOL:
            raise AssertionError(f"f32 gan {key} after the step: card vs CPU relative error {u_err}")
    log("f32-gan", json.dumps({
        "config": "flagship width, encoder/decoder depth 1, b1 x 4 frames (1 padded), perceptual on; "
                  "Discriminator(base_features=8, num_levels=2), float32",
        "metrics_cpu": m_cpu, "metric_rel_err": errs,
        "worst_grad_rel_err": {k: w[0] for k, w in worst.items()}, "worst_grad_leaf": {k: w[1] for k, w in worst.items()},
        "leaves_at_rounding_noise": {"vae": len(vae_noise), "discriminator": len(_discriminator_noise(cpu_disc))},
        "u_rel_max_abs_err": u_err, "tols": [TRAIN_F32_TOL, PERCEPTUAL_F32_TOL, GRAD_F32_TOL, ZERO_GRAD_TOL, D_NOISE_TOL],
    }))
    del cpu_model, gpu_model, cpu_disc, gpu_disc
    torch.cuda.empty_cache()


def phase_train_gan(dev, train_launches: dict):
    """The flagship GAN step: the "train" phase's ``ModelConfig(remat=False)`` and batch
    (b1 x 16f, 2 rollouts, perceptual on) with a full-width ``Discriminator()`` (base 32,
    4 levels, remat on, bf16), ``make_adversarial_train_step`` at its defaults. Its
    launches of #1-#4 must equal ``train_launches`` (the discriminator runs cuDNN convs,
    no kernel of the port); the metrics are the JAX step's and finite, every ``u`` moves,
    the first step leaves both models as they were (lr 0). Then 3 timed steps after a
    warm-up, a profiled one, and the discriminator's own device ms (its three calls and
    the two backwards a step takes through it) for its share."""
    import torch

    from video_vae_tpu_torch import (
        DynamicHParams,
        LossConfig,
        ModelConfig,
        OptimConfig,
        VideoVAE,
        build_perceptual,
        create_optimizer,
    )
    from video_vae_tpu_torch.losses import discriminator_loss, generator_adversarial_loss
    from video_vae_tpu_torch.models import Discriminator
    from video_vae_tpu_torch.train import make_adversarial_train_step

    cfg = ModelConfig(remat=False)
    model = VideoVAE(cfg, device=dev, seed=0)
    disc = Discriminator(device=dev, seed=1)
    opt, d_opt = create_optimizer(model, OptimConfig()), create_optimizer(disc, OptimConfig())
    loss_cfg, hp = LossConfig(), DynamicHParams.default()
    gan_step = make_adversarial_train_step(loss_cfg, build_perceptual(loss_cfg, device=dev))
    gen = torch.Generator().manual_seed(8)
    video = torch.rand(TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(TRAIN_BATCH, FRAMES, device=dev)
    draws = torch.Generator(device=dev).manual_seed(9)
    steps = [0]

    def step():
        metrics = gan_step(model, opt, disc, d_opt, video, mask, hp, steps[0], generator=draws)
        steps[0] += 1
        return metrics

    u0 = {n: b.clone() for n, b in disc.named_buffers()}
    before = [p.detach().clone() for p in [*model.parameters(), *disc.parameters()]]
    reset_launches()
    first = {k: float(v) for k, v in step().items()}
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != train_launches:
        raise AssertionError(f"launches per train-gan step {launches}, the train step's {train_launches}")
    if set(first) != set(GAN_METRICS) or not _finite(first):
        raise AssertionError(f"train-gan step 1 metrics {first}")
    if any(torch.equal(b, u0[n]) for n, b in disc.named_buffers()):
        raise AssertionError("a spectral norm's u did not move in the step")
    if any(not torch.equal(p, q) for p, q in zip([*model.parameters(), *disc.parameters()], before)):
        raise AssertionError("the first GAN step (lr 0) changed a parameter")
    del before
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(NEW_PATH_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    profile = profile_device("train-gan", step, ms, passes=1)

    video_c = video.to(cfg.compute_dtype())
    with torch.no_grad():
        recon = model(video_c, mask, generator=draws).reconstruction

    def discriminator_work():  # D's part of a step: D(recon) and its input gradient, then D's own step
        x = recon.detach().requires_grad_()
        torch.autograd.grad(generator_adversarial_loss(disc(x)), x)
        d_loss, _ = discriminator_loss(disc(video_c), disc(recon[:TRAIN_BATCH]))
        torch.autograd.grad(d_loss, list(disc.parameters()))

    d_ms = device_ms(discriminator_work, iters=2, traces=3)
    log("train-gan", json.dumps({
        "config": f"{describe(cfg)}, bf16 compute, f32 params, b{TRAIN_BATCH} x {FRAMES} frames, rl (2 rollouts), "
                  "perceptual on, remat off; Discriminator() (base 32, 4 levels, remat on, bf16), adversarial "
                  "weight 0.1 from step 0",
        "launches": launches, "ms_per_step_median": ms, "ms_per_step_all": times, "peak_memory_gib": peak,
        "device_ms": profile["device_busy_ms_per_run"], "device_ops": profile["device_ops_per_run"],
        "idle_share": profile["idle_share_vs_median"], "discriminator_device_ms": d_ms,
        "discriminator_share_of_device_ms": d_ms / profile["device_busy_ms_per_run"],
        "discriminator_params": sum(p.numel() for p in disc.parameters()), "step1_metrics": first,
    }))
    del model, disc, opt, d_opt, recon
    torch.cuda.empty_cache()


def reference_tree(params: dict, cfg) -> dict:
    """``params`` ({'/' path: host array}) as a reference checkpoint's model subtree:
    nested dicts, block stacks as lists, every leaf an object with ``.value``, and a
    ``ROPE`` cos/sin pair in each attention block, as the reference caches them (the
    import drops them)."""
    from video_vae_tpu_torch.ops.rope import rope_tables

    class Leaf:
        def __init__(self, value):
            self.value = value

    tree: dict = {}
    for key, value in params.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = Leaf(value)
    for stack in ("encoder", "decoder"):
        for block in tree[stack]["layers"].values():
            for name, seq in (("SpatialAttention", cfg.num_patches), ("TemporalAttention", cfg.max_temporal_len)):
                cos, sin = rope_tables(seq, cfg.head_dim)
                block[name]["ROPE"] = {"cos": Leaf(cos.numpy()), "sin": Leaf(sin.numpy())}

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        return [node[str(i)] for i in range(len(node))] if all(k.isdigit() for k in node) else node

    return listify(tree)


def _serving_batch(cfg, dev):
    """The "serving" phase's b2 x 16f video and frame mask (clip 1 ends in 3 padded frames)."""
    import torch

    gen = torch.Generator().manual_seed(3)
    video = torch.rand(BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(BATCH, FRAMES, device=dev)
    mask[1, FRAMES - 3:] = 0
    return video, mask


def phase_reference_import(cfg, dev):
    """``train/checkpoint.py:import_reference_state`` at the flagship's width and depth.

    One seeded flagship's parameters go to the host as a reference checkpoint's tree
    and into a second flagship of another seed: first with one leaf's shape changed
    (the walk's last), which must raise ``ValueError`` and leave the second model as
    it was, then whole: the count must be the number of parameters and every
    parameter the first model's bits. One bf16 b2 x 16f serving pass of each (the
    "serving" phase's batch; the final conv redrawn, or its zero init would hide the
    UNet) must give the same bits, each pass launching the serving path's kernels."""
    import torch

    from video_vae_tpu_torch import VideoVAE, reconstruct
    from video_vae_tpu_torch.train import import_reference_state

    started = time.monotonic()
    source = VideoVAE(cfg, device=dev, seed=0)
    random_final_conv(source, torch.Generator().manual_seed(34))
    target = VideoVAE(cfg, device=dev, seed=1)
    params = {name.replace(".", "/"): p.detach().cpu().numpy() for name, p in source.named_parameters()}
    last = list(params)[-1]
    bad = reference_tree({**params, last: params[last][..., None]}, cfg)
    before = [p.detach().clone() for p in target.parameters()]
    try:
        import_reference_state(target, bad)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a reference tree with a changed shape was imported")
    if any(not torch.equal(p, q) for p, q in zip(target.parameters(), before)):
        raise AssertionError("a failed reference import changed the model")
    del before, bad
    copied = import_reference_state(target, reference_tree(params, cfg))
    import_s = time.monotonic() - started
    if copied != len(params):
        raise AssertionError(f"reference import copied {copied} of {len(params)} parameters")
    if any(not torch.equal(p, q) for p, q in zip(target.parameters(), source.parameters())):
        raise AssertionError("an imported parameter differs from the reference tree's bits")
    video, mask = _serving_batch(cfg, dev)
    want = expected_launches(cfg, "serving", "fused")
    outs = []
    for model in (source, target):
        reset_launches()
        outs.append(reconstruct(model, video, mask, device=dev))
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != want:
            raise AssertionError(f"launches per reference-import pass {launches}, expected {want}")
    if not torch.isfinite(outs[0].float()).all() or not torch.equal(outs[0], outs[1]):
        raise AssertionError("the imported model's serving pass differs from the source model's bits")
    log("reference-import", json.dumps({
        "config": f"{describe(cfg)}, bf16, b{BATCH} x {FRAMES} frames, path fused",
        "params": len(params), "copied": copied, "elements": sum(v.size for v in params.values()),
        "same_bits": True, "serving_same_bits": True, "launches_per_pass": launches,
        "changed_shape_refused": refused, "import_s": import_s, "seconds": time.monotonic() - started,
    }))
    del source, target, outs
    torch.cuda.empty_cache()


def phase_slope_serving(cfg, dev):
    """``utils/timing.py:robust_slope`` on the flagship's bf16 b2 x 16f serving pass:
    chains of ``SLOPE_CHAINS`` passes, each timed on the host clock and ended by
    ``torch.cuda.synchronize()``, ``SLOPE_REPEATS`` repeats. Prints the per-step
    estimate beside the "serving" phase's median and device ms; it is a record, held
    only to be finite and positive. Every pass launches the serving path's kernels."""
    import math

    import torch

    from video_vae_tpu_torch import VideoVAE, reconstruct
    from video_vae_tpu_torch.utils import robust_slope

    started = time.monotonic()
    model = VideoVAE(cfg, device=dev, seed=0)
    video, mask = _serving_batch(cfg, dev)

    def chain(k):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(k):
                reconstruct(model, video, mask, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        return run

    for _ in range(2):
        reconstruct(model, video, mask, device=dev)
    torch.cuda.synchronize()
    k_short, k_long = SLOPE_CHAINS
    reset_launches()
    est = robust_slope(chain(k_short), chain(k_long), k_short, k_long, repeats=SLOPE_REPEATS)
    launches = read_launches()
    passes = SLOPE_REPEATS * (k_short + k_long)
    want = {k: n * passes for k, n in expected_launches(cfg, "serving", "fused").items()}
    if launches != want:
        raise AssertionError(f"launches over the slope's {passes} serving passes {launches}, expected {want}")
    if not (math.isfinite(est.per_step) and est.per_step > 0):
        raise AssertionError(f"slope-serving: per-step estimate {est.per_step} s")
    log("slope-serving", json.dumps({
        "config": f"{describe(cfg)}, bf16, b{BATCH} x {FRAMES} frames, path fused; chains of {k_short} and "
                  f"{k_long} passes, {SLOPE_REPEATS} repeats, host clock after torch.cuda.synchronize()",
        "per_step_ms": est.per_step * 1e3, "slopes_ms": [x * 1e3 for x in est.slopes],
        "spread_ms": est.spread * 1e3, "outliers": est.outliers,
        "t_short_s": est.t_shorts, "t_long_s": est.t_longs, "summary": est.summary(),
        "serving": SERVING_RECORD.get("serving"), "passes": passes, "seconds": time.monotonic() - started,
    }))
    del model
    torch.cuda.empty_cache()


def long_config(**overrides):
    """The 512² phases' model: the flagship at ``--resize 512`` (spatial S = 1024)."""
    from video_vae_tpu_torch import ModelConfig

    return ModelConfig(height=LONG_SIDE, width=LONG_SIDE, **overrides)


def long_seq_cases(seqs, batch=FRAMES):
    """(name, B, S, key mask, dtype, {}) at each S of ``seqs``: ``batch`` sequences
    (a b1 x 16f step's spatial calls), each keeping a prefix of at least one key and
    the last every key, bf16 and f32; counted on no path."""
    import torch

    gen = torch.Generator().manual_seed(41)
    cases = []
    for S in seqs:
        lengths = torch.randint(1, S + 1, (batch,), generator=gen)
        lengths[-1] = S
        mask = torch.arange(S)[None, :] < lengths[:, None]
        cases += [(f"long S={S}", batch, S, mask, dtype, {}) for dtype in ("bfloat16", "float32")]
    return cases


def phase_long_seq_kernels(dev, rows):
    """Kernels #1, #3, #5, #6 and #7 against their plain versions past 256 tokens,
    where the bf16 kernels take their split variant: at the calls of the 512²
    serving pass (b2 x 16f) and train step (b1 x 16f), spatial S = 1024 and
    temporal S = 16 (the slab variant), counted on the 512² paths ("serving-512",
    "train-512"; #3 also on "train-512-sublayer", #5 on "serving-512-pallas", #7
    on "serving-512-sublayer" and "train-512-sublayer"), with the same gates as
    the flagship's (the same bits twice, a sequence whose keys are all masked,
    SDPA beside each); then at S = 257 and 576 at head_dim 64, and also at 1024
    at head_dim 128 (the flagship's width in 4 heads), masked, bf16 and f32,
    counted on no path; then #1, #5 and #7's split forward at its own cases
    (:func:`phase_split_fwd_kernels`: head dims 16 to 128, unmasked and masked, a
    "split-fwd" line each beside SDPA's forward and #7's chain); then #3 and #6's
    split backward at the same cases (:func:`phase_split_bwd_kernels`, a
    "split-bwd" line each beside SDPA's backward); then #2 and #4 at the 512²
    UNet's convs (bf16), counted on "serving-512" and "train-512"."""
    cfg = long_config()
    phase_attention_kernels(cfg, dev, rows, "serving-512", "train-512", masked_rows=True,
                            sublayer_train="train-512-sublayer")
    phase_flash_kernels(cfg, dev, rows, paths={"serving-512-pallas": "serving"})
    phase_sublayer_kernel(cfg, dev, rows, paths={"serving-512-sublayer": "serving", "train-512-sublayer": "train"})
    for model, seqs in ((cfg, LONG_SEQS), (long_config(num_heads=4), LONG_SEQS + (cfg.num_patches,))):
        cases = long_seq_cases(seqs)
        phase_attention_kernels(model, dev, rows, None, None, cases, masked_rows=True)
        phase_flash_kernels(model, dev, rows, cases, paths=False)
        phase_sublayer_kernel(model, dev, rows, cases, paths=False)
    phase_split_fwd_kernels(dev)
    phase_split_bwd_kernels(dev)
    phase_conv_kernels(cfg, dev, rows, "serving-512", "train-512", f32=False)


def phase_split_fwd_kernels(dev):
    """#1, #5 and #7's split forward (past 256 tokens: the wgmma launch at head dims
    64 and 128, mma.sync at 16 and 32) at ``utils/split_bwd_times.py:CASES``, each
    without a key mask and with one that keeps a prefix of each sequence (the first
    sequence none, so its rows average all S keys): each kernel against its plain
    version within ``KERNEL_TOL``, the same bits from two launches; one "split-fwd"
    line a case with the device ms a call of #1, #5 and #7 beside SDPA's forward on
    the same q, k and v and #7's chain (the yardsticks) and the bounds. Counted on
    no path and left out of the kernel record, as :func:`phase_split_bwd_kernels`."""
    from video_vae_tpu_torch.utils import split_fwd_times

    for line in split_fwd_times.lines(dev):
        log("split-fwd", json.dumps(line))


def phase_tile_bwd_kernels(dev):
    """#3's wgmma tile kernel (64 < S <= 256 at head dims 64 and 128) at
    ``utils/tile_bwd_times.py:CASES`` (the spatial calls of the flagship's, the
    trainer's and the 4-head model's steps, the MAE's S = 196, S = 65 at both
    head dims), each without a key mask and with one that keeps a prefix of each
    sequence (the first sequence none): against its plain version within
    ``KERNEL_TOL``, the sequence with no key too, the same bits from two launches;
    one "tile-bwd" line a case with its device ms beside SDPA's backward on the
    same q, k, v and dO (the yardstick) and the bound. Counted on no path and left
    out of the kernel record: the paths count and record #3 at
    ``phase_attention_kernels``' checks of their own calls."""
    from video_vae_tpu_torch.utils import tile_bwd_times

    for line in tile_bwd_times.lines(dev):
        log("tile-bwd", json.dumps(line))


def phase_split_bwd_kernels(dev):
    """#3 and #6's split backward (past 256 tokens: wgmma launches at head dims 64
    and 128, mma.sync at 16 and 32) at ``utils/split_bwd_times.py:CASES`` (the
    512² spatial calls at b2 and b1, S = 257 and 576, D = 128 at S = 1024, D = 16
    and 32 at S = 576), each without a key mask and with one that keeps a prefix
    of each sequence (the first sequence none): each kernel against its plain
    version within ``KERNEL_TOL``, the same bits from two launches; one
    "split-bwd" line a case with the device ms a call of #3 and #6 beside SDPA's
    backward on the same q, k, v and dO (the yardstick) and the bound. Counted
    on no path and left out of the kernel record: the 512² paths count and
    record these kernels at ``phase_attention_kernels``' and
    ``phase_flash_kernels``' checks."""
    from video_vae_tpu_torch.utils import split_bwd_times

    for line in split_bwd_times.lines(dev):
        log("split-bwd", json.dumps(line))


def phase_long(dev, launches):
    """The flagship at 512² through its entry points: the bf16 b2 x 16f serving pass
    on the fused path ("serving-512"), the sublayer path ("serving-512-sublayer")
    and the pallas path ("serving-512-pallas"), each held to the first; the bf16
    b1 x 16f train step (remat off) on the fused and the sublayer path
    ("train-512", "train-512-sublayer", the second held to the first's loss for the
    same draws); then the trainer on the config ``cli/train.py --synthetic --resize
    512`` builds ("trainer-512", the trainer phase's cut and checks). Every pass's
    and step's launches are held; ``launches`` takes those of each path."""
    cfg = long_config()
    launches["serving-512"], ref = phase_serving(cfg, dev, "fused", None, NEW_PATH_TIMED_FORWARDS, label="serving-512")
    for path in ("sublayer", "pallas"):
        launches[f"serving-512-{path}"], _ = phase_serving(cfg, dev, path, ref, NEW_PATH_TIMED_FORWARDS,
                                                           label=f"serving-512-{path}")
    del ref
    train = cfg.replace(remat=False)
    launches["train-512"], ref = phase_train(train, dev, "fused", None, NEW_PATH_TIMED_STEPS, label="train-512")
    launches["train-512-sublayer"], _ = phase_train(train, dev, "sublayer", ref, NEW_PATH_TIMED_STEPS,
                                                    label="train-512-sublayer")
    phase_trainer(dev, LONG_ARGS, "trainer-512")


def kernel_record(rows, launches_by_path):
    """One entry per kernel; times and bounds summed over the launches of its main
    path (the default train step, or the train step of the path that runs it),
    each launch at the time of its shape's kernel check.

    ``by_path`` holds the same sums for each path that runs the kernel (with
    the profiler's device ms, and by launch, where each of its rows has them);
    a path stands there only if every launch it made of the kernel was at a
    shape the kernel was held against its plain version at.
    """
    from video_vae_tpu_torch.ops import KERNELS

    out = []
    for kernel in KERNELS:
        mine = [r for r in rows if r["kernel"] == kernel.symbol]
        by_path = {}
        for path in PATHS:
            used = [r for r in mine if r["per_pass"].get(path)]
            if not used:
                continue

            def total(key, rs=used, path=path):
                return sum(r[key] * r["per_pass"][path] for r in rs)

            checked = sum(r["per_pass"][path] for r in used)
            if checked != launches_by_path[path][kernel.symbol]:
                raise AssertionError(
                    f"{kernel.symbol} on {path}: {launches_by_path[path][kernel.symbol]} launches, "
                    f"{checked} of them held against the plain version at their shape"
                )
            by_ops = total("bound_ms", [r for r in used if r["bound_by"] == "operations"])
            by_path[path] = {
                "launches": launches_by_path[path][kernel.symbol],
                **({"wgmma_launches": launches_by_path[path][WGRAD_WGMMA_VARIANT]}
                   if kernel.symbol == "vvt_conv3d_wgrad" and WGRAD_WGMMA_VARIANT in launches_by_path[path] else {}),
                **({"wgmma_tile_launches": launches_by_path[path][ATTN_BWD_WGMMA_TILE]}
                   if kernel.symbol == "vvt_fused_attention_bwd" and ATTN_BWD_WGMMA_TILE in launches_by_path[path]
                   else {}),
                **({"wide_launches": launches_by_path[path][ATTN_WIDE[kernel.symbol]]}
                   if ATTN_WIDE.get(kernel.symbol) in launches_by_path[path] else {}),
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                # the larger share of the summed bound
                "bound_by": "operations" if 2 * by_ops >= total("bound_ms") else "bytes",
                "library_ms": total("library_ms"),
            }
            for key in ("device_ms", "library_device_ms", "direct_device_ms"):  # profiler sums where each row has one
                if all(key in r for r in used):
                    by_path[path][key] = total(key)
            if all("launch_device_ms" in r for r in used):  # and by launch
                by_path[path]["launch_device_ms"] = {
                    label: sum(r["launch_device_ms"][label] * r["per_pass"][path] for r in used)
                    for label in used[0]["launch_device_ms"]
                }
        main = by_path[MAIN_PATH.get(kernel.symbol, "train")]
        out.append({
            "name": kernel.symbol, "route": "cuda",
            "source": f"video_vae_tpu_torch/csrc/{kernel.source}",
            "replaces": REPLACES[kernel.symbol], "launches": main["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "by_path": by_path,
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from video_vae_tpu_torch import ModelConfig
    from video_vae_tpu_torch.ops import KERNELS
    from video_vae_tpu_torch.ops._build import build

    warnings.filterwarnings("ignore", message="Perceptual loss is using RANDOM")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python", sys.version.split()[0])

    for source, messages in build([k.source for k in KERNELS]).items():
        for line in messages.splitlines():
            if "Used" in line or "spill" in line or "error" in line or "entry function" in line:
                log(f"nvcc {source}: {line.strip()}")

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = _timed(name, fn)
    cfg = ModelConfig()
    wide = tapdot_model_config()
    log("cuts", json.dumps({
        "flagship paths": f"none: full width and depth; {TIMED_FORWARDS} passes and {TIMED_STEPS} steps timed on "
                          "the default path; the float32 card-vs-CPU checks run at depth 1",
        "tap-dot path": f"{describe(wide)}: the transformer cut from depth {cfg.encoder_depth}/"
                        f"{cfg.decoder_depth} to 1/1, the UNet at full size; {TAPDOT_TIMED_FORWARDS} "
                        f"passes and {TAPDOT_TIMED_STEPS} steps timed",
        "trainer": f"the transformer cut from depth {cfg.encoder_depth}/{cfg.decoder_depth} to "
                   f"{TRAINER_DEPTH[0]}/{TRAINER_DEPTH[1]}, the width, UNet and VGG at full size; "
                   f"{TRAINER_CLIPS} synthetic clips, so one epoch of {TRAINER_STEPS} steps and an eval of "
                   f"{TRAINER_CLIPS // TRAINER_BATCH} batches",
        "tiny": "none: cli/train.py --synthetic --tiny --steps 5 as it stands (one epoch of 32 steps)",
        "train-small": "none of width or depth; one step timed 3 times",
        "train-h4": "none: the flagship's width and depth in 4 heads of 128; the float32 card-vs-CPU step at "
                    "depth 1",
        "serving-d96 / train-d96": f"the flagship's width with qkv_features={D96_QKV} (8 heads of 96, the "
                                   f"kernels padded to 128), the transformer cut from depth {cfg.encoder_depth}/"
                                   f"{cfg.decoder_depth} to {D96_DEPTH[0]}/{D96_DEPTH[1]}; {D96_TIMED_FORWARDS} "
                                   f"passes and {D96_TIMED_STEPS} steps timed; the float32 card-vs-CPU step at "
                                   "depth 1",
        "serving-d256 / train-d256": f"none: the flagship's width and depth in {D256_HEADS} heads of 256 (the "
                                     f"kernels' wide variant); {D256_TIMED_FORWARDS} passes and {D256_TIMED_STEPS} "
                                     "steps timed; the float32 card-vs-CPU step at depth 1",
        "cache-latents / decode-latents": f"none of width or depth; {LATENT_VIDEOS} synthetic clips",
        "dist-nccl": f"the trainer's config and cut, {TRAINER_CLIPS} clips on one rank, no eval, no dump",
        "dist-gloo-2": f"the trainer's config and cut; 2 ranks on one card (gloo); {TRAINER_CLIPS} clips a mesh, "
                       f"no eval, no profiled step; fsdp=2 and tensor=2 stop after {DIST_SHORT_STEPS} step (its "
                       "time holds the warm-up), without the video dump",
        "mae": f"none of width or depth: the flagship at {MAE_SIDE}² (BASELINE's video-MAE config), "
               f"b{MAE_CLIPS} x {MAE_FRAMES}f (BASELINE names no batch); {MAE_TIMED} runs timed; the float32 "
               "card-vs-CPU check at depth 1 + 1",
        "train-gan": f"none: the train step's model and batch with Discriminator() at its defaults; "
                     f"{NEW_PATH_TIMED_STEPS} steps timed; the float32 card-vs-CPU step at depth 1 with "
                     "Discriminator(base_features=8, num_levels=2)",
        "reference-import / slope-serving": f"none: the flagship at full width and depth, the serving batch; "
                                            f"{SLOPE_REPEATS} repeats of chains of {SLOPE_CHAINS} passes",
        "serving-512 / train-512": f"none of width or depth: the flagship at {LONG_SIDE}² (cli/train.py "
                                   f"--resize {LONG_SIDE}), the serving batch and the train step's, remat off; "
                                   f"{NEW_PATH_TIMED_FORWARDS} passes and {NEW_PATH_TIMED_STEPS} steps timed",
        "trainer-512": f"the trainer's: the transformer cut to {TRAINER_DEPTH[0]}/{TRAINER_DEPTH[1]} blocks, "
                       f"{TRAINER_CLIPS} synthetic clips; cli/train.py --synthetic {' '.join(LONG_ARGS)}",
    }))
    if [sum(d.values()) for d in tapdot_launches(wide)] != [4, 4]:
        raise AssertionError(f"the tap-dot model's gate counts changed: {tapdot_launches(wide)}")
    for entry in ("serving", "train"):  # head_dim 96 runs the flagship's launches, #3's wgmma tile included
        cut = cfg.replace(encoder_depth=D96_DEPTH[0], decoder_depth=D96_DEPTH[1])
        if expected_launches(d96_config(), entry, "fused") != expected_launches(cut, entry, "fused"):
            raise AssertionError(f"the d96 model's {entry} launches differ from the flagship's at its depth")
        # head_dim 256 runs the flagship's launches, every attention launch on the wide variant
        flagship, d256 = expected_launches(cfg, entry, "fused"), expected_launches(d256_config(), entry, "fused")
        on_wide = {ATTN_WIDE[k]: flagship[k] for k in ("vvt_fused_attention_fwd", "vvt_fused_attention_bwd")}
        if d256 != {**flagship, ATTN_BWD_WGMMA_TILE: 0, **on_wide}:
            raise AssertionError(f"the d256 model's {entry} launches {d256} are not the flagship's on the wide variant")
    rows = []
    started = time.monotonic()
    phase_attention_kernels(cfg, dev, rows)
    phase_flash_kernels(cfg, dev, rows)
    phase_sublayer_kernel(cfg, dev, rows)
    phase_mlp_kernel(cfg, dev, rows)
    phase_conv_kernels(cfg, dev, rows)
    phase_pooled_conv(cfg, dev, rows)
    # the tap-dot model's own shapes: its depth-1 transformer's attention, the tap-dot
    # kernel where the gate holds, the direct conv and the filter gradient everywhere else
    phase_attention_kernels(wide, dev, rows, "serving-tapdot", "train-tapdot")
    phase_tapdot_kernel(wide, dev, rows)
    phase_conv_kernels(wide, dev, rows, "serving-tapdot", "train-tapdot", tapdot=True)
    # the trainer's shapes: b2 x 32 frames with its first batch's padding, remat on
    phase_trainer_kernels(dev, rows)
    # the 2-rank data=2 run's local shapes: b1 x 32 frames a rank
    phase_dist_kernels(dev, rows)
    log("seconds", json.dumps({"kernel checks": time.monotonic() - started}))
    started = time.monotonic()
    # head_dim 16 and 32 (the tiny and small presets), tiny's UNet, the cf VGG's convs
    phase_head_dim_kernels(dev, rows)
    phase_vgg_conv_kernels(dev, rows)
    log("seconds", json.dumps({"head-dim and vgg kernel checks": time.monotonic() - started}))
    started = time.monotonic()
    # head_dim 128 (ModelConfig(num_heads=4)), and #1-#4 at b1 x 64 frames (the latent CLIs)
    phase_h4_kernels(dev, rows)
    phase_latent_kernels(cfg, dev, rows)
    log("seconds", json.dumps({"head-dim-128 and b1x64f kernel checks": time.monotonic() - started}))
    started = time.monotonic()
    # head dims the kernels pad: the d96 model's calls, and D = 8, 24, 48 and 96 up to S = 1024
    phase_d96_kernels(dev, rows)
    phase_padded_head_dim_kernels(dev, rows)
    log("seconds", json.dumps({"padded head-dim kernel checks": time.monotonic() - started}))
    started = time.monotonic()
    # head dims past 128 (the wide variant): the d256 model's calls, and D = 130-512 up to S = 1024
    phase_d256_kernels(dev, rows)
    phase_wide_head_dim_kernels(dev, rows)
    log("seconds", json.dumps({"wide head-dim kernel checks": time.monotonic() - started}))
    started = time.monotonic()
    # #3's wgmma tile kernel at the paths' tile shapes, S = 65 and 196, a sequence with no key
    phase_tile_bwd_kernels(dev)
    log("seconds", json.dumps({"tile-bwd-kernels": time.monotonic() - started}))
    started = time.monotonic()
    # past 256 tokens (the split variant): the flagship's calls at 512², S = 257 and 576, and
    # S = 1024 at head_dim 128; #2 and #4 at the 512² UNet
    phase_long_seq_kernels(dev, rows)
    log("seconds", json.dumps({"long-seq-kernels": time.monotonic() - started}))
    started = time.monotonic()
    launches = {}
    serving_ref = train_ref = None
    for path in FLAGSHIP_PATHS:
        phase_f32_forward(dev, path)
        launches[path_name("serving", path)], out = phase_serving(
            cfg, dev, path, serving_ref, TIMED_FORWARDS if path == "fused" else NEW_PATH_TIMED_FORWARDS
        )
        serving_ref = serving_ref or out
    launches["serving-sublayer-mlp"], _ = phase_serving(
        cfg, dev, "sublayer-mlp", serving_ref, NEW_PATH_TIMED_FORWARDS
    )
    _, wide_ref = phase_serving(wide, dev, "tapdot-off", None, TAPDOT_TIMED_FORWARDS, redraw_final_conv=True)
    launches["serving-tapdot"], _ = phase_serving(
        wide, dev, "tapdot", wide_ref, TAPDOT_TIMED_FORWARDS, redraw_final_conv=True
    )
    del serving_ref, wide_ref
    log("seconds", json.dumps({"serving paths": time.monotonic() - started}))
    started = time.monotonic()
    phase_f32_train(dev)
    phase_f32_modes(dev)
    for path in FLAGSHIP_PATHS:
        launches[path_name("train", path)], ref = phase_train(
            cfg.replace(remat=False), dev, path, train_ref,
            TIMED_STEPS if path == "fused" else NEW_PATH_TIMED_STEPS,
        )
        train_ref = train_ref or ref
    phase_train_vgg_cf(cfg, dev, train_ref)
    _, wide_ref = phase_train(
        wide.replace(remat=False), dev, "tapdot-off", None, TAPDOT_TIMED_STEPS, redraw_final_conv=True
    )
    launches["train-tapdot"], _ = phase_train(
        wide.replace(remat=False), dev, "tapdot", wide_ref, TAPDOT_TIMED_STEPS, redraw_final_conv=True
    )
    log("seconds", json.dumps({"train paths": time.monotonic() - started}))
    started = time.monotonic()
    launches["train-h4"], _ = phase_train(h4_config().replace(remat=False), dev, "fused", None, NEW_PATH_TIMED_STEPS,
                                          label="train-h4")
    phase_f32_train(dev, h4=True)
    log("seconds", json.dumps({"head_dim 128 steps": time.monotonic() - started}))
    started = time.monotonic()
    launches["serving-d96"], _ = phase_serving(d96_config(), dev, "fused", None, D96_TIMED_FORWARDS,
                                               label="serving-d96")
    launches["train-d96"], _ = phase_train(d96_config().replace(remat=False), dev, "fused", None,
                                           D96_TIMED_STEPS, label="train-d96")
    phase_f32_train(dev, d96=True)
    log("seconds", json.dumps({"head_dim 96 paths": time.monotonic() - started}))
    started = time.monotonic()
    launches["serving-d256"], _ = phase_serving(d256_config(), dev, "fused", None, D256_TIMED_FORWARDS,
                                                label="serving-d256")
    launches["train-d256"], _ = phase_train(d256_config().replace(remat=False), dev, "fused", None,
                                            D256_TIMED_STEPS, label="train-d256")
    phase_f32_train(dev, d256=True)
    log("seconds", json.dumps({"head_dim 256 paths": time.monotonic() - started}))
    started = time.monotonic()
    launches["trainer"], trainer = phase_trainer(dev)
    log("seconds", json.dumps({"trainer": time.monotonic() - started}))
    started = time.monotonic()
    phase_dist_nccl(trainer)
    launches["dist-gloo-2"] = phase_dist_gloo(trainer)
    log("seconds", json.dumps({"dist-nccl and dist-gloo-2": time.monotonic() - started}))
    started = time.monotonic()
    launches["tiny"] = phase_tiny(dev)
    phase_f32_train(dev, tiny=True)
    phase_train_small(dev)
    log("seconds", json.dumps({"tiny and small": time.monotonic() - started}))
    started = time.monotonic()
    launches.update(phase_latent_clis(dev))
    log("seconds", json.dumps({"latent CLIs": time.monotonic() - started}))
    started = time.monotonic()
    # the VideoMAE at 224² (S = 196): #1 and #3 at its calls, its step and eval forward, f32 card vs CPU
    phase_mae_kernels(dev, rows)
    launches["mae"], launches["mae-eval"] = phase_mae(dev)
    phase_f32_mae(dev)
    log("seconds", json.dumps({"mae-kernels and mae": time.monotonic() - started}))
    started = time.monotonic()
    # the GAN step: the train step's launches, the discriminator on cuDNN; f32 card vs CPU
    phase_train_gan(dev, launches["train"])
    phase_f32_gan(dev)
    log("seconds", json.dumps({"train-gan": time.monotonic() - started}))
    started = time.monotonic()
    # the reference-checkpoint import and the slope timer on the flagship's serving pass
    phase_reference_import(cfg, dev)
    phase_slope_serving(cfg, dev)
    log("seconds", json.dumps({"reference-import and slope-serving": time.monotonic() - started}))
    started = time.monotonic()
    # the flagship at 512² (spatial S = 1024) through its entry points
    phase_long(dev, launches)
    log("seconds", json.dumps({"serving-512, train-512 and trainer-512": time.monotonic() - started}))
    log("phase-seconds", json.dumps(PHASE_SECONDS))
    log(json.dumps(kernel_record(rows, launches)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--four-cards"]:
        sys.exit(four_cards(sys.argv[2:]))
    sys.exit(main())
