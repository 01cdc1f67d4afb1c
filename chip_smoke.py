#!/usr/bin/env python3
"""Drive the PyTorch port's serving pass and train step on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds the port's four CUDA kernels from ``video_vae_tpu_torch/csrc``, then:

1. holds each kernel against its plain PyTorch version on the card, at every
   shape the flagship serving pass and train step give it (the attention
   forward and backward, the conv forward, its input gradient through the
   same kernel, and the filter gradient), and times the kernel, the plain
   version and one library call for the same function;
2. runs the serving pass (encode → keep/drop → fill-blend → decode) at the
   flagship width and reduced depth in float32 on the card and on the CPU,
   with the same seeded weights, and compares the two;
3. runs the full-depth flagship serving pass in bfloat16 on a batch of
   2 clips × 16 frames, checks the output, counts the kernels' launches in
   one pass, times the pass, then traces three passes with
   ``torch.profiler`` and prints device time per launching torch op (and
   per kernel for the port's own) and the device's idle share;
4. runs one float32 train step (RL forward, the full objective with the VGG
   perceptual loss, backward) at the flagship width and depth 1 on the card
   and on the CPU with the same weights and random draws, and compares the
   loss, every metric and every parameter's gradient;
5. runs the full-depth flagship train step in bfloat16 on 1 clip × 16
   frames (remat off): counts every kernel's launches in one step, checks
   the loss, the gradient norm and the update, times 10 steps, checks that a
   remat-on step gives the same loss and gradients, and profiles one step.

Every failure ends the script with a non-zero exit and no result line. The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it holds the per-kernel record (times in ms on this card, summed over
one train step's launches; the serving pass's sums under ``by_path``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
# keep decisions are compared only where no probability sits near its uniform
MIN_MARGIN = 0.02
# published H100 SXM peaks the bounds are taken against
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BATCH, FRAMES = 2, 16  # the serving batch; the train step's decoder runs 2 rollouts of 1 clip
TRAIN_BATCH = 1
TIMED_FORWARDS = 10
TIMED_STEPS, WARMUP_STEPS = 10, 3
REPLACES = {
    "vvt_fused_attention_fwd": "video_vae_tpu/ops/flash_attention.py:425",
    "vvt_conv3d_cf": "video_vae_tpu/ops/conv3d.py:178",
    "vvt_fused_attention_bwd": "video_vae_tpu/ops/flash_attention.py:724",
    "vvt_conv3d_wgrad": "video_vae_tpu/ops/conv3d.py:873",
}
PATHS = ("train", "serving")


def log(*parts):
    print(*parts, flush=True)


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


def _record(rows, kernel, case, shape, dtype, err, ms, plain_ms, library_ms, library, bound, per):
    rows.append(dict(
        kernel=kernel.symbol, case=case, shape=shape, dtype=dtype, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, library=library, bound_ms=bound[0],
        bound_by=bound[1], per_pass=per if dtype == "bfloat16" else {},
    ))
    log("kernel-check", json.dumps(rows[-1]))


def phase_attention_kernels(cfg, dev, rows):
    """Attention forward and backward kernels against their plain versions."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    H, D = cfg.num_heads, cfg.head_dim
    for name, B, S, padded, dtype, per in attention_cases(cfg):
        tdt = getattr(torch, dtype)
        qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(dev, tdt)
        g = torch.randn(B, S, H * D, generator=gen).to(dev, tdt)
        qs = (1 + 0.2 * torch.randn(D, generator=gen)).to(dev)
        ks = (1 + 0.2 * torch.randn(D, generator=gen)).to(dev)
        mask = None
        if name.startswith("temporal"):  # the frame mask, expanded over the patches
            clips = B // cfg.num_patches
            frames = torch.ones(clips, S, dtype=torch.bool)
            if padded:
                frames[-1, S - 3:] = False
            mask = frames[:, None, :].expand(clips, B // clips, S).reshape(B, S).to(dev)
        keys = B * S if mask is None else int(mask.sum())  # the keys this run's mask leaves in
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2).contiguous() for t in qkv.split(H * D, -1))
        amask = None if mask is None else mask[:, None, None, :]

        out = fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
        torch.cuda.synchronize()
        err = check_close(f"attention {name} {dtype}", out, fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H), dtype)
        _record(
            rows, fa.FUSED_ATTENTION, f"{name} {dtype}", [B, S, 3 * H * D], dtype, err,
            time_ms(lambda: fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H), 20),
            time_ms(lambda: fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H), 5),
            time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask), 20),
            "scaled_dot_product_attention, core only",
            bound_ms(nbytes(qkv, out, mask), 4.0 * H * S * keys * D, dtype), per,
        )

        got = fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
        torch.cuda.synchronize()
        ref = fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
        err = max(check_close(f"attention bwd {name} {dtype} {part}", a, b, dtype)
                  for part, a, b in zip(("dqkv", "dq_scale", "dk_scale"), got, ref))
        del ref
        # library yardstick: SDPA's backward on already normalised, rotated q/k
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=amask)
        g_heads = g.reshape(B, S, H, D).transpose(1, 2).contiguous()
        # recompute of the scores, dv, dP, dq, dk over the kept keys
        bwd_flops = 10.0 * H * S * keys * D
        _record(
            rows, fa.FUSED_ATTENTION_BWD, f"{name} {dtype}", [B, S, 3 * H * D], dtype, err,
            time_ms(lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H), 10),
            time_ms(lambda: fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H), 3),
            time_ms(lambda: torch.autograd.grad(o, leaves, g_heads, retain_graph=True), 10),
            "scaled_dot_product_attention backward, core only",
            bound_ms(nbytes(qkv, g, mask) + nbytes(*got), bwd_flops, dtype),
            {"train": per["train"]} if per else {},
        )
        del qkv, g, out, got, q, k, v, leaves, o, g_heads
    torch.cuda.empty_cache()


def phase_conv_kernels(cfg, dev, rows):
    """Conv forward, input gradient (same kernel) and filter gradient against plain."""
    import torch
    import torch.nn.functional as F

    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(1)
    for name, h, w, cins, cout, k, dtype in conv_cases(cfg):
        tdt = getattr(torch, dtype)
        cin = sum(cins)
        xs = [torch.randn(BATCH, FRAMES, c, h, w, generator=gen).to(dev, tdt) for c in cins]
        x2 = xs[1] if len(xs) == 2 else None
        kernel = (torch.randn(*k, cin, cout, generator=gen) / (cin * k[0] * k[1] * k[2]) ** 0.5).to(dev, tdt)
        bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
        g = torch.randn(BATCH, FRAMES, cout, h, w, generator=gen).to(dev, tdt)
        pad = (k[0] // 2, k[1] // 2, k[2] // 2)
        # only the taps that land inside the clip and the frame: SAME padding adds zeros
        flops = 2.0 * BATCH * cout * cin * valid_taps(FRAMES, k[0]) * valid_taps(h, k[1]) * valid_taps(w, k[2])
        x_ncdhw = torch.cat(xs, dim=2).transpose(1, 2).contiguous()
        g_ncdhw = g.transpose(1, 2).contiguous()
        w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()

        out = conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias)
        torch.cuda.synchronize()
        err = check_close(f"conv {name}", out, conv3d.conv3d_cf_plain(xs[0], x2, kernel, bias), dtype)
        lib_bias = bias.to(tdt)
        _record(
            rows, conv3d.CONV3D, name, [BATCH, FRAMES, list(cins), h, w, cout, list(k)], dtype, err,
            time_ms(lambda: conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias), 5),
            time_ms(lambda: conv3d.conv3d_cf_plain(xs[0], x2, kernel, bias), 1, warmup=0),
            time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), 5),
            "torch.nn.functional.conv3d (cuDNN), concatenated input",
            bound_ms(nbytes(*xs, kernel, bias, out), flops, dtype), {"serving": 1, "train": 1},
        )
        del out

        # input gradient: the forward kernel on g with the flipped, IO-swapped kernel
        flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
        zero = torch.zeros(cin, dtype=torch.float32, device=dev)
        dx = conv3d.conv3d_cf_cuda(g, None, flipped, zero)
        torch.cuda.synchronize()
        err = check_close(f"conv dgrad {name}", dx, conv3d.conv3d_cf_plain(g, None, flipped, zero), dtype)
        w_flip = flipped.permute(4, 3, 0, 1, 2).contiguous()
        _record(
            rows, conv3d.CONV3D, f"{name} dgrad", [BATCH, FRAMES, cout, h, w, cin, list(k)], dtype, err,
            time_ms(lambda: conv3d.conv3d_cf_cuda(g, None, flipped, zero), 5),
            time_ms(lambda: conv3d.conv3d_cf_plain(g, None, flipped, zero), 1, warmup=0),
            time_ms(lambda: F.conv3d(g_ncdhw, w_flip, padding=pad), 5),
            "torch.nn.functional.conv3d (cuDNN) of g, flipped kernel",
            bound_ms(nbytes(g, flipped, dx), flops, dtype), {"train": 1},
        )
        del dx

        dw = conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k)
        torch.cuda.synchronize()
        err = check_close(f"conv wgrad {name}", dw, conv3d.conv3d_wgrad_plain(xs[0], x2, g, *k), "float32")
        w_shape = (cout, cin, *k)
        _record(
            rows, conv3d.CONV3D_WGRAD, name, [BATCH, FRAMES, list(cins), h, w, cout, list(k)], dtype, err,
            time_ms(lambda: conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k), 5),
            time_ms(lambda: conv3d.conv3d_wgrad_plain(xs[0], x2, g, *k), 1, warmup=0),
            time_ms(lambda: torch.nn.grad.conv3d_weight(x_ncdhw, w_shape, g_ncdhw, padding=pad), 5),
            "torch.nn.grad.conv3d_weight (cuDNN), concatenated input",
            bound_ms(nbytes(*xs, g, dw), flops, dtype), {"train": 1},
        )
        del xs, x2, g, dw, x_ncdhw, g_ncdhw, flipped
    torch.cuda.empty_cache()


def phase_f32_forward(dev):
    """Flagship width, depth 1: the float32 serving pass on the card against the CPU."""
    import torch

    from video_vae_tpu_torch import ModelConfig, VideoVAE, reconstruct

    cfg = ModelConfig(dtype="float32", encoder_depth=1, decoder_depth=1)
    cpu_model = VideoVAE(cfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # the zero-initialised final conv would hide the whole UNet
        fc = cpu_model.decoder.unet.final_conv.kernel
        fc.copy_(torch.randn(fc.shape, generator=gen) / fc.shape[-2] ** 0.5)
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
    if not rel <= FORWARD_F32_TOL:
        raise AssertionError(f"f32 forward card vs CPU: relative max-abs error {rel} > {FORWARD_F32_TOL}")
    log("f32-forward", json.dumps({
        "config": "flagship width, encoder/decoder depth 1, b1 x 8 frames (2 padded)",
        "rel_max_abs_err": rel, "tol": FORWARD_F32_TOL, "kept_frames": int(keep_cpu.sum()),
    }))


def reset_launches():
    from video_vae_tpu_torch.ops import KERNELS

    for kernel in KERNELS:
        kernel.launches = 0


def read_launches() -> dict:
    from video_vae_tpu_torch.ops import KERNELS

    return {kernel.symbol: kernel.launches for kernel in KERNELS}


def phase_serving(cfg, dev):
    """Full-depth bf16 serving pass: launch counts of one pass, its time, its profile."""
    import torch

    from video_vae_tpu_torch import VideoVAE, reconstruct

    model = VideoVAE(cfg, device=dev, seed=0)
    gen = torch.Generator().manual_seed(3)
    video = torch.rand(BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(BATCH, FRAMES, device=dev)
    mask[1, FRAMES - 3:] = 0

    reset_launches()
    out = reconstruct(model, video, mask, device=dev)
    torch.cuda.synchronize()
    launches = read_launches()

    want = (BATCH, FRAMES, cfg.height, cfg.width, cfg.channels)
    if tuple(out.shape) != want or not torch.isfinite(out.float()).all():
        raise AssertionError(f"serving pass: shape {tuple(out.shape)} (want {want}) or non-finite")
    expected = {  # two attention calls per block; the mixer, 2 per down/up block, 2 bottleneck
        "vvt_fused_attention_fwd": 2 * (cfg.encoder_depth + cfg.decoder_depth),
        "vvt_conv3d_cf": 1 + 4 * cfg.unet_levels + 2,
        "vvt_fused_attention_bwd": 0,
        "vvt_conv3d_wgrad": 0,
    }
    if launches != expected:
        raise AssertionError(f"launches per serving pass {launches}, expected {expected}")

    for _ in range(2):
        reconstruct(model, video, mask, device=dev)
    times = []
    for _ in range(TIMED_FORWARDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        reconstruct(model, video, mask, device=dev)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    log("serving", json.dumps({
        "config": f"flagship, bf16, b{BATCH} x {FRAMES} frames", "launches": launches,
        "ms_per_forward_median": ms, "clips_per_s": BATCH / (ms / 1e3),
        "ms_per_forward_all": times,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }))
    profile_device("serving", lambda: reconstruct(model, video, mask, device=dev), ms)
    del model
    torch.cuda.empty_cache()
    return launches


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


def _draws(model, video, mask, seed):
    """Latent noise and Bernoulli uniforms from ``seed``, with no near-tie keep decision."""
    import torch

    with torch.no_grad():
        mean, _, prob = model.encode(video, mask)
    p = prob.float().repeat_interleave(2, dim=0)[..., None]
    for s in range(seed, seed + 100):
        gen = torch.Generator().manual_seed(s)
        noise = torch.randn(mean.shape, generator=gen)
        uniforms = torch.rand(p.shape, generator=gen)
        if (uniforms - p.cpu()).abs().min() > MIN_MARGIN:
            return noise, uniforms
    raise AssertionError("no draw without a near-tie keep decision")


def phase_f32_train(dev):
    """Flagship width, depth 1, b1 x 4 frames: one f32 train step, card against CPU."""
    import torch

    from video_vae_tpu_torch import DynamicHParams, LossConfig, ModelConfig, VideoVAE
    from video_vae_tpu_torch.losses import make_perceptual_loss_fn
    from video_vae_tpu_torch.models.vgg import load_vgg
    from video_vae_tpu_torch.train.step import loss_and_grads

    cfg = ModelConfig(dtype="float32", encoder_depth=1, decoder_depth=1, remat=False)
    loss_cfg, hp = LossConfig(), DynamicHParams.default()
    cpu_model = VideoVAE(cfg, device="cpu", seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # the zero-initialised final conv would cut the UNet's gradients
        fc = cpu_model.decoder.unet.final_conv.kernel
        fc.copy_(torch.randn(fc.shape, generator=gen) / fc.shape[-2] ** 0.5)
    gpu_model = VideoVAE(cfg, device=dev, seed=4)
    gpu_model.load_state_dict(cpu_model.state_dict())
    video = torch.rand(1, 4, cfg.height, cfg.width, cfg.channels, generator=gen)
    mask = torch.ones(1, 4)
    mask[0, 3:] = 0
    noise, uniforms = _draws(cpu_model, video, mask, seed=6)

    results = {}
    for name, model, device in (("cpu", cpu_model, "cpu"), ("gpu", gpu_model, dev)):
        vgg = load_vgg(None, device=device)
        loss, metrics, grads = loss_and_grads(
            model, video.to(device), mask.to(device), hp, loss_cfg, make_perceptual_loss_fn(vgg),
            noise=noise.to(device), uniforms=uniforms.to(device),
        )
        results[name] = ({k: float(v.detach()) for k, v in metrics.items()}, [g.cpu() for g in grads])
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results["gpu"]
    errs = {}
    for key, ref in m_cpu.items():
        tol = PERCEPTUAL_F32_TOL if key == "perceptual_loss" else TRAIN_F32_TOL
        scale = 1.0 if key == "rl_loss" else abs(ref)  # rl_loss is 0 up to rounding
        errs[key] = abs(m_gpu[key] - ref) / scale if scale else abs(m_gpu[key] - ref)
        if not abs(m_gpu[key] - ref) <= tol * scale:
            raise AssertionError(f"f32 train step {key}: card {m_gpu[key]} vs CPU {ref}")
    worst = (0.0, "")
    for (name, _), a, b in zip(cpu_model.named_parameters(), g_gpu, g_cpu):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        if not (a - b).abs().max() <= GRAD_F32_TOL * b.abs().max():
            raise AssertionError(f"f32 train step gradient {name}: relative error {rel} > {GRAD_F32_TOL}")
        worst = max(worst, (rel, name))
    log("f32-train", json.dumps({
        "config": "flagship width, encoder/decoder depth 1, b1 x 4 frames (1 padded), perceptual on",
        "metrics_cpu": m_cpu, "metric_rel_err": errs, "worst_grad_rel_err": worst[0],
        "worst_grad_leaf": worst[1], "leaves": len(g_cpu),
        "tols": [TRAIN_F32_TOL, PERCEPTUAL_F32_TOL, GRAD_F32_TOL],
    }))
    del cpu_model, gpu_model
    torch.cuda.empty_cache()


def _set_remat(model, on: bool):
    for module in model.modules():
        if hasattr(module, "remat"):
            module.remat = on


def phase_train(cfg, dev):
    """Full-depth bf16 b1 x 16f train step: launches, checks, time, remat, profile."""
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

    model = VideoVAE(cfg, device=dev, seed=0)
    opt = create_optimizer(model, OptimConfig())
    loss_cfg, hp = LossConfig(), DynamicHParams.default()
    perceptual = build_perceptual(loss_cfg, device=dev)
    gen = torch.Generator().manual_seed(8)
    video = torch.rand(TRAIN_BATCH, FRAMES, cfg.height, cfg.width, cfg.channels, generator=gen).to(dev)
    mask = torch.ones(TRAIN_BATCH, FRAMES, device=dev)
    draws = torch.Generator(device=dev).manual_seed(9)

    def step():
        return train_step(model, opt, video, mask, hp, loss_cfg, perceptual, generator=draws)

    initial = [p.detach().clone() for p in model.parameters()]
    reset_launches()
    first = step()
    torch.cuda.synchronize()
    launches = read_launches()
    expected = {
        "vvt_fused_attention_fwd": 2 * (cfg.encoder_depth + cfg.decoder_depth),
        "vvt_fused_attention_bwd": 2 * (cfg.encoder_depth + cfg.decoder_depth),
        "vvt_conv3d_cf": 2 * (1 + 4 * cfg.unet_levels + 2),  # forward and input gradient
        "vvt_conv3d_wgrad": 1 + 4 * cfg.unet_levels + 2,
    }
    if launches != expected:
        raise AssertionError(f"launches per train step {launches}, expected {expected}")
    metrics = {k: float(v) for k, v in first.items()}
    if not all(map(lambda v: v == v and abs(v) != float("inf"), metrics.values())):
        raise AssertionError(f"train step: non-finite metrics {metrics}")
    if not metrics["grad_norm"] > 0:
        raise AssertionError(f"train step: grad_norm {metrics['grad_norm']}")
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
    for _ in range(TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    log("train", json.dumps({
        "config": f"flagship, bf16 compute, f32 params, b{TRAIN_BATCH} x {FRAMES} frames, "
                  "rl (2 rollouts), perceptual on, remat off",
        "launches": launches, "ms_per_step_median": ms, "ms_per_step_all": times,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "step1_metrics": metrics, "step2_metrics": second, "leaves_changed_by_step2": changed,
        "leaves": len(list(model.parameters())),
    }))

    # remat on and off: the same loss and gradients for the same draws
    video_c, mask_c = video.to(cfg.compute_dtype()), mask
    noise = torch.randn((TRAIN_BATCH, FRAMES, cfg.num_patches, cfg.latent_dim), generator=gen)
    uniforms = torch.rand((2 * TRAIN_BATCH, FRAMES, 1, 1), generator=gen)
    outs = []
    torch.backends.cudnn.deterministic = True  # the VGG's cuDNN algorithms, run to run
    for on in (False, True):
        _set_remat(model, on)
        loss, _, grads = loss_and_grads(model, video_c, mask_c, hp, loss_cfg, perceptual,
                                        noise=noise.to(dev), uniforms=uniforms.to(dev))
        outs.append((float(loss.detach()), grads))
    _set_remat(model, False)
    torch.backends.cudnn.deterministic = False
    (l0, g0), (l1, g1) = outs
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(g1, g0))
    if not (abs(l0 - l1) <= 1e-6 * abs(l0) and worst <= 1e-5):
        raise AssertionError(f"remat on vs off: loss {l1} vs {l0}, worst gradient error {worst}")
    log("train-remat", json.dumps({"loss_remat_off": l0, "loss_remat_on": l1, "worst_grad_rel_err": worst}))
    del outs, g0, g1

    profile_device("train", step, ms, passes=2)
    return launches


def kernel_record(rows, launches_by_path):
    """One entry per kernel; times and bounds summed over one train step.

    ``by_path`` holds the same sums for each path that runs the kernel.
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

            by_ops = total("bound_ms", [r for r in used if r["bound_by"] == "operations"])
            by_path[path] = {
                "launches": launches_by_path[path][kernel.symbol],
                "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                # the larger share of the summed bound
                "bound_by": "operations" if 2 * by_ops >= total("bound_ms") else "bytes",
                "library_ms": total("library_ms"),
            }
        main = by_path["train"]
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
            if "Used" in line or "spill" in line or "error" in line:
                log(f"nvcc {source}: {line.strip()}")

    cfg = ModelConfig()
    rows = []
    phase_attention_kernels(cfg, dev, rows)
    phase_conv_kernels(cfg, dev, rows)
    phase_f32_forward(dev)
    serving = phase_serving(cfg, dev)
    phase_f32_train(dev)
    train = phase_train(cfg.replace(remat=False), dev)
    log(json.dumps(kernel_record(rows, {"serving": serving, "train": train})))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
