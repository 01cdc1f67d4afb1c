"""Hold and time the fused attention backward's tile variant (#3 at 64 < S <= 256).

    python3 video_vae_tpu_torch/utils/tile_bwd_times.py <package root> [label] [--paths]

imports ``video_vae_tpu_torch`` and ``chip_smoke`` from ``<package root>`` (the
root of a checkout of this commit or of another, e.g. an unpacked ``git
archive`` of the parent), builds #3 (``csrc/fused_attention_bwd.cu``), prints
the wgmma tile kernel's registers and spills where the root has it, and one
``tile-bwd`` JSON line a case of :func:`lines`. Run it by path, so that the
package comes from the root given; compare two roots only in turns in one call
on one card (a, b, b, a). ``chip_smoke.py`` prints the same lines for its own
tree ("tile-bwd-kernels"). With ``--paths`` it runs instead the root's own
``chip_smoke.py`` phases of the steps whose backward makes these calls
(:func:`paths`), which print each step's device ms and launches.
"""

from __future__ import annotations

import json
import sys

# (label, B, S, H, D), bf16: B x H (sequence, head) pairs of S tokens at head dim D. The
# spatial calls (S = 256, 16 x 16 patches) of the flagship's train step (b1 x 16 frames,
# its decoder's 2 rollouts b2), of the trainer's (b2 x 32 frames, rollouts b4) and of the
# same step in 4 heads of 128; the VideoMAE's at 224² (S = 196, b4 x 16 frames); one
# token past the slab variant at both head dims
CASES = (
    ("flagship b1x16f", 16, 256, 8, 64), ("flagship b2x16f", 32, 256, 8, 64),
    ("trainer b2x32f", 64, 256, 8, 64), ("trainer b4x32f", 128, 256, 8, 64),
    ("h4 b1x16f", 16, 256, 4, 128), ("h4 b2x16f", 32, 256, 4, 128),
    ("mae b4x16f", 64, 196, 8, 64),
    ("S=65", 16, 65, 8, 64), ("S=65 D=128", 16, 65, 4, 128),
)


def lines(dev, cases=CASES):
    """One dict a case of ``cases``, each without a key mask and with one that
    keeps a prefix of each sequence (the first sequence none, the last all):
    #3 held to its plain version within ``chip_smoke.KERNEL_TOL`` (the sequence
    with no key too) and to its own bits on a second launch, then the device ms
    a call (``chip_smoke.device_ms``), SDPA's backward on the same q, k, v and
    dO (the yardstick; the port never calls it) and the bound (5 products of S x
    kept keys x D a pair at the bf16 peak, or its bytes)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from video_vae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(25)
    for label, B, S, H, D in cases:
        for masked in (False, True):
            qkv = torch.randn(B, S, 3 * H * D, generator=gen).to(dev, torch.bfloat16)
            g = torch.randn(B, S, H * D, generator=gen).to(dev, torch.bfloat16)
            qs, ks = ((1 + 0.2 * torch.randn(D, generator=gen)).to(dev) for _ in range(2))
            mask, keys = None, B * S
            if masked:
                lengths = torch.randint(1, S + 1, (B,), generator=gen)
                lengths[0], lengths[-1] = 0, S
                mask = (torch.arange(S)[None, :] < lengths[:, None]).to(dev)
                keys = int(mask.sum())
            case = f"{label}{' masked' if masked else ''}"
            run = lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)  # noqa: E731
            got, again = run(), run()
            torch.cuda.synchronize()
            ref = fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H)
            err = max(chip_smoke.check_close(f"{case} {i}", a, b, "bfloat16") for i, (a, b) in enumerate(zip(got, ref)))
            if masked:  # the sequence with no key spreads P over all S keys
                err = max(err, chip_smoke.check_close(f"{case} the masked sequence", got[0][0], ref[0][0], "bfloat16"))
            if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits twice
                raise AssertionError(f"{case}: two launches gave different bits")
            q, k, v = (t.reshape(B, S, H, D).transpose(1, 2).contiguous() for t in qkv.split(H * D, -1))
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=None if mask is None else mask[:, None, None, :])
            g_heads = g.reshape(B, S, H, D).transpose(1, 2).contiguous()
            flops = 10.0 * H * S * keys * D  # the scores, dv, dP, dq, dk over the kept keys
            bound = chip_smoke.bound_ms(chip_smoke.nbytes(qkv, g, mask) + chip_smoke.nbytes(*got), flops, "bfloat16")
            ms = chip_smoke.device_ms(run, 10)
            sdpa = chip_smoke.device_ms(lambda: torch.autograd.grad(o, leaves, g_heads, retain_graph=True), 10)
            yield {"case": case, "B": B, "S": S, "H": H, "D": D, "plan": list(fa.fused_attention_bwd_plan(B, S, H, D)),
                   "fused_bwd_device_ms": ms, "sdpa_bwd_device_ms": sdpa, "fused_bwd_vs_sdpa": ms / sdpa,
                   "fused_bwd_bound_ms": bound[0], "fused_bwd_bound_by": bound[1], "fused_bwd_max_abs_err": err,
                   "fused_bwd_tflops": flops / ms / 1e9}
            del qkv, g, got, again, ref, q, k, v, leaves, o, g_heads
    torch.cuda.empty_cache()


def paths(dev) -> None:
    """The root's ``chip_smoke.py`` phases, end to end: the flagship's serving pass
    (no backward), its bf16 b1 x 16f train step on the fused and the sublayer path
    (21 of #3's 42 launches on its spatial calls), the 4-head model's ("train-h4",
    head dim 128), the VideoMAE's gradient step and eval forward ("mae", S = 196)
    and the trainer (b2 x 32f at 3/3 blocks), each with its own checks, launch
    counts and device ms (``torch.profiler``)."""
    import torch

    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig()
    chip_smoke.phase_serving(cfg, dev, "fused", None, chip_smoke.NEW_PATH_TIMED_FORWARDS)
    train = cfg.replace(remat=False)
    _, ref = chip_smoke.phase_train(train, dev, "fused", None, chip_smoke.NEW_PATH_TIMED_STEPS)
    chip_smoke.phase_train(train, dev, "sublayer", ref, chip_smoke.NEW_PATH_TIMED_STEPS)
    chip_smoke.phase_train(chip_smoke.h4_config().replace(remat=False), dev, "fused", None,
                           chip_smoke.NEW_PATH_TIMED_STEPS, label="train-h4")
    chip_smoke.phase_mae(dev)
    chip_smoke.phase_trainer(dev)


def main(root: str, label: str, end_to_end: bool = False) -> None:
    sys.path.insert(0, root)
    import warnings

    import torch

    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available():
        raise SystemExit("tile_bwd_times needs a CUDA card")
    if end_to_end:
        warnings.filterwarnings("ignore", message="Perceptual loss is using RANDOM")
        paths(torch.device("cuda"))
        return
    for source, log in build(("fused_attention_bwd.cu",)).items():
        log_lines = log.splitlines()
        for i, line in enumerate(log_lines):  # the wgmma tile kernel's registers and spills
            if "Compiling entry function" in line and "tile_wg" in line:
                print(f"ptxas {source}:", " | ".join(x.strip() for x in log_lines[i:i + 4]), flush=True)
            elif "wgmma" in line and "tile_wg" in line:  # e.g. wgmma serialised by the compiler
                print(f"ptxas {source}: {line.strip()}", flush=True)
    for line in lines(torch.device("cuda")):
        print("tile-bwd", json.dumps({"root": label, **line}), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--paths"]
    if len(args) not in (1, 2):
        sys.exit(__doc__)
    main(args[0], args[1] if len(args) == 2 else args[0], "--paths" in sys.argv[1:])
