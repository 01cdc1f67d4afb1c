"""Hold and time the split attention backward (#3 and #6 past 256 tokens).

    python3 video_vae_tpu_torch/utils/split_bwd_times.py <package root> [label]

imports ``video_vae_tpu_torch`` and ``chip_smoke`` from ``<package root>`` (the
root of a checkout of this commit or of another, e.g. an unpacked ``git
archive`` of the parent), builds #3 (``csrc/fused_attention_bwd.cu``) and #6
(``csrc/flash_attention_bwd.cu``), prints the wgmma launches' registers and
spills, and one ``split-bwd`` JSON line a case of :func:`lines`. Run it by
path, so that the package comes from the root given; compare two roots only
in turns in one call on one card (a, b, b, a). ``chip_smoke.py`` prints the
same lines for its own tree ("long-seq-kernels").
"""

from __future__ import annotations

import json
import sys

# (label, B, S, H, D), bf16: B x H (sequence, head) pairs of S tokens at head dim D. The
# 512² spatial calls (the serving pass's b2 and the train step's b1 x 16 frames), one key
# past the tile variant, a ragged length (24² patches), the flagship's width in 4 heads of
# 128, and head dims 16 and 32 (which keep the mma.sync launches)
CASES = (
    ("512² b2", 32, 1024, 8, 64), ("512² b1", 16, 1024, 8, 64),
    ("S=257", 16, 257, 8, 64), ("S=576", 16, 576, 8, 64), ("D=128 S=1024", 16, 1024, 4, 128),
    ("D=16 S=576", 16, 576, 8, 16), ("D=32 S=576", 16, 576, 8, 32),
)


def lines(dev, cases=CASES):
    """One dict a case of ``cases``, each without a key mask and with one that
    keeps a prefix of each sequence (the first sequence none, the last all):
    #3 and #6 each held to its plain version within ``chip_smoke.KERNEL_TOL``
    and to its own bits on a second launch, then the device ms a call of each
    (``chip_smoke.device_ms``), of SDPA's backward on the same q, k, v and dO
    (the yardstick; the port never calls it), and each kernel's bound (5
    products of S x kept keys x D a pair at the bf16 peak, or its bytes)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from video_vae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(22)
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
            q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
            q, k, gh = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)
            lq, lk, lv, lg = (t.transpose(1, 2).contiguous() for t in (q, k, v, gh))
            leaves = [t.detach().requires_grad_() for t in (lq, lk, lv)]
            o = F.scaled_dot_product_attention(*leaves, attn_mask=None if mask is None else mask[:, None, None, :])
            flops = 10.0 * H * S * keys * D  # the scores, dv, dP, dq, dk over the kept keys
            line = {"case": f"{label}{' masked' if masked else ''}", "B": B, "S": S, "H": H, "D": D,
                    "sdpa_bwd_device_ms": chip_smoke.device_ms(
                        lambda: torch.autograd.grad(o, leaves, lg, retain_graph=True), 10)}
            for name, run, plain, operands in (
                ("fused_bwd", lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H),
                 lambda: fa.fused_qkv_attention_bwd_plain(qkv, qs, ks, mask, g, H), (qkv, g, mask)),
                ("flash_bwd", lambda: fa.flash_attention_bwd_cuda(q, k, v, mask, gh),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, mask, gh), (q, k, v, gh, mask)),
            ):
                got, again = run(), run()
                torch.cuda.synchronize()
                err = max(chip_smoke.check_close(f"{line['case']} {name} {i}", a, b, "bfloat16")
                          for i, (a, b) in enumerate(zip(got, plain())))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits twice
                    raise AssertionError(f"{line['case']} {name}: two launches gave different bits")
                bound = chip_smoke.bound_ms(chip_smoke.nbytes(*operands) + chip_smoke.nbytes(*got), flops, "bfloat16")
                ms = chip_smoke.device_ms(run, 10)
                line.update({f"{name}_device_ms": ms, f"{name}_vs_sdpa": ms / line["sdpa_bwd_device_ms"],
                             f"{name}_bound_ms": bound[0], f"{name}_bound_by": bound[1],
                             f"{name}_max_abs_err": err, f"{name}_tflops": flops / ms / 1e9})
                del got, again
            yield line
            del qkv, g, q, k, v, gh, lq, lk, lv, lg, leaves, o
    torch.cuda.empty_cache()


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    import torch

    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available():
        raise SystemExit("split_bwd_times needs a CUDA card")
    for source, log in build(("fused_attention_bwd.cu", "flash_attention_bwd.cu")).items():
        log_lines = log.splitlines()
        for i, line in enumerate(log_lines):  # the wgmma split launches' registers and spills
            if "Compiling entry function" in line and "split_wg" in line:
                print(f"ptxas {source}:", " | ".join(x.strip() for x in log_lines[i:i + 4]), flush=True)
            elif "wgmma" in line and "split_wg" in line:  # e.g. wgmma serialised by the compiler
                print(f"ptxas {source}: {line.strip()}", flush=True)
    for line in lines(torch.device("cuda")):
        print("split-bwd", json.dumps({"root": label, **line}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else sys.argv[1])
