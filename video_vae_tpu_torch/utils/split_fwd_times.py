"""Hold and time the split attention forward (#1, #5 and #7's attention past 256 tokens).

    python3 video_vae_tpu_torch/utils/split_fwd_times.py <package root> [label]

imports ``video_vae_tpu_torch`` and ``chip_smoke`` from ``<package root>`` (the
root of a checkout of this commit or of another, e.g. an unpacked ``git
archive`` of the parent), builds #1 (``csrc/fused_attention.cu``), #5
(``csrc/flash_attention.cu``) and #7 (``csrc/attention_sublayer.cu``), prints
the split forward launches' registers and spills, and one ``split-fwd`` JSON
line a case of :func:`lines`. Run it by path, so that the package comes from
the root given; compare two roots only in turns in one call on one card (a,
b, b, a). ``chip_smoke.py`` prints the same lines for its own tree
("long-seq-kernels").
"""

from __future__ import annotations

import json
import sys


def lines(dev, cases=None):
    """One dict a case of ``cases`` (by default ``split_bwd_times.CASES``:
    (label, B, S, H, D), bf16, B x H (sequence, head) pairs of S tokens at head
    dim D), each without a key mask and with one that keeps a prefix of each
    sequence (the first sequence none, so that its rows average all S keys;
    the last all): #1, #5 and #7 each held to its plain
    version within ``chip_smoke.KERNEL_TOL`` and to its own bits on a second
    launch, then the device ms a call of each (``chip_smoke.device_ms``), of
    SDPA's forward on the same q, k and v (the yardstick of #1 and #5; the port
    never calls it) and of #7's chain (LN -> matmul -> SDPA -> matmul), and
    each kernel's bound (``chip_smoke.bound_ms``: 2 products of S x kept keys x
    D a pair at the bf16 peak, #7's two projections beside them, or the
    bytes)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from video_vae_tpu_torch import ModelConfig
    from video_vae_tpu_torch.ops import flash_attention as fa
    from video_vae_tpu_torch.utils.split_bwd_times import CASES

    C = ModelConfig().embed_dim
    gen = torch.Generator().manual_seed(23)
    for label, B, S, H, D in CASES if cases is None else cases:
        HD = H * D
        rn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
        lng, lnb, wqkv, bqkv, wout, bout = (t.to(dev) for t in (
            1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, 3 * HD) / C**0.5, 0.2 * rn(3 * HD), 0.1 * rn(HD, C) / HD**0.5,
            0.2 * rn(C)))
        w16 = [t.to(torch.bfloat16) for t in (wqkv, bqkv, wout, bout)]
        for masked in (False, True):
            qkv = rn(B, S, 3 * HD).to(dev, torch.bfloat16)
            x = rn(B, S, C).to(dev, torch.bfloat16)
            qs, ks = ((1 + 0.2 * rn(D)).to(dev) for _ in range(2))
            mask, keys = None, B * S
            if masked:
                lengths = torch.randint(1, S + 1, (B,), generator=gen)
                lengths[0], lengths[-1] = 0, S
                mask = (torch.arange(S)[None, :] < lengths[:, None]).to(dev)
                keys = int(mask.sum())
            amask = None if mask is None else mask[:, None, None, :]
            q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(HD, -1))
            q, k = q.contiguous(), k.contiguous()  # v a view into qkv, as the pallas path hands it over
            lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))

            def chain():
                xa = F.layer_norm(x, (C,), lng.to(x.dtype), lnb.to(x.dtype), 1e-6).to(torch.bfloat16)
                cq, ck, cv = (t.reshape(B, S, H, D).transpose(1, 2)
                              for t in (torch.matmul(xa, w16[0]) + w16[1]).split(HD, -1))
                o = F.scaled_dot_product_attention(cq, ck, cv, attn_mask=amask)
                return x + torch.matmul(o.transpose(1, 2).reshape(B, S, HD), w16[2]) + w16[3]

            sublayer = (x, lng, lnb, wqkv, bqkv, qs, ks, wout, bout, mask, H)
            flops = 4.0 * H * S * keys * D  # q k^T and P.V over the kept keys
            projections = 2.0 * B * S * C * 3 * HD + 2.0 * B * S * HD * C
            line = {"case": f"{label}{' masked' if masked else ''}", "B": B, "S": S, "H": H, "D": D,
                    "sdpa_device_ms": chip_smoke.device_ms(
                        lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask), 10),
                    "chain_device_ms": chip_smoke.device_ms(chain, 10)}
            for name, run, plain, operands, work, yardstick in (
                ("fused", lambda: (fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H),),
                 lambda: (fa.fused_qkv_attention_plain(qkv, qs, ks, mask, H),), (qkv, mask), flops, "sdpa"),
                ("flash", lambda: (fa.flash_attention_cuda(q, k, v, mask),),
                 lambda: (fa.flash_attention_plain(q, k, v, mask),), (q, k, v, mask), flops, "sdpa"),
                ("sublayer", lambda: fa.fused_attention_sublayer_cuda(*sublayer),
                 lambda: fa.fused_attention_sublayer_plain(*sublayer), (x, x, *w16, lng, lnb, mask),
                 flops + projections, "chain"),
            ):
                got, again = run(), run()
                torch.cuda.synchronize()
                err = max(chip_smoke.check_close(f"{line['case']} {name} {i}", a, b, "bfloat16")
                          for i, (a, b) in enumerate(zip(got, plain())))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):  # no atomics: the same bits twice
                    raise AssertionError(f"{line['case']} {name}: two launches gave different bits")
                moved = chip_smoke.nbytes(*operands) + (0 if name == "sublayer" else chip_smoke.nbytes(*got))
                bound = chip_smoke.bound_ms(moved, work, "bfloat16")
                ms = chip_smoke.device_ms(run, 10)
                line.update({f"{name}_device_ms": ms, f"{name}_vs_{yardstick}": ms / line[f"{yardstick}_device_ms"],
                             f"{name}_bound_ms": bound[0], f"{name}_bound_by": bound[1],
                             f"{name}_max_abs_err": err, f"{name}_tflops": work / ms / 1e9})
                del got, again
            yield line
            del qkv, x, q, k, v, lq, lk, lv
    torch.cuda.empty_cache()


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    import torch

    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available():
        raise SystemExit("split_fwd_times needs a CUDA card")
    sources = ("fused_attention.cu", "flash_attention.cu", "attention_sublayer.cu")
    for source, log in build(sources).items():
        log_lines = log.splitlines()
        for i, line in enumerate(log_lines):  # the split forward launches' registers and spills
            if "Compiling entry function" in line and ("split_wg_fwd" in line or "split_fwd" in line):
                print(f"ptxas {source}:", " | ".join(x.strip() for x in log_lines[i:i + 4]), flush=True)
            elif "wgmma" in line and "split_wg_fwd" in line:  # e.g. wgmma serialised by the compiler
                print(f"ptxas {source}: {line.strip()}", flush=True)
    for line in lines(torch.device("cuda")):
        print("split-fwd", json.dumps({"root": label, **line}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else sys.argv[1])
