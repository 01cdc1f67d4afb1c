"""Hold the attention kernels to another commit's bits on the same card.

    python3 video_vae_tpu_torch/utils/kernel_bits.py save <package root> <out.pt>
    python3 video_vae_tpu_torch/utils/kernel_bits.py compare <a.pt> <b.pt>

``save`` imports ``video_vae_tpu_torch`` from ``<package root>`` (the root of a
checkout of this commit or of another, e.g. an unpacked ``git archive`` of the
parent), builds its five attention kernels (#1, #3, #5, #6, #7) and runs each
at the head dims of ``HEAD_DIMS`` that its package takes (the instantiations
16, 32, 64 and 128, the padded 8, 24, 48 and 96, and the wide 130, 192 and
256; an older package refuses the last three), in bf16 and f32, on five
shapes: four of at most 256 tokens (the flagship's temporal and spatial calls
and two ragged ones; the slab and tile variants) and one past 256 (the split
variant), with seeded inputs and key masks that leave some sequences no key,
then saves every output. ``compare`` prints how
many of the outputs that both files hold are equal bit for bit, by head dim,
and the outputs only one of them holds. Run it by path, so that
the package comes from the root given, not from the working directory; run
the two commits in turns on one card (a, b, b, a).
"""

from __future__ import annotations

import sys

SOURCES = ("fused_attention.cu", "fused_attention_bwd.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "attention_sublayer.cu")
SHAPES = ((512, 16, 8), (32, 256, 8), (5, 37, 8), (3, 80, 8), (2, 300, 8))  # (B, S, H)
HEAD_DIMS, WIDTH = (16, 32, 64, 128, 8, 24, 48, 96, 130, 192, 256), 768


def save(root: str, out: str) -> None:
    sys.path.insert(0, root)
    import torch

    from video_vae_tpu_torch.ops import flash_attention as fa
    from video_vae_tpu_torch.ops._build import build

    build(SOURCES)
    dev, C = torch.device("cuda"), WIDTH
    gen = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen)

    def takes(D):
        try:
            fa.check_head_dim(D)
        except ValueError:
            return False
        return True

    outputs = {}
    for (B, S, H), D in ((shape, D) for D in HEAD_DIMS if takes(D) for shape in SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            qkv, g = rn(B, S, 3 * H * D).to(dev, dtype), rn(B, S, H * D).to(dev, dtype)
            qs, ks = (1 + 0.2 * rn(D)).to(dev), (1 + 0.2 * rn(D)).to(dev)
            lengths = torch.randint(0, S + 1, (B,), generator=gen)
            mask = (torch.arange(S)[None, :] < lengths[:, None]).to(dev)
            key = f"{B}x{S}x{H} D{D} {dtype}"
            outputs[f"fused {key}"] = fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
            outputs[f"fused bwd {key}"] = fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
            q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
            q, k = q.contiguous(), k.contiguous()
            outputs[f"flash {key}"] = fa.flash_attention_cuda(q, k, v, mask)
            outputs[f"flash bwd {key}"] = fa.flash_attention_bwd_cuda(q, k, v, mask, g.reshape(B, S, H, D))
            weights = (rn(B, S, C).to(dtype), 1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, 3 * H * D) / C**0.5,
                       0.2 * rn(3 * H * D), qs.cpu(), ks.cpu(), rn(H * D, C) / (H * D) ** 0.5, 0.2 * rn(C))
            outputs[f"sublayer {key}"] = fa.fused_attention_sublayer_cuda(*(t.to(dev) for t in weights), mask, H)
    torch.cuda.synchronize()
    torch.save({k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu() for k, v in outputs.items()}, out)
    print(f"saved {len(outputs)} outputs of {root} to {out}")


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    both = [key for key in a if key in b]
    differ, by_dim = [], {}
    for key in both:
        x, y = (a[key], b[key]) if isinstance(a[key], tuple) else ((a[key],), (b[key],))
        same = all(torch.equal(p, q) for p, q in zip(x, y))
        if not same:
            differ.append(key)
        dim = next(word for word in key.split() if word.startswith("D") and word[1:].isdigit())
        counts = by_dim.setdefault(dim, [0, 0])
        counts[0] += same
        counts[1] += 1
    only = sorted(set(a) ^ set(b))
    print(f"same bits: {len(both) - len(differ)} of {len(both)} outputs in both files; by head dim "
          f"{ {dim: f'{n}/{total}' for dim, (n, total) in by_dim.items()} }; differ: {differ}; "
          f"in one file only: {len(only)}")
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] not in ("save", "compare"):
        sys.exit(__doc__)
    if sys.argv[1] == "save":
        save(sys.argv[2], sys.argv[3])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
