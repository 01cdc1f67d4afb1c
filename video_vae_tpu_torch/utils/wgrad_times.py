"""Hold and time the bf16 conv filter gradient (#4) at every conv of a train step.

    python3 video_vae_tpu_torch/utils/wgrad_times.py <package root> [label] [--sets=flagship,tapdot,trainer,512]

imports ``video_vae_tpu_torch`` and ``chip_smoke`` from ``<package root>`` (the
root of a checkout of this commit or of another, e.g. an unpacked ``git
archive`` of the parent), builds #4 (``csrc/conv3d_wgrad.cu``), prints its
launches' registers and spills, then one ``wgrad-times`` JSON line a conv of
each set and one ``wgrad-sum`` line a set: the 15 bf16 convs of the flagship's
UNet at the default train step's b2 x 16 frames (``flagship``; the UNet runs
on the step's 2 rollouts), of the tap-dot model's (``tapdot``), of the
trainer's b4 x 32 frames (``trainer``) and of the flagship at 512² (``512``).
Run it by path, so that the package comes from the root given; compare two
roots only in turns in one call on one card (a, b, b, a). ``chip_smoke.py``
holds #4 at the same convs ("wgrad-vs-cudnn" lines).
"""

from __future__ import annotations

import json
import sys

SETS = ("flagship", "tapdot", "trainer", "512")
# the launches of the wgmma variant, in launch order (that tree's only)
WG_LAUNCHES = ("channels_last_kernel", "wgrad_wg_kernel", "wgrad_wg_reduce_kernel")


def cases(name: str):
    """(model, batch, frames, conv name, h, w, source channels, cout, kernel size) of a set."""
    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    cfg, batch, frames = {
        "flagship": (ModelConfig(), chip_smoke.BATCH, chip_smoke.FRAMES),
        "tapdot": (chip_smoke.tapdot_model_config(), chip_smoke.BATCH, chip_smoke.FRAMES),
        "trainer": (ModelConfig(), 2 * chip_smoke.TRAINER_BATCH, chip_smoke.TRAINER_FRAMES),
        "512": (ModelConfig(height=512, width=512), chip_smoke.BATCH, chip_smoke.FRAMES),
    }[name]
    for conv, h, w, cins, cout, k, dtype in chip_smoke.conv_cases(cfg):
        if dtype == "bfloat16":
            yield name, batch, frames, conv, h, w, cins, cout, k


def padded_share(conv3d, b, t, h, w, cins, cout, k):
    """1 − the products the wgmma kernel needs over those it issues (its bands,
    N tiles and pixel tiles padded), where that tree has the kernel; else None."""
    if not hasattr(conv3d, "wgrad_wg_plan") or w % 8:
        return None
    plan = conv3d.wgrad_wg_plan(cins[0], cins[1] if len(cins) == 2 else 0, cout, b, t, h, w, *k)
    issued = plan.mtiles * 64 * plan.cin_pad * plan.tiles * plan.rows * plan.bw
    return 1 - k[0] * k[1] * k[2] * sum(cins) * cout * b * t * h * w / issued


def lines(dev, sets=SETS):
    """One dict a conv: #4 held to ``conv3d_wgrad_plain`` within
    ``chip_smoke.KERNEL_TOL['float32']`` · max|ref| and to its own bits on a
    second launch, then the device ms a call (``chip_smoke.device_ms``) of #4
    and of cuDNN's filter gradient (``torch.nn.grad.conv3d_weight`` on the
    concatenated input: the yardstick; the port never calls it), the bound
    (``chip_smoke.bound_ms``: the products of the taps inside the clip and the
    frame at the bf16 peak, or the bytes), TFLOP/s, the padded share of the
    products and, for a tree with the wgmma kernel, the device ms of each of
    its three launches."""
    import torch

    import chip_smoke
    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(24)
    for name in sets:
        for model, b, t, conv, h, w, cins, cout, k in cases(name):
            cin = sum(cins)
            xs = [torch.randn(b, t, c, h, w, generator=gen).to(dev, torch.bfloat16) for c in cins]
            x2 = xs[1] if len(xs) == 2 else None
            g = torch.randn(b, t, cout, h, w, generator=gen).to(dev, torch.bfloat16)
            x_ncdhw = torch.cat(xs, dim=2).transpose(1, 2).contiguous()
            g_ncdhw = g.transpose(1, 2).contiguous()
            pad = (k[0] // 2, k[1] // 2, k[2] // 2)

            def run():
                return conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k)

            def cudnn():
                return torch.nn.grad.conv3d_weight(x_ncdhw, (cout, cin, *k), g_ncdhw, padding=pad)

            got, again = run(), run()
            torch.cuda.synchronize()
            err = chip_smoke.check_close(f"{name} {conv}", got, conv3d.conv3d_wgrad_plain(xs[0], x2, g, *k),
                                         "float32")
            if not torch.equal(got, again):  # no atomics: the same bits twice
                raise AssertionError(f"{name} {conv}: two launches gave different bits")
            flops = 2.0 * b * cout * cin * chip_smoke.valid_taps(t, k[0]) * chip_smoke.valid_taps(
                h, k[1]) * chip_smoke.valid_taps(w, k[2])
            bound = chip_smoke.bound_ms(chip_smoke.nbytes(*xs, g, got), flops, "bfloat16")
            ms = chip_smoke.device_ms(run, 10)
            line = {"set": model, "case": conv, "shape": [b, t, list(cins), h, w, cout, list(k)],
                    "device_ms": ms, "cudnn_device_ms": chip_smoke.device_ms(cudnn, 10),
                    "bound_ms": bound[0], "bound_by": bound[1], "tflops": flops / ms / 1e9,
                    "max_abs_err": err, "padded_share": padded_share(conv3d, b, t, h, w, cins, cout, k)}
            if hasattr(conv3d, "wgrad_variant") and conv3d.wgrad_variant(torch.bfloat16, w) == "wgmma":
                line["launch_device_ms"] = dict(zip(WG_LAUNCHES, chip_smoke.device_launch_ms(run, WG_LAUNCHES)))
            yield line
            del xs, x2, g, got, again, x_ncdhw, g_ncdhw
        torch.cuda.empty_cache()


def main(root: str, label: str, sets=SETS) -> None:
    sys.path.insert(0, root)
    import torch

    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_times needs a CUDA card")
    for source, log in build(("conv3d_wgrad.cu",)).items():
        log_lines = log.splitlines()
        for i, line in enumerate(log_lines):  # the products' launches: registers and spills
            if "Compiling entry function" in line and "wgrad" in line and "reduce" not in line:
                print(f"ptxas {source}:", " | ".join(x.strip() for x in log_lines[i:i + 4]), flush=True)
    sums: dict = {}
    for line in lines(torch.device("cuda"), sets):
        print("wgrad-times", json.dumps({"root": label, **line}), flush=True)
        total = sums.setdefault(line["set"], {"device_ms": 0.0, "cudnn_device_ms": 0.0, "bound_ms": 0.0})
        for key in total:
            total[key] += line[key]
    for name, total in sums.items():  # each conv launches #4 once a step
        print("wgrad-sum", json.dumps({"root": label, "set": name, **total}), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--sets")]
    chosen = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--sets=")), ",".join(SETS))
    if len(args) not in (1, 2):
        sys.exit(__doc__)
    main(args[0], args[1] if len(args) == 2 else args[0], tuple(chosen.split(",")))
