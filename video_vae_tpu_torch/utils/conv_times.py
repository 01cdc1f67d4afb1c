"""Hold and time a bf16 conv kernel at every conv of a train step: the direct
conv (#2, forward and input gradient) or the filter gradient (#4).

    python3 video_vae_tpu_torch/utils/conv_times.py <package root> [label] [--kernel=2|4] [--sets=flagship,tapdot,trainer,512,vgg] [--variant=mma|wgmma]

imports ``video_vae_tpu_torch`` and ``chip_smoke`` from ``<package root>`` (the
root of a checkout of this commit or of another, e.g. an unpacked ``git
archive`` of the parent), builds the kernel's source (#2 ``csrc/conv3d.cu``,
#4 ``csrc/conv3d_wgrad.cu``; #4 by default), prints its launches' registers
and spills, then one JSON line a conv of each set and one sum line a path:
the 15 bf16 convs of the flagship's UNet at the default train step's b2 x 16
frames (``flagship``; the UNet runs on the step's 2 rollouts, and a serving
pass's b2 x 16 frames are the same shapes), of the tap-dot model's
(``tapdot``), of the trainer's b4 x 32 frames (``trainer``), of the
flagship at 512² (``512``) and, for #2 only, the cf VGG's three kt = 1 convs
on a train step's 32 frames (``vgg``; not in the default sets). For #2 a
conv's line holds its forward and its input gradient (the conv of g with the
flipped, IO-swapped kernel), and the sums are a path's launches: a serving
pass the forwards, a train step the forwards and input gradients, the
trainer's remat the encoder and decoder forwards twice, the tap-dot paths
only the convs the tap-dot gate leaves to #2, the VGG's step each forward
twice (reconstruction and target) and each input gradient once ("conv-times"
and "conv-sum" lines); for #4 each conv once a step ("wgrad-times",
"wgrad-sum"). ``--variant`` sends every bf16 #2 call that the variant takes
(wgmma: a width that is a multiple of 8 and a plan that fits) to that variant
in place of ``conv_variant``'s choice, to time both variants at every conv of
one tree. Run it by path, so that the package comes from the root given;
compare two roots, or two variants, only in turns in one call on one card (a,
b, b, a). ``chip_smoke.py`` holds both kernels at the same convs.
"""

from __future__ import annotations

import contextlib
import json
import sys

SETS = ("flagship", "tapdot", "trainer", "512")
DIRECT_ONLY_SETS = ("vgg",)
# the launches of each kernel's wgmma variant, in launch order (that tree's only), by a
# part of each kernel's name (either channels-last copy); #2's copies one source or two
WGRAD_WG_LAUNCHES = ("channels_last", "wgrad_wg_kernel", "wgrad_wg_reduce_kernel")


def conv_wg_launches(sources: int) -> tuple[str, ...]:
    return ("weights_kmajor_kernel",) + ("channels_last",) * sources + ("conv_wg_kernel",)


# #2's paths by set: (path name, launches a forward and an input gradient make of #2 there)
PATHS = {
    "flagship": (("serving", "fwd"), ("train", "fwd+dgrad")),
    "512": (("serving-512", "fwd"), ("train-512", "fwd+dgrad")),
    "trainer": (("trainer", "remat+dgrad"),),
    "tapdot": (("serving-tapdot", "fwd"), ("train-tapdot", "fwd+dgrad")),
    "vgg": (("train-vgg-cf", "2fwd+dgrad"),),
}


def cases(name: str):
    """(model, batch, frames, conv name, h, w, source channels, cout, kernel size) of a set."""
    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    if name == "vgg":  # its forwards; their input gradients are chip_smoke's dgrad cases
        for conv, side, cin, cout, _ in chip_smoke.VGG_CONV_CASES:
            if "dgrad" not in conv:
                yield name, 1, chip_smoke.VGG_FRAMES, conv, side, side, (cin,), cout, (1, 3, 3)
        return
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
    """1 − the products #4's wgmma kernel needs over those it issues (its bands,
    N tiles and pixel tiles padded), where that tree has the kernel; else None."""
    if not hasattr(conv3d, "wgrad_wg_plan") or w % 8:
        return None
    plan = conv3d.wgrad_wg_plan(cins[0], cins[1] if len(cins) == 2 else 0, cout, b, t, h, w, *k)
    issued = plan.mtiles * 64 * plan.cin_pad * plan.tiles * plan.rows * plan.bw
    return 1 - k[0] * k[1] * k[2] * sum(cins) * cout * b * t * h * w / issued


def conv_variant(conv3d, h, w, k, cout) -> str:
    """The variant of #2 that root's package runs a bf16 conv of that shape on (a
    tree before the wgmma variant: the mma.sync kernel)."""
    import torch

    return conv3d.conv_variant(torch.bfloat16, h, w, k, cout) if hasattr(conv3d, "conv_variant") else "mma"


def run_variant(conv3d, forced, c1, c2, cout, b, t, h, w, k) -> str:
    """The variant of #2 that a bf16 conv of that shape runs on: root's choice, or
    ``forced`` where it takes the conv (mma: any; wgmma: w % 8 == 0 and a plan
    that fits)."""
    if forced == "mma":
        return forced
    if forced == "wgmma" and w % 8 == 0:
        try:
            conv3d.conv_wg_plan(c1, c2, cout, b, t, h, w, *k)
            return forced
        except ValueError:
            pass
    return conv_variant(conv3d, h, w, k, cout)


@contextlib.contextmanager
def routed(conv3d, variant: str):
    """Root's bf16 #2 calls on ``variant`` inside the block (a tree with one
    variant: as it is)."""
    import torch

    chosen = getattr(conv3d, "conv_variant", None)
    if chosen is not None:
        conv3d.conv_variant = lambda dtype, *shape: variant if dtype == torch.bfloat16 else chosen(dtype, *shape)
    try:
        yield
    finally:
        if chosen is not None:
            conv3d.conv_variant = chosen


def _flops(b, t, h, w, cin, cout, k):
    """The products of the taps inside the clip and the frame (SAME's zeros add nothing)."""
    import chip_smoke

    return 2.0 * b * cout * cin * chip_smoke.valid_taps(t, k[0]) * chip_smoke.valid_taps(
        h, k[1]) * chip_smoke.valid_taps(w, k[2])


def direct_lines(dev, sets=SETS, forced=None):
    """One dict a conv: #2's forward and input gradient, each held to
    ``conv3d_cf_plain`` within ``chip_smoke.KERNEL_TOL['bfloat16']`` · max|ref|
    and to its own bits on a second launch, then the device ms a call
    (``chip_smoke.device_ms``) of #2 and of cuDNN's ``F.conv3d`` on the
    concatenated input (the yardstick; the port never calls it), the bound
    (``chip_smoke.bound_ms``), TFLOP/s and, where the call runs on the wgmma
    variant, the device ms of each of its launches; each call on root's variant
    or ``forced`` (:func:`run_variant`)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from video_vae_tpu_torch.ops import conv3d

    gen = torch.Generator().manual_seed(28)
    for name in sets:
        for model, b, t, conv, h, w, cins, cout, k in cases(name):
            cin = sum(cins)
            xs = [torch.randn(b, t, c, h, w, generator=gen).to(dev, torch.bfloat16) for c in cins]
            x2 = xs[1] if len(xs) == 2 else None
            kernel = (torch.randn(*k, cin, cout, generator=gen) / (cin * k[0] * k[1] * k[2]) ** 0.5).to(
                dev, torch.bfloat16)
            bias = (0.1 * torch.randn(cout, generator=gen)).to(dev)
            g = torch.randn(b, t, cout, h, w, generator=gen).to(dev, torch.bfloat16)
            flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
            zero = torch.zeros(cin, dtype=torch.float32, device=dev)
            pad = (k[0] // 2, k[1] // 2, k[2] // 2)
            x_ncdhw = torch.cat(xs, dim=2).transpose(1, 2).contiguous()
            g_ncdhw = g.transpose(1, 2).contiguous()
            w_oidhw = kernel.permute(4, 3, 0, 1, 2).contiguous()
            w_flip = flipped.permute(4, 3, 0, 1, 2).contiguous()
            lib_bias = bias.to(torch.bfloat16)
            flops = _flops(b, t, h, w, cin, cout, k)
            line = {"set": model, "case": conv, "shape": [b, t, list(cins), h, w, cout, list(k)],
                    "variant": [run_variant(conv3d, forced, cins[0], cin - cins[0], cout, b, t, h, w, k),
                                run_variant(conv3d, forced, cout, 0, cin, b, t, h, w, k)],
                    "tapdot": [chip_smoke.takes_tapdot(cins, cout, k, w), chip_smoke.takes_tapdot((cout,), cin, k, w)]}
            for part, run, cudnn, operands in (
                ("fwd", lambda: conv3d.conv3d_cf_cuda(xs[0], x2, kernel, bias),
                 lambda: F.conv3d(x_ncdhw, w_oidhw, lib_bias, padding=pad), (*xs, kernel, bias)),
                ("dgrad", lambda: conv3d.conv3d_cf_cuda(g, None, flipped, zero),
                 lambda: F.conv3d(g_ncdhw, w_flip, padding=pad), (g, flipped)),
            ):
                with routed(conv3d, line["variant"][part == "dgrad"]):
                    got, again = run(), run()
                    torch.cuda.synchronize()
                ref = (conv3d.conv3d_cf_plain(xs[0], x2, kernel, bias) if part == "fwd"
                       else conv3d.conv3d_cf_plain(g, None, flipped, zero))
                err = chip_smoke.check_close(f"{name} {conv} {part}", got, ref, "bfloat16")
                if not torch.equal(got, again):  # no split-K, no atomics: the same bits twice
                    raise AssertionError(f"{name} {conv} {part}: two launches gave different bits")
                bound = chip_smoke.bound_ms(chip_smoke.nbytes(*operands, got), flops, "bfloat16")
                with routed(conv3d, line["variant"][part == "dgrad"]):
                    ms = chip_smoke.device_ms(run, 10)
                    line[part] = {"device_ms": ms, "cudnn_device_ms": chip_smoke.device_ms(cudnn, 10),
                                  "bound_ms": bound[0], "bound_by": bound[1], "tflops": flops / ms / 1e9,
                                  "max_abs_err": err}
                    if line["variant"][part == "dgrad"] == "wgmma":
                        names = conv_wg_launches(len(xs) if part == "fwd" else 1)
                        line[part]["launch_device_ms"] = chip_smoke.device_launch_ms(run, names)
                del got, again, ref
            yield line
            del xs, x2, g, x_ncdhw, g_ncdhw, flipped
        torch.cuda.empty_cache()


def direct_sums(lines) -> dict:
    """#2's device ms, cuDNN's and the bound summed over each path's launches."""
    sums: dict = {}
    for line in lines:
        remat = line["case"].startswith(("encoders", "decoders"))
        for path, launches in PATHS[line["set"]]:
            total = sums.setdefault(path, {"launches": 0, "device_ms": 0.0, "cudnn_device_ms": 0.0, "bound_ms": 0.0})
            twice = launches == "2fwd+dgrad" or (launches == "remat+dgrad" and remat)
            parts = {"fwd": 2 if twice else 1, "dgrad": int(launches != "fwd")}
            if line["set"] == "tapdot":  # the convs the tap-dot gate leaves to #2
                parts = {p: n * (not taken) for (p, n), taken in zip(parts.items(), line["tapdot"])}
            for part, n in parts.items():
                total["launches"] += n
                for key in ("device_ms", "cudnn_device_ms", "bound_ms"):
                    total[key] += n * line[part][key]
    return sums


def wgrad_lines(dev, sets=SETS):
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
            flops = _flops(b, t, h, w, cin, cout, k)
            bound = chip_smoke.bound_ms(chip_smoke.nbytes(*xs, g, got), flops, "bfloat16")
            ms = chip_smoke.device_ms(run, 10)
            line = {"set": model, "case": conv, "shape": [b, t, list(cins), h, w, cout, list(k)],
                    "device_ms": ms, "cudnn_device_ms": chip_smoke.device_ms(cudnn, 10),
                    "bound_ms": bound[0], "bound_by": bound[1], "tflops": flops / ms / 1e9,
                    "max_abs_err": err, "padded_share": padded_share(conv3d, b, t, h, w, cins, cout, k)}
            if hasattr(conv3d, "wgrad_variant") and conv3d.wgrad_variant(torch.bfloat16, w) == "wgmma":
                line["launch_device_ms"] = dict(zip(WGRAD_WG_LAUNCHES,
                                                    chip_smoke.device_launch_ms(run, WGRAD_WG_LAUNCHES)))
            yield line
            del xs, x2, g, got, again, x_ncdhw, g_ncdhw
        torch.cuda.empty_cache()


def _print_ptxas(log: str, source: str, kernel: str) -> None:
    """The products' launches' registers and spills from nvcc's -Xptxas -v output."""
    log_lines = log.splitlines()
    for i, line in enumerate(log_lines):
        if "Compiling entry function" in line and kernel in line and "reduce" not in line:
            print(f"ptxas {source}:", " | ".join(x.strip() for x in log_lines[i:i + 4]), flush=True)
        elif "warning" in line.lower() and "wgmma" in line:
            print(f"ptxas {source}:", line.strip(), flush=True)


def main(root: str, label: str, kernel: int = 4, sets=SETS, forced=None) -> None:
    sys.path.insert(0, root)
    import torch

    from video_vae_tpu_torch.ops._build import build

    if not torch.cuda.is_available():
        raise SystemExit("conv_times needs a CUDA card")
    source, entry = {2: ("conv3d.cu", "conv"), 4: ("conv3d_wgrad.cu", "wgrad")}[kernel]
    for name, log in build((source,)).items():
        _print_ptxas(log, name, entry)
    dev = torch.device("cuda")
    if kernel == 4:
        sums: dict = {}
        for line in wgrad_lines(dev, sets):
            print("wgrad-times", json.dumps({"root": label, **line}), flush=True)
            total = sums.setdefault(line["set"], {"device_ms": 0.0, "cudnn_device_ms": 0.0, "bound_ms": 0.0})
            for key in total:
                total[key] += line[key]
        for name, total in sums.items():  # each conv launches #4 once a step
            print("wgrad-sum", json.dumps({"root": label, "set": name, **total}), flush=True)
        return
    lines = []
    for line in direct_lines(dev, sets, forced):
        print("conv-times", json.dumps({"root": label, **line}), flush=True)
        lines.append(line)
    for path, total in direct_sums(lines).items():
        print("conv-sum", json.dumps({"root": label, "path": path, **total}), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    options = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--") and "=" in a)
    if len(args) not in (1, 2) or set(options) - {"sets", "kernel", "variant"} or options.get(
            "variant", "mma") not in ("mma", "wgmma"):
        sys.exit(__doc__)
    main(args[0], args[1] if len(args) == 2 else args[0], int(options.get("kernel", 4)),
         tuple(options.get("sets", ",".join(SETS)).split(",")), options.get("variant"))
