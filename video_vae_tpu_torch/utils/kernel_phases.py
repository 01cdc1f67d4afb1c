"""What sets the pace of the bf16 fused attention backward kernel (#3).

    python3 -m video_vae_tpu_torch.utils.kernel_phases

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds copies of ``csrc/fused_attention_bwd.cu`` with one phase of
``csrc/fused_attention_bwd_mma.cuh`` cut out (a loop that runs no times, a
call that is skipped, a load replaced by a constant; the outputs of a cut
copy are wrong, only its time counts), all at once, into
``video_vae_tpu_torch/_build/phases/``, and prints, for each bf16 attention
call of the flagship train step, the device time per call of each copy from
``chip_smoke.device_ms``. The time a phase takes is the full kernel's less
the copy without it. Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

from video_vae_tpu_torch.ops import _build
from video_vae_tpu_torch.ops import flash_attention as fa

HEADER = "fused_attention_bwd_mma.cuh"
_NEVER = "S < 0"  # a condition no launch meets

# name -> (text of the header, its replacement), each found at least once
CUTS = {
    "full": [],
    "no_query_side": [("it < items; it += warps) {  // query side", f"it < items && {_NEVER}; it += warps) {{")],
    "no_key_side": [("it < items; it += warps) {  // key side", f"it < items && {_NEVER}; it += warps) {{")],
    "no_sides": [("it < items; it += warps) {  // query side", f"it < items && {_NEVER}; it += warps) {{"),
                 ("it < items; it += warps) {  // key side", f"it < items && {_NEVER}; it += warps) {{")],
    "no_query_first_pass": [("c < (TWO_PASS ? chunks : 1); ++c) {", "c < (TWO_PASS ? 0 : 1); ++c) {")],
    "no_key_recompute": [("row_dots<1>(st, kf, q_s, q0, 1);", "row_dots<1>(st, kf, q_s, q0, 0);"),
                         ("row_dots<1>(dt, vf, do_s, q0, 1);", "row_dots<1>(dt, vf, do_s, q0, 0);")],
    "no_exp": [("exp2f(", "(")],
    "no_epilogues": [("    ln_rope_bwd(d", f"    if ({_NEVER}) ln_rope_bwd(d"),
                     ("    store_rows(dv,", f"    if ({_NEVER}) store_rows(dv,")],
    "no_epilogue_tables": [(f"__ldg(reinterpret_cast<const float2*>({t} + d0{hi}))", "make_float2(0.5f, 0.25f)")
                           for t in ("c", "sn") for hi in ("", " + D / 2")],
}


def _build_cut(name: str):
    """Start nvcc on a copy of csrc with the cut applied; (process, library path)."""
    out_dir = _build.BUILD_DIR / "phases" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, out_dir)
    text = (out_dir / HEADER).read_text()
    for old, new in CUTS[name]:
        if old not in text:
            raise RuntimeError(f"cut {name}: {old!r} is not in {HEADER}")
        text = text.replace(old, new)
    (out_dir / HEADER).write_text(text)
    lib = out_dir / "fused_attention_bwd.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "fused_attention_bwd.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def _kernel(lib_path) -> _build.CudaKernel:
    """The backward's entry point bound from another library, counted like FUSED_ATTENTION_BWD."""
    kernel = _build.CudaKernel(fa.FUSED_ATTENTION_BWD.source, fa.FUSED_ATTENTION_BWD.symbol,
                               fa.FUSED_ATTENTION_BWD.argtypes)
    lib = ctypes.CDLL(str(lib_path))
    kernel._fn = getattr(lib, kernel.symbol)
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._error_string = lib.vvt_error_string
    kernel._error_string.argtypes, kernel._error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return kernel


def main() -> int:
    import torch

    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA card")
    builds = {name: _build_cut(name) for name in CUTS}
    kernels = {}
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc for cut {name} exited {proc.returncode}:\n{log}")
        kernels[name] = _kernel(lib)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = ModelConfig()
    gen = torch.Generator().manual_seed(0)
    full = fa.FUSED_ATTENTION_BWD
    try:
        for name, B, S, padded, dtype, _ in chip_smoke.attention_cases(cfg):
            qkv, g, qs, ks, mask, _ = chip_smoke._attention_inputs(cfg, dev, gen, name, B, S, padded, dtype)
            if dtype != "bfloat16":
                continue
            times = {}
            for cut, kernel in kernels.items():
                fa.FUSED_ATTENTION_BWD = kernel
                times[cut] = chip_smoke.device_ms(
                    lambda: fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, cfg.num_heads))
            print("kernel-phases", json.dumps({"case": name, "B": B, "S": S, "device_ms": times}), flush=True)
    finally:
        fa.FUSED_ATTENTION_BWD = full
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
