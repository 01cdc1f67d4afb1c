"""What sets the pace of the bf16 attention kernels (#1, #3, #5, #6), of the
conv filter gradient (#4), of the MLP sublayer kernel (#8) and of the tap-dot
conv (#9).

    python3 -m video_vae_tpu_torch.utils.kernel_phases [--kernel 1|3|4|5|6|8|9] [--split]

from the root of the repository, on a machine with a CUDA card and nvcc.
It builds copies of the kernel's source (#3, the default:
``csrc/fused_attention_bwd.cu``; #5: ``csrc/flash_attention.cu``; #6:
``csrc/flash_attention_bwd.cu``; #8: ``csrc/fused_mlp.cu``; #9:
``csrc/conv3d_tapdot.cu``; #4: ``csrc/conv3d_wgrad.cu``, its bf16 wgmma
kernel's cuts in ``csrc/conv3d_wgrad_wg.cuh`` and the channels-last copy of
``csrc/channels_last.cuh``) with one phase of
its device code (its own headers: for #3 and #6 also the softmax backward
they share in ``csrc/fused_attention_mma_common.cuh``, for #5 the fused
forward's ``csrc/fused_attention_mma.cuh``, whose softmax it runs) cut out (a
loop that runs no times, a call that is skipped, a load replaced by a
constant; the outputs of a cut copy are wrong, only its time counts), all at
once, into ``video_vae_tpu_torch/_build/phases/``, and prints the device time
per call of each copy: for #3, #5 and #6 at each bf16 attention call of the
flagship train step (``chip_smoke.device_ms``; #3's spatial calls run the
wgmma tile block, ``TILE_WG_CUTS``, its temporal ones the mma.sync slab, the other
cuts), for #8 at its N = 8192 and N = 4096 calls, each of its three launches
(``chip_smoke.device_launch_ms``), for #9 at each
of its calls on the tap-dot model (b2 x 16 frames), the whole call and its
launches (the channels-last copies, the GEMM), for #4 at each bf16 conv of
the flagship's and the tap-dot model's train steps (b2 x 16 frames), the
whole call (the copy of g, the products, the reduce). ``--split`` takes the split
variant past 256 tokens instead, timed at the bf16 spatial calls of the
flagship's 512² serving pass and train step (S = 1024, b2 and b1; head dim
64): for #3 and #6 the backward's cuts, ``SPLIT_CUTS`` in
``csrc/attention_split_bwd.cuh`` (its query side's first walk, the dq
product, the dv and dk products, the ring's TMA loads, the exps); for #1
(``csrc/fused_attention.cu``, which ``--kernel 1`` takes only with
``--split``) and #5 the forward's, ``SPLIT_FWD_CUTS`` in
``csrc/attention_split_fwd.cuh`` (the P.V product, the exps, the ring's TMA
loads; #5's first walk; #1's LN + RoPE pass). The time a phase takes is the
full kernel's less the copy without it. Nothing here runs on import.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

from video_vae_tpu_torch.ops import _build, conv3d
from video_vae_tpu_torch.ops import flash_attention as fa
from video_vae_tpu_torch.ops import fused_block as fb

COMMON = "fused_attention_mma_common.cuh"
_NEVER = "S < 0"  # a condition no launch meets
_SIDE = "it < items; it += warps) {{  // {} side"
_CUT_SIDE = f"it < items && {_NEVER}; it += warps) {{"

# the query and key sides of #3 and of #6's slab blocks
SIDE_CUTS = {
    "no_query_side": [(_SIDE.format("query"), _CUT_SIDE)],
    "no_key_side": [(_SIDE.format("key"), _CUT_SIDE)],
    "no_sides": [(_SIDE.format("query"), _CUT_SIDE), (_SIDE.format("key"), _CUT_SIDE)],
}

# the channels-last copy's two loops (csrc/channels_last.cuh), run no times
_COPY_LOOP = "i < TILE * TILE / 8; i += THREADS) {"
_NO_COPY_LOOP = "i < TILE * TILE / 8 && C < 0; i += THREADS) {"

# #3's wgmma tile block (csrc/fused_attention_bwd_wg.cuh, the flagship's spatial calls at
# head dim 64, where every row array is resident and no ring streams): its TMA loads (the
# mbarriers expect no bytes; shared memory keeps what it held), the LN + RoPE of q and k,
# the query side's walks (statistics and dq~), the key side's walk (dv and dk~), the
# epilogues (dv's stores and both LN + RoPE backwards). Cut copies at head dim 128 are
# built but never run: its ring would wait on a walk cut out of the consumers.
TILE_WG_HEADER = "fused_attention_bwd_wg.cuh"
TILE_WG_CUTS = {
    "wg_no_tma_loads": [("mbar_expect_tx(qk_full, 2 * T * B64);", "mbar_expect_tx(qk_full, 0);"),
                        ("mbar_expect_tx(vg_full, 2 * T * B64);", "mbar_expect_tx(vg_full, 0);"),
                        *[(f"split_wg::load_tile<D, ROWS>({dst} + t * B64,",
                           f"if (S < 0) split_wg::load_tile<D, ROWS>({dst} + t * B64,")
                          for dst in ("q_s", "k_s", "v_s", "g_s")]],
    "wg_no_norm_rope": [("split_wg::norm_rope_own_q<D>(", "if (S < 0) split_wg::norm_rope_own_q<D>(")],
    "wg_no_query_walks": [("n < steps; ++n) {  // query side", "n < steps && S < 0; ++n) {")],
    "wg_no_key_walk": [("n < T; ++n) {  // key side", "n < T && S < 0; ++n) {")],
    "wg_no_epilogues": [("epilogue_staged<D>(du,", "if (S < 0) epilogue_staged<D>(du,"),
                        ("split_wg::store_rows<D, bf16>(dv,", "if (S < 0) split_wg::store_rows<D, bf16>(dv,")],
}

# kernel -> (source, its headers, the ops module and the name of its launch counter there,
# cuts: name -> [(text, replacement)])
KERNELS = {
    "3": ("fused_attention_bwd.cu", ("fused_attention_bwd_mma.cuh", COMMON, TILE_WG_HEADER), fa,
          "FUSED_ATTENTION_BWD", {
        "full": [],
        **SIDE_CUTS,
        "no_query_first_pass": [("c < (TWO_PASS ? chunks : 1); ++c) {", "c < (TWO_PASS ? 0 : 1); ++c) {")],
        "no_key_recompute": [("row_dots<D, 1>(st, kf, q_s, q0, 1);", "row_dots<D, 1>(st, kf, q_s, q0, 0);"),
                             ("row_dots<D, 1>(dt, vf, do_s, q0, 1);", "row_dots<D, 1>(dt, vf, do_s, q0, 0);")],
        "no_exp": [("exp2f(", "(")],
        "no_epilogues": [("    ln_rope_bwd<D>(d", f"    if ({_NEVER}) ln_rope_bwd<D>(d"),
                         ("    store_rows<D>(dv,", f"    if ({_NEVER}) store_rows<D>(dv,")],
        "no_epilogue_tables": [(f"__ldg(reinterpret_cast<const float2*>({t} + d0{hi}))", "make_float2(0.5f, 0.25f)")
                               for t in ("c", "sn") for hi in ("", " + D / 2")],
        **TILE_WG_CUTS,
    }),
    # the first walk over the keys (its products and exps), P.V, every exp, the
    # output's stores, the staging copies
    "5": ("flash_attention.cu", ("flash_attention_mma.cuh", "fused_attention_mma.cuh"), fa, "FLASH_ATTENTION", {
        "full": [],
        "no_first_walk": [("  if (two_pass) {\n    for (int c = 0; c < chunks; ++c) {",
                           f"  if (two_pass) {{\n    for (int c = 0; c < chunks && {_NEVER}; ++c) {{")],
        "no_pv": [("if (kk < steps) {", f"if (kk < steps && {_NEVER}) {{")],
        "no_exp": [("exp2f(", "(")],
        "no_stores": [("if (row0 + r < S)", f"if (row0 + r < S && {_NEVER})")],
        "no_staging": [("p < 3 * H * P; p += blockDim.x) {", f"p < 3 * H * P && {_NEVER}; p += blockDim.x) {{"),
                       ("i < s16; i += row_step)", f"i < s16 && {_NEVER}; i += row_step)")],
    }),
    # slab blocks (S <= 64): the sides; tile blocks (S > 64): the statistics, the
    # key side's rounds (its recompute of the scores and dP), the dq tiles
    "6": ("flash_attention_bwd.cu", ("flash_attention_bwd_mma.cuh", COMMON), fa, "FLASH_ATTENTION_BWD", {
        "full": [],
        **SIDE_CUTS,
        "no_stats": [("      bwd::online_chunk<D, TILE_KT>(", f"      if ({_NEVER}) bwd::online_chunk<D, TILE_KT>(")],
        "no_key_rounds": [("    key_round<D>(q_s,", f"    if ({_NEVER}) key_round<D>(q_s,")],
        "no_key_recompute": [("row_dots<D, 1>(st, f, q_s, i0, 1);", "row_dots<D, 1>(st, f, q_s, i0, 0);"),
                             ("row_dots<D, 1>(dt, f, do_s, i0, 1);", "row_dots<D, 1>(dt, f, do_s, i0, 0);")],
        "no_dq_tiles": [("it < (q1 - q0) / 16 * (D / 16); it += warps) {",
                         f"it < (q1 - q0) / 16 * (D / 16) && {_NEVER}; it += warps) {{")],
        "no_exp": [("exp2f(", "(")],
        "no_epilogues": [("    bwd::store_rows<D>(d", f"    if ({_NEVER}) bwd::store_rows<D>(d")],
        "no_staging": [("e < (part1 - part0) * n * unit * P; e += blockDim.x) {",
                        f"e < (part1 - part0) * n * unit * P && {_NEVER}; e += blockDim.x) {{")],
    }),
    # the GEMMs' products, the finishing of the epilogue (staging read back, SiLU or
    # residual, 16-byte stores: the stores' cut leaves the accumulators staged), the SiLU
    "8": ("fused_mlp.cu", ("gemm_sm90.cuh",), fb, "FUSED_MLP", {
        "full": [],
        "no_products": [("Wgmma<BN>::mma(d,", "if (K < 0) Wgmma<BN>::mma(d,")],
        "no_finish": [("if (row >= N || col >= M) continue;", "if (row >= N || col >= M || N > 0) continue;")],
        "no_silu": [("silu8(v);", "(void)v;")],
    }),
    # the products, the input's TMA boxes (the weights' still arrive), the
    # channels-last copy (its launches stay, empty), the epilogue's stores
    "9": ("conv3d_tapdot.cu", ("conv3d_tapdot.cu", "channels_last.cuh"), conv3d, "CONV3D_TAPDOT", {
        "full": [],
        "no_products": [("WgmmaKK<WG_N>::mma(d,", "if (g.H < 0) WgmmaKK<WG_N>::mma(d,")],
        "no_tap_loads": [("mbar_expect_tx(&b_full[b.slot], b_bytes);", "mbar_expect_tx(&b_full[b.slot], 0);"),
                         ("for (int q = 0; q < panels; ++q) {", "for (int q = 0; q < panels && g.H < 0; ++q) {")],
        "no_copy": [(_COPY_LOOP, _NO_COPY_LOOP)],
        "no_epilogue": [("for (int j = 0; j < WG_N / 8; ++j) {", "for (int j = 0; j < WG_N / 8 && g.H < 0; ++j) {")],
    }),
    # the bf16 wgmma filter gradient (csrc/conv3d_wgrad_wg.cuh): the channels-last
    # copy of g (its launch stays, empty), the products, the ring's TMA loads (each
    # slot's `full` mbarrier expects no bytes; the slots keep what they held: the
    # "constant loads"), the reduce (its launch skipped)
    "4": ("conv3d_wgrad.cu", ("conv3d_wgrad_wg.cuh", "channels_last.cuh"), conv3d, "CONV3D_WGRAD", {
        "full": [],
        "no_copy": [(_COPY_LOOP, _NO_COPY_LOOP)],
        "no_products": [("WgmmaT<NB>::mma(d[m], smem_desc(", "if (geo.H < 0) WgmmaT<NB>::mma(d[m], smem_desc(")],
        "constant_loads": [("mbar_expect_tx(&full[slot], bytes);", "mbar_expect_tx(&full[slot], 0);"),
                           ("tma_load_5d(a_dst + j * box_bytes,", "if (geo.H < 0) tma_load_5d(a_dst + j * box_bytes,"),
                           ("tma_load_3d(b_dst + j * NB * 128,", "if (geo.H < 0) tma_load_3d(b_dst + j * NB * 128,"),
                           ("tma_load_4d(b_dst, x_map,", "if (geo.H < 0) tma_load_4d(b_dst, x_map,"),
                           *[(f"tma_load_{d}d({dst}, &x{i}_map,", f"if (geo.H < 0) tma_load_{d}d({dst}, &x{i}_map,")
                             for d in (3, 4) for i, dst in ((1, "dst"), (2, "dst + geo.c1p * 128"))]],
        "no_reduce": [("  wgrad_wg_reduce_kernel<<<", "  if (total < 0) wgrad_wg_reduce_kernel<<<")],
    }),
}


# the split backward's phases (csrc/attention_split_bwd.cuh, #3 and #6 past 256 tokens):
# the query side's first walk (its steps, products and exps: the walk runs no times),
# the query side's dq product, the key side's dv and dk products, the ring's TMA
# loads (each stage's `full` mbarrier expects no bytes; the stages keep what they
# held), every exp
SPLIT_HEADER = "attention_split_bwd.cuh"
SPLIT_CUTS = {
    "full": [],
    "no_walk1": [("steps = 2 * tiles;", "steps = tiles;"),
                 ("const bool first_walk = n < tiles;", "const bool first_walk = false;")],
    "no_dq": [("mma_rows<D, KT>(dq, ds, k_tile);", f"if ({_NEVER}) mma_rows<D, KT>(dq, ds, k_tile);")],
    "no_dvdk": [("mma_rows<D, QT>(dv, pa, do_tile);", f"if ({_NEVER}) mma_rows<D, QT>(dv, pa, do_tile);"),
                ("mma_rows<D, QT>(dk, da, q_tile);", f"if ({_NEVER}) mma_rows<D, QT>(dk, da, q_tile);")],
    "no_ring_loads": [("mbar_expect_tx(&full[stage], 2 * KB);", "mbar_expect_tx(&full[stage], 0);"),
                      ("mbar_expect_tx(&full[stage], 2 * QB);", "mbar_expect_tx(&full[stage], 0);"),
                      ("load_tile<D, KT>(st, &maps.", f"if ({_NEVER}) load_tile<D, KT>(st, &maps."),
                      ("load_tile<D, KT>(st + KB, &maps.", f"if ({_NEVER}) load_tile<D, KT>(st + KB, &maps."),
                      ("load_tile<D, QT>(st, &maps.", f"if ({_NEVER}) load_tile<D, QT>(st, &maps."),
                      ("load_tile<D, QT>(st + QB, &maps.", f"if ({_NEVER}) load_tile<D, QT>(st + QB, &maps.")],
    "no_exp": [("exp2f(", "(")],
}

# the split forward's phases (csrc/attention_split_fwd.cuh, #1 and #5 past 256 tokens):
# the P.V product, every exp, the ring's TMA loads (each stage's `full` mbarrier
# expects no bytes; the stages keep what they held), #5's first walk (its statistics
# launch; the second reads what the output holds; #5 only), #1's LN + RoPE pass (#1
# only: the forward reads the workspace as it stands)
SPLIT_FWD_HEADER = "attention_split_fwd.cuh"
SPLIT_FWD_CUTS = {
    "full": [],
    "no_pv": [("  mma_rows<D, KT>(o, p, v_tile);", "  if (KT < 0) mma_rows<D, KT>(o, p, v_tile);")],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    "no_ring_loads": [("mbar_expect_tx(&full[stage], with_v ? 2 * KB : KB);", "mbar_expect_tx(&full[stage], 0);"),
                      ("load_tile<D, KT>(st, &maps.k,", f"if ({_NEVER}) load_tile<D, KT>(st, &maps.k,"),
                      ("if (with_v) load_tile<D, KT>(", f"if (with_v && {_NEVER}) load_tile<D, KT>(")],
    "no_walk1": [("const cudaError_t err = run(&split_wg_fwd_kernel<D, STATS>);",
                  "const cudaError_t err = a.S < 0 ? run(&split_wg_fwd_kernel<D, STATS>) : cudaSuccess;")],
    "no_norm_rope": [("cudaError_t err = split::launch_norm_rope<D>(",
                      f"cudaError_t err = cudaSuccess;\n  if ({_NEVER}) split::launch_norm_rope<D>(")],
}
SPLIT_FWD_ONLY = {"no_walk1": "5", "no_norm_rope": "1"}  # the cuts that reach one kernel

# --split: kernel -> (source, the ops module and the name of its launch counter there)
SPLIT_KERNELS = {
    "1": ("fused_attention.cu", fa, "FUSED_ATTENTION"),
    "3": ("fused_attention_bwd.cu", fa, "FUSED_ATTENTION_BWD"),
    "5": ("flash_attention.cu", fa, "FLASH_ATTENTION"),
    "6": ("flash_attention_bwd.cu", fa, "FLASH_ATTENTION_BWD"),
}


def split_cuts(kernel: str):
    """(header, cuts) of the split variant of an attention kernel: the backward's
    for #3 and #6, the forward's for #1 and #5 (each without the other's own cut)."""
    if kernel in ("3", "6"):
        return SPLIT_HEADER, SPLIT_CUTS
    return SPLIT_FWD_HEADER, {name: edits for name, edits in SPLIT_FWD_CUTS.items()
                              if SPLIT_FWD_ONLY.get(name, kernel) == kernel}


def _build_cut(source: str, headers, tag: str, name: str, edits):
    """Start nvcc on a copy of csrc with the cut applied; (process, library path).

    Each replacement applies to every one of the kernel's ``headers`` that holds
    the text, and must be found in at least one."""
    out_dir = _build.BUILD_DIR / "phases" / tag / name
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, out_dir)
    texts = {h: (out_dir / h).read_text() for h in headers}
    for old, new in edits:
        if not any(old in t for t in texts.values()):
            raise RuntimeError(f"cut {name}: {old!r} is in none of {headers}")
        texts = {h: t.replace(old, new) for h, t in texts.items()}
    for h, t in texts.items():
        (out_dir / h).write_text(t)
    lib = out_dir / source.replace(".cu", ".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out_dir / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def _kernel(counter: _build.CudaKernel, lib_path) -> _build.CudaKernel:
    """The entry point of ``counter`` bound from another library, counted like it."""
    kernel = _build.CudaKernel(counter.source, counter.symbol, counter.argtypes)
    lib = ctypes.CDLL(str(lib_path))
    kernel._fn = getattr(lib, kernel.symbol)
    kernel._fn.argtypes, kernel._fn.restype = kernel.argtypes, ctypes.c_int
    kernel._error_string = lib.vvt_error_string
    kernel._error_string.argtypes, kernel._error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return kernel


def _attention_calls(kernel_id, dev, split=False):
    """(case, its fields, call) of each bf16 attention call of the flagship train step,
    or with ``split`` each bf16 spatial call (S > 256) of its 512² serving pass and
    train step."""
    import torch

    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    cfg = chip_smoke.long_config() if split else ModelConfig()
    H, D = cfg.num_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(0)
    for name, B, S, padded, dtype, _ in chip_smoke.attention_cases(cfg):
        if dtype != "bfloat16" or (split and S <= fa.TILE_MAX_SEQ):
            continue
        qkv, g, qs, ks, mask, _ = chip_smoke._attention_inputs(cfg, dev, gen, name, B, S, padded, dtype)
        if kernel_id == "1":
            def call(qkv=qkv, qs=qs, ks=ks, mask=mask):
                return fa.fused_qkv_attention_cuda(qkv, qs, ks, mask, H)
        elif kernel_id == "3":
            def call(qkv=qkv, qs=qs, ks=ks, mask=mask, g=g):
                return fa.fused_qkv_attention_bwd_cuda(qkv, qs, ks, mask, g, H)
        else:  # q and k contiguous, v a view into qkv, as the "pallas" path hands them over
            q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
            q, k, g_heads = q.contiguous(), k.contiguous(), g.reshape(B, S, H, D)

            def call(q=q, k=k, v=v, mask=mask, g_heads=g_heads):
                if kernel_id == "5":
                    return fa.flash_attention_cuda(q, k, v, mask)
                return fa.flash_attention_bwd_cuda(q, k, v, mask, g_heads)
        yield name, {"B": B, "S": S}, call


def _mlp_calls(dev):
    """(case, its fields, call) of the MLP kernel's calls in a b2 x 16f serving pass
    (inference variant, N = 8192) and a b1 x 16f train step (training variant,
    N = 8192 and 4096), on f32 weights as the model hands them over."""
    import torch

    import chip_smoke
    from video_vae_tpu_torch import ModelConfig

    cfg = ModelConfig()
    C, F = cfg.embed_dim, cfg.mlp_dim
    gen = torch.Generator().manual_seed(30)
    rn = lambda *shape: torch.randn(*shape, generator=gen).to(dev)  # noqa: E731
    params = (1 + 0.2 * rn(C), 0.2 * rn(C), rn(C, F) / C**0.5, 0.2 * rn(F), 0.1 * rn(F, C) / F**0.5, 0.2 * rn(C))
    tokens = chip_smoke.FRAMES * cfg.num_patches
    for n, save in ((chip_smoke.BATCH * tokens, False), (chip_smoke.BATCH * tokens, True),
                    (chip_smoke.TRAIN_BATCH * tokens, True)):
        x = rn(n, C).to(torch.bfloat16)

        def call(x=x, save=save):
            return fb.fused_mlp_sublayer_cuda(x, *params, save_residuals=save)
        yield f"N={n} {'training' if save else 'inference'}", {"N": n}, call


def _tapdot_calls(dev):
    """(case, its fields, call) of each of the tap-dot kernel's calls on the tap-dot
    model at b2 x 16 frames (``chip_smoke.tapdot_launches``), with its launches' names."""
    import torch

    import chip_smoke

    gen = torch.Generator().manual_seed(31)
    forward, dgrad = chip_smoke.tapdot_launches(chip_smoke.tapdot_model_config())
    for cins, cout, k, h, w in dict.fromkeys([*forward, *dgrad]):
        xs = [torch.randn(chip_smoke.BATCH, chip_smoke.FRAMES, c, h, w, generator=gen).to(dev, torch.bfloat16)
              for c in cins]
        kernel = (torch.randn(*k, sum(cins), cout, generator=gen) / (sum(cins) * 9) ** 0.5).to(dev, torch.bfloat16)
        bias = torch.randn(cout, generator=gen).to(dev)
        x2 = xs[1] if len(xs) == 2 else None

        def call(xs=xs, x2=x2, kernel=kernel, bias=bias):
            return conv3d.conv3d_tapdot_cuda(xs[0], x2, kernel, bias)
        names = chip_smoke.TAPDOT_LAUNCHES[-len(xs) - 1:]
        yield f"{'+'.join(map(str, cins))}->{cout} @{h}x{w}", {"launches": names}, call


def _wgrad_calls(dev):
    """(case, its fields, call) of #4 at each bf16 conv of the flagship's and the
    tap-dot model's train steps (b2 x 16 frames: the UNet's 2 rollouts)."""
    import torch

    from video_vae_tpu_torch.utils.wgrad_times import cases

    gen = torch.Generator().manual_seed(32)
    for name in ("flagship", "tapdot"):
        for model, b, t, conv, h, w, cins, cout, k in cases(name):
            xs = [torch.randn(b, t, c, h, w, generator=gen).to(dev, torch.bfloat16) for c in cins]
            g = torch.randn(b, t, cout, h, w, generator=gen).to(dev, torch.bfloat16)
            x2 = xs[1] if len(xs) == 2 else None

            def call(xs=xs, x2=x2, g=g, k=k):
                return conv3d.conv3d_wgrad_cuda(xs[0], x2, g, *k)
            yield f"{model} {conv}", {"shape": [b, t, list(cins), h, w, cout, list(k)]}, call


def main(argv=None) -> int:
    import torch

    import chip_smoke

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(set(KERNELS) | set(SPLIT_KERNELS)), default="3")
    parser.add_argument("--split", action="store_true",
                        help="#1, #3, #5 or #6: the split variant's phases at 512²")
    args = parser.parse_args(argv)
    kernel_id, split = args.kernel, args.split
    if split and kernel_id not in SPLIT_KERNELS:
        raise SystemExit(f"--split takes --kernel {', '.join(sorted(SPLIT_KERNELS))}")
    if not split and kernel_id not in KERNELS:
        raise SystemExit(f"--kernel {kernel_id} takes --split")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA card")
    if split:
        source, module, attr = SPLIT_KERNELS[kernel_id]
        header, cuts = split_cuts(kernel_id)
        headers, tag = (header,), kernel_id + "-split"
    else:
        source, headers, module, attr, cuts = KERNELS[kernel_id]
        tag = kernel_id
    full = getattr(module, attr)
    builds = {name: _build_cut(source, headers, tag, name, edits) for name, edits in cuts.items()}
    kernels = {}
    for name, (proc, lib) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc for cut {name} exited {proc.returncode}:\n{log}")
        kernels[name] = _kernel(full, lib)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    calls = {"4": lambda: _wgrad_calls(dev), "8": lambda: _mlp_calls(dev), "9": lambda: _tapdot_calls(dev)}.get(
        kernel_id, lambda: _attention_calls(kernel_id, dev, split))()
    try:
        for name, fields, call in calls:
            times = {}
            for cut, kernel in kernels.items():
                setattr(module, attr, kernel)
                if kernel_id == "8":
                    times[cut] = chip_smoke.device_launch_ms(call, chip_smoke.MLP_LAUNCHES)
                elif kernel_id == "9":  # the whole call, then its launches
                    times[cut] = [chip_smoke.device_ms(call), chip_smoke.device_launch_ms(call, fields["launches"])]
                else:
                    times[cut] = chip_smoke.device_ms(call)
            print("kernel-phases", json.dumps({"kernel": kernel_id, "split": split, "case": name, **fields,
                                               "device_ms": times}), flush=True)
    finally:
        setattr(module, attr, full)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
