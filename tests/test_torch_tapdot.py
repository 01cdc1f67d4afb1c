"""The port's tap-dot conv and pooled conv entry point against the JAX package's, on the CPU.

``conv3d_tapdot_plain`` (the arithmetic of the CUDA tap-dot kernel) is held
to the Pallas ``_tapdot_kernel`` run in interpret mode at the shapes of the
JAX package's own test, cut to one frame: one source, two sources, a large
output width (an input gradient's shape) and the pooled output. The port's
gate is held to ``tapdot_supported``; ``conv3d_cf_pooled`` to the JAX entry
point, forward and gradients; and the port's ``UNet3D`` with kt = 1 and wide
features, one level, on a 128-wide frame with ``VVT_TAPDOT=1`` to the JAX
``UNet3D(layout="cf")`` with the same weights (its kernels in interpret mode),
forward and input gradient. Inputs come from numpy seeds.

Tolerances, as max-abs error over max|reference|: bf16 outputs 1e-2 (bf16
operands, f32 sums, one output rounding: the bound of
``test_torch_conv3d.py``); f32 1e-4, gradients 1e-3 of the leaf's largest
value; the bf16 UNet 3e-2, the model bound of ``test_torch_model.py``, and
its input gradient 6e-2: that gradient passes seven convs and six GroupNorm +
SiLU VJPs in bf16, and the two packages differ by 3.3e-2 to 4.2e-2 of its
largest value at these seeds whether the knob is on or off on both sides. The
port's own result with the knob on is also held to its result with it off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.models.unet import UNet3D as JaxUNet3D
from video_vae_tpu.ops import conv3d as jconv
from video_vae_tpu_torch import load_jax_params
from video_vae_tpu_torch.models.unet import UNet3D
from video_vae_tpu_torch.ops import conv3d as tconv

BF16_TOL, F32_TOL, GRAD_TOL, MODEL_TOL, MODEL_GRAD_TOL = 1e-2, 1e-4, 1e-3, 3e-2, 6e-2


def _rel_err(ours, theirs):
    theirs = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


def _conv_data(shape, cins, cout, k, seed):
    rng = np.random.default_rng(seed)
    b, t, h, w = shape
    xs = [(0.5 * rng.standard_normal((b, t, c, h, w))).astype(np.float32) for c in cins]
    kernel = (rng.standard_normal((*k, sum(cins), cout)) / np.sqrt(np.prod(k) * sum(cins))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return xs, kernel, bias


@pytest.mark.parametrize(
    "cins,cout,pool",
    [([256], 128, False), ([256, 64], 128, False), ([128], 512, False), ([256], 128, True)],
)
def test_tapdot_plain_matches_pallas_interpret(cins, cout, pool):
    xs, kernel, bias = _conv_data((1, 1, 128, 128), cins, cout, (1, 3, 3), seed=sum(cins) + cout)
    jxs = tuple(jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    ref = jconv._conv3d_tapdot_cf(
        jxs if len(jxs) > 1 else jxs[0], jnp.asarray(kernel).astype(jnp.bfloat16), jnp.asarray(bias),
        interpret=True, pool=pool,
    )
    txs = [torch.from_numpy(x).bfloat16() for x in xs]
    out = tconv.conv3d_tapdot_plain(
        txs[0], txs[1] if len(txs) > 1 else None, torch.from_numpy(kernel).bfloat16(),
        torch.from_numpy(bias), pool=pool,
    )
    for ours, theirs in zip(out if pool else (out,), ref if pool else (ref,)):
        assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == tuple(theirs.shape)
        assert _rel_err(ours, theirs) <= BF16_TOL
    if pool:  # the pooled output is the 2x2 max of the full one
        assert torch.equal(out[1], tconv.max_pool_2x_cf(out[0]))


@pytest.mark.parametrize(
    "cins,cout,k,h,w,dtype,env",
    [
        ((128,), 128, (1, 3, 3), 128, 128, "bfloat16", "1"),
        ((128,), 128, (1, 3, 3), 128, 128, "bfloat16", "0"),  # the knob is off
        ((128, 128), 128, (1, 3, 3), 128, 128, "bfloat16", "1"),
        ((64, 64), 64, (1, 3, 3), 256, 256, "bfloat16", "1"),
        ((128,), 256, (1, 3, 3), 128, 128, "bfloat16", "1"),
        ((128,), 128, (3, 3, 3), 128, 128, "bfloat16", "1"),  # kt = 3
        ((128,), 128, (1, 3, 3), 64, 64, "bfloat16", "1"),  # a narrow frame
        ((64,), 128, (1, 3, 3), 128, 128, "bfloat16", "1"),  # too few input channels
        ((132,), 128, (1, 3, 3), 128, 128, "bfloat16", "1"),  # cin % 8
        ((128,), 12, (1, 3, 3), 128, 128, "bfloat16", "1"),  # cout % 8
        ((124, 12), 128, (1, 3, 3), 128, 128, "bfloat16", "1"),  # a source's channels % 8
        ((128,), 128, (1, 3, 3), 128, 128, "float32", "1"),  # f32 stays on the direct kernel
    ],
)
def test_tapdot_gate_matches_jax(cins, cout, k, h, w, dtype, env, monkeypatch):
    """The port's gate is the JAX package's: ``tapdot_supported`` and the
    per-source alignment of ``_conv3d_pallas_cf``, reached only for 2-byte
    dtypes (``_cf_auto_impl``). The JAX gate's VMEM tile search is a TPU
    budget with no counterpart here; it holds at every shape listed."""
    monkeypatch.setenv("VVT_TAPDOT", env)
    cin = sum(cins)
    theirs = (
        jnp.dtype(dtype).itemsize == 2
        and jconv.tapdot_supported(cin, cout, *k, h, w)
        and all(c % 8 == 0 for c in cins)
    )
    xs = [torch.empty((1, 1, c, h, w), dtype=getattr(torch, dtype), device="meta") for c in cins]
    kernel = torch.empty((*k, cin, cout), device="meta")
    ours = tconv.tapdot_supported(xs[0], xs[1] if len(xs) > 1 else None, kernel)
    assert ours == bool(theirs)
    assert ours == (env == "1" and k[0] == 1 and w >= 128 and cin >= 128 and cin % 8 == 0
                    and cout % 8 == 0 and all(c % 8 == 0 for c in cins) and dtype == "bfloat16")


def test_dispatch_takes_the_tapdot_version_when_the_gate_holds(monkeypatch):
    """On CPU tensors the dispatch takes the plain version of whichever kernel
    the gate picks, for the forward conv, the two-source conv and the input gradient."""
    calls = []
    real = tconv.conv3d_tapdot_plain
    monkeypatch.setattr(tconv, "conv3d_tapdot_plain", lambda *a, **k: (calls.append(a[2].shape), real(*a, **k))[1])
    xs, kernel, bias = _conv_data((1, 1, 8, 128), (64, 64), 128, (1, 3, 3), seed=5)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (*xs, kernel)]
    tb = torch.from_numpy(bias)
    for flag, expected in (("0", []), ("1", [(1, 3, 3, 128, 128)] * 2)):
        monkeypatch.setenv("VVT_TAPDOT", flag)
        calls.clear()
        y = tconv.conv3d_cf_cat2(*leaves, tb)
        grads = torch.autograd.grad(y.float().sum(), leaves)
        assert calls == expected  # the forward, then the input gradient (128 -> 128)
        assert all(torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_conv3d_cf_pooled_matches_jax(impl):
    """Forward and gradients of (full, pooled) against the JAX entry point: its
    XLA form at a small frame, and its Pallas kernel's fused pool epilogue in
    interpret mode at a 128-wide one (forward only: same backward)."""
    shape = (1, 2, 16, 24) if impl == "xla" else (1, 1, 32, 128)
    xs, kernel, bias = _conv_data(shape, (12,), 16, (3, 3, 3), seed=6)
    jargs = [jnp.asarray(a) for a in (xs[0], kernel, bias)]
    if impl == "pallas":
        jargs[:2] = [a.astype(jnp.bfloat16) for a in jargs[:2]]
    full_j, pooled_j = jconv.conv3d_cf_pooled(*jargs, impl, impl == "pallas")
    targs = [torch.from_numpy(a) for a in (xs[0], kernel, bias)]
    if impl == "pallas":
        targs[:2] = [a.bfloat16() for a in targs[:2]]
    leaves = [a.clone().requires_grad_() for a in targs]
    full, pooled = tconv.conv3d_cf_pooled(*leaves)
    tol = F32_TOL if impl == "xla" else BF16_TOL
    assert tuple(pooled.shape) == tuple(pooled_j.shape) == (*shape[:2], 16, shape[2] // 2, shape[3] // 2)
    assert _rel_err(full, full_j) <= tol and _rel_err(pooled, pooled_j) <= tol
    assert torch.equal(pooled, tconv.max_pool_2x_cf(full))
    if impl == "pallas":
        return

    def loss(x, k, b):
        full, pooled = jconv.conv3d_cf_pooled(x, k, b, "xla", False)
        return jnp.sum(full**2) + jnp.sum(pooled**3)

    refs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*jargs)
    grads = torch.autograd.grad(full.square().sum() + pooled.pow(3).sum(), leaves)
    for name, ours, theirs in zip(("x", "kernel", "bias"), grads, refs):
        assert ours.shape == tuple(theirs.shape) and _rel_err(ours, theirs) <= GRAD_TOL, name


def test_conv3d_cf_pooled_refuses_an_odd_frame():
    with pytest.raises(ValueError, match="even"):
        tconv.conv3d_cf_pooled(torch.zeros(1, 1, 4, 5, 8), torch.zeros(1, 3, 3, 4, 4), torch.zeros(4))


@pytest.mark.parametrize("base,dtype,tol", [(64, "bfloat16", MODEL_TOL), (128, "bfloat16", MODEL_TOL),
                                            (64, "float32", F32_TOL)])
def test_unet_on_the_tapdot_path_matches_jax(base, dtype, tol, monkeypatch):
    """kt = 1, one level, a 32 x 128 frame. At base width 64 the UpBlock's
    two-source conv (64 + 64 -> 64) passes the gate; at 128 every level-0 conv
    but the first does, and so do their input gradients. A float32 model stays
    on the direct conv on both sides."""
    monkeypatch.setenv("VVT_TAPDOT", "1")
    monkeypatch.setenv("VVT_PALLAS_INTERPRET", "1")
    channels, out_features = 8, 3
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    junet = JaxUNet3D(channels, base, 1, out_features, nnx.Rngs(0), temporal_kernel=1, remat=False,
                      layout="cf", dtype=jdt)
    params = random_params(junet, 21)
    set_jax_params(junet, params)
    unet = UNet3D(channels, base, 1, out_features, torch.Generator().manual_seed(0),
                  temporal_kernel=1, dtype=tdt)
    assert load_jax_params(unet, params) == len(params)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((1, 1, channels, 32, 128)).astype(np.float32)
    g = rng.standard_normal((1, 1, out_features, 32, 128)).astype(np.float32)

    def jax_loss(m, x):
        y = m(x)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), y

    (_, ref), ref_dx = nnx.jit(nnx.value_and_grad(jax_loss, argnums=1, has_aux=True))(
        junet, jnp.asarray(x).astype(jdt)
    )
    calls = []
    real = tconv.conv3d_tapdot_plain
    monkeypatch.setattr(tconv, "conv3d_tapdot_plain", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    out = unet(tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g).to(out.dtype))
    # forward convs and input gradients that pass the gate
    assert len(calls) == {(64, "bfloat16"): 1, (128, "bfloat16"): 7, (64, "float32"): 0}[base, dtype]
    assert tuple(out.shape) == tuple(ref.shape) == (1, 1, out_features, 32, 128)
    assert _rel_err(out, ref) <= tol
    assert _rel_err(dx, ref_dx) <= (MODEL_GRAD_TOL if dtype == "bfloat16" else GRAD_TOL)
    # the knob picks a kernel, not another function
    monkeypatch.setenv("VVT_TAPDOT", "0")
    out_off = unet(tx)
    (dx_off,) = torch.autograd.grad(out_off, tx, torch.from_numpy(g).to(out.dtype))
    assert (out - out_off).abs().max() <= BF16_TOL * out_off.abs().max()
    assert (dx - dx_off).abs().max() <= BF16_TOL * dx_off.abs().max()
