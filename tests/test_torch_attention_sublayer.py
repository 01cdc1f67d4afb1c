"""The port's attention sublayer against the JAX package's, on the CPU.

``fused_attention_sublayer_plain`` (the arithmetic of the CUDA kernel) and the
backward of the port's ``fused_attention_sublayer`` are held to the Pallas
sublayer kernel run in interpret mode and to ``jax.grad`` through its custom
VJP, at the shape of the JAX package's own sublayer tests (4 sequences of 16
tokens, width 128, 2 heads of 32; the last quarter of the keys masked).
Inputs and parameters come from a numpy seed.

Tolerances, as max-abs error over max|reference|: the forward and its two
residuals 2e-2 (the JAX package's own test holds the kernel to its module at
3e-2), every gradient 3e-2 of its leaf's largest value (6e-2 there). With an
f32 x both sides still round the GEMM operands to bf16, so the same bounds
hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_vae_tpu.ops import flash_attention as jfa
from video_vae_tpu_torch.ops.flash_attention import (
    fused_attention_sublayer,
    fused_attention_sublayer_plain,
)

FWD_TOL, GRAD_TOL = 2e-2, 3e-2
B, S, C, H, QKV = 4, 16, 128, 2, 64
NAMES = ("x", "ln_scale", "ln_bias", "wqkv", "bqkv", "q_scale", "k_scale", "wout", "bout")


def _setup(dtype, masked, seed=3):
    rng = np.random.default_rng(seed)
    d = QKV // H
    arrays = dict(
        x=rng.standard_normal((B, S, C)),
        ln_scale=1 + 0.2 * rng.standard_normal(C),
        ln_bias=0.2 * rng.standard_normal(C),
        wqkv=rng.standard_normal((C, 3 * QKV)) / np.sqrt(C),
        bqkv=0.2 * rng.standard_normal(3 * QKV),
        q_scale=1 + 0.2 * rng.standard_normal(d),
        k_scale=1 + 0.2 * rng.standard_normal(d),
        wout=rng.standard_normal((QKV, C)) / np.sqrt(QKV),
        bout=0.2 * rng.standard_normal(C),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    g = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((B, S), bool)
        mask[:, : S * 3 // 4] = True
    jargs = [jnp.asarray(arrays[n]) for n in NAMES]
    jargs[0] = jargs[0].astype(dtype)
    targs = [torch.from_numpy(arrays[n]) for n in NAMES]
    targs[0] = targs[0].to(getattr(torch, dtype))
    jmask = None if mask is None else jnp.asarray(mask).reshape(B, 1, 1, S)
    tmask = None if mask is None else torch.from_numpy(mask)
    return jargs, jmask, targs, tmask, g


def _rel_err(ours, theirs):
    theirs = np.asarray(theirs.astype(jnp.float32))
    return np.abs(ours.float().numpy() - theirs).max() / np.abs(theirs).max()


CASES = [("bfloat16", True), ("bfloat16", False), ("float32", True)]


@pytest.mark.parametrize("dtype,masked", CASES)
def test_sublayer_plain_forward_and_residuals_match_pallas_interpret(dtype, masked):
    jargs, jmask, targs, tmask, _ = _setup(dtype, masked)

    def jax_fwd(*args):  # the training variant: y and the two residuals
        return jfa._attn_sublayer_impl(
            *args, jmask, H, 10000.0, 1.0, True, save_residuals=True
        )

    refs = jax.jit(jax_fwd)(*jargs)
    outs = fused_attention_sublayer_plain(*targs, tmask, H)
    for name, ours, theirs in zip(("y", "qkv", "o"), outs, refs):
        assert ours.dtype == targs[0].dtype and ours.shape == theirs.shape, name
        assert _rel_err(ours, theirs) <= FWD_TOL, name
    # the inference variant is the same y
    y = jax.jit(lambda *a: jfa.fused_attention_sublayer(*a, jmask, H, 10000.0, 1.0, True))(*jargs)
    with torch.no_grad():
        ours = fused_attention_sublayer(*targs, None if tmask is None else tmask[:, None, None, :], H)
    assert torch.equal(ours, outs[0])
    assert _rel_err(ours, y) <= FWD_TOL


@pytest.mark.parametrize("dtype,masked", CASES)
def test_sublayer_gradients_match_jax(dtype, masked):
    jargs, jmask, targs, tmask, g = _setup(dtype, masked)
    jg = jnp.asarray(g)

    def loss(*args):
        y = jfa.fused_attention_sublayer(*args, jmask, H, 10000.0, 1.0, True)
        return jnp.sum(y.astype(jnp.float32) * jg)

    refs = jax.jit(jax.grad(loss, argnums=tuple(range(len(NAMES)))))(*jargs)
    leaves = [t.clone().requires_grad_() for t in targs]
    y = fused_attention_sublayer(*leaves, tmask, H)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(y.dtype))
    for name, ours, theirs, leaf in zip(NAMES, grads, refs, targs):
        assert ours.dtype == leaf.dtype and ours.shape == leaf.shape, name
        assert _rel_err(ours, theirs) <= GRAD_TOL, name
