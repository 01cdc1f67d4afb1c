"""The port's plain masked attention against the JAX package's, on the CPU.

``flash_attention_plain`` and ``flash_attention_bwd_plain`` (the arithmetic of
the two CUDA kernels) are held to the Pallas kernels run in interpret mode
and to ``jax.grad`` through them; the autograd wrapper is held to the same
gradients; ``masked_attention(impl="xla")`` is held to
``jax.nn.dot_product_attention``. Inputs come from a numpy seed. The batch
(3 sequences x 2 heads) is no multiple of the Pallas batch tile of 8, and in
the masked cases sequence 1 has every key masked.

Tolerances, as max-abs error over max|reference|: f32 1e-5 (the same
arithmetic in another summation order), bf16 2e-2 (a few bf16 roundings of
values up to the reference's max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_vae_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from video_vae_tpu_torch.ops.attention import masked_attention
from video_vae_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S, H, D = 3, 16, 2, 16
CASES = [(dtype, masked) for dtype in TOL for masked in (False, True)]


def _inputs(dtype, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, S), bool)
        mask[0, S - 5:] = False
        mask[1, :] = False  # a fully masked row: uniform weights, not NaN
    tdt = getattr(torch, dtype)
    as_torch = [torch.from_numpy(a).to(tdt) for a in (q, k, v, g)]
    as_jax = [jnp.asarray(a).astype(dtype) for a in (q, k, v, g)]
    jmask = None if mask is None else jnp.asarray(mask).reshape(B, 1, 1, S)
    tmask = None if mask is None else torch.from_numpy(mask)
    return as_torch, tmask, as_jax, jmask


def _rel_err(ours, theirs):
    theirs = np.asarray(theirs.astype(jnp.float32))
    return np.abs(ours.float().numpy() - theirs).max() / np.abs(theirs).max()


@pytest.mark.parametrize("dtype,masked", CASES)
def test_flash_attention_plain_matches_pallas_interpret(dtype, masked):
    (q, k, v, _), mask, (jq, jk, jv, _), jmask = _inputs(dtype, masked)
    ref = jax.jit(lambda q, k, v: jax_flash_attention(q, k, v, jmask, True))(jq, jk, jv)
    out = flash_attention_plain(q, k, v, mask)
    assert out.dtype == q.dtype and out.shape == (B, S, H, D)
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, ref) <= TOL[dtype]
    if masked:  # uniform weights over all S keys where every key is masked
        uniform = v[1].float().mean(dim=0, keepdim=True).expand(S, H, D)
        assert (out[1].float() - uniform).abs().max() <= 2e-2 * uniform.abs().max()


@pytest.mark.parametrize("dtype,masked", CASES)
def test_flash_attention_bwd_plain_matches_jax_grad(dtype, masked):
    (q, k, v, g), mask, (jq, jk, jv, jg), jmask = _inputs(dtype, masked)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, jmask, True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    refs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    ours = flash_attention_bwd_plain(q, k, v, mask, g)
    for name, a, b, src in zip(("dq", "dk", "dv"), ours, refs, (q, k, v)):
        assert a.dtype == src.dtype
        assert _rel_err(a, b) <= TOL[dtype], name

    # the autograd wrapper reaches the same backward
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, None if mask is None else mask.reshape(B, 1, 1, S))
    grads = torch.autograd.grad(out, leaves, g)
    for a, b in zip(grads, ours):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,masked", CASES)
def test_masked_attention_xla_matches_jax_dot_product_attention(dtype, masked):
    (q, k, v, g), mask, (jq, jk, jv, jg), jmask = _inputs(dtype, masked, seed=1)

    def fwd(q, k, v):
        return jax.nn.dot_product_attention(q, k, v, mask=jmask)

    def loss(q, k, v):
        return jnp.sum(fwd(q, k, v).astype(jnp.float32) * jg.astype(jnp.float32))

    ref = jax.jit(fwd)(jq, jk, jv)
    refs = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = masked_attention(*leaves, mask, impl="xla")
    assert out.dtype == q.dtype
    assert _rel_err(out.detach(), ref) <= TOL[dtype]
    grads = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel_err(a, b) <= TOL[dtype], name


def test_masked_attention_pallas_is_flash_attention():
    (q, k, v, _), mask, _, _ = _inputs("float32", True)
    assert torch.equal(masked_attention(q, k, v, mask, impl="pallas"), flash_attention(q, k, v, mask))
    with pytest.raises(ValueError, match="unknown attention impl"):
        masked_attention(q, k, v, mask, impl="cudnn")
