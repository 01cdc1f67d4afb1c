"""The port's plain fused attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (both its packed
small-S path and its per-head path) and its plain reference chain; the same
numpy inputs go through the port's ``fused_qkv_attention``, which on a CPU
tensor is the plain PyTorch version of the CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_vae_tpu.ops.flash_attention import _reference_fused_chain
from video_vae_tpu.ops.flash_attention import fused_qkv_attention as jax_fused_qkv_attention
from video_vae_tpu.ops.rope import rope_tables as jax_rope_tables
from video_vae_tpu_torch.ops.flash_attention import fused_qkv_attention
from video_vae_tpu_torch.ops.rope import rope_tables

# f32: the same arithmetic in another order (the JAX kernel takes per-head
# statistics through segment matmuls and divides after P.V)
F32_TOL = 1e-4
# bf16: the JAX kernel rounds P to bf16 before P.V, as the port's CUDA kernel
# does; the plain version, which a CPU tensor takes, keeps P in f32
BF16_TOL = 2e-2


def _inputs(B, S, H, D, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, S, 3 * H * D)).astype(np.float32)
    q_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    k_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    mask = None
    if masked:  # each sequence keeps a different number of leading keys
        lengths = rng.integers(1, S + 1, B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).reshape(B, 1, 1, S)
    return qkv, q_scale, k_scale, mask


def _rel_err(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "B,S,H,dtype,tol",
    [
        (8, 16, 8, "float32", F32_TOL),  # JAX packed small-S path (H·S = 128 lanes)
        (8, 16, 8, "bfloat16", BF16_TOL),
        (2, 128, 2, "float32", F32_TOL),  # JAX per-head path (S >= 128)
    ],
)
def test_plain_matches_jax_kernel_interpret(B, S, H, dtype, tol, masked):
    D = 64
    qkv, q_scale, k_scale, mask = _inputs(B, S, H, D, masked, seed=S + H)
    jdt = jnp.dtype(dtype)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = jax.jit(
        lambda x, qs, ks, m: jax_fused_qkv_attention(x, qs, ks, m, H, 10000.0, 1.0, True)
    )(jnp.asarray(qkv, jdt), jnp.asarray(q_scale), jnp.asarray(k_scale), jmask)
    ref = np.asarray(ref.astype(jnp.float32))

    tdt = getattr(torch, dtype)
    out = fused_qkv_attention(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(q_scale), torch.from_numpy(k_scale),
        None if mask is None else torch.from_numpy(mask), H,
    )
    assert out.dtype == tdt and out.shape == (B, S, H * D)
    assert _rel_err(out.float().numpy(), ref) <= tol


@pytest.mark.parametrize("masked", [True, False])
def test_plain_matches_jax_reference_chain(masked):
    B, S, H, D = 3, 24, 4, 16
    qkv, q_scale, k_scale, mask = _inputs(B, S, H, D, masked, seed=5)
    cos, sin = jax_rope_tables(S, D, 10000.0, 2.0)
    ref = _reference_fused_chain(
        jnp.asarray(qkv), jnp.asarray(q_scale), jnp.asarray(k_scale),
        None if mask is None else jnp.asarray(mask), H, cos, sin,
    )
    out = fused_qkv_attention(
        torch.from_numpy(qkv), torch.from_numpy(q_scale), torch.from_numpy(k_scale),
        None if mask is None else torch.from_numpy(mask.reshape(B, S)), H, 10000.0, 2.0,
    )
    assert _rel_err(out.numpy(), np.asarray(ref)) <= F32_TOL
    # the NTK tables themselves
    c, s = rope_tables(S, D, 10000.0, 2.0)
    np.testing.assert_allclose(c.numpy(), np.asarray(cos), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sin), atol=1e-5)
