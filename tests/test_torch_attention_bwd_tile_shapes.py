"""The port's fused attention backward at the shapes of #3's wgmma tile kernel
(``csrc/fused_attention_bwd_wg.cuh``: 64 < S <= 256 at head dims 64 and 128)
against the JAX package, on the CPU.

The card runs the kernel; here a CPU tensor takes its plain version,
``fused_qkv_attention_bwd_plain``, which the card holds the kernel to. It is
held to ``jax.vjp`` of the JAX package's reference chain
(``_reference_fused_chain``, f32 throughout) at S = 196 (the MAE's spatial
call, a partial last 64-row tile) and 256 (the flagship's), head dims 64 and
128, masked and open, and to the JAX Pallas ``_fused_bwd_kernel`` in
interpret mode at S = 196, head dim 64, as ``tests/test_torch_backward.py``
holds it at S = 16 and 128. Masks keep at least one key in every sequence:
the JAX chains give a row with no key no gradient through their ``where``.
Inputs are drawn with numpy and given to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.ops.flash_attention import _reference_fused_chain
from video_vae_tpu.ops.flash_attention import fused_qkv_attention as jax_fused_qkv_attention
from video_vae_tpu.ops.rope import rope_tables as jax_rope_tables
from video_vae_tpu_torch.ops.flash_attention import fused_attention_bwd_plan, fused_qkv_attention_bwd_plain

# f32, the same arithmetic in another order
F32_TOL = 1e-4
# the bound the JAX package holds its interpret-mode Pallas backward to against the XLA chain
PALLAS_BWD_TOL = 5e-3

CASES = [(2, 196, 2, 64), (2, 256, 2, 64), (2, 196, 1, 128), (2, 256, 1, 128)]


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _inputs(B, S, H, D, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, S, 3 * H * D)).astype(np.float32)
    q_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    k_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    mask = None
    if masked:  # one sequence keeps a single key, the other a prefix past the last full 64-row tile
        mask = np.arange(S)[None, :] < np.array([1, S - 3])[:, None]
    return qkv, q_scale, k_scale, mask, g


def _port(qkv, q_scale, k_scale, mask, g, H, alpha=1.0):
    t = torch.from_numpy
    out = fused_qkv_attention_bwd_plain(t(qkv), t(q_scale), t(k_scale), None if mask is None else t(mask), t(g), H,
                                        10000.0, alpha)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("B,S,H,D", CASES)
def test_tile_shape_bwd_matches_jax_reference_chain(B, S, H, D, masked):
    assert fused_attention_bwd_plan(B, S, H, D) == ("tile_wg", 1, 12)  # the card's wgmma tile kernel
    qkv, q_scale, k_scale, mask, g = _inputs(B, S, H, D, masked, seed=S + D)
    alpha = 2.0  # NTK-scaled RoPE tables
    cos, sin = jax_rope_tables(S, D, 10000.0, alpha)
    jmask = None if mask is None else jnp.asarray(mask.reshape(B, 1, 1, S))
    _, vjp = jax.vjp(
        lambda x, qs, ks: _reference_fused_chain(x, qs, ks, jmask, H, cos, sin),
        jnp.asarray(qkv), jnp.asarray(q_scale), jnp.asarray(k_scale),
    )
    ref = jax.jit(vjp)(jnp.asarray(g))
    for name, ours, theirs in zip(("dqkv", "dq_scale", "dk_scale"), _port(qkv, q_scale, k_scale, mask, g, H, alpha),
                                  ref):
        assert _rel_err(ours, theirs) <= F32_TOL, name


@pytest.mark.parametrize("masked", [True, False])
def test_tile_shape_bwd_matches_jax_kernel_interpret(masked):
    B, S, H, D = 2, 196, 2, 64
    qkv, q_scale, k_scale, mask, g = _inputs(B, S, H, D, masked, seed=11)
    jmask = None if mask is None else jnp.asarray(mask.reshape(B, 1, 1, S))

    def fwd(x, qs, ks):
        return jax_fused_qkv_attention(x, qs, ks, jmask, H, 10000.0, 1.0, True)

    _, vjp = jax.vjp(fwd, jnp.asarray(qkv), jnp.asarray(q_scale), jnp.asarray(k_scale))
    ref = jax.jit(vjp)(jnp.asarray(g))
    for name, ours, theirs in zip(("dqkv", "dq_scale", "dk_scale"), _port(qkv, q_scale, k_scale, mask, g, H), ref):
        assert _rel_err(ours, theirs) <= PALLAS_BWD_TOL, name
