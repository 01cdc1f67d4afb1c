"""The port's backward passes against the JAX package's, on the CPU.

* fused attention: the port's ``fused_qkv_attention_bwd_plain`` (the plain
  version of the CUDA backward kernel) against the JAX Pallas
  ``_fused_bwd_kernel`` in interpret mode and against ``jax.vjp`` of the JAX
  reference chain, and against ``torch.autograd`` of the port's plain forward;
* conv: dx, dW and db of the port's ``conv3d_cf``/``conv3d_cf_cat2`` against
  ``jax.grad`` of the JAX ones, and ``conv3d_wgrad_plain`` against the JAX
  Pallas ``_wgrad_kernel`` in interpret mode and ``torch.autograd``;
* the LayerNorm and GroupNorm+SiLU hand-derived backwards against ``jax.grad``.

Inputs are drawn with numpy and given to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.ops.conv3d import _conv3d_wgrad_pallas_cf
from video_vae_tpu.ops.conv3d import conv3d_cf as jax_conv3d_cf
from video_vae_tpu.ops.conv3d import conv3d_cf_cat2 as jax_conv3d_cf_cat2
from video_vae_tpu.ops.flash_attention import _reference_fused_chain
from video_vae_tpu.ops.flash_attention import fused_qkv_attention as jax_fused_qkv_attention
from video_vae_tpu.ops.norm import group_norm_cf as jax_group_norm_cf
from video_vae_tpu.ops.norm import layer_norm as jax_layer_norm
from video_vae_tpu.ops.rope import rope_tables as jax_rope_tables
from video_vae_tpu_torch.ops.conv3d import (
    conv3d_cf,
    conv3d_cf_cat2,
    conv3d_cf_plain,
    conv3d_wgrad_plain,
)
from video_vae_tpu_torch.ops.flash_attention import (
    fused_qkv_attention,
    fused_qkv_attention_bwd_plain,
    fused_qkv_attention_plain,
)
from video_vae_tpu_torch.ops.norm import group_norm_cf, layer_norm

# the bound the JAX package holds its interpret-mode Pallas backward to
# against the XLA chain (tests/test_flash_attention.py): the kernel's f32
# segment matmuls and packed softmax reorder every sum
PALLAS_BWD_TOL = 5e-3
# f32, the same arithmetic in another order
F32_TOL = 1e-4


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- attention


def _attention_inputs(B, S, H, D, masked, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, S, 3 * H * D)).astype(np.float32)
    q_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    k_scale = (1.0 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    mask = None
    if masked:  # each sequence keeps a different number of leading keys
        lengths = rng.integers(1, S + 1, B)
        mask = np.arange(S)[None, :] < lengths[:, None]
    return qkv, q_scale, k_scale, mask, g


def _port_bwd(qkv, q_scale, k_scale, mask, g, H, alpha=1.0):
    dqkv, dqs, dks = fused_qkv_attention_bwd_plain(
        _t(qkv), _t(q_scale), _t(k_scale), None if mask is None else _t(mask), _t(g), H,
        10000.0, alpha,
    )
    return dqkv.numpy(), dqs.numpy(), dks.numpy()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize(
    "B,S,H",
    [
        (8, 16, 8),  # JAX packed small-S path (H·S = 128 lanes), the train step's temporal shape
        (3, 128, 2),  # JAX per-head path; B = 3 needs block padding
    ],
)
def test_attention_bwd_plain_matches_jax_kernel_interpret(B, S, H, masked):
    D = 64
    qkv, q_scale, k_scale, mask, g = _attention_inputs(B, S, H, D, masked, seed=B + S + H)
    jmask = None if mask is None else jnp.asarray(mask.reshape(B, 1, 1, S))

    def fwd(x, qs, ks):
        return jax_fused_qkv_attention(x, qs, ks, jmask, H, 10000.0, 1.0, True)

    _, vjp = jax.vjp(fwd, jnp.asarray(qkv), jnp.asarray(q_scale), jnp.asarray(k_scale))
    ref = jax.jit(vjp)(jnp.asarray(g))
    for name, ours, theirs in zip(("dqkv", "dq_scale", "dk_scale"), _port_bwd(qkv, q_scale, k_scale, mask, g, H), ref):
        assert _rel_err(ours, theirs) <= PALLAS_BWD_TOL, name


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("B,S,H,D", [(3, 24, 4, 16), (2, 16, 8, 64)])
def test_attention_bwd_plain_matches_jax_reference_chain(B, S, H, D, masked):
    qkv, q_scale, k_scale, mask, g = _attention_inputs(B, S, H, D, masked, seed=7 * S + H)
    alpha = 2.0  # NTK-scaled RoPE tables
    cos, sin = jax_rope_tables(S, D, 10000.0, alpha)
    jmask = None if mask is None else jnp.asarray(mask.reshape(B, 1, 1, S))
    _, vjp = jax.vjp(
        lambda x, qs, ks: _reference_fused_chain(x, qs, ks, jmask, H, cos, sin),
        jnp.asarray(qkv), jnp.asarray(q_scale), jnp.asarray(k_scale),
    )
    ref = vjp(jnp.asarray(g))
    ours = _port_bwd(qkv, q_scale, k_scale, mask, g, H, alpha)
    for name, a, b in zip(("dqkv", "dq_scale", "dk_scale"), ours, ref):
        assert _rel_err(a, b) <= F32_TOL, name


@pytest.mark.parametrize("masked", [True, False])
def test_attention_bwd_plain_matches_torch_autograd(masked):
    """The hand-written backward against autograd of the plain forward."""
    B, S, H, D = 4, 12, 2, 32
    qkv, q_scale, k_scale, mask, g = _attention_inputs(B, S, H, D, masked, seed=3)
    m = None if mask is None else _t(mask)
    leaves = [_t(qkv).double().requires_grad_(), _t(q_scale).double().requires_grad_(),
              _t(k_scale).double().requires_grad_()]
    out = fused_qkv_attention_plain(*leaves, m, H)
    ref = torch.autograd.grad(out, leaves, _t(g).double())
    ours = fused_qkv_attention_bwd_plain(
        leaves[0].detach(), leaves[1].detach(), leaves[2].detach(), m, _t(g).double(), H
    )
    for a, b in zip(ours, ref):
        assert _rel_err(a.numpy(), b.numpy()) <= F32_TOL


def test_attention_autograd_function_routes_to_plain_backward():
    """``fused_qkv_attention`` under autograd returns the plain backward's gradients."""
    B, S, H, D = 2, 8, 2, 64
    qkv, q_scale, k_scale, mask, g = _attention_inputs(B, S, H, D, True, seed=11)
    leaves = [_t(x).requires_grad_() for x in (qkv, q_scale, k_scale)]
    out = fused_qkv_attention(*leaves, _t(mask.reshape(B, 1, 1, S)), H)
    grads = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(grads, _port_bwd(qkv, q_scale, k_scale, mask, g, H)):
        np.testing.assert_array_equal(a.numpy(), b)


# --------------------------------------------------------------------- conv


def _conv_data(shape, cins, cout, k, seed):
    rng = np.random.default_rng(seed)
    b, t, h, w = shape
    xs = [rng.standard_normal((b, t, c, h, w)).astype(np.float32) for c in cins]
    kernel = (rng.standard_normal((*k, sum(cins), cout)) / np.sqrt(np.prod(k) * sum(cins))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    g = rng.standard_normal((b, t, cout, h, w)).astype(np.float32)
    return xs, kernel, bias, g


@pytest.mark.parametrize(
    "cins,cout,k",
    [
        ((6,), 6, (3, 7, 7)),  # the tiny config's patch mixer
        ((5,), 3, (1, 3, 5)),
        ((4, 4), 4, (3, 3, 3)),  # an UpBlock skip concat, never materialised
        ((8, 8), 6, (3, 3, 3)),
    ],
)
def test_conv_grads_match_jax(cins, cout, k):
    xs, kernel, bias, g = _conv_data((2, 4, 10, 12), cins, cout, k, seed=sum(cins) * cout)

    if len(cins) == 1:
        def jfn(*a):
            return jax_conv3d_cf(*a)
    else:
        def jfn(*a):
            return jax_conv3d_cf_cat2(*a)
    jargs = [jnp.asarray(x) for x in (*xs, kernel, bias)]
    _, vjp = jax.vjp(jfn, *jargs)
    ref = vjp(jnp.asarray(g))

    leaves = [_t(x).requires_grad_() for x in (*xs, kernel, bias)]
    out = conv3d_cf(*leaves) if len(cins) == 1 else conv3d_cf_cat2(*leaves)
    ours = torch.autograd.grad(out, leaves, _t(g))
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape
        assert _rel_err(a.numpy(), b) <= F32_TOL, i


@pytest.mark.parametrize(
    "cins,k",
    [
        ((12,), (3, 3, 3)),  # the shapes of the JAX package's own wgrad test
        ((12,), (3, 7, 7)),
        ((8, 8), (3, 3, 3)),  # two sources, the concat never built
    ],
)
def test_wgrad_plain_matches_jax_kernel_interpret(cins, k):
    rng = np.random.default_rng(sum(k) + len(cins))
    cout, shape = 16, (1, 3, 128, 128)
    bf16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    xs = [bf16((0.5 * rng.standard_normal((shape[0], shape[1], c, *shape[2:]))).astype(np.float32)) for c in cins]
    g = bf16((0.5 * rng.standard_normal((shape[0], shape[1], cout, *shape[2:]))).astype(np.float32))
    jx = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in xs]
    ref = _conv3d_wgrad_pallas_cf(
        jx[0] if len(jx) == 1 else tuple(jx), jnp.asarray(g.float().numpy(), jnp.bfloat16), *k,
        interpret=True,
    )
    ours = conv3d_wgrad_plain(xs[0], xs[1] if len(xs) == 2 else None, g, *k)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    # bf16 operands, exact products, f32 sums over 49k pixels in two orders
    assert _rel_err(ours.numpy(), np.asarray(ref)) <= F32_TOL


def test_wgrad_plain_matches_torch_autograd():
    xs, kernel, bias, g = _conv_data((2, 3, 9, 11), (5, 3), 4, (3, 5, 3), seed=1)
    x1, x2 = (_t(x).double() for x in xs)
    w = _t(kernel).double().requires_grad_()
    (ref,) = torch.autograd.grad(conv3d_cf_plain(x1, x2, w, _t(bias)), [w], _t(g).double())
    ours = conv3d_wgrad_plain(x1, x2, _t(g).double(), 3, 5, 3)
    assert _rel_err(ours.numpy(), ref.numpy()) <= F32_TOL


# -------------------------------------------------------------------- norms


@pytest.mark.parametrize("use_bias", [True, False])
def test_layer_norm_bwd_matches_jax(use_bias):
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((3, 5, 48))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(48)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(48)).astype(np.float32) if use_bias else None
    g = rng.standard_normal(x.shape).astype(np.float32)

    args = [jnp.asarray(a) for a in (x, scale) + ((bias,) if use_bias else ())]
    _, vjp = jax.vjp(lambda x, s, *b: jax_layer_norm(x, s, b[0] if b else None), *args)
    ref = vjp(jnp.asarray(g))

    leaves = [_t(a).requires_grad_() for a in (x, scale) + ((bias,) if use_bias else ())]
    out = layer_norm(leaves[0], leaves[1], leaves[2] if use_bias else None)
    ours = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(ours, ref):
        assert _rel_err(a.numpy(), b) <= F32_TOL


def test_group_norm_silu_bwd_matches_jax():
    rng = np.random.default_rng(5)
    x = (1.0 + rng.standard_normal((2, 3, 8, 6, 10))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(8)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x, s, b: jax_group_norm_cf(x, s, b, 4, silu=True),
        *(jnp.asarray(a) for a in (x, scale, bias)),
    )
    ref = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_() for a in (x, scale, bias)]
    out = group_norm_cf(*leaves, 4, silu=True)
    ours = torch.autograd.grad(out, leaves, _t(g))
    for a, b in zip(ours, ref):
        assert _rel_err(a.numpy(), b) <= F32_TOL
