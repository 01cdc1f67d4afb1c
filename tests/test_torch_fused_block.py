"""The port's one-kernel MLP sublayer against the JAX package's, on the CPU.

``fused_mlp_sublayer_plain`` (the arithmetic of the CUDA kernel) is held to
the Pallas MLP kernel run in interpret mode (y and the two bf16 residuals)
and to the JAX op's CPU chain; the backward of the port's
``fused_mlp_sublayer`` to ``jax.grad`` through the JAX custom VJP. Then the
path the knob opens: ``apply_mlp``, a ``FactoredAttention`` block, the serving
pass and one train step at ``tiny_config`` with ``VVT_MLP_FUSED=1`` on both
sides (the JAX kernels in interpret mode through ``VVT_PALLAS_INTERPRET=1``),
alone and together with ``VVT_ATTN_SUBLAYER=1``. Inputs and parameters come
from numpy seeds.

Tolerances, as max-abs error over max|reference|: the forward and its
residuals 2e-2 (one bf16 rounding of h, a and y at other places of the f32
sums), every gradient 3e-2 of its leaf's largest value, the bounds the
attention sublayer's tests use. With an f32 x both sides still round the
GEMM operands to bf16, so the same bounds hold; the model-level checks take
the bf16 bound of ``test_torch_model.py`` (3e-2) for that reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_attention_paths import _draws, _inputs, _jax_loss_and_grads, _models
from test_torch_model import random_params, set_jax_params

from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.layers import MLP as JaxMLP
from video_vae_tpu.models.layers import FactoredAttention as JaxFactoredAttention
from video_vae_tpu.models.layers import _apply_mlp
from video_vae_tpu.ops import fused_block as jfb
from video_vae_tpu.train.step import make_reconstruct_fn
from video_vae_tpu_torch import DynamicHParams, load_jax_params, reconstruct, tiny_config
from video_vae_tpu_torch.models.layers import MLP, FactoredAttention, apply_mlp
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops.fused_block import fused_mlp_sublayer, fused_mlp_sublayer_plain
from video_vae_tpu_torch.train.step import loss_and_grads

FWD_TOL, GRAD_TOL, MODEL_TOL = 2e-2, 3e-2, 3e-2
MIN_MARGIN = 0.02
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")
# (B, S, C, F, x dtype): the JAX tests' shape, an f32 x, and a ragged row count
CASES = [(4, 16, 128, 256, "bfloat16"), (4, 16, 128, 256, "float32"), (1, 13, 128, 256, "bfloat16")]


def _setup(b, s, c, f, dtype, seed=4):
    rng = np.random.default_rng(seed)
    arrays = dict(
        x=rng.standard_normal((b, s, c)),
        ln_scale=1 + 0.2 * rng.standard_normal(c),
        ln_bias=0.2 * rng.standard_normal(c),
        w1=rng.standard_normal((c, f)) / np.sqrt(c),
        b1=0.2 * rng.standard_normal(f),
        w2=rng.standard_normal((f, c)) / np.sqrt(f),
        b2=0.2 * rng.standard_normal(c),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    g = rng.standard_normal((b, s, c)).astype(np.float32)
    jargs = [jnp.asarray(arrays[n]) for n in NAMES]
    jargs[0] = jargs[0].astype(dtype)
    targs = [torch.from_numpy(arrays[n]) for n in NAMES]
    targs[0] = targs[0].to(getattr(torch, dtype))
    return jargs, targs, g


def _rel_err(ours, theirs):
    theirs = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


def _set_path(monkeypatch, sublayer=False):
    monkeypatch.setenv("VVT_MLP_FUSED", "1")
    monkeypatch.setenv("VVT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VVT_ATTN_SUBLAYER", "1" if sublayer else "0")


@pytest.mark.parametrize("b,s,c,f,dtype", CASES)
def test_mlp_plain_forward_and_residuals_match_pallas_interpret(b, s, c, f, dtype):
    jargs, targs, _ = _setup(b, s, c, f, dtype)
    refs = jfb._mlp_pallas(*jfb._prep(*jargs), interpret=True, save_residuals=True)
    outs = fused_mlp_sublayer_plain(*targs)
    assert outs[0].dtype == targs[0].dtype and outs[0].shape == (b, s, c)
    assert outs[1].dtype == outs[2].dtype == torch.bfloat16
    assert outs[1].shape == (b * s, c) and outs[2].shape == (b * s, f)
    for name, ours, theirs in zip(("y", "xa", "h"), outs, refs):
        assert _rel_err(ours.reshape(theirs.shape), theirs) <= FWD_TOL, name


@pytest.mark.parametrize("b,s,c,f,dtype", CASES)
def test_mlp_sublayer_matches_jax_cpu_chain(b, s, c, f, dtype):
    """Off the TPU the JAX op runs ``mlp_reference_chain``; without autograd the
    port's op is the inference variant and gives the plain version's y."""
    jargs, targs, _ = _setup(b, s, c, f, dtype)
    ref = jax.jit(jfb.fused_mlp_sublayer)(*jargs)
    with torch.no_grad():
        y = fused_mlp_sublayer(*targs)
    assert torch.equal(y, fused_mlp_sublayer_plain(*targs)[0])
    assert y.dtype == targs[0].dtype and _rel_err(y, ref) <= FWD_TOL


@pytest.mark.parametrize("b,s,c,f,dtype", CASES)
def test_mlp_sublayer_gradients_match_jax(b, s, c, f, dtype):
    jargs, targs, g = _setup(b, s, c, f, dtype)
    jg = jnp.asarray(g)

    def loss(*args):
        return jnp.sum(jfb.fused_mlp_sublayer(*args, True).astype(jnp.float32) * jg)

    refs = jax.jit(jax.grad(loss, argnums=tuple(range(len(NAMES)))))(*jargs)
    leaves = [t.clone().requires_grad_() for t in targs]
    y = fused_mlp_sublayer(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(y.dtype))
    for name, ours, theirs, leaf in zip(NAMES, grads, refs, targs):
        assert ours.dtype == leaf.dtype and ours.shape == leaf.shape, name
        assert _rel_err(ours, theirs) <= GRAD_TOL, name


@pytest.mark.parametrize("mode,params_need_grad,training", [
    (torch.enable_grad, True, True),
    (torch.enable_grad, False, False),
    (torch.no_grad, True, False),
    (torch.inference_mode, True, False),
])
def test_mlp_sublayer_variant_follows_the_grad_mode(mode, params_need_grad, training, monkeypatch):
    """The training variant (the one that writes the residuals) is asked for
    only where a graph is recorded: a model's parameters require gradients in
    a serving pass too, and that pass takes the inference variant."""
    from video_vae_tpu_torch.ops import fused_block as fb

    asked = []
    plain = fb.fused_mlp_sublayer_plain
    real = fb._MLPSublayer.forward

    def forward(ctx, *args):
        asked.append(args[-1])
        return real(ctx, *args)

    monkeypatch.setattr(fb._MLPSublayer, "forward", staticmethod(forward))
    _, targs, _ = _setup(1, 13, 128, 256, "float32")
    x, *params = targs
    params = [p.clone().requires_grad_(params_need_grad) for p in params]
    with mode():
        y = fused_mlp_sublayer(x, *params)
    assert asked == [training]
    assert y.requires_grad == training
    assert torch.equal(y.detach(), plain(*targs)[0])


def test_mlp_sublayer_rounds_unlike_the_module_chain():
    """The kernel adds the f32 branch to f32(x) and rounds once; ``x + mlp(x)``
    rounds the branch first. On a bf16 x the two differ in some elements."""
    _, targs, _ = _setup(4, 16, 128, 256, "bfloat16")
    mlp = MLP(128, 256, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    with torch.no_grad():
        for p, t in zip(
            (mlp.norm.scale, mlp.norm.bias, mlp.linear1.kernel, mlp.linear1.bias,
             mlp.linear2.kernel, mlp.linear2.bias), targs[1:]):
            p.copy_(t)
        fused = fused_mlp_sublayer(*targs)
        chain = targs[0] + mlp(targs[0])
    assert _rel_err(fused, jnp.asarray(chain.float().numpy())) <= FWD_TOL
    assert not torch.equal(fused, chain)


# ---- the path VVT_MLP_FUSED opens in the model ------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches_jax(dtype, monkeypatch):
    _set_path(monkeypatch)
    c, f, b, s = 48, 64, 3, 8
    jmlp = JaxMLP(c, f, nnx.Rngs(0), dtype=jnp.dtype(dtype))
    params = random_params(jmlp, 11)
    set_jax_params(jmlp, params)
    mlp = MLP(c, f, torch.Generator().manual_seed(0), dtype=getattr(torch, dtype))
    assert load_jax_params(mlp, params) == len(params) == 6
    x = np.random.default_rng(12).standard_normal((b, s, c)).astype(np.float32)
    ref = nnx.jit(_apply_mlp)(jmlp, jnp.asarray(x).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        out = apply_mlp(mlp, tx)
        monkeypatch.setenv("VVT_MLP_FUSED", "0")  # read at every call
        chain = apply_mlp(mlp, tx)
    assert out.shape == (b, s, c) and out.dtype == tx.dtype
    assert _rel_err(out, ref) <= FWD_TOL
    assert torch.equal(chain, tx + mlp(tx)) and not torch.equal(chain, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factored_attention_block_matches_jax_on_the_mlp_path(dtype, monkeypatch):
    _set_path(monkeypatch)
    c, f, heads, qkv, b, t, hw = 48, 64, 2, 32, 2, 8, 4
    jblock = JaxFactoredAttention(c, f, heads, qkv, nnx.Rngs(0), attention_impl="fused",
                                  dtype=jnp.dtype(dtype))
    params = random_params(jblock, 13)
    set_jax_params(jblock, params)
    block = FactoredAttention(c, f, heads, qkv, torch.Generator().manual_seed(0),
                              attention_impl="fused", dtype=getattr(torch, dtype))
    assert load_jax_params(block, params) == len(params)
    x = np.random.default_rng(14).standard_normal((b, t, hw, c)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, 5:] = False
    ref = nnx.jit(lambda m, x, k: m(x, k))(
        jblock, jnp.asarray(x).astype(dtype), jnp.asarray(mask).reshape(b, 1, 1, t)
    )
    with torch.no_grad():
        out = block(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask))
    assert out.shape == (b, t, hw, c)
    assert _rel_err(out, ref) <= MODEL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sublayer", [False, True])
def test_reconstruct_matches_jax_on_the_mlp_path(sublayer, dtype, monkeypatch):
    _set_path(monkeypatch, sublayer)
    video, mask = _inputs()
    jax_model, port = _models(dtype, attention_impl="fused")
    jdt = jnp.dtype(dtype)
    ref = make_reconstruct_fn(jdt)(jax_model, jnp.asarray(video), jnp.asarray(mask))
    ref = np.asarray(ref.astype(jnp.float32))
    j_prob = np.asarray(nnx.jit(lambda m, v, f: m.encode(v.astype(jdt), f)[2])(
        jax_model, jnp.asarray(video), jnp.asarray(mask)).astype(jnp.float32))
    out = reconstruct(port, video, mask, device="cpu")
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    assert np.abs(out.float().numpy() - ref).max() / np.abs(ref).max() <= MODEL_TOL
    with torch.inference_mode():
        prob = port.encode(
            torch.from_numpy(video).to(port.cfg.compute_dtype()), torch.from_numpy(mask)
        )[2].float().numpy()
    clear = (np.abs(j_prob - 0.5) > MIN_MARGIN) & (np.abs(prob - 0.5) > MIN_MARGIN)
    assert clear.sum() >= clear.size - 2  # at most a near-tie or two left out
    np.testing.assert_array_equal((prob >= 0.5)[clear], (j_prob >= 0.5)[clear])
    # the knob changes the result: the default path rounds elsewhere
    monkeypatch.setenv("VVT_MLP_FUSED", "0")
    assert not torch.equal(out, reconstruct(port, video, mask, device="cpu"))


@pytest.mark.parametrize("sublayer", [False, True])
def test_train_step_matches_jax_on_the_mlp_path(sublayer, monkeypatch):
    """Loss, metrics and every gradient of one f32 train step; the products of
    the fused sublayers run on bf16 operands on both sides, hence the bf16 bound."""
    _set_path(monkeypatch, sublayer)
    video, mask = _inputs()
    jcfg = jax_tiny_config(dtype="float32", attention_impl="fused")
    jax_model, port = _models("float32", attention_impl="fused")
    noise, uniforms = _draws(22, jax_model, video, mask, "float32", (4, 8, 1, 1))
    ref_metrics, ref_grads = _jax_loss_and_grads(jax_model, video, mask, 22, jcfg.loss)
    cfg = tiny_config(dtype="float32", attention_impl="fused")
    loss, metrics, grads = loss_and_grads(
        port, video, mask, DynamicHParams.default(), cfg.loss, None, noise=noise, uniforms=uniforms
    )
    assert set(metrics) == set(ref_metrics)
    for key, value in metrics.items():
        scale = 1.0 if key == "rl_loss" else abs(ref_metrics[key])  # rl_loss is 0 up to rounding
        value = float(value.detach())
        assert abs(value - ref_metrics[key]) <= MODEL_TOL * scale, (key, value, ref_metrics[key])
    names = [n.replace(".", "/") for n, _ in port.named_parameters()]
    assert set(names) == set(ref_grads)
    scale = max(np.abs(g).max() for g in ref_grads.values())
    # a conv bias under a one-channel-per-group GroupNorm has a zero gradient
    # on both sides up to rounding (see test_torch_attention_paths.py)
    vanishing = {
        f"{n}/conv/bias".replace(".", "/")
        for n, m in port.named_modules()
        if isinstance(m, ConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()
    }
    for pname, g in zip(names, grads):
        theirs = ref_grads[pname]
        if pname in vanishing:
            assert max(g.abs().max().item(), np.abs(theirs).max()) <= 1e-6 * scale, pname
            continue
        err = np.abs(g.numpy() - theirs).max()
        assert err <= MODEL_TOL * np.abs(theirs).max(), (pname, err, np.abs(theirs).max())
