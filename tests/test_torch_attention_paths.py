"""Every attention path of the port's model against the JAX package's, on the CPU.

``ModelConfig(attention_impl=...)`` picks ``"fused"``, ``"xla"`` or ``"pallas"``
in both packages, and ``VVT_ATTN_SUBLAYER=1`` (with ``"fused"``) routes each
block's attention sublayer through the one-kernel sublayer. The same
numpy-drawn weights and inputs go through both, at ``tiny_config``: the
``Attention`` module alone, the serving pass, and one train step's loss,
metrics and gradients. Off the TPU the JAX ``"pallas"`` path takes its XLA
chain, so ``"xla"`` and ``"pallas"`` share one JAX reference; the JAX sublayer
kernel runs in interpret mode (``VVT_PALLAS_INTERPRET=1``).

Also here: the ``"ste"`` selection mode (train and eval forward with the JAX
draws injected), ``round_ste``'s gradient, ``scan_rollout_decode`` on = off,
and the eval step's metrics.

Bounds are those of ``test_torch_model.py`` and ``test_torch_train_step.py``:
f32 1e-4 of the reference's max (gradients 1e-3 of their leaf's max), bf16
3e-2. The sublayer rounds its GEMM operands to bf16 inside an f32 model, so
its f32 runs are held to the bf16 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_model import random_params, set_jax_params

from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.layers import Attention as JaxAttention
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.step import _loss_fn, make_eval_step, make_reconstruct_fn
from video_vae_tpu_torch import (
    DynamicHParams,
    VideoVAE,
    eval_step,
    load_jax_params,
    reconstruct,
    tiny_config,
)
from video_vae_tpu_torch.models.layers import Attention
from video_vae_tpu_torch.models.unet import ConvBlock3D
from video_vae_tpu_torch.ops.ste import gumbel_sigmoid_sample, round_ste
from video_vae_tpu_torch.train.step import loss_and_grads

SEED = 10
F32_TOL, GRAD_F32_TOL, BF16_TOL = 1e-4, 1e-3, 3e-2
MIN_MARGIN = 0.02  # decisions are compared only where no probability is a near-tie
# (name, attention_impl, sublayer): the paths of the port
PATHS = [("xla", "xla", False), ("pallas", "pallas", False), ("sublayer", "fused", True)]


def _set_path(monkeypatch, sublayer):
    if sublayer:
        monkeypatch.setenv("VVT_ATTN_SUBLAYER", "1")
        monkeypatch.setenv("VVT_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("VVT_ATTN_SUBLAYER", raising=False)


def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0  # the last 3 frames of clip 1 are padding
    return video, mask


def _models(dtype, **overrides):
    """(JAX model, port) with the same numpy-drawn parameters."""
    jcfg = jax_tiny_config(dtype=dtype, **overrides).model
    jax_model = nnx.jit(lambda: JaxVideoVAE(jcfg, nnx.Rngs(0, sampling=1)))()
    params = random_params(jax_model, SEED)
    set_jax_params(jax_model, params)
    port = VideoVAE(tiny_config(dtype=dtype, **overrides).model, device="cpu")
    assert load_jax_params(port, params) == len(params)
    return jax_model, port


def _rel_err(ours, theirs):
    theirs = np.asarray(jnp.asarray(theirs).astype(jnp.float32))
    return np.abs(ours.detach().float().numpy() - theirs).max() / np.abs(theirs).max()


# ---- the Attention module alone --------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("impl", ["fused", "xla", "pallas"])
def test_attention_module_matches_jax(impl, dtype, tol):
    C, H, QKV, B, S = 48, 2, 32, 3, 8
    jattn = JaxAttention(C, H, QKV, nnx.Rngs(0), attention_impl=impl, dtype=jnp.dtype(dtype))
    params = random_params(jattn, SEED)
    set_jax_params(jattn, params)
    attn = Attention(C, H, QKV, torch.Generator().manual_seed(0), attention_impl=impl,
                     dtype=getattr(torch, dtype))
    assert load_jax_params(attn, params) == len(params)
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 5:] = False
    ref = nnx.jit(lambda m, x, k: m(x, k))(
        jattn, jnp.asarray(x).astype(dtype), jnp.asarray(mask).reshape(B, 1, 1, S)
    )
    with torch.no_grad():
        out = attn(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(mask))
    assert out.shape == (B, S, C)
    assert _rel_err(out, ref) <= tol


def test_rope_tables_first_made_in_inference_mode_serve_autograd():
    """The serving pass runs under inference_mode and caches the tables; a
    train step on the unfused chain then multiplies them into its graph."""
    from video_vae_tpu_torch.ops.rope import apply_rope, rope_tables

    seq = 11  # a length no other test caches first
    with torch.inference_mode():
        cos, _ = rope_tables(seq, 16)
    assert not cos.is_inference()
    q = torch.randn(2, seq, 2, 16, requires_grad=True)
    qr, kr = apply_rope(q, q)
    (g,) = torch.autograd.grad((qr * kr).sum(), q)
    assert torch.isfinite(g).all()


# ---- the serving pass -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reconstructions():
    """The JAX serving pass per (dtype, sublayer), computed once."""
    cache = {}

    def get(dtype, sublayer):
        if (dtype, sublayer) not in cache:
            video, mask = _inputs()
            jax_model, _ = _models(dtype, attention_impl="fused" if sublayer else "xla")
            jdt = jnp.dtype(dtype)
            ref = make_reconstruct_fn(jdt)(jax_model, jnp.asarray(video), jnp.asarray(mask))
            prob = nnx.jit(lambda m, v, f: m.encode(v.astype(jdt), f)[2])(
                jax_model, jnp.asarray(video), jnp.asarray(mask)
            )
            cache[dtype, sublayer] = (
                np.asarray(ref.astype(jnp.float32)), np.asarray(prob.astype(jnp.float32))
            )
        return cache[dtype, sublayer]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,impl,sublayer", PATHS)
def test_reconstruct_matches_jax_on_each_path(name, impl, sublayer, dtype, monkeypatch,
                                              jax_reconstructions):
    _set_path(monkeypatch, sublayer)
    ref, j_prob = jax_reconstructions(dtype, sublayer)
    video, mask = _inputs()
    _, port = _models(dtype, attention_impl=impl)
    assert port.encoder.layers[0].TemporalAttention.attention_impl == impl
    out = reconstruct(port, video, mask, device="cpu")
    tol = F32_TOL if dtype == "float32" and not sublayer else BF16_TOL
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    assert np.abs(out.float().numpy() - ref).max() / np.abs(ref).max() <= tol
    with torch.inference_mode():
        prob = port.encode(
            torch.from_numpy(video).to(port.cfg.compute_dtype()), torch.from_numpy(mask)
        )[2].float().numpy()
    assert np.abs(j_prob - 0.5).min() > MIN_MARGIN  # no decision is a tie
    np.testing.assert_array_equal(prob >= 0.5, j_prob >= 0.5)


# ---- one train step's loss, metrics and gradients ---------------------------


def _draws(seed, jax_model, video, mask, dtype, uniform_shape):
    """The JAX forward's two draws for ``nnx.Rngs(sampling=seed)``, as torch tensors."""
    rngs = nnx.Rngs(sampling=seed)
    k_noise, k_uniform = rngs.sampling(), rngs.sampling()
    logvar = nnx.jit(lambda m, v, f: m.encode(v, f)[1])(
        jax_model, jnp.asarray(video, dtype), jnp.asarray(mask)
    )
    noise = jax.random.normal(k_noise, logvar.shape, dtype)
    uniforms = jax.random.uniform(k_uniform, uniform_shape, jnp.float32)
    noise = torch.from_numpy(np.array(noise.astype(jnp.float32))).to(getattr(torch, dtype))
    return noise, torch.from_numpy(np.array(uniforms))


def _jax_loss_and_grads(jax_model, video, mask, seed, loss_cfg):
    @nnx.jit
    def run(model, video, mask, rngs, hp):
        def f(model, rngs):
            return _loss_fn(model, video, mask, rngs, hp, loss_cfg, None)

        (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
        return metrics, grads

    metrics, grads = run(jax_model, jnp.asarray(video), jnp.asarray(mask),
                         nnx.Rngs(sampling=seed), JaxDynamicHParams.default())
    grads = {"/".join(map(str, p)): np.asarray(v.get_value()) for p, v in grads.flat_state()}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX f32 loss, metrics and gradients per sublayer flag, computed once."""
    cache = {}

    def get(sublayer):
        if sublayer not in cache:
            video, mask = _inputs()
            jcfg = jax_tiny_config(dtype="float32", attention_impl="fused" if sublayer else "xla")
            jax_model, _ = _models("float32", attention_impl="fused" if sublayer else "xla")
            draws = _draws(22, jax_model, video, mask, "float32", (4, 8, 1, 1))
            cache[sublayer] = (*_jax_loss_and_grads(jax_model, video, mask, 22, jcfg.loss), draws)
        return cache[sublayer]

    return get


@pytest.mark.parametrize("name,impl,sublayer", PATHS)
def test_train_step_matches_jax_on_each_path(name, impl, sublayer, monkeypatch, jax_steps):
    _set_path(monkeypatch, sublayer)
    ref_metrics, ref_grads, (noise, uniforms) = jax_steps(sublayer)
    video, mask = _inputs()
    cfg = tiny_config(dtype="float32", attention_impl=impl)
    _, port = _models("float32", attention_impl=impl)
    loss, metrics, grads = loss_and_grads(
        port, video, mask, DynamicHParams.default(), cfg.loss, None, noise=noise, uniforms=uniforms
    )
    tol, grad_tol = (BF16_TOL, BF16_TOL) if sublayer else (F32_TOL, GRAD_F32_TOL)
    assert set(metrics) == set(ref_metrics)
    for key, value in metrics.items():
        scale = 1.0 if key == "rl_loss" else abs(ref_metrics[key])  # rl_loss is 0 up to rounding
        value = float(value.detach())
        assert abs(value - ref_metrics[key]) <= tol * scale, (key, value, ref_metrics[key])
    names = [n.replace(".", "/") for n, _ in port.named_parameters()]
    assert set(names) == set(ref_grads)
    scale = max(np.abs(g).max() for g in ref_grads.values())
    # A conv bias whose GroupNorm has one channel per group shifts that group
    # by a constant, which the norm removes: its gradient is 0 on both sides
    # up to rounding, and is held to that instead.
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
        assert err <= grad_tol * np.abs(theirs).max(), (pname, err, np.abs(theirs).max())


# ---- "ste" mode, round_ste, scan_rollout_decode, the eval step --------------


def test_round_ste_rounds_and_passes_gradients_through():
    x = torch.tensor([0.2, 0.5, 0.7, 1.5, 2.5], requires_grad=True)
    y = round_ste(x)
    assert torch.equal(y.detach(), torch.tensor([0.0, 0.0, 1.0, 2.0, 2.0]))  # ties to even
    (g,) = torch.autograd.grad(y, x, torch.arange(5.0))
    assert torch.equal(g, torch.arange(5.0))
    # eval: the thresholded sigmoid, no draw
    logits = torch.tensor([-1.0, 0.3])
    assert torch.equal(gumbel_sigmoid_sample(logits, train=False), torch.tensor([0.0, 1.0]))
    # train with a generator: a {0,1} gate whose gradient reaches the logits
    logits = torch.zeros(64, requires_grad=True)
    gate = gumbel_sigmoid_sample(logits, generator=torch.Generator().manual_seed(0), temperature=0.5)
    assert set(gate.detach().tolist()) == {0.0, 1.0}
    assert torch.autograd.grad(gate.sum(), logits)[0].abs().min() > 0


@pytest.mark.parametrize("train", [True, False])
def test_ste_forward_matches_jax(train):
    video, mask = _inputs()
    jax_model, port = _models("float32", selection_mode="ste")
    seed = 5
    out_j = nnx.jit(lambda m, v, f, r: m(v, f, r, train=train))(
        jax_model, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=seed)
    )
    noise, uniforms = _draws(seed, jax_model, video, mask, "float32", (2, 8, 1))
    with torch.no_grad():
        out = port(torch.from_numpy(video), torch.from_numpy(mask), train=train,
                   noise=noise, uniforms=uniforms)
    assert out.rollouts == out_j.rollouts == 1
    gate_j = np.asarray(out_j.selection_mask)
    assert 0 < gate_j.sum() < gate_j.size  # the gate drops some frames and keeps some
    np.testing.assert_array_equal(out.selection_mask.numpy(), gate_j)
    for field in ("reconstruction", "latent", "selection_prob", "log_variance", "mean"):
        ours, theirs = getattr(out, field), getattr(out_j, field)
        assert tuple(ours.shape) == tuple(theirs.shape), field
        assert _rel_err(ours, theirs) <= F32_TOL, field


def test_ste_gradient_reaches_the_selection_head():
    video, mask = _inputs()
    cfg = tiny_config(dtype="float32", selection_mode="ste")
    port = VideoVAE(cfg.model, device="cpu", seed=3)
    _, _, grads = loss_and_grads(
        port, video, mask, DynamicHParams.default(), cfg.loss, None,
        generator=torch.Generator().manual_seed(1),
    )
    by_name = dict(zip((n for n, _ in port.named_parameters()), grads))
    assert by_name["encoder.selection_layer2.kernel"].abs().max() > 0


def test_scan_rollout_decode_matches_batched_decode():
    video, mask = _inputs()
    results = []
    for scan in (False, True):
        cfg = tiny_config(dtype="float32", scan_rollout_decode=scan)
        port = VideoVAE(cfg.model, device="cpu", seed=3)
        with torch.no_grad():  # the zero-initialised final conv would hide the UNet
            fc = port.decoder.unet.final_conv.kernel
            fc.copy_(torch.randn(fc.shape, generator=torch.Generator().manual_seed(4)) * 0.1)
        gen = torch.Generator().manual_seed(7)
        noise = torch.randn((2, 8, 16, cfg.model.latent_dim), generator=gen)
        uniforms = torch.rand((4, 8, 1, 1), generator=gen)
        with torch.no_grad():
            recon = port(torch.from_numpy(video), torch.from_numpy(mask), noise=noise,
                         uniforms=uniforms).reconstruction
        loss, _, grads = loss_and_grads(
            port, video, mask, DynamicHParams.default(), cfg.loss, None, noise=noise, uniforms=uniforms
        )
        results.append((recon, float(loss), grads))
    (r0, l0, g0), (r1, l1, g1) = results
    assert r0.shape == r1.shape == (4, 8, 32, 32, 3)
    assert (r0 - r1).abs().max() <= 1e-6 * r0.abs().max()  # the same (b r) order, the same values
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    # per leaf; a leaf whose true gradient is 0 (some conv biases, see the
    # train-step test) is rounding noise of the largest gradient on both sides
    scale = max(float(b.abs().max()) for b in g1)
    for a, b in zip(g0, g1):
        if float(b.abs().max()) <= 1e-6 * scale:
            assert float(a.abs().max()) <= 1e-6 * scale
        else:
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("sample_latent", [True, False])
def test_eval_step_matches_jax(sample_latent):
    video, mask = _inputs()
    jax_model, port = _models("float32")
    jcfg = jax_tiny_config(dtype="float32")
    seed = 22
    ref = make_eval_step(jcfg.loss, None, compute_dtype=jnp.float32, sample_latent=sample_latent)(
        jax_model, jnp.asarray(video), jnp.asarray(mask), nnx.Rngs(sampling=seed),
        JaxDynamicHParams.default(),
    )
    noise, uniforms = _draws(seed, jax_model, video, mask, "float32", (4, 8, 1, 1))
    if not sample_latent:  # the JAX forward then takes only the Bernoulli draw
        uniforms = torch.from_numpy(np.array(jax.random.uniform(
            nnx.Rngs(sampling=seed).sampling(), (4, 8, 1, 1), jnp.float32)))
    before = [p.detach().clone() for p in port.parameters()]
    metrics = eval_step(
        port, video, mask, DynamicHParams.default(), tiny_config().loss, None,
        sample_latent=sample_latent, noise=noise, uniforms=uniforms,
    )
    assert set(metrics) == set(ref) and "psnr_sampled" in metrics
    for key, theirs in ref.items():
        theirs = float(theirs)
        scale = 1.0 if key == "rl_loss" else abs(theirs)
        assert abs(float(metrics[key]) - theirs) <= F32_TOL * scale, (key, float(metrics[key]), theirs)
        assert not metrics[key].requires_grad
    assert all(torch.equal(p, q) for p, q in zip(port.parameters(), before))
