"""The port's channels-first VGG (``layout="cf"``) against the JAX package's, on the CPU.

* ``VGG16Features(layout="cf")`` in f32 against JAX ``VGG16Features(layout="cf",
  dtype=float32)`` with the JAX filters carried across by ``load_jax_params``:
  the three activations, their vector-Jacobian product into the input, and the
  perceptual loss with its gradient into the reconstruction (JAX's
  ``conv3d_cf`` takes its XLA path on the CPU; the port's its plain version);
* the port's cf VGG against its own nhwc one on the same filters;
* ``build_perceptual(LossConfig(vgg_layout="cf"))``;
* a backward through the cf VGG, whose filters are frozen, computes no filter
  gradient, while a conv whose filter trains still does.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.losses.perceptual import make_perceptual_loss_fn as jax_make_perceptual
from video_vae_tpu.models.vgg import VGG16Features as JaxVGG16Features
from video_vae_tpu_torch import LossConfig, load_jax_params
from video_vae_tpu_torch.losses import make_perceptual_loss_fn
from video_vae_tpu_torch.models.vgg import PERCEPTUAL_LAYERS, VGG16Features, load_vgg
from video_vae_tpu_torch.ops import conv3d
from video_vae_tpu_torch.train.step import build_perceptual

# f32 on both sides, the same convolutions summed in other orders
ATOL, RTOL = 1e-4, 1e-3



@pytest.fixture(scope="module")
def vggs():
    """(JAX cf VGG, the port's cf VGG, the port's nhwc VGG), f32, the same filters."""
    jax_vgg = JaxVGG16Features(nnx.Rngs(0), layout="cf", dtype=jnp.float32)
    flat = {"/".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jax_vgg, nnx.Param).flat_state()}
    ports = []
    for layout in ("cf", "nhwc"):
        port = VGG16Features(torch.Generator().manual_seed(0), layout=layout, dtype=torch.float32)
        assert load_jax_params(port, flat) == 6
        ports.append(port.requires_grad_(False))
    return (jax_vgg, *ports)


def _frames(seed, n=3):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 32, 3)).astype(np.float32)


def test_cf_activations_match_jax(vggs):
    jax_vgg, port, _ = vggs
    x = _frames(1)
    want = jax.jit(lambda m, x: m(x))(jax_vgg, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert set(got) == set(PERCEPTUAL_LAYERS)
    for layer in PERCEPTUAL_LAYERS:
        w = np.asarray(want[layer])
        assert got[layer].shape == w.shape and w.shape[0] == 1  # (1, N, C, h, w)
        np.testing.assert_allclose(got[layer].numpy(), w, atol=ATOL, rtol=RTOL, err_msg=layer)


def test_cf_activation_vjp_matches_jax(vggs):
    """The activations' gradient into the input for one cotangent a layer, f32
    throughout: the input gradient of each conv, the ReLUs and the pool."""
    jax_vgg, port, _ = vggs
    x = _frames(2)
    want, vjp = jax.vjp(lambda a: jax_vgg(a), jnp.asarray(x))
    rng = np.random.default_rng(3)
    cot = {layer: rng.normal(size=np.asarray(want[layer]).shape).astype(np.float32) for layer in want}
    (j_grad,) = vjp({layer: jnp.asarray(c) for layer, c in cot.items()})
    xt = torch.from_numpy(x).requires_grad_()
    acts = port(xt)
    (grad,) = torch.autograd.grad([acts[k] for k in cot], [xt], [torch.from_numpy(cot[k]) for k in cot])
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(grad.numpy(), j_grad, atol=ATOL * np.abs(j_grad).max(), rtol=RTOL)


@pytest.mark.parametrize("chunk_frames", [32, 2])
def test_cf_perceptual_loss_and_input_gradient_match_jax(vggs, chunk_frames):
    jax_vgg, port, _ = vggs
    rng = np.random.default_rng(chunk_frames)
    x = rng.uniform(0, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    j_fn = jax_make_perceptual(jax_vgg, chunk_frames=chunk_frames)
    j_val, j_vjp = jax.vjp(lambda a: j_fn(a, jnp.asarray(target), 2), jnp.asarray(x))
    cot = rng.uniform(0.5, 1.5, (2,)).astype(np.float32)
    (j_grad,) = j_vjp(jnp.asarray(cot))

    fn = make_perceptual_loss_fn(port, chunk_frames=chunk_frames)
    xt = torch.from_numpy(x).requires_grad_()
    val = fn(xt, torch.from_numpy(target), 2)
    (grad,) = torch.autograd.grad(val, [xt], torch.from_numpy(cot))
    assert val.shape == (2,)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(j_val), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=ATOL, rtol=RTOL)


def test_cf_matches_the_ports_nhwc(vggs):
    _, cf, nhwc = vggs
    x = torch.from_numpy(_frames(4))
    a, b = cf(x), nhwc(x)
    for layer in PERCEPTUAL_LAYERS:
        np.testing.assert_allclose(a[layer][0].numpy(), b[layer].numpy(), atol=ATOL, rtol=RTOL, err_msg=layer)
    rng = np.random.default_rng(5)
    video = torch.from_numpy(rng.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32))
    grads = []
    for vgg in (cf, nhwc):
        leaf = video.clone().requires_grad_()
        val = make_perceptual_loss_fn(vgg)(leaf, target, 2)
        grads.append((val.detach(), *torch.autograd.grad(val.sum(), [leaf])))
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(), atol=ATOL, rtol=RTOL)


def test_build_perceptual_takes_the_cf_layout():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn = build_perceptual(LossConfig(vgg_layout="cf"), device="cpu")
        vgg = load_vgg(None, layout="cf", device="cpu")
    assert vgg.layout == "cf" and not any(p.requires_grad for p in vgg.parameters())
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 2, 16, 16, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (1, 2, 16, 16, 3)).astype(np.float32))
    val = fn(x, target, 2)
    assert val.shape == (2,) and torch.isfinite(val).all() and (val > 0).all()
    with pytest.raises(ValueError, match="layout"):
        load_vgg(None, layout="nchw", device="cpu")


def test_frozen_cf_vgg_computes_no_filter_gradient(vggs, monkeypatch):
    """The cf VGG's filters are frozen: its backward runs each conv's input
    gradient and no filter gradient; a conv whose filter trains runs one."""
    _, port, _ = vggs
    calls = []
    wgrad = conv3d.conv3d_wgrad

    def counted(*args):
        calls.append(args[2].shape)
        return wgrad(*args)

    monkeypatch.setattr(conv3d, "conv3d_wgrad", counted)
    x = torch.from_numpy(_frames(7, n=2)).requires_grad_()
    acts = port(x)
    (grad,) = torch.autograd.grad(sum(a.sum() for a in acts.values()), [x])
    assert calls == [] and torch.isfinite(grad).all() and grad.abs().max() > 0

    gen = torch.Generator().manual_seed(8)
    x5 = torch.randn(1, 2, 4, 8, 8, generator=gen, requires_grad=True)
    kernel = torch.randn(1, 3, 3, 4, 4, generator=gen, requires_grad=True)
    bias = torch.zeros(4, requires_grad=True)
    dx, dk, db = torch.autograd.grad(conv3d.conv3d_cf(x5, kernel, bias).sum(), [x5, kernel, bias])
    assert len(calls) == 1 and dk.shape == kernel.shape and db.shape == bias.shape
