"""The port's reference-checkpoint import against the JAX package's, on the CPU.

A reference-shaped tree (nested dicts, block stacks as lists, every leaf
wrapped in an object with ``.value``, the reference's RoPE cos/sin caches
under ``ROPE`` in each attention block, a ``None`` leaf) is made from the
JAX ``VideoVAE``'s parameters, redrawn with numpy, and imported by both
packages' ``import_reference_state``: the same count, the tree's values bit
for bit, the same f32 serving pass. A bad tree raises the same exception
with the same message in both, and leaves the port's model as it was,
where the JAX import has written every entry it walked before the error.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from flax import nnx
import jax.numpy as jnp

from helpers.threads import one_thread  # noqa: F401
from test_torch_model import F32_TOL, random_params
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.checkpoint import import_reference_state as jax_import
from video_vae_tpu.train.step import make_reconstruct_fn
from video_vae_tpu_torch import VideoVAE, reconstruct, tiny_config
from video_vae_tpu_torch.train import import_reference_state

SEED = 20
ROPE_LEN = 8  # the reference caches cos/sin for max_temporal_len positions


class Leaf:
    """A restored reference variable: the array under ``.value``."""

    def __init__(self, value):
        self.value = value


def _listify(node):
    """Every dict whose keys are 0..n-1 becomes a list, as the reference keeps block stacks."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def nested(params: dict, wrap=lambda v: v) -> dict:
    tree = {}
    for key, value in params.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = wrap(value)
    return tree


def reference_tree(params: dict, head_dim: int) -> dict:
    """``params`` ({'/' path: array}) as a reference checkpoint's model subtree."""
    tree = nested(params, Leaf)
    rng = np.random.default_rng(SEED)
    for stack in ("encoder", "decoder"):
        for block in tree[stack]["layers"].values():
            for name in ("SpatialAttention", "TemporalAttention"):
                block[name]["ROPE"] = {
                    c: Leaf(rng.standard_normal((ROPE_LEN, head_dim)).astype(np.float32)) for c in ("cos", "sin")
                }
    tree["encoder"]["rng_cache"] = Leaf(None)  # an empty variable: skipped by both
    return _listify(tree)


def _jax_model(seed):
    return nnx.jit(lambda: JaxVideoVAE(jax_tiny_config(dtype="float32").model, nnx.Rngs(seed, sampling=1)))()


def _port_model(seed):
    return VideoVAE(tiny_config(dtype="float32").model, device="cpu", seed=seed)


def _jax_values(model) -> dict:
    return {"/".join(map(str, p)): np.array(v.get_value()) for p, v in nnx.state(model).flat_state()}


def _snapshot(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()}


def _unchanged(model, before: dict) -> bool:
    return all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def params():
    return random_params(_jax_model(0), SEED)


@pytest.fixture(scope="module")
def head_dim():
    cfg = tiny_config().model
    return cfg.qkv_features // cfg.num_heads


@pytest.fixture(scope="module")
def imported(params, head_dim):
    """(JAX count, port count, JAX model, port model) after importing one reference tree."""
    tree = reference_tree(params, head_dim)
    jax_model, port = _jax_model(1), _port_model(1)
    return jax_import(jax_model, tree), import_reference_state(port, tree), jax_model, port


def test_counts_and_bits(imported, params):
    jax_count, port_count, _, port = imported
    assert port_count == jax_count == len(params)
    ours = {name.replace(".", "/"): p for name, p in port.named_parameters()}
    assert set(ours) == set(params)
    for key, value in params.items():
        assert torch.equal(ours[key].detach(), torch.from_numpy(value)), key


def test_reconstruct_matches_jax(imported):
    _, _, jax_model, port = imported
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (2, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0
    ref = np.asarray(make_reconstruct_fn(jnp.float32)(jax_model, jnp.asarray(video), jnp.asarray(mask)))
    out = reconstruct(port, video, mask, device="cpu").float().numpy()
    assert out.shape == ref.shape == (2, 8, 32, 32, 3)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= F32_TOL, err


def _extra(tree):
    tree["encoder"]["extra_head"] = {"kernel": Leaf(np.zeros((3, 3), np.float32))}


def _dropped(tree):
    del tree["decoder"]["layers"][0]["TemporalAttention"]["q_norm"]["scale"]


def _reshaped(tree, key):
    # the last entry of the walk: the JAX import has written every other one by then
    node = tree
    *parents, leaf = key.split("/")
    for p in parents:
        node = node[int(p)] if isinstance(node, list) else node[p]
    node[leaf] = Leaf(np.zeros(node[leaf].value.shape + (1,), np.float32))


@pytest.mark.parametrize("case,error,path", [
    ("extra", KeyError, "('encoder', 'extra_head', 'kernel')"),
    ("dropped", ValueError, "('decoder', 'layers', '0', 'TemporalAttention', 'q_norm', 'scale')"),
    ("reshaped", ValueError, None),
])
def test_bad_tree_raises_as_jax_and_leaves_the_port_unchanged(params, head_dim, case, error, path):
    tree = reference_tree(params, head_dim)
    last = list(params)[-1]
    {"extra": _extra, "dropped": _dropped, "reshaped": lambda t: _reshaped(t, last)}[case](tree)
    path = path or f"shape mismatch at {last}"
    jax_model = _jax_model(2)
    jax_before = _jax_values(jax_model)
    with pytest.raises(error) as jax_exc:
        jax_import(jax_model, tree)
    if case == "reshaped":  # the deliberate difference: JAX has written every entry before the last
        changed = [k for k, v in _jax_values(jax_model).items() if not np.array_equal(v, jax_before[k])]
        assert len(changed) == len(params) - 1 and last not in changed
    port = _port_model(2)
    before = _snapshot(port)
    with pytest.raises(error) as port_exc:
        import_reference_state(port, tree)
    assert type(port_exc.value) is type(jax_exc.value)
    assert str(port_exc.value) == str(jax_exc.value)
    assert path in str(port_exc.value)
    assert _unchanged(port, before)


def test_nnx_state_and_numpy_dicts_agree(imported):
    """The JAX import of an ``nnx.State`` and the port's of plain nested numpy
    dicts holding the same values give the same parameters."""
    _, _, source, _ = imported
    state = nnx.state(source)
    flat = _jax_values(source)
    jax_model, port = _jax_model(3), _port_model(3)
    jax_count = jax_import(jax_model, state)
    assert import_reference_state(port, nested(flat)) == jax_count == len(flat)
    for key, value in _jax_values(jax_model).items():
        assert torch.equal(port.get_parameter(key.replace("/", ".")).detach(), torch.from_numpy(value)), key
