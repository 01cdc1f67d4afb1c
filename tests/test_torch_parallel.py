"""The port's parallel layer against the JAX package's, in one process on the CPU.

Every parameter of the tiny and the flagship model is placed on six mesh
shapes by both packages' rules; ``mesh_info``'s decisions, ``build_mesh``'s
errors, ``largest_divisor_leq`` and the batch rows each rank holds are held to
the JAX package on real JAX meshes of the 8 simulated CPU devices
(``tests/conftest.py``). The port's meshes here are shapes only (no process
group); ``tests/test_torch_distributed.py`` trains on real ones.
"""

import itertools
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from flax import nnx
from jax.sharding import NamedSharding

from video_vae_tpu.core.config import ModelConfig as JaxModelConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.parallel import mesh as jax_mesh
from video_vae_tpu.parallel import sharding as jax_sharding
from video_vae_tpu_torch import ModelConfig, VideoVAE, tiny_config
from video_vae_tpu_torch.parallel import mesh as port_mesh
from video_vae_tpu_torch.parallel import sharding as port_sharding

MESH_SHAPES = ((2, 2, 2), (4, 1, 1), (1, 4, 1), (1, 1, 4), (2, 1, 2), (1, 2, 2))
# the port's tensor shard of these is the rank's heads of each of q, k and v
# (sharding.BY_HEADS); JAX's is a contiguous block of columns
BY_HEADS_SUFFIXES = ("qkv_projection/kernel", "qkv_projection/bias")


def _factorizations(n):
    return [(d, f, t) for d, f, t in itertools.product(range(1, n + 1), repeat=3) if d * f * t == n]


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return jax_mesh.build_mesh(*shape, devices=jax.devices()[:n])


def _port_mesh(shape):
    return port_mesh.build_mesh(*shape, world_size=int(np.prod(shape)))


def _jax_param_shapes(cfg):
    abstract = nnx.eval_shape(lambda: JaxVideoVAE(cfg, nnx.Rngs(0, sampling=1)))
    return {"/".join(map(str, path)): tuple(var.get_value().shape)
            for path, var in nnx.state(abstract, nnx.Param).flat_state()}


def _port_param_shapes(cfg):
    """The port model's {path: shape}, built on the meta device: no weights are
    drawn (the flagship's 170 M would take seconds of a loaded CPU)."""
    with torch.device("meta"), mock.patch.object(torch.nn.Module, "to", lambda self, *a, **k: self):
        model = VideoVAE(cfg, device="cpu")
    return {n.replace(".", "/"): tuple(p.shape) for n, p in model.named_parameters()}


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def models():
    """{name: (JAX {path: shape}, port {path: shape})} for the tiny and the flagship model."""
    out = {}
    for name, jcfg, cfg in (("tiny", jax_tiny_config().model, tiny_config().model),
                            ("flagship", JaxModelConfig(), ModelConfig())):
        out[name] = (_jax_param_shapes(jcfg), _port_param_shapes(cfg))
    return out


@pytest.mark.parametrize("model", ["tiny", "flagship"])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_param_placement_matches_jax(models, model, shape):
    jax_shapes, port_shapes = models[model]
    assert port_shapes == jax_shapes
    jm = _jax_mesh(shape)
    ours = port_sharding.param_shardings({n: torch.empty(s, device="meta") for n, s in port_shapes.items()},
                                         _port_mesh(shape))
    split_by_tensor = 0
    for path, s in jax_shapes.items():
        theirs = jax_sharding._prune_spec_for_shape(jm, s, jax_sharding._spec_for_path(path, s))
        assert ours[path] == _padded(theirs, len(s)), (path, ours[path], theirs)
        split_by_tensor += "tensor" in ours[path]
    # the rules really split something over tensor where the mesh has it
    assert (split_by_tensor > 0) == (shape[2] > 1)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 4), (1, 2, 2)])
def test_param_pieces_match_jax_device_shards(shape):
    """Each rank's piece of each tiny parameter (``shard_state``) equals the
    shard JAX puts on the device at that mesh position, except the QKV
    projection's, which is the rank's heads of each third (checked apart)."""
    cfg = tiny_config(num_heads=4).model
    jm, pm = _jax_mesh(shape), _port_mesh(shape)
    rng = np.random.default_rng(0)
    full = {n.replace(".", "/"): torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
            for n, p in VideoVAE(cfg, device="cpu").named_parameters()}
    specs = port_sharding.param_shardings(full, pm)
    by_heads = [n for n in full if n.endswith(BY_HEADS_SUFFIXES)]
    assert len(by_heads) == 8 and all("tensor" in specs[n] for n in by_heads) == (shape[2] > 1)
    for path, value in full.items():
        spec = jax_sharding._prune_spec_for_shape(jm, value.shape, jax_sharding._spec_for_path(path, value.shape))
        arr = jax.device_put(value.numpy(), NamedSharding(jm, spec))
        for piece in arr.addressable_shards:
            coord = dict(zip(jm.axis_names, map(int, np.argwhere(jm.devices == piece.device)[0])))
            ours = port_sharding.shard_state({path: value}, pm, coord)[path]
            if path in by_heads and shape[2] > 1:
                t, n = coord["tensor"], shape[2]
                d = specs[path].index("tensor")
                thirds = value.unflatten(d, (3, n, value.shape[d] // (3 * n)))
                want = thirds.select(d + 1, t).flatten(d, d + 1)
                fsdp = specs[path].index("fsdp") if "fsdp" in specs[path] else None
                if fsdp is not None:
                    m = want.shape[fsdp] // shape[1]
                    want = want.narrow(fsdp, coord["fsdp"] * m, m)
                assert torch.equal(ours, want), path
                assert ours.shape == tuple(np.asarray(piece.data).shape)
            else:
                np.testing.assert_array_equal(ours.numpy(), np.asarray(piece.data), err_msg=path)


@pytest.mark.parametrize("tensor_safe", [True, False])
@pytest.mark.parametrize("shape", _factorizations(4) + _factorizations(8))
def test_mesh_info_matches_jax(shape, tensor_safe):
    jm, pm = _jax_mesh(shape), _port_mesh(shape)
    for batch in range(1, 9):
        with jax_sharding.activate_mesh(jm):
            jmesh, jaxes = jax_sharding.mesh_info(batch, tensor_safe=tensor_safe)
        with port_sharding.activate_mesh(pm):
            mesh, axes = port_sharding.mesh_info(batch, tensor_safe=tensor_safe)
            assert port_sharding.takes_chain() == (shape[2] > 1)
        assert (mesh is None, axes) == (jmesh is None, jaxes), (batch, axes, jaxes)
    assert port_sharding.mesh_info(4) == (None, None) and not port_sharding.takes_chain()


@pytest.mark.parametrize("args", [(3, 1, 1), (-1, 3, 1), (-1, 1, 3), (2, 2, 1), (8, 2, 1), (-1, 16, 1)])
def test_build_mesh_errors_match_jax(args):
    with pytest.raises(ValueError) as theirs:
        jax_mesh.build_mesh(*args, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as ours:
        port_mesh.build_mesh(*args, world_size=8)
    assert str(ours.value) == str(theirs.value)


def test_build_mesh_absorbs_the_remaining_ranks():
    for fsdp, tensor in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (1, 8)):
        theirs = jax_mesh.build_mesh(-1, fsdp, tensor, devices=jax.devices()[:8])
        ours = port_mesh.build_mesh(-1, fsdp, tensor, world_size=8)
        assert port_mesh.mesh_shape(ours) == dict(theirs.shape)
        assert ours.mesh.tolist() == [[[d.id for d in row] for row in plane] for plane in theirs.devices]


def test_largest_divisor_leq_matches_jax():
    for n in range(1, 130):
        for cap in range(1, 20):
            assert port_mesh.largest_divisor_leq(n, cap) == jax_mesh.largest_divisor_leq(n, cap)


@pytest.mark.parametrize("shape", _factorizations(8) + [(4, 1, 1), (1, 2, 2)])
def test_batch_rows_match_jax(shape):
    """Each rank's rows of a global batch are the rows JAX puts on its device,
    the whole batch where the (data, fsdp) axes do not divide it."""
    jm, pm = _jax_mesh(shape), _port_mesh(shape)
    for global_batch in range(1, 9):
        video = np.arange(global_batch * 3, dtype=np.float32).reshape(global_batch, 3)
        sharded = jax_sharding.shard_process_local_batch({"video": video}, jm)["video"]
        for piece in sharded.addressable_shards:
            coord = dict(zip(jm.axis_names, map(int, np.argwhere(jm.devices == piece.device)[0])))
            rows = port_sharding.batch_slice(global_batch, pm, coord)
            np.testing.assert_array_equal(video[rows], np.asarray(piece.data))
        local = port_mesh.local_batch_size(global_batch, pm)
        assert local == rows.stop - rows.start


def test_draw_local_keeps_the_ranks_rows_of_the_global_draw():
    """Under ``local_rows`` a draw of the rank's rows (times the rollouts) is the
    matching slice of the draw one process makes for the whole batch."""
    whole = torch.rand((8, 3, 1), generator=torch.Generator().manual_seed(5))
    rollouts = torch.rand((16, 3, 1), generator=torch.Generator().manual_seed(5))
    with port_sharding.local_rows(slice(2, 4), 8):
        mine = port_sharding.draw_local(torch.rand, (2, 3, 1), generator=torch.Generator().manual_seed(5))
        pairs = port_sharding.draw_local(torch.rand, (4, 3, 1), generator=torch.Generator().manual_seed(5))
    assert torch.equal(mine, whole[2:4]) and torch.equal(pairs, rollouts[4:8])
    plain = port_sharding.draw_local(torch.rand, (2, 3), generator=torch.Generator().manual_seed(5))
    assert torch.equal(plain, torch.rand((2, 3), generator=torch.Generator().manual_seed(5)))


@pytest.mark.parametrize("by_heads", [False, True])
@pytest.mark.parametrize("dim", [0, 1])
def test_split_and_join_round_trip(by_heads, dim):
    t = torch.arange(2 * 24, dtype=torch.float32).reshape(2, 24) if dim else torch.arange(24.0 * 2).reshape(24, 2)
    pieces = [port_sharding._split(t, dim, 4, i, by_heads) for i in range(4)]
    assert torch.equal(port_sharding._join(pieces, dim, by_heads), t)
    if by_heads:  # piece i: the i-th of four blocks of each third
        thirds = t.chunk(3, dim=dim)
        assert torch.equal(pieces[1], torch.cat([x.chunk(4, dim=dim)[1] for x in thirds], dim=dim))


def test_constrain_and_the_jax_names():
    from video_vae_tpu_torch import parallel

    x = torch.ones(2, 3)
    assert port_sharding.constrain(x, ("data", "fsdp"), None) is x
    pm = _port_mesh((2, 2, 2))
    assert parallel.batch_sharding(pm, 3) == (("data", "fsdp"), None, None)
    assert parallel.replicated(pm) == ()
    for name in ("build_mesh", "mesh_from_config", "batch_sharding", "constrain", "param_shardings",
                 "replicated", "shard_state", "shard_process_local_batch"):
        assert callable(getattr(parallel, name))


def test_attention_and_mlp_kernels_give_way_under_tensor_parallelism(monkeypatch):
    """Under a tensor > 1 mesh ``attention_impl="pallas"`` takes the ``"xla"``
    chain and ``VVT_MLP_FUSED=1`` the module chain, each logged as such (JAX
    ``ops/attention.py:48``, ``ops/fused_block.py:224``); without the mesh the
    kernels' wrappers run."""
    from video_vae_tpu_torch.models.layers import MLP, apply_mlp
    from video_vae_tpu_torch.ops.attention import masked_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 2, 16, generator=gen) for _ in range(3))
    mask = torch.ones(2, 8, dtype=torch.bool)
    mask[1, 5:] = False
    mlp = MLP(16, 32, gen, dtype=torch.float32)
    x = torch.randn(2, 8, 16, generator=gen)
    monkeypatch.setenv("VVT_MLP_FUSED", "1")
    for shape, want in (((1, 1, 2), "chain"), ((2, 1, 1), "plain")):
        port_sharding.clear_dispatch_log()
        with port_sharding.activate_mesh(_port_mesh(shape)):
            out = masked_attention(q, k, v, mask, impl="pallas")
            y = apply_mlp(mlp, x)
        ops = {op: impl for op, impl, _ in port_sharding.dispatch_log()}
        assert ops == {"flash_attention": want, "fused_mlp": want}, shape
        ref = masked_attention(q, k, v, mask, impl="xla")
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        if want == "chain":  # the module chain itself; the fused kernel rounds its products to bf16
            torch.testing.assert_close(y, x + mlp(x), rtol=0, atol=0)

