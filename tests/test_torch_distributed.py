"""The port's sharded train step against the JAX package's one-device step.

Four gloo ranks on the CPU (one ``torch.multiprocessing`` spawn for the file,
``tests/helpers/dist_worker.py``) train the f32 tiny model, perceptual loss
on, from the same weights, batch of 4 clips and injected draws under each
factorization of 4 of ``__graft_entry__.py:dryrun_multichip``: (1,2,2),
(4,1,1), (1,4,1) and (1,1,4), the last with 4 heads on both sides (TP needs
the heads to split). Meanwhile this process runs the JAX package's step
(the ``jax_f32`` pattern of ``test_torch_train_step.py``). Each factorization
must give JAX's loss metrics and gradients of one step, JAX's metrics over
two steps (the global gradient norm among them) and JAX's parameters after
them; no gradient may vanish where JAX's does not (wrappers that hide the
parameters from ``torch.autograd.grad`` give zeros or a rank's own
gradients). A checkpoint saved under (1,2,2) restores under (4,1,1) and its
next step equals the uninterrupted run's. A 2-rank ``torch.distributed.run``
of the training CLI exits 0 and writes one checkpoint.
"""

import ast
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from flax import nnx
from test_torch_model import set_jax_params

from helpers import dist_worker
from video_vae_tpu.core.config import DynamicHParams as JaxDynamicHParams
from video_vae_tpu.core.config import LossConfig as JaxLossConfig
from video_vae_tpu.core.config import tiny_config as jax_tiny_config
from video_vae_tpu.losses.perceptual import make_perceptual_loss_fn as jax_make_perceptual
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.models.vgg import load_vgg as jax_load_vgg
from video_vae_tpu.train.setup import create_optimizer as jax_create_optimizer
from video_vae_tpu.train.step import _loss_fn, make_train_step
from video_vae_tpu_torch import VideoVAE, load_jax_params, tiny_config
from video_vae_tpu_torch.models.unet import ConvBlock3D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEED = 10
BATCH = 4
DRAW_SEEDS = (98, 176, 428)  # the sampling streams of steps 1, 2 and 3 (no near-ties at b = 4)
F32_TOL = 1e-4
PERCEPTUAL_F32_TOL = 1e-3
GRAD_F32_TOL = 1e-3  # per leaf, against the largest JAX value of that leaf
MIN_MARGIN = 0.02
JOIN_TIMEOUT_S = 600
LABELS = [label for label, *_ in dist_worker.CASES]
HEADS = {label: heads for label, _, heads, _ in dist_worker.CASES}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(SEED)
    video = rng.uniform(0.0, 1.0, (BATCH, 8, 32, 32, 3)).astype(np.float32)
    mask = np.ones((BATCH, 8), np.float32)
    mask[1, 5:] = 0  # padded frames in a clip of rank 0's and of rank 2's rows
    mask[2, 6:] = 0
    return video, mask


def _random_params(model, seed):
    """Every parameter redrawn with numpy (``test_torch_model.random_params``'s
    rules), keyed by its '/' path."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("kernel"):
            arr = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif name.endswith("scale"):
            arr = 1.0 + 0.2 * rng.standard_normal(shape)
        else:
            arr = 0.2 * rng.standard_normal(shape)
        params[name.replace(".", "/")] = arr.astype(np.float32)
    return params


def _draws(model, video, mask):
    """The JAX forward's two draws for each of ``DRAW_SEEDS``, as torch tensors;
    no keep decision within ``MIN_MARGIN`` of its probability."""
    with torch.no_grad():
        _, logvar, prob = model.encode(torch.from_numpy(video), torch.from_numpy(mask))
    p = prob.repeat_interleave(2, dim=0)[..., None].numpy()
    out = []
    for seed in DRAW_SEEDS:
        rngs = nnx.Rngs(sampling=seed)
        k_noise, k_uniform = rngs.sampling(), rngs.sampling()
        noise = jax.random.normal(k_noise, tuple(logvar.shape), jnp.float32)
        uniforms = jax.random.uniform(k_uniform, (2 * BATCH, video.shape[1], 1, 1), jnp.float32)
        assert np.abs(np.asarray(uniforms) - p).min() > MIN_MARGIN
        out.append((torch.from_numpy(np.array(noise)), torch.from_numpy(np.array(uniforms))))
    return out


def _flat(state):
    return {"/".join(map(str, p)): np.asarray(v.get_value()) for p, v in state.flat_state()}


def _jax_run(heads, params, vgg, video, mask):
    """The JAX one-device f32 step: one step's loss metrics and gradients, then
    the metrics of two ``make_train_step`` steps and the parameters after them."""
    jcfg = jax_tiny_config(dtype="float32", num_heads=heads)
    jax_model = nnx.jit(lambda: JaxVideoVAE(jcfg.model, nnx.Rngs(0, sampling=1)))()
    set_jax_params(jax_model, params)
    jax_pf = jax_make_perceptual(vgg)
    hp = JaxDynamicHParams.default()
    loss_cfg = JaxLossConfig(use_perceptual=True)
    jv, jm = jnp.asarray(video), jnp.asarray(mask)

    @nnx.jit
    def grads_of(model, rngs):
        def f(model, rngs):
            return _loss_fn(model, jv, jm, rngs, hp, loss_cfg, jax_pf)

        (_, metrics), grads = nnx.value_and_grad(f, has_aux=True)(model, rngs)
        return metrics, grads

    metrics, grads = grads_of(jax_model, nnx.Rngs(sampling=DRAW_SEEDS[0]))
    res = {"loss_metrics": {k: float(v) for k, v in metrics.items()}, "grads": _flat(grads)}
    step = make_train_step(loss_cfg, jax_pf, compute_dtype=jnp.float32)
    opt = jax_create_optimizer(jax_model, jcfg.optim)
    res["steps"] = [
        {k: float(v) for k, v in step(jax_model, opt, jv, jm, nnx.Rngs(sampling=s), hp).items()}
        for s in DRAW_SEEDS[:2]
    ]
    res["params"] = _flat(nnx.state(jax_model, nnx.Param))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX references by head count, the ranks' results, the run's directory)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        video, mask = _inputs()
        jax_vgg = jax_load_vgg(None)
        vgg = _flat(nnx.state(jax_vgg, nnx.Param))
        params, draws = {}, {}
        for heads in sorted(set(HEADS.values())):
            model = VideoVAE(tiny_config(dtype="float32", num_heads=heads).model, device="cpu")
            params[heads] = _random_params(model, SEED)
            load_jax_params(model, params[heads])
            draws[heads] = _draws(model, video, mask)
        torch.save({"params": params, "vgg": vgg, "video": torch.from_numpy(video),
                    "mask": torch.from_numpy(mask), "draws": draws}, os.path.join(tmp, "inputs.pt"))
        ctx = mp.start_processes(dist_worker.worker, args=(WORLD, _free_port(), tmp), nprocs=WORLD,
                                 join=False, start_method="spawn")
        try:
            refs = {heads: _jax_run(heads, params[heads], jax_vgg, video, mask) for heads in params}
        finally:
            for p in ctx.processes:
                p.join(JOIN_TIMEOUT_S)
            alive = [p.pid for p in ctx.processes if p.is_alive()]
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        assert not alive, f"ranks {alive} did not finish in {JOIN_TIMEOUT_S} s"
        assert all(p.exitcode == 0 for p in ctx.processes), [p.exitcode for p in ctx.processes]
        results = torch.load(os.path.join(tmp, "results.pt"), weights_only=False)
        return refs, results, tmp
    finally:
        torch.set_num_threads(before)


def _close(ours, theirs, key, tol):
    scale = 1.0 if key == "rl_loss" else abs(theirs)  # rl_loss is 0 up to rounding
    return abs(ours - theirs) <= tol * scale


def _tol(key):
    return PERCEPTUAL_F32_TOL if key == "perceptual_loss" else F32_TOL


def _vanishing():
    """Conv biases whose GroupNorm has one channel a group: 0 gradient on both sides."""
    model = VideoVAE(tiny_config().model, device="cpu")
    return {f"{n}/conv/bias".replace(".", "/") for n, m in model.named_modules()
            if isinstance(m, ConvBlock3D) and m.norm.num_groups == m.norm.scale.numel()}


@pytest.mark.parametrize("label", LABELS)
def test_sharded_step_matches_the_jax_step(runs, label):
    refs, results, _ = runs
    ref, ours = refs[HEADS[label]], results[label]
    assert set(ours["loss_metrics"]) == set(ref["loss_metrics"])
    for key, value in ours["loss_metrics"].items():
        assert _close(value, ref["loss_metrics"][key], key, _tol(key)), (key, value, ref["loss_metrics"][key])
    for i, (mine, theirs) in enumerate(zip(ours["steps"], ref["steps"])):
        assert set(mine) == set(theirs)
        for key in theirs:
            assert _close(mine[key], theirs[key], key, _tol(key)), (i, key, mine[key], theirs[key])
    assert ref["steps"][1]["grad_norm"] > 1.0  # the clip acts
    assert set(ours["params"]) == set(ref["params"])
    for name, value in ours["params"].items():
        theirs = ref["params"][name]
        err = np.abs(value.numpy() - theirs).max()
        assert err <= GRAD_F32_TOL * np.abs(theirs).max(), (name, err)


@pytest.mark.parametrize("label", LABELS)
def test_sharded_gradients_match_the_jax_gradients(runs, label):
    """Every gathered gradient is JAX's; none is all zeros where JAX's is not."""
    refs, results, _ = runs
    theirs_all, ours_all = refs[HEADS[label]]["grads"], results[label]["grads"]
    assert set(ours_all) == set(theirs_all)
    scale = max(np.abs(g).max() for g in theirs_all.values())
    vanishing = _vanishing()
    for name, g in ours_all.items():
        theirs = theirs_all[name]
        assert tuple(g.shape) == theirs.shape, name
        if name in vanishing:
            assert max(np.abs(g.numpy()).max(), np.abs(theirs).max()) <= 1e-6 * scale, name
            continue
        assert np.abs(g.numpy()).max() > 0, f"{name}: all-zero gradient"
        err = np.abs(g.numpy() - theirs).max()
        assert err <= GRAD_F32_TOL * np.abs(theirs).max(), (name, err, np.abs(theirs).max())


@pytest.mark.parametrize("label", LABELS)
def test_grad_norm_is_the_one_device_norm(runs, label):
    """Step 1's clip norm is the norm of the whole gradient, not of a shard."""
    refs, results, _ = runs
    one_device = math.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                               for g in refs[HEADS[label]]["grads"].values()))
    assert _close(results[label]["steps"][0]["grad_norm"], one_device, "grad_norm", F32_TOL)


def test_rows_and_dispatch_follow_the_mesh(runs):
    """Rank 0's rows, and the kernels its step dispatched: the fused attention
    through its wrapper without TP, the chain under TP."""
    _, results, _ = runs
    assert [results[label]["rows"] for label in LABELS] == [(0, 2), (0, 1), (0, 1), (0, 4)]
    for label, shape, _, _ in dist_worker.CASES:
        attention = {impl for op, impl, _ in results[label]["dispatch"] if op.startswith("fused_attention")}
        assert attention == ({"chain"} if shape[2] > 1 else {"plain"}), label


def test_checkpoint_moves_across_meshes(runs):
    """Saved under (1,2,2) after 2 steps, restored under (4,1,1): the next step
    equals the uninterrupted run's, and the file holds the full JAX tree."""
    _, results, tmp = runs
    restored, run = results["restore"], results["1,2,2"]
    assert restored["count"] == dist_worker.SAVED_AFTER
    for key, theirs in run["steps"][dist_worker.SAVED_AFTER].items():
        assert _close(restored["step"][key], theirs, key, F32_TOL), (key, restored["step"][key], theirs)
    for name, value in restored["params"].items():
        theirs = run["params_last"][name]
        assert (value - theirs).abs().max() <= GRAD_F32_TOL * theirs.abs().max(), name
    state = torch.load(os.path.join(tmp, "ckpt", "state.pt"), weights_only=True)
    model = VideoVAE(tiny_config(dtype="float32").model, device="cpu")
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert [tuple(m.shape) for m in state["optimizer"]["mu"]] == [tuple(p.shape) for p in model.parameters()]


def test_only_rank_zero_writes(runs):
    _, _, tmp = runs
    assert os.path.exists(os.path.join(tmp, "log0", "train.jsonl"))
    assert os.path.exists(os.path.join(tmp, "ckpt0", "1", "state.pt"))
    for rank in range(1, WORLD):
        assert not os.path.exists(os.path.join(tmp, f"log{rank}"))
        assert not os.path.exists(os.path.join(tmp, f"ckpt{rank}"))


def test_two_rank_cli_run(tmp_path):
    """``torch.distributed.run`` of the training CLI over 2 CPU ranks (data = 2):
    one epoch of the tiny preset, one checkpoint of the full tree."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_port",
         str(_free_port()), "-m", "video_vae_tpu_torch.cli.train", "--synthetic", "--tiny", "--steps", "2",
         "--device", "cpu", "--checkpoint_dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["32", "train.jsonl"]
    state = torch.load(tmp_path / "32" / "state.pt", weights_only=True)
    assert state["optimizer"]["count"] == 32
    model = VideoVAE(tiny_config().model, device="cpu")
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("knobs", [{}, {"VVT_ATTN_SUBLAYER": "1", "VVT_MLP_FUSED": "1"}], ids=["default", "sublayer-mlp"])
def test_four_rank_dryrun(knobs):
    """``parallel/dryrun.py`` over 4 CPU ranks: every factorization takes a finite
    step; under tensor > 1 every attention and MLP dispatch is the chain, under
    pure DP the fused attention (or the sublayer) goes through its wrapper."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **knobs}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4", "--master_port",
         str(_free_port()), "-m", "video_vae_tpu_torch.parallel.dryrun", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[dryrun] 4-rank dryrun complete (all factorizations)" in proc.stdout
    impls = {}  # mesh -> {(op, impl)}
    for line in proc.stdout.splitlines():
        if " dispatches: " in line:
            head, listed = line.split(" dispatches: ")
            impls[head.split()[-1]] = {tuple(d.split(":")[:2]) for d in ast.literal_eval(listed)}
    assert sorted(impls) == ["(1,1,4)", "(1,2,2)", "(1,4,1)", "(4,1,1)"]
    attention = "fused_attention_sublayer" if knobs else "fused_attention"
    for mesh, tensor_parallel in (("(4,1,1)", False), ("(1,4,1)", False), ("(1,2,2)", True), ("(1,1,4)", True)):
        blocks = {(op, impl) for op, impl in impls[mesh] if not op.startswith("conv3d")}
        want = "chain" if tensor_parallel else "plain"
        assert (attention, want) in blocks and all(impl == want for _, impl in blocks), (mesh, blocks)
        assert (("fused_mlp", want) in blocks) == bool(knobs), (mesh, blocks)
