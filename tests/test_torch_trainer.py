"""The port's trainer, checkpoints, logger and training CLI.

The curriculum, the compression-rate ramp and the CLI's config are held to
the JAX package's exactly. A tiny CPU ``run_epoch`` is held to hand-called
``train_step``s on the same batches with the same generator, exactly; a
checkpoint round trip and a resumed step likewise. A JAX orbax checkpoint of
a tiny model and its ``nnx.Optimizer`` (Adam state filled with random
values, no train step compiled) is read with orbax here and carried into the
port through ``load_jax_params`` and ``load_jax_optimizer_state``.
"""

import dataclasses
import json
import os
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from helpers.threads import one_thread  # noqa: F401
from video_vae_tpu.cli.train import build_parser as jax_build_parser
from video_vae_tpu.cli.train import config_from_args as jax_config_from_args
from video_vae_tpu.core import config as jax_config
from video_vae_tpu.models.vae import VideoVAE as JaxVideoVAE
from video_vae_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from video_vae_tpu.train.metrics import MetricLogger as JaxMetricLogger
from video_vae_tpu.train.setup import create_optimizer as jax_create_optimizer
from video_vae_tpu.train.setup import make_lr_schedule as jax_make_lr_schedule
from video_vae_tpu.train.trainer import Trainer as JaxTrainer
from video_vae_tpu.train.trainer import curriculum_plan as jax_curriculum_plan
from video_vae_tpu.utils.metrics import count_params as jax_count_params
from video_vae_tpu_torch import VideoVAE, create_optimizer, eval_step, reconstruct, train_step
from video_vae_tpu_torch.cli import train as cli
from video_vae_tpu_torch.core.config import DynamicHParams, tiny_config
from video_vae_tpu_torch.data.pipeline import create_dataloader
from video_vae_tpu_torch.data.video_io import HAVE_CV2
from video_vae_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_jax_optimizer_state,
    load_jax_params,
    save_checkpoint,
)
from video_vae_tpu_torch.train.metrics import MetricLogger
from video_vae_tpu_torch.train.trainer import Trainer, curriculum_plan
from video_vae_tpu_torch.utils.metrics import count_params, masked_psnr



def _cfg(tmp_path, **train):
    """tiny_config on 4 synthetic clips (2 steps an epoch), every step logged."""
    cfg = tiny_config()
    return cfg.replace(
        data=cfg.data.replace(synthetic_num_clips=4, backend="threaded"),
        train=cfg.train.replace(**{
            "log_every": 1, "video_every": 0, "checkpoint_every_steps": 0,
            "checkpoint_dir": str(tmp_path / "ckpt"), "video_save_dir": str(tmp_path / "videos"), **train,
        }),
    )


def _lines(cfg):
    with open(os.path.join(cfg.train.checkpoint_dir, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


def _batches(cfg, seed):
    plan = curriculum_plan(cfg, 0)
    data_cfg = cfg.data.replace(batch_size=plan.batch_size, max_frames=plan.max_frames)
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in create_dataloader(data_cfg, seed=seed)]


def _hand_steps(cfg, batches, model=None, opt=None, generator=None, rate=2.0):
    """Metrics of ``train_step`` called by hand over ``batches`` (a fresh trainer's state by default)."""
    model = model or VideoVAE(cfg.model, device="cpu", seed=cfg.train.model_seed)
    opt = opt or create_optimizer(model, cfg.optim)
    generator = generator or torch.Generator("cpu").manual_seed(cfg.train.seed)
    hp = DynamicHParams.default(max_compression_rate=rate)
    return [
        {k: float(v) for k, v in train_step(model, opt, b["video"], b["mask"], hp, cfg.loss, None,
                                            generator=generator).items()}
        for b in batches
    ]


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert a.optimizer.count == b.optimizer.count
    for m, n in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(m, n)


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("frames", [8, 16, 32, 64])
@pytest.mark.parametrize("curriculum", [True, False])
def test_curriculum_plan_matches_jax(batch, frames, curriculum):
    for min_batch, max_frames in ((1, 64), (2, 32)):
        train = dict(curriculum=curriculum, curriculum_min_batch=min_batch, curriculum_max_frames=max_frames)
        ours = tiny_config()
        ours = ours.replace(data=ours.data.replace(batch_size=batch, max_frames=frames),
                            train=ours.train.replace(**train))
        theirs = jax_config.tiny_config()
        theirs = theirs.replace(data=theirs.data.replace(batch_size=batch, max_frames=frames),
                                train=theirs.train.replace(**train))
        for epoch in range(6):
            assert dataclasses.asdict(curriculum_plan(ours, epoch)) == dataclasses.asdict(
                jax_curriculum_plan(theirs, epoch))


@pytest.mark.parametrize("resumed", [False, True])
def test_hparams_for_step_match_jax(resumed):
    ours = SimpleNamespace(cfg=tiny_config(), _resumed=resumed)
    theirs = SimpleNamespace(cfg=jax_config.tiny_config(), _resumed=resumed)
    for step in (0, 2000, 2001):
        mine = dataclasses.asdict(Trainer.hparams_for_step(ours, step))
        want = JaxTrainer.hparams_for_step(theirs, step)  # f32 scalars
        assert {k: np.float32(v) for k, v in mine.items()} == {k: np.asarray(getattr(want, k)) for k in mine}
        assert mine["max_compression_rate"] == (100000.0 if resumed else 10000.0 if step > 2000 else 2.0)


ARGVS = {
    "defaults": [],
    "tiny": ["--tiny", "--steps", "2"],
    "synthetic small": ["--synthetic", "--small", "--batch_size", "4", "--max_frames", "16", "--resize", "128"],
    "every flag": [
        "--run", "--model_path", "m", "--data_dir", "d", "--eval_dir", "e", "--epochs", "3",
        "--selection_mode", "ste", "--vgg_weights", "v.npz", "--no_perceptual", "--checkpoint_dir", "c",
        "--fsdp", "2", "--tensor", "2", "--profile", "--gcs_prefix", "gs://b/r", "--independent_shards",
    ],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_from_args_matches_jax(name):
    """The JAX CLI's config, but for one deliberate difference: the port's data
    frames take the model's size (``--resize``), where JAX's stay at 256²."""
    argv = ARGVS[name]
    ours = cli.config_from_args(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    theirs = jax_config_from_args(jax_build_parser().parse_args(argv))
    want = dataclasses.asdict(theirs)
    want["data"]["resize"] = (theirs.model.height, theirs.model.width)
    assert dataclasses.asdict(ours) == want


def test_resize_sizes_the_data_to_the_model():
    """``--resize 64``: the synthetic loader's frames are the model's 64² (the JAX
    CLI's would be 256², which its model at 64² cannot take)."""
    from video_vae_tpu_torch.data.pipeline import create_dataloader

    argv = ["--synthetic", "--small", "--resize", "64", "--batch_size", "1", "--max_frames", "4", "--device", "cpu"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jax_config_from_args(jax_build_parser().parse_args(argv[:-2]))
    assert (cfg.model.height, cfg.model.width) == cfg.data.resize == (64, 64)
    assert theirs.data.resize == (256, 256) != (theirs.model.height, theirs.model.width)
    batch = next(iter(create_dataloader(cfg.data.replace(synthetic_num_clips=1), seed=0)))
    assert batch["video"].shape == (1, 4, 64, 64, 3)


def test_run_epoch_logs_the_hand_called_steps(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, install_signal_handlers=False, device="cpu")
    assert trainer.run_epoch(0)
    assert trainer.global_step == 2 and trainer.data_wait_s >= 0.0
    lines = _lines(cfg)
    assert [line["step"] for line in lines] == [1, 2]
    want = _hand_steps(cfg, _batches(cfg, cfg.data.seed))
    for line, metrics in zip(lines, want):
        assert metrics and {k: line[k] for k in metrics} == metrics
    assert trainer.ckpt.all_steps() == [2]  # the epoch's end


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_h2d_overlap_knob_keeps_the_metrics(tmp_path, monkeypatch, overlap):
    monkeypatch.setenv("VVT_H2D_OVERLAP", overlap)
    cfg = _cfg(tmp_path)
    assert Trainer(cfg, install_signal_handlers=False, device="cpu").run_epoch(0)
    want = _hand_steps(cfg, _batches(cfg, cfg.data.seed))
    assert [{k: line[k] for k in m} for line, m in zip(_lines(cfg), want)] == want


def test_checkpoint_round_trip_and_resumed_step(tmp_path):
    cfg = _cfg(tmp_path)
    first = Trainer(cfg, install_signal_handlers=False, device="cpu")
    assert first.run_epoch(0)
    resumed = Trainer(cfg, install_signal_handlers=False, device="cpu")
    assert resumed.global_step == 2 and resumed.optimizer.count == 2
    _same_state(first, resumed)
    assert resumed.hparams_for_step(resumed.global_step).max_compression_rate == 100000.0

    # the next step of the uninterrupted run and of the resumed one: the same batch, draws and hp
    batch = _batches(cfg, seed=9)[:1]
    for trainer in (first, resumed):
        trainer.next_metrics = _hand_steps(cfg, batch, trainer.model, trainer.optimizer,
                                           torch.Generator("cpu").manual_seed(5))
    assert first.next_metrics == resumed.next_metrics
    _same_state(first, resumed)

    # save_checkpoint / load_checkpoint by path, into a model with other weights
    path = str(tmp_path / "one")
    save_checkpoint(first.model, first.optimizer, path)
    other = SimpleNamespace(model=VideoVAE(cfg.model, device="cpu", seed=99))
    other.optimizer = create_optimizer(other.model, cfg.optim)
    load_checkpoint(other.model, other.optimizer, path)
    _same_state(first, other)


def test_checkpoint_manager_keeps_the_newest_and_skips_old_steps(tmp_path):
    cfg = tiny_config()
    model = VideoVAE(cfg.model, device="cpu")
    opt = create_optimizer(model, cfg.optim)
    manager = CheckpointManager(str(tmp_path / "m"), max_to_keep=3)
    for step in (1, 2, 3, 4, 5):
        assert manager.save(step, model, opt)
    assert not manager.save(5, model, opt) and not manager.save(2, model, opt)
    manager.wait()
    assert manager.all_steps() == [3, 4, 5]
    assert sorted(os.listdir(manager.step_dir(5))) == ["state.pt"]  # no temporary file left
    assert manager.restore_latest(model, opt) == 5
    manager.close()


def test_graceful_shutdown_saves_and_stops(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, install_signal_handlers=True, device="cpu")
    try:
        if signal.SIGTERM in trainer.shutdown._prev:  # installed: the main thread
            signal.raise_signal(signal.SIGTERM)
        else:
            trainer.shutdown._handler(signal.SIGTERM, None)
        assert trainer.shutdown.should_stop
        assert not trainer.run_epoch(0)  # one step, a checkpoint, then stop
    finally:
        trainer.shutdown.uninstall()
    assert trainer.global_step == 1 and trainer.ckpt.all_steps() == [1]


def test_run_eval_averages_the_scalars(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, install_signal_handlers=False, device="cpu")
    state = trainer.generator.get_state()
    avg = trainer.run_eval(0)
    generator = torch.Generator("cpu")
    generator.set_state(state)
    hp = trainer.hparams_for_step(0)
    per_batch = [eval_step(trainer.model, b["video"], b["mask"], hp, cfg.loss, None, generator=generator)
                 for b in _batches(cfg, cfg.data.seed + 10_000)]
    assert len(per_batch) == 2
    want = {k: sum(float(m[k]) for m in per_batch) / 2 for k in per_batch[0]}
    assert avg == want and "psnr_sampled" in avg
    assert {k: v for k, v in _lines(cfg)[-1].items() if k.startswith("eval_")} == {
        f"eval_{k}": v for k, v in want.items()}


def test_dump_videos_logs_psnr_and_writes_mp4s(tmp_path):
    cfg = _cfg(tmp_path, video_every=2)
    trainer = Trainer(cfg, install_signal_handlers=False, device="cpu")
    assert trainer.run_epoch(0)
    dumps = [line for line in _lines(cfg) if "dump_psnr_det" in line]
    assert [line["step"] for line in dumps] == [2]
    batch = _batches(cfg, cfg.data.seed)[1]  # step 2's batch, after its update
    recon = reconstruct(trainer.model, batch["video"], batch["mask"], device="cpu")
    assert dumps[0]["dump_psnr_det"] == float(masked_psnr(recon.float(), batch["video"], batch["mask"]))
    if HAVE_CV2:
        out = os.path.join(cfg.train.video_save_dir, "train", "epoch0")
        assert sorted(os.listdir(out)) == ["step2_original.mp4", "step2_recon.mp4"]


def test_metric_logger_lines_have_jax_keys(tmp_path, capsys):
    values = {"loss": 0.5, "grad_norm": 2.0, "kept_frame_density": 0.25}
    ours_dir, jax_dir = tmp_path / "ours", tmp_path / "jax"
    ours = MetricLogger(log_dir=str(ours_dir))
    ours.log({k: torch.tensor(v) for k, v in values.items()} | {"reconstruction": torch.zeros(2, 3)}, 7)
    ours.log({"psnr_sampled": torch.tensor(20.0)}, 7, prefix="eval_")
    ours.close()
    theirs = JaxMetricLogger(log_dir=str(jax_dir))
    theirs.log({k: jnp.asarray(v) for k, v in values.items()} | {"reconstruction": jnp.zeros((2, 3))}, 7)
    theirs.log({"psnr_sampled": jnp.asarray(20.0)}, 7, prefix="eval_")
    theirs.close()
    read = [[json.loads(line) for line in open(d / "train.jsonl")] for d in (ours_dir, jax_dir)]
    for a, b in zip(*read):
        assert a.keys() == b.keys()
        assert {k: v for k, v in a.items() if k != "elapsed"} == {k: v for k, v in b.items() if k != "elapsed"}
    echo = capsys.readouterr().out.splitlines()
    assert echo[0].startswith("[train step 7] loss=0.5, grad_norm=2") and echo[1].startswith("[eval_ step 7]")


def test_count_params_matches_jax():
    jax_model = nnx.eval_shape(lambda: JaxVideoVAE(jax_config.tiny_config().model, nnx.Rngs(0, sampling=1)))
    assert count_params(VideoVAE(tiny_config().model, device="cpu")) == jax_count_params(jax_model)


def test_cli_main_runs_and_resumes(tmp_path):
    ckpt = str(tmp_path / "c")
    argv = ["--tiny", "--steps", "2", "--device", "cpu", "--checkpoint_dir", ckpt]
    cli.main(argv)
    # --steps is checked between epochs: the first epoch (64 clips, batch 2) runs to its end
    assert CheckpointManager(ckpt).all_steps() == [32]
    assert os.path.exists(os.path.join(ckpt, "train.jsonl"))  # tiny logs every 50 steps: no line yet
    # the next run on that directory resumes from its checkpoint
    resumed = Trainer(cli.config_from_args(cli.build_parser().parse_args(argv)), install_signal_handlers=False,
                      device="cpu")
    assert resumed.global_step == 32 and resumed.optimizer.count == 32
    assert resumed.hparams_for_step(32).max_compression_rate == 100000.0


def test_cli_refuses_a_parallel_mesh(tmp_path):
    """A mesh whose product is not the number of ranks is refused, as JAX's
    ``build_mesh`` refuses it; here one process is one rank (the meshes that
    fit several ranks train in ``test_torch_distributed.py``)."""
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp\\*tensor=2"):
        cli.main(["--tiny", "--fsdp", "2", "--device", "cpu", "--checkpoint_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        Trainer(tiny_config().replace(mesh=tiny_config().mesh.replace(data=2)), device="cpu")


def _flat(tree, prefix=()):
    """(path, leaf) of orbax's restored nested dicts, where each nnx variable is {"value": leaf}."""
    if isinstance(tree, dict) and set(tree) != {"value"}:
        for key, value in tree.items():
            yield from _flat(value, prefix + (str(key),))
    else:
        yield prefix, tree["value"] if isinstance(tree, dict) else tree


def test_jax_orbax_checkpoint_carries_into_the_port(tmp_path):
    import orbax.checkpoint as ocp

    jcfg = jax_config.tiny_config()
    jax_model = nnx.jit(lambda: JaxVideoVAE(jcfg.model, nnx.Rngs(0, sampling=1)))()
    jax_opt = jax_create_optimizer(jax_model, jcfg.optim)
    rng = np.random.default_rng(0)
    count = 2345

    def fill(path, x):
        key = jax.tree_util.keystr(path)
        if "'mu'" in key:
            return jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        if "'nu'" in key:
            return jnp.asarray(rng.uniform(0.0, 1e-3, x.shape), x.dtype)
        if "['count']" in key:
            return jnp.asarray(count, x.dtype)
        return x

    nnx.update(jax_opt, jax.tree_util.tree_map_with_path(fill, nnx.state(jax_opt)))
    path = str(tmp_path / "jax_ckpt")
    jax_save_checkpoint(jax_model, jax_opt, path)

    restored = ocp.StandardCheckpointer().restore(path)
    params = {"/".join(p): np.asarray(v) for p, v in _flat(restored["model"])}
    opt_flat = {"/".join(p): np.asarray(v) for p, v in _flat(restored["optimizer"])}
    adam = "opt_state/1/0/"
    mu = {k[len(adam + "mu/"):]: v for k, v in opt_flat.items() if k.startswith(adam + "mu/")}
    nu = {k[len(adam + "nu/"):]: v for k, v in opt_flat.items() if k.startswith(adam + "nu/")}

    cfg = tiny_config()
    model = VideoVAE(cfg.model, device="cpu", seed=7)
    opt = create_optimizer(model, cfg.optim)
    assert load_jax_params(model, params) == len(params)
    assert load_jax_optimizer_state(opt, opt_flat[adam + "count"], mu, nu) == len(params)
    assert opt.count == count
    want = {"/".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jax_opt).flat_state()}
    assert np.asarray(want[adam + "mu/fill_token"]).any()  # the moments were filled
    for name, p, m, n in zip(opt.names, model.parameters(), opt.mu, opt.nu):
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
        np.testing.assert_array_equal(m.numpy(), want[adam + "mu/" + name])
        np.testing.assert_array_equal(n.numpy(), want[adam + "nu/" + name])
    lr = float(jax_make_lr_schedule(jcfg.optim)(count))
    assert abs(opt.schedule(opt.count) - lr) <= 1e-6 * jcfg.optim.learning_rate
    with pytest.raises(KeyError, match="missing"):
        load_jax_optimizer_state(opt, count, {k: v for k, v in list(mu.items())[1:]}, nu)
