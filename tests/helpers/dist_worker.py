"""One rank of ``tests/test_torch_distributed.py``: the port's sharded tiny train
step under each factorization of 4 ranks, on gloo, on the CPU.

It imports torch and the port only (the JAX references are computed in the
parent meanwhile). The parent writes ``inputs.pt`` (weights, VGG filters,
batch, draws); rank 0 writes ``results.pt``: per factorization the global
metrics and full gradients (gathered from the shards) of one ``loss_and_grads``, the metrics of each
``train_step`` and the full parameters after them; then the step after a
checkpoint saved under (1, 2, 2) and restored under (4, 1, 1), and two GAN
steps (``train/adversarial.py``) under data=2 x fsdp=2.
"""

import os

import torch
import torch.distributed as dist

# (label, mesh shape, num_heads, steps): TP over 4 ranks needs 4 heads
CASES = (("1,2,2", (1, 2, 2), 2, 3), ("4,1,1", (4, 1, 1), 2, 2), ("1,4,1", (1, 4, 1), 2, 2),
         ("1,1,4", (1, 1, 4), 4, 2))
SAVED_AFTER = 2  # steps of the (1, 2, 2) run before its checkpoint
GAN_MESH, GAN_STEPS = (2, 2, 1), 2  # the GAN step under data=2 x fsdp=2


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _build(shape, heads, inp):
    from video_vae_tpu_torch import VideoVAE, create_optimizer, load_jax_params, tiny_config
    from video_vae_tpu_torch.parallel.mesh import build_mesh
    from video_vae_tpu_torch.train.setup import create_sharded_model

    cfg = tiny_config(dtype="float32", num_heads=heads)
    mesh = build_mesh(*shape)
    model = create_sharded_model(lambda: VideoVAE(cfg.model, device="cpu"), mesh)
    load_jax_params(model, inp["params"][heads])
    return cfg, mesh, model, create_optimizer(model, cfg.optim, mesh)


def _step(model, opt, mesh, inp, heads, i, pf):
    from video_vae_tpu_torch import DynamicHParams, LossConfig, train_step
    from video_vae_tpu_torch.parallel.sharding import activate_mesh, batch_slice

    rows = batch_slice(len(inp["video"]), mesh)
    noise, uniforms = inp["draws"][heads][i]
    with activate_mesh(mesh):
        return _floats(train_step(
            model, opt, inp["video"][rows], inp["mask"][rows], DynamicHParams.default(),
            LossConfig(use_perceptual=True), pf,
            noise=noise[rows], uniforms=uniforms[2 * rows.start: 2 * rows.stop],
        ))


def _full_params(model, opt):
    from video_vae_tpu_torch.train.checkpoint import _state

    return {k.replace(".", "/"): v.clone() for k, v in _state(model, opt)["model"].items()}


def run_case(label, shape, heads, steps, inp, pf, tmp):
    from video_vae_tpu_torch import DynamicHParams, LossConfig
    from video_vae_tpu_torch.parallel.sharding import activate_mesh, batch_slice, clear_dispatch_log, dispatch_log
    from video_vae_tpu_torch.train.checkpoint import save_checkpoint
    from video_vae_tpu_torch.train.step import loss_and_grads

    cfg, mesh, model, opt = _build(shape, heads, inp)
    sharding = model.sharding
    rows = batch_slice(len(inp["video"]), mesh)
    noise, uniforms = inp["draws"][heads][0]
    clear_dispatch_log()
    with activate_mesh(mesh):
        _, metrics, grads = loss_and_grads(
            model, inp["video"][rows], inp["mask"][rows], DynamicHParams.default(),
            LossConfig(use_perceptual=True), pf,
            noise=noise[rows], uniforms=uniforms[2 * rows.start: 2 * rows.stop],
        )
    out = {
        "rows": (rows.start, rows.stop),
        "loss_metrics": _floats(metrics),
        "grads": {n: sharding.full(n, g, shard=True) for n, g in zip(sharding.names, grads)},
        "dispatch": sorted(set(dispatch_log())),
        "steps": [],
    }
    for i in range(steps):
        out["steps"].append(_step(model, opt, mesh, inp, heads, i, pf))
        if i + 1 == 2:
            out["params"] = _full_params(model, opt)
        if label == "1,2,2" and i + 1 == SAVED_AFTER:
            save_checkpoint(model, opt, os.path.join(tmp, "ckpt"))
    if label == "1,2,2":
        out["params_last"] = _full_params(model, opt)
    return out


def restore_case(inp, pf, tmp):
    """A fresh (4, 1, 1) model and optimizer, the (1, 2, 2) checkpoint, one step."""
    from video_vae_tpu_torch.train.checkpoint import load_checkpoint

    _, mesh, model, opt = _build((4, 1, 1), 2, inp)
    load_checkpoint(model, opt, os.path.join(tmp, "ckpt"))
    count = opt.count
    metrics = _step(model, opt, mesh, inp, 2, SAVED_AFTER, pf)
    return {"count": count, "step": metrics, "params": _full_params(model, opt)}


def rank_zero_writes(tmp):
    """Each rank asks for a log and a checkpoint in a directory of its own:
    only rank 0's may exist afterwards."""
    from video_vae_tpu_torch import VideoVAE, create_optimizer, tiny_config
    from video_vae_tpu_torch.parallel.mesh import build_mesh
    from video_vae_tpu_torch.train.checkpoint import CheckpointManager
    from video_vae_tpu_torch.train.metrics import MetricLogger
    from video_vae_tpu_torch.train.setup import create_sharded_model

    rank = dist.get_rank()
    cfg = tiny_config()
    mesh = build_mesh(2, 2, 1)
    model = create_sharded_model(lambda: VideoVAE(cfg.model, device="cpu"), mesh)
    opt = create_optimizer(model, cfg.optim, mesh)
    logger = MetricLogger(log_dir=os.path.join(tmp, f"log{rank}"))
    logger.log({"loss": torch.tensor(1.0)}, 1, echo=False)
    logger.close()
    manager = CheckpointManager(os.path.join(tmp, f"ckpt{rank}"), distributed=True)
    manager.save(1, model, opt)
    manager.wait()


def gan_case(inp, pf):
    """The GAN step under data=2 x fsdp=2 (one clip a rank), two steps: rank 0's
    global metrics, the full parameters of both models and the spectral norms'
    ``u`` after them, and whether every rank holds the same discriminator."""
    from video_vae_tpu_torch import DynamicHParams, LossConfig, load_jax_params
    from video_vae_tpu_torch.models import Discriminator
    from video_vae_tpu_torch.parallel.sharding import activate_mesh, batch_slice
    from video_vae_tpu_torch.train import create_optimizer, load_jax_batch_stats, make_adversarial_train_step

    cfg, mesh, model, opt = _build(GAN_MESH, 2, inp)
    disc = Discriminator(3, 4, 1, remat=False, dtype=torch.float32, device="cpu")
    load_jax_params(disc, inp["gan"]["d_params"])
    load_jax_batch_stats(disc, inp["gan"]["u"])
    d_opt = create_optimizer(disc, cfg.optim)
    step = make_adversarial_train_step(LossConfig(use_perceptual=True), pf)
    rows = batch_slice(len(inp["video"]), mesh)
    out = {"rows": (rows.start, rows.stop), "steps": []}
    for i in range(GAN_STEPS):
        noise, uniforms = inp["draws"][2][i]
        with activate_mesh(mesh):
            out["steps"].append(_floats(step(
                model, opt, disc, d_opt, inp["video"][rows], inp["mask"][rows], DynamicHParams.default(), i,
                noise=noise[rows], uniforms=uniforms[2 * rows.start: 2 * rows.stop],
            )))
    flat = torch.cat([p.detach().reshape(-1) for p in disc.parameters()] + [b.reshape(-1) for b in disc.buffers()])
    everyone = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(everyone, flat)
    out["d_replicated"] = all(torch.equal(flat, other) for other in everyone)
    out["params"] = _full_params(model, opt)
    out["d_params"] = {n.replace(".", "/"): p.detach().clone() for n, p in disc.named_parameters()}
    out["u"] = {n.replace(".", "/"): b.clone() for n, b in disc.named_buffers()}
    return out


def worker(rank, world, port, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        from video_vae_tpu_torch import load_jax_params
        from video_vae_tpu_torch.losses import make_perceptual_loss_fn
        from video_vae_tpu_torch.models.vgg import load_vgg

        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        vgg = load_vgg(None, device="cpu")
        load_jax_params(vgg, inp["vgg"])
        pf = make_perceptual_loss_fn(vgg)
        out = {label: run_case(label, shape, heads, steps, inp, pf, tmp) for label, shape, heads, steps in CASES}
        out["restore"] = restore_case(inp, pf, tmp)
        out["gan"] = gan_case(inp, pf)
        rank_zero_writes(tmp)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "results.pt"))
    finally:
        dist.destroy_process_group()
