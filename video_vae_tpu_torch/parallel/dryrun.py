"""One tiny train step under each factorization of the ranks it is launched on.

The counterpart of the JAX package's ``dryrun_multichip``: the primary
factorization (tensor 2 and fsdp 2 where the rank count allows), then pure
DP, FSDP only and TP only (``num_heads`` = max(2, n) so that the heads split
over the ranks). Each step must give a finite loss. The dispatch log must show
every attention and MLP kernel call giving way to the module chain under
tensor > 1, also with ``VVT_ATTN_SUBLAYER=1`` or ``VVT_MLP_FUSED=1``, and
under pure DP at least one fused-attention (or attention-sublayer) call
through its kernel's wrapper (``plain`` on the CPU, ``kernel`` on the card).

    python -m torch.distributed.run --nproc_per_node 4 -m video_vae_tpu_torch.parallel.dryrun --device cpu
"""

from __future__ import annotations

import argparse
import math

import torch
import torch.distributed as dist

# the ops that give way to the module chain under tensor > 1 (tensor_safe=False)
CHAIN_OPS = ("fused_attention", "fused_attention_bwd", "flash_attention", "flash_attention_bwd",
             "fused_attention_sublayer", "fused_mlp")


def run_one(data: int, fsdp: int, tensor: int, device: torch.device, **model_overrides):
    """One tiny train step on a (data, fsdp, tensor) mesh; (loss, sorted dispatches)."""
    from video_vae_tpu_torch.core.config import DynamicHParams, tiny_config
    from video_vae_tpu_torch.models.vae import VideoVAE
    from video_vae_tpu_torch.parallel.mesh import build_mesh
    from video_vae_tpu_torch.parallel.sharding import (
        activate_mesh, batch_slice, clear_dispatch_log, dispatch_log, local_rows,
    )
    from video_vae_tpu_torch.train.setup import create_optimizer, create_sharded_model
    from video_vae_tpu_torch.train.step import train_step

    mesh = build_mesh(data, fsdp, tensor, device_type=device.type)
    cfg = tiny_config(**model_overrides)
    batch = max(2, 2 * data * fsdp)  # divisible by the (data, fsdp) batch axes
    rows = batch_slice(batch, mesh)
    model = create_sharded_model(lambda: VideoVAE(cfg.model, device=device, seed=0), mesh)
    optimizer = create_optimizer(model, cfg.optim, mesh)
    video = torch.zeros(batch, cfg.data.max_frames, cfg.model.height, cfg.model.width, cfg.model.channels,
                        device=device)[rows]
    mask = torch.ones(batch, cfg.data.max_frames, device=device)[rows]
    clear_dispatch_log()
    with activate_mesh(mesh), local_rows(rows, batch):
        metrics = train_step(model, optimizer, video, mask, DynamicHParams.default(), cfg.loss, None,
                             generator=torch.Generator(device).manual_seed(0))
    loss = float(metrics["loss"])
    impls = sorted({f"{op}:{impl}" + (f":{list(ax)}" if ax else "") for op, impl, ax in dispatch_log()})
    if dist.get_rank() == 0:
        print(f"[dryrun] ({data},{fsdp},{tensor}) dispatches: {impls}", flush=True)
    if not math.isfinite(loss):
        raise AssertionError(f"({data},{fsdp},{tensor}): non-finite loss {loss}")
    attention = [(op, impl) for op, impl, _ in dispatch_log() if op in CHAIN_OPS]
    if tensor > 1:
        if not attention or any(impl != "chain" for _, impl in attention):
            raise AssertionError(f"({data},{fsdp},{tensor}): attention dispatches {sorted(set(attention))}")
    if dist.get_rank() == 0:
        print(f"[dryrun] ({data},{fsdp},{tensor}) train step OK, loss={loss:.4f}", flush=True)
    return loss, impls


def dryrun(device: torch.device) -> None:
    n = dist.get_world_size()
    tensor = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    data = n // (tensor * fsdp)
    run_one(data, fsdp, tensor, device)
    if n > 1:
        want = "kernel" if device.type == "cuda" else "plain"
        _, dp = run_one(n, 1, 1, device)
        if not any(s.split(":")[:2] in (["fused_attention", want], ["fused_attention_sublayer", want])
                   for s in dp):
            raise AssertionError(f"no fused attention through its kernel's wrapper under pure DP: {dp}")
        run_one(1, n, 1, device)
        run_one(1, 1, n, device, num_heads=max(2, n))
    if dist.get_rank() == 0:
        print(f"[dryrun] {n}-rank dryrun complete (all factorizations)", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None)
    args = p.parse_args(argv)
    from video_vae_tpu_torch.core.device import resolve_device
    from video_vae_tpu_torch.train.trainer import maybe_init_distributed

    device = maybe_init_distributed(resolve_device(args.device), args.dist_backend)
    if not dist.is_initialized():
        raise SystemExit("run this under python -m torch.distributed.run")
    if device.type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    try:
        dryrun(device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
