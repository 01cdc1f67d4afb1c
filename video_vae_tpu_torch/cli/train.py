"""Training CLI of the port: the JAX package's ``cli/train.py`` on the port's Trainer.

    python -m video_vae_tpu_torch.cli.train --data_dir /path/videos --run
    python -m video_vae_tpu_torch.cli.train --synthetic --tiny --steps 5 --device cpu

The flags and the config they build are the JAX CLI's, plus ``--device``
(default ``cuda``; without CUDA only ``--device cpu`` runs). ``--steps N``
stops after the first epoch that ends at or past step N: the count is
checked between epochs. ``--fsdp`` or ``--tensor`` above 1 raises: the port
trains on one device.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the video VAE")
    p.add_argument("--run", action="store_true", help="enable wandb logging")
    p.add_argument("--model_path", type=str, default=None, help="checkpoint to resume from")
    p.add_argument("--data_dir", type=str, default="/mnt/t9/videos")
    p.add_argument("--eval_dir", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--max_frames", type=int, default=32)
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps", type=int, default=0, help="stop after N steps (0 = full run)")
    p.add_argument("--selection_mode", choices=["rl", "ste", "none"], default="rl")
    p.add_argument("--tiny", action="store_true", help="CPU-runnable tiny config")
    p.add_argument("--small", action="store_true", help="small debug config")
    p.add_argument("--synthetic", action="store_true", help="synthetic data")
    p.add_argument("--vgg_weights", type=str, default=None)
    p.add_argument("--no_perceptual", action="store_true")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument(
        "--profile", action="store_true",
        help="capture a torch.profiler trace (steps 10-15) into "
             "<checkpoint_dir>/profile",
    )
    p.add_argument(
        "--gcs_prefix", type=str, default=None,
        help="gs:// prefix to mirror checkpoints and video dumps to",
    )
    p.add_argument(
        "--independent_shards", action="store_true",
        help="multi-process sampling with a seed per process over the full "
             "dataset instead of exact sharding",
    )
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def config_from_args(args):
    from video_vae_tpu_torch.core.config import VAEConfig, tiny_config

    if args.tiny:
        cfg = tiny_config()
    else:
        cfg = VAEConfig()
        model = cfg.model.replace(
            height=args.resize, width=args.resize, selection_mode=args.selection_mode
        )
        if args.small:
            model = model.replace(
                encoder_depth=2, decoder_depth=2, mlp_dim=256, qkv_features=128
            )
        cfg = cfg.replace(model=model)
    cfg = cfg.replace(
        data=cfg.data.replace(
            base_dir=args.data_dir,
            eval_dir=args.eval_dir,
            batch_size=args.batch_size if not args.tiny else cfg.data.batch_size,
            max_frames=args.max_frames if not args.tiny else cfg.data.max_frames,
            synthetic=args.synthetic or args.tiny,
            independent_shards=args.independent_shards,
        ),
        train=cfg.train.replace(
            num_epochs=args.epochs,
            checkpoint_dir=args.checkpoint_dir,
            profile_dir=(
                f"{args.checkpoint_dir}/profile" if args.profile else None
            ),
            gcs_upload_prefix=args.gcs_prefix,
        ),
        mesh=cfg.mesh.replace(fsdp=args.fsdp, tensor=args.tensor),
        loss=cfg.loss.replace(use_perceptual=not args.no_perceptual and not args.tiny),
    )
    return cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from video_vae_tpu_torch.train.trainer import Trainer

    cfg = config_from_args(args)
    trainer = Trainer(
        cfg,
        vgg_weights=args.vgg_weights,
        use_wandb=args.run,
        restore_from=args.model_path,
        device=args.device,
    )
    if args.steps:
        for epoch in range(cfg.train.num_epochs):
            if not trainer.run_epoch(epoch) or trainer.global_step >= args.steps:
                break
        trainer.ckpt.wait()
    else:
        trainer.fit()


if __name__ == "__main__":
    main()
