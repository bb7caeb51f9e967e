"""Training entry point (counterpart: ``diff3d_tpu/cli/train_cli.py``).

The flags this slice of the port acts on: ``--config``, ``--batch``,
``--steps``, ``--accum``, ``--workdir``, ``--transfer`` (resume from the
latest checkpoint, the data stream seeked to its step), ``--train_data``
/ ``--picklefile`` (SRN), ``--synthetic`` (the procedural dataset) or
``--synthetic_scenes`` / ``--scene_objects`` (ray-traced sphere scenes),
``--remat`` / ``--remat_policy`` (rematerialised UNet blocks),
``--num_workers``, ``--warmup_examples``, ``--ema_halflife_examples``,
``--ckpt_every``, the model widths (``--ch``, ``--emb_ch``,
``--num_res_blocks``, ``--imgsize``, as ``sample_cli`` takes them),
``--device`` (the card unless another is named) and ``--eager`` (the
train step eagerly instead of as CUDA graphs, for comparison).
The JAX package's other flags wait for later slices of the port; the
parser rejects them as unknown (exit code 2).

Usage:
    python -m diff3d_tpu_torch.cli.train_cli --synthetic --steps 10 \\
        --warmup_examples 1280 --workdir runs/port_train
    python -m diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --synthetic --steps 2 --workdir /tmp/port_train
    python -m diff3d_tpu_torch.cli.train_cli --config srn128 --accum 4 \\
        --synthetic_scenes --steps 10 --warmup_examples 1280 \\
        --workdir runs/port_train128
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from diff3d_tpu_torch.cli._common import (add_model_width_args,
                                          apply_model_width_overrides)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="Not in this slice of the port (see ROADMAP.md): --val_data, "
               "--param_sharding, --model_parallel, --context_parallel, "
               "--attn_impl, --pallas, --eval_every, "
               "--init_from, --init_res, --ckpt_mode, --ckpt_async, "
               "--elastic, --elastic_max_remesh.")
    p.add_argument("--transfer", action="store_true",
                   help="resume from the latest checkpoint in --workdir")
    p.add_argument("--train_data", default="./data/SRN/cars_train")
    p.add_argument("--picklefile", default=None,
                   help="object index pickle; regenerated by globbing when "
                        "absent")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--batch", type=int, default=None,
                   help="global batch (default from the config: 128)")
    p.add_argument("--steps", type=int, default=None,
                   help="max optimizer steps")
    p.add_argument("--accum", type=int, default=None,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--workdir", default=".")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the procedural dataset (no SRN data)")
    p.add_argument("--synthetic_scenes", action="store_true",
                   help="train on the ray-traced sphere-scene dataset (a "
                        "true 3D novel-view task at toy scale)")
    p.add_argument("--scene_objects", type=int, default=64,
                   help="number of training scenes for --synthetic_scenes")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="rematerialise UNet blocks in the backward pass "
                        "(default from the config: on for srn128)")
    p.add_argument("--remat_policy", choices=["nothing", "dots"],
                   default=None,
                   help="what a rematerialised block keeps: its input "
                        "only, or also every conv / matmul output")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--warmup_examples", type=int, default=None,
                   help="linear lr warmup span in examples (default: 10M; "
                        "shorten it for short runs or the lr stays ~0)")
    p.add_argument("--ema_halflife_examples", type=int, default=None,
                   help="EMA half-life in examples (default: 500K)")
    p.add_argument("--ckpt_every", type=int, default=None,
                   help="checkpoint cadence in steps")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    p.add_argument("--eager", action="store_true",
                   help="run the train step eagerly instead of as CUDA "
                        "graphs (the comparison path)")
    add_model_width_args(p)
    return p


def config_from_args(args):
    from diff3d_tpu_torch import config as config_lib

    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    over = {k: v for k, v in (
        ("global_batch", args.batch), ("max_steps", args.steps),
        ("accum_steps", args.accum),
        ("warmup_examples", args.warmup_examples),
        ("ema_halflife_examples", args.ema_halflife_examples),
        ("ckpt_every", args.ckpt_every)) if v is not None}
    if over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **over))
    model_over = {k: v for k, v in (("remat", args.remat),
                                    ("remat_policy", args.remat_policy))
                  if v is not None}
    if model_over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_over))
    return apply_model_width_overrides(cfg, args)


def build_trainer(args):
    """The :class:`~diff3d_tpu_torch.train.Trainer` of ``args``, with its
    loader attached and seeked to the (restored) step."""
    import torch

    from diff3d_tpu_torch.data import (InfiniteLoader, SRNDataset,
                                       SyntheticDataset,
                                       SyntheticScenesDataset,
                                       prefetch_to_device)
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.train import Trainer

    if args.synthetic and args.synthetic_scenes:
        raise SystemExit(
            "--synthetic and --synthetic_scenes are mutually exclusive")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # Exact resume: cuDNN picks deterministic algorithms (the port's
        # own kernels use no float atomics).
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if args.synthetic_scenes:
        ds = SyntheticScenesDataset(num_objects=args.scene_objects,
                                    num_views=24, imgsize=cfg.model.H)
    elif args.synthetic:
        ds = SyntheticDataset(num_objects=64, num_views=32,
                              imgsize=cfg.model.H)
    else:
        ds = SRNDataset("train", args.train_data, args.picklefile,
                        imgsize=cfg.model.H, split_seed=cfg.data.split_seed,
                        train_fraction=cfg.data.train_fraction)
    trainer = Trainer(cfg, workdir=args.workdir, transfer=args.transfer,
                      device=device,
                      cuda_graphs=False if args.eager else None)
    loader = InfiniteLoader(ds, cfg.train.global_batch, seed=cfg.train.seed,
                            num_workers=args.num_workers,
                            start_step=trainer.state.step)
    trainer.loader = prefetch_to_device(loader, device)
    return trainer


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    trainer = build_trainer(args)
    try:
        trainer.train()
    finally:
        trainer.loader.close()


if __name__ == "__main__":
    main()
