"""Training entry point (counterpart: ``diff3d_tpu/cli/train_cli.py``).

The flags this slice of the port acts on: ``--config``, ``--batch``,
``--steps``, ``--accum``, ``--workdir``, ``--transfer`` (resume from the
latest checkpoint, the data stream seeked to its step), ``--train_data``
/ ``--picklefile`` (SRN), ``--synthetic`` (the procedural dataset) or
``--synthetic_scenes`` / ``--scene_objects`` (ray-traced sphere scenes),
``--remat`` / ``--remat_policy`` (rematerialised UNet blocks),
``--num_workers``, ``--warmup_examples``, ``--ema_halflife_examples``,
``--ckpt_every``, ``--ckpt_mode`` / ``--ckpt_async`` (the checkpoint
modes of ``train/checkpoint.py``), ``--init_from`` / ``--init_res``
(seed the parameters and the EMA from a checkpoint trained at another
resolution, ``convert/progressive.py``), the model widths (``--ch``,
``--emb_ch``, ``--num_res_blocks``, ``--imgsize``, as ``sample_cli``
takes them), ``--eval_every`` / ``--val_data`` (the val loss of the EMA
weights every N steps, on held-out scenes or objects: ``--val_data`` in
full, else the val split of ``--train_data``), ``--device`` (the card
unless another is named) and ``--eager`` (the train step eagerly instead
of as CUDA graphs, for comparison).  SIGTERM or SIGINT stops a run
gracefully: the step it reached is checkpointed, and ``--transfer``
resumes there.

Data, tensor and context parallelism: launched by ``torchrun``, the ranks
form a ``(data, model)`` mesh with ``--model_parallel`` ranks on the model
axis (NCCL on the card, gloo with ``--device cpu``); every data rank
trains ``global_batch / data_size`` rows of each global batch;
``--param_sharding`` picks ``replicated`` (DDP: gradients all-reduced,
the step a CUDA graph), ``fsdp`` (FSDP2, eager), ``tp`` (the parameters
split Megatron-style over the model axis, eager) or ``fsdp+tp`` (both);
``--context_parallel`` (with ``--model_parallel N``) splits the
activations' image rows over the model axis, eager, with any of the
placements (under ``tp`` / ``fsdp+tp`` the parameters stay split and each
layer gathers its split leaves whole); rank 0 writes metrics and
checkpoints.  ``--elastic`` runs under the
elastic supervisor (re-mesh and resume after a preemption or a transient
fault; ``--elastic_max_remesh`` cycles in a row without progress give
up).  ``--pallas`` and ``--attn_impl auto|pallas`` name the kernels the
port runs on the card anyway (accepted and logged); ``--attn_impl xla``
asks for the plain versions, which the port runs only off the card: it is
accepted with ``--device cpu`` and refused on the card.  The JAX
package's other flags are unknown here (exit code 2).

Usage:
    python -m diff3d_tpu_torch.cli.train_cli --synthetic --steps 10 \\
        --warmup_examples 1280 --workdir runs/port_train
    python -m diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --synthetic --steps 2 --workdir /tmp/port_train
    python -m diff3d_tpu_torch.cli.train_cli --synthetic_scenes \\
        --config srn64 --ch 64 --emb_ch 512 --num_res_blocks 2 --batch 32 \\
        --steps 6000 --warmup_examples 20000 --eval_every 1000 \\
        --workdir runs/port_quality_r2
    python -m diff3d_tpu_torch.cli.train_cli --config srn128 --accum 4 \\
        --synthetic_scenes --steps 10 --warmup_examples 1280 \\
        --workdir runs/port_train128
    python -m diff3d_tpu_torch.cli.train_cli --config srn128 --ch 128 \\
        --accum 4 --synthetic_scenes --init_from runs/port_train/checkpoints \\
        --init_res 64 --workdir runs/port_train128_seeded
    torchrun --standalone --nproc_per_node 8 -m \\
        diff3d_tpu_torch.cli.train_cli --synthetic_scenes \\
        --param_sharding fsdp --workdir runs/port_train_dp
    torchrun --standalone --nproc_per_node 2 -m \\
        diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --synthetic --steps 2 --workdir /tmp/port_train_dp
    torchrun --standalone --nproc_per_node 2 -m \\
        diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --synthetic --steps 2 --param_sharding tp --model_parallel 2 \\
        --workdir /tmp/port_train_tp
    torchrun --standalone --nproc_per_node 2 -m \\
        diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --synthetic --steps 2 --context_parallel --model_parallel 2 \\
        --workdir /tmp/port_train_cp
    torchrun --standalone --nproc_per_node 2 -m \\
        diff3d_tpu_torch.cli.train_cli --device cpu --config test \\
        --imgsize 16 --synthetic --steps 2 --context_parallel \\
        --model_parallel 2 --param_sharding tp --workdir /tmp/port_train_cptp

(``--init_from`` keeps every width: srn64 is ch 128, srn128 ch 256, so a
64^2 -> 128^2 transfer takes ``--ch 128``.)
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from diff3d_tpu_torch.cli._common import (add_mesh_args,
                                          add_model_width_args,
                                          apply_mesh_overrides,
                                          apply_model_width_overrides)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--transfer", action="store_true",
                   help="resume from the latest checkpoint in --workdir")
    p.add_argument("--train_data", default="./data/SRN/cars_train")
    p.add_argument("--val_data", default=None,
                   help="directory of held-out objects for --eval_every's "
                        "in-training validation (used in full); without it, "
                        "the val split of --train_data is used")
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
    p.add_argument("--eval_every", type=int, default=None,
                   help="score the EMA weights on a held-out batch every N "
                        "steps (val split of --train_data, or --val_data "
                        "when given); logged as val_loss in metrics.jsonl")
    p.add_argument("--warmup_examples", type=int, default=None,
                   help="linear lr warmup span in examples (default: 10M; "
                        "shorten it for short runs or the lr stays ~0)")
    p.add_argument("--ema_halflife_examples", type=int, default=None,
                   help="EMA half-life in examples (default: 500K)")
    p.add_argument("--ckpt_every", type=int, default=None,
                   help="checkpoint cadence in steps")
    p.add_argument("--init_from", default=None,
                   help="seed params+EMA from this checkpoint (its EMA "
                        "weights, any mode), trained at --init_res with the "
                        "same width: progressive resolution transfer -- "
                        "pos_emb is bilinearly resized, every other "
                        "parameter copies.  Fresh optimizer and schedule "
                        "(unlike --transfer); skipped when --transfer "
                        "resumed past step 0")
    p.add_argument("--init_res", type=int, default=64,
                   help="resolution the --init_from checkpoint was trained "
                        "at")
    p.add_argument("--ckpt_mode", choices=["full", "ema_bf16", "full_sliced"],
                   default=None,
                   help="'full' (the default on a fresh directory): exact "
                        "resume, one file per checkpoint; 'ema_bf16': the "
                        "bf16 EMA only (eval weights, warm restart); "
                        "'full_sliced': exact resume, one file per tensor "
                        "with per-tensor retry and an atomic commit.  "
                        "Default: the directory's mode")
    p.add_argument("--ckpt_async", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="write full_sliced checkpoints from a background "
                        "thread (the default); --no-ckpt_async writes them "
                        "synchronously.  No effect on the other modes")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    p.add_argument("--eager", action="store_true",
                   help="run the train step eagerly instead of as CUDA "
                        "graphs (the comparison path)")
    add_mesh_args(p)
    p.add_argument("--context_parallel", action="store_true",
                   help="split the activations' image rows over the "
                        "model axis (--model_parallel N > 1; the step "
                        "eager).  With --param_sharding tp|fsdp+tp the "
                        "parameters stay split over the model axis and each "
                        "layer gathers its split leaves whole")
    p.add_argument("--attn_impl", default=None,
                   choices=["auto", "pallas", "xla"],
                   help="'auto' / 'pallas': the hand-written kernels, which "
                        "the port runs on the card anyway; 'xla': the "
                        "plain versions, which the port runs only off the "
                        "card (accepted with --device cpu)")
    p.add_argument("--pallas", action="store_true",
                   help="the fused GroupNorm kernels: the port runs them on "
                        "the card anyway (accepted and logged)")
    p.add_argument("--elastic", action="store_true",
                   help="train under the elastic supervisor: after a "
                        "preemption (SIGTERM) or a transient backend fault, "
                        "re-initialise the process group, rebuild the "
                        "mesh, restore the latest checkpoint and resume "
                        "the data stream at its step.  Resumes from the "
                        "latest checkpoint; --eval_every is not wired here")
    p.add_argument("--elastic_max_remesh", type=int, default=8,
                   help="give up after this many re-mesh cycles in a row "
                        "without progress (a cycle that advances the step "
                        "refills the budget)")
    add_model_width_args(p)
    return p


def refuse_unported(args) -> None:
    """Exit for ``--attn_impl xla`` on the card (the card's path runs the
    kernels, never their plain versions)."""
    if args.attn_impl == "xla" and (
            args.device is None or not str(args.device).startswith("cpu")):
        raise SystemExit(
            "--attn_impl xla asks for the plain attention, which the port "
            "runs only off the card: the card's path runs the hand-written "
            "kernels (take --attn_impl auto, or --device cpu)")


def log_kernel_flags(args) -> None:
    """Log what ``--pallas`` / ``--attn_impl`` name in the port."""
    if args.pallas or args.attn_impl in ("auto", "pallas"):
        logging.info("--pallas / --attn_impl %s: the hand-written CUDA "
                     "kernels (ops/csrc/film.cu, attention.cu) run on the "
                     "card; off the card their plain versions run",
                     args.attn_impl or "auto")
    if args.attn_impl == "xla":
        logging.info("--attn_impl xla: the plain versions (the CPU runs "
                     "nothing else)")


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
        ("ckpt_every", args.ckpt_every), ("eval_every", args.eval_every),
        ("ckpt_mode", args.ckpt_mode),
        ("ckpt_async", args.ckpt_async)) if v is not None}
    if over:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **over))
    cfg = apply_mesh_overrides(cfg, args)
    model_over = {k: v for k, v in (("remat", args.remat),
                                    ("remat_policy", args.remat_policy))
                  if v is not None}
    if model_over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **model_over))
    return apply_model_width_overrides(cfg, args)


def datasets(args, cfg):
    """``(train, val)`` datasets of ``args``; ``val`` is None without
    ``eval_every``.  Synthetic val sets are 8 objects from another seed
    (entirely different scenes); ``--val_data`` is used in full."""
    from diff3d_tpu_torch.data import (SRNDataset, SyntheticDataset,
                                       SyntheticScenesDataset)

    evals = bool(cfg.train.eval_every)
    H = cfg.model.H
    if args.synthetic_scenes:
        ds = SyntheticScenesDataset(num_objects=args.scene_objects,
                                    num_views=24, imgsize=H)
        val = (SyntheticScenesDataset(num_objects=8, num_views=24,
                                      imgsize=H, seed=1) if evals else None)
        return ds, val
    if args.synthetic:
        ds = SyntheticDataset(num_objects=64, num_views=32, imgsize=H)
        val = (SyntheticDataset(num_objects=8, num_views=32, imgsize=H,
                                seed=1) if evals else None)
        return ds, val
    split = dict(imgsize=H, split_seed=cfg.data.split_seed)
    ds = SRNDataset("train", args.train_data, args.picklefile,
                    train_fraction=cfg.data.train_fraction, **split)
    if not evals:
        return ds, None
    if args.val_data:
        return ds, SRNDataset("train", args.val_data, None,
                              train_fraction=1.0, **split)
    return ds, SRNDataset("val", args.train_data, args.picklefile,
                          train_fraction=cfg.data.train_fraction, **split)


def _setup(args):
    """``(cfg, device, env)`` of ``args``: the refusals first, then the
    mesh over the process group (if any) and the per-rank batch check."""
    import torch

    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.parallel import make_mesh

    refuse_unported(args)
    log_kernel_flags(args)
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
    try:
        env = make_mesh(cfg.mesh, model=cfg.model)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if cfg.train.global_batch % env.data_size:
        raise SystemExit(f"global batch {cfg.train.global_batch} does not "
                         f"split over {env.data_size} ranks")
    return cfg, device, env


def rank_loader(ds, cfg, env, *, seed: int, start_step: int = 0,
                num_workers: int = 0, sample_mode: str = "iid"):
    """This rank's :class:`InfiniteLoader`: ``global_batch / world`` rows,
    the rank's slots of each global batch."""
    from diff3d_tpu_torch.data import InfiniteLoader

    return InfiniteLoader(ds, cfg.train.global_batch // env.data_size,
                          seed=seed, host_id=env.data_rank,
                          num_hosts=env.data_size, num_workers=num_workers,
                          start_step=start_step, sample_mode=sample_mode)


def build_trainer(args, preemption: bool = False):
    """The :class:`~diff3d_tpu_torch.train.Trainer` of ``args`` on the
    mesh of the process group (one process: the no-group mesh), with this
    rank's loader attached and seeked to the (restored) step and its val
    loader (``--eval_every``); ``preemption`` installs its SIGTERM / SIGINT
    handler first (``main`` does; ``trainer.install_preemption_handler()``
    then returns the uninstaller, which the caller runs when done)."""
    from diff3d_tpu_torch.data import prefetch_to_device
    from diff3d_tpu_torch.train import Trainer

    cfg, device, env = _setup(args)
    ds, val_ds = datasets(args, cfg)
    trainer = Trainer(cfg, workdir=args.workdir, transfer=args.transfer,
                      device=device,
                      cuda_graphs=False if args.eager else None, env=env)
    if args.init_from:
        seed_from_checkpoint(trainer, args.init_from, args.init_res)
    if preemption:
        trainer.install_preemption_handler()
    # The loader is built after the restore, so a --transfer run seeks the
    # data stream to the restored step.  The val loader is not seeked (as
    # the JAX package's): a resumed run scores other val batches.
    loader = rank_loader(ds, cfg, env, seed=cfg.train.seed,
                         num_workers=args.num_workers,
                         start_step=trainer.state.step)
    trainer.loader = prefetch_to_device(loader, device)
    if val_ds is not None:
        trainer.val_loader = rank_loader(val_ds, cfg, env,
                                         seed=cfg.train.seed + 1,
                                         sample_mode="permute")
    return trainer


def build_supervisor(args):
    """The :class:`~diff3d_tpu_torch.train.ElasticSupervisor` of
    ``args``: each cycle's loader is this rank's, seeked to the restored
    step."""
    from diff3d_tpu_torch.data import prefetch_to_device
    from diff3d_tpu_torch.runtime.retry import (RetryPolicy,
                                                is_transient_backend_error)
    from diff3d_tpu_torch.train import ElasticSupervisor

    if args.init_from:
        raise SystemExit(
            "--elastic and --init_from are mutually exclusive: seed the "
            "workdir with a plain --init_from run first, then relaunch "
            "--elastic (it resumes from the latest checkpoint)")
    cfg, device, _ = _setup(args)
    ds, _ = datasets(args, cfg)

    def make_loader(step, env):
        return prefetch_to_device(
            rank_loader(ds, cfg, env, seed=cfg.train.seed, start_step=step,
                        num_workers=args.num_workers), device)

    return ElasticSupervisor(
        cfg, make_loader, workdir=args.workdir,
        retry=RetryPolicy(max_attempts=args.elastic_max_remesh,
                          base_delay_s=2.0, max_delay_s=60.0,
                          classify=is_transient_backend_error),
        device=device, cuda_graphs=False if args.eager else None)


def seed_from_checkpoint(trainer, path: str, init_res: int) -> None:
    """Progressive resolution transfer (``convert/progressive.py``): copy
    the EMA weights of the checkpoint at ``path``, trained at ``init_res``
    with the trainer's widths, into the trainer's parameters and EMA, with
    ``pos_emb`` resized.  In place, with ``copy_``: the trainer's captured
    step reads its tensors at their addresses, so a replaced tensor would
    never be read.  Skipped (logged) when the trainer already resumed past
    step 0."""
    import torch

    from diff3d_tpu_torch.cli._common import load_eval_params
    from diff3d_tpu_torch.convert.progressive import (
        adapt_params_resolution, check_resolution_compatible)
    from diff3d_tpu_torch.models import XUNet

    state = trainer.state
    if state.step > 0:
        logging.info(
            "--init_from %s SKIPPED: the workdir already resumed at step %d "
            "(progressive-transfer seeding only applies to a fresh run; "
            "point --workdir somewhere new to re-seed)", path, state.step)
        return
    mcfg = trainer.cfg.model
    src = XUNet(dataclasses.replace(mcfg, H=init_res, W=init_res))
    src_step = load_eval_params(path, src, raw_params=False)   # on the CPU
    params = adapt_params_resolution(
        {k: v.detach() for k, v in src.named_parameters()}, (mcfg.H, mcfg.W))
    if trainer.env.tensor_parallel:      # this rank's blocks
        params = {k: trainer.env.local_of(k, v) for k, v in params.items()}
    target = dict(state.model.named_parameters())
    check_resolution_compatible(params, target)
    with torch.no_grad():
        for name, p in target.items():
            p.copy_(params[name])
            state.ema[name].copy_(params[name])
    logging.info("seeded params+EMA from %s (step-%s %dx%d model) -> %dx%d",
                 path, src_step, init_res, init_res, mcfg.H, mcfg.W)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    import torch.distributed as dist

    from diff3d_tpu_torch.parallel import (maybe_initialize_distributed,
                                           shutdown_distributed)

    refuse_unported(args)
    # First: under torchrun this joins the group (NCCL takes LOCAL_RANK's
    # card before anything else touches CUDA).  A group the caller made
    # is used as it is and left up.
    owned = not dist.is_initialized() and maybe_initialize_distributed(
        device=args.device)
    try:
        if args.elastic:
            build_supervisor(args).run()
            return
        trainer = build_trainer(args, preemption=True)
        uninstall = trainer.install_preemption_handler()  # the one installed
        try:
            trainer.train()
        finally:
            trainer.loader.close()
            uninstall()
    finally:
        if owned:
            shutdown_distributed()


if __name__ == "__main__":
    main()
