"""Convert a reference PyTorch checkpoint into a port checkpoint
(counterpart: ``diff3d_tpu/cli/convert_cli.py``).

Takes the reference's ``.pt`` files (``{'model': state_dict, 'optim':
..., 'step': ...}``, the published pretrained weights among them), checks
every key and shape against ``--config`` first (``--verify`` stops
there; a mismatch exits non-zero before anything is written), and writes
a ``full``-mode checkpoint (``<out>/ckpt_<step>.pt``) that ``sample_cli
--model <out>``, ``eval_cli --model <out>`` and ``train_cli --transfer``
(with ``<out>`` as ``<workdir>/checkpoints``) load as they are.  The
step is kept (``--step`` overrides it) and the warmup schedule is put at
it, so a converted step-100K checkpoint does not warm up again; Adam
starts from zero moments (the reference's torch Adam state is not
carried), and the EMA is seeded from the converted weights.  Runs on the
card unless ``--device`` names another.

Usage:
    python -m diff3d_tpu_torch.cli.convert_cli --torch_ckpt latest.pt \\
        --out ./checkpoints [--config srn64] [--verify]
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--torch_ckpt", required=True, help="reference .pt file")
    p.add_argument("--out", required=True,
                   help="checkpoint directory to write")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--step", type=int, default=None,
                   help="override the step recorded in the checkpoint")
    p.add_argument("--verify", action="store_true",
                   help="report every missing / extra / shape-mismatched "
                        "key against --config and exit without writing "
                        "(non-zero on a mismatch); the same check always "
                        "runs before a conversion")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.convert.torch_ckpt import (convert_state_dict,
                                                     read_torch_checkpoint,
                                                     verify_state_dict)

    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    sd, ckpt_step = read_torch_checkpoint(args.torch_ckpt)
    report = verify_state_dict(sd, cfg.model)
    if any(report.values()):
        for kind, items in report.items():
            for it in items:
                logging.error("verify: %s: %s", kind, it)
        raise SystemExit(
            f"{args.torch_ckpt} does not match --config {args.config}: "
            f"{len(report['missing'])} missing, {len(report['extra'])} "
            f"extra, {len(report['shape_mismatch'])} shape-mismatched "
            "keys (full list above)")
    logging.info("verify: %s matches the expected %s key set (%d tensors)",
                 args.torch_ckpt, args.config, len(sd))
    if args.verify:
        return

    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import (CheckpointManager,
                                        create_train_state,
                                        set_schedule_step)

    device = resolve_device(args.device)
    model = XUNet(cfg.model)
    model.load_state_dict(convert_state_dict(sd, cfg.model))
    state = create_train_state(model.to(device).train(), cfg.train)
    step = args.step if args.step is not None else ckpt_step
    set_schedule_step(state, step)
    state.step = step
    CheckpointManager(args.out, keep=1, mode="full").save(state, force=True)
    n = sum(p.numel() for p in model.parameters())
    logging.info("converted %s (%.1fM params, step %d) -> %s",
                 args.torch_ckpt, n / 1e6, step, args.out)


if __name__ == "__main__":
    main()
