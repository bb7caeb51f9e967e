"""Novel-view sampling entry point (counterpart:
``diff3d_tpu/cli/sample_cli.py``).

``--model`` is a checkpoint directory of the port's ``Trainer`` in any
mode (its latest checkpoint; ``convert_cli``'s output is one), one
``ckpt_<step>.pt``, a plain state dict
(``torch.save(model.state_dict())``) or a Flax parameter tree saved as an
``.npz`` of ``/``-joined paths (:func:`~diff3d_tpu_torch.cli._common.
load_eval_params`).  From a checkpoint it samples with the EMA weights,
or the raw ones under ``--raw_params``.  ``--sampler ddim`` samples
deterministically (a distilled k-step student: ``--sampler ddim --steps
k``).  (Reading an Orbax checkpoint
needs JAX, so it waits.)  Runs on the card unless ``--device`` names
another; there the reverse step runs as a CUDA graph.
Output layout: ``{out}/{step}/{gt,0..7}.png``.

Usage:
    python -m diff3d_tpu_torch.cli.sample_cli --model ./checkpoints \
        --target ./data/SRN/cars_test/<object-id> [--out ./sampling]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from diff3d_tpu_torch.cli._common import (add_model_width_args,
                                          apply_model_width_overrides,
                                          load_eval_params)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   help="checkpoint directory, ckpt_<step>.pt, port state "
                        "dict (.pt) or Flax params (.npz)")
    p.add_argument("--target", required=True,
                   help="SRN object dir with rgb/ pose/ intrinsics/")
    p.add_argument("--out", default="sampling")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--steps", type=int, default=None,
                   help="diffusion steps (reference: 256)")
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--scan_chunks", type=int, default=1,
                   help="split each view's reverse diffusion into this "
                        "many segments (must divide --steps; bit-identical "
                        "to 1)")
    p.add_argument("--sampler", choices=["ancestral", "ddim"],
                   default="ancestral",
                   help="reverse-process update: 'ancestral' (the paper's "
                        "stochastic sampler) or 'ddim' (deterministic, eta "
                        "= 0: a distilled k-step student samples with "
                        "--sampler ddim --steps k)")
    p.add_argument("--raw_params", action="store_true",
                   help="sample with raw params instead of EMA")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    add_model_width_args(p)
    return p


def config_from_args(args):
    from diff3d_tpu_torch import config as config_lib

    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    if args.steps:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, timesteps=args.steps))
    return apply_model_width_overrides(cfg, args)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from diff3d_tpu_torch.data.srn import load_object_views
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    model = build_model(cfg.model, device)
    load_eval_params(args.model, model, args.raw_params)

    views = load_object_views(os.path.normpath(args.target), cfg.model.H)
    try:
        sampler = Sampler(model, cfg, device=device,
                          sampler_kind=args.sampler,
                          scan_chunks=args.scan_chunks)
    except ValueError as e:     # --scan_chunks that does not divide --steps
        raise SystemExit(str(e))
    sampler.synthesize(views, torch.Generator(device).manual_seed(args.seed),
                       out_dir=args.out, max_views=args.max_views)
    logging.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
