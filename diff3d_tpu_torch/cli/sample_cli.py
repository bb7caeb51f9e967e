"""Novel-view sampling entry point (counterpart:
``diff3d_tpu/cli/sample_cli.py``).

``--model`` is a port state dict (``.pt``, ``torch.save(model.state_dict())``)
or a Flax parameter tree saved as an ``.npz`` of ``/``-joined paths,
carried over by :mod:`diff3d_tpu_torch.convert.from_jax`.  (Reading an
Orbax checkpoint needs JAX, so it waits; ``--scan_chunks`` and
``--raw_params`` have no counterpart here yet.)  Runs on the card unless
``--device`` names another.  Output layout: ``{out}/{step}/{gt,0..7}.png``.

Usage:
    python -m diff3d_tpu_torch.cli.sample_cli --model params.npz \
        --target ./data/SRN/cars_test/<object-id> [--out ./sampling]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

_WIDTH_KEYS = ("ch", "emb_ch", "num_res_blocks")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   help="port state dict (.pt) or Flax params (.npz)")
    p.add_argument("--target", required=True,
                   help="SRN object dir with rgb/ pose/ intrinsics/")
    p.add_argument("--out", default="sampling")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--steps", type=int, default=None,
                   help="diffusion steps (reference: 256)")
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    p.add_argument("--ch", type=int, default=None,
                   help="base channel width (must match the weights)")
    p.add_argument("--emb_ch", type=int, default=None,
                   help="conditioning embedding width")
    p.add_argument("--num_res_blocks", type=int, default=None,
                   help="res blocks per UNet level")
    p.add_argument("--imgsize", type=int, default=None,
                   help="square image resolution H=W")
    return p


def config_from_args(args):
    from diff3d_tpu_torch import config as config_lib

    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    if args.steps:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, timesteps=args.steps))
    over = {k: getattr(args, k) for k in _WIDTH_KEYS
            if getattr(args, k) is not None}
    if args.imgsize is not None:
        over["H"] = over["W"] = args.imgsize
    if over:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **over))
    return cfg


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from diff3d_tpu_torch.convert import load_flax_params, load_npz
    from diff3d_tpu_torch.data.srn import load_object_views
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    model = build_model(cfg.model, device)
    if args.model.endswith(".npz"):
        load_flax_params(model, load_npz(args.model))
    else:
        model.load_state_dict(torch.load(args.model, map_location=device,
                                         weights_only=True))
    logging.info("loaded %s", args.model)

    views = load_object_views(os.path.normpath(args.target), cfg.model.H)
    sampler = Sampler(model, cfg, device=device)
    sampler.synthesize(views, torch.Generator(device).manual_seed(args.seed),
                       out_dir=args.out, max_views=args.max_views)
    logging.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
