"""Shared CLI plumbing (counterpart: ``diff3d_tpu/cli/_common.py``).

The checkpoint-consuming CLIs must rebuild the exact ``ModelConfig`` a
checkpoint was trained with, so the width flags that change the
parameters' shapes live here and every CLI takes them; and every CLI that
samples loads its weights through :func:`load_eval_params`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Optional

_WIDTH_KEYS = ("ch", "emb_ch", "num_res_blocks")


def add_model_width_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ch", type=int, default=None,
                   help="base channel width — must match the trained "
                        "checkpoint (reference: 128 at 64^2)")
    p.add_argument("--emb_ch", type=int, default=None,
                   help="conditioning embedding width (reference: 1024)")
    p.add_argument("--num_res_blocks", type=int, default=None,
                   help="res blocks per UNet level (reference: 3)")
    p.add_argument("--imgsize", type=int, default=None,
                   help="square image resolution H=W — overrides the "
                        "--config preset (must match the trained "
                        "checkpoint; must be divisible by 2^(levels-1))")


def apply_model_width_overrides(cfg, args):
    """Returns ``cfg`` with any of --ch/--emb_ch/--num_res_blocks applied,
    plus --imgsize (H=W resolution override)."""
    over = {k: getattr(args, k) for k in _WIDTH_KEYS
            if getattr(args, k, None) is not None}
    if getattr(args, "imgsize", None) is not None:
        over["H"] = over["W"] = args.imgsize
    if not over:
        return cfg
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **over))


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The placement flags of the training and evaluation CLIs: they set
    ``cfg.mesh`` (:func:`apply_mesh_overrides`), the config the JAX
    package's CLIs read it from."""
    p.add_argument("--param_sharding",
                   choices=["replicated", "fsdp", "tp", "fsdp+tp"],
                   default=None,
                   help="'replicated' (every rank the whole state), 'fsdp' "
                        "(FSDP2, the step eager), 'tp' (the parameters "
                        "split over the model axis, eager) or 'fsdp+tp' "
                        "(both); sampling keeps whole copies over the data "
                        "axis")
    p.add_argument("--model_parallel", type=int, default=None,
                   help="ranks on the mesh's model axis (tp / fsdp+tp, or "
                        "train_cli's --context_parallel)")


def apply_mesh_overrides(cfg, args):
    """Returns ``cfg`` with --param_sharding / --model_parallel (and
    --context_parallel, where the CLI takes it) applied to ``cfg.mesh``."""
    over = {k: getattr(args, k) for k in ("param_sharding", "model_parallel")
            if getattr(args, k, None) is not None}
    if getattr(args, "context_parallel", False):
        over["context_parallel"] = True
    if not over:
        return cfg
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                             **over))


def load_eval_params(path: str, model, raw_params: bool) -> Optional[int]:
    """Load the weights to sample with into ``model`` (in place, on its
    device) and return their training step (None where the file does not
    record one).

    ``path`` is any of: a checkpoint directory of the port's ``Trainer``
    in any of its modes (``full``, ``ema_bf16``, ``full_sliced``, read by
    the directory's marker; its latest checkpoint); one
    ``ckpt_<step>.pt``; a plain state dict
    (``torch.save(model.state_dict())``); a Flax parameter tree saved as
    an ``.npz``.  From a checkpoint the EMA weights load, or the raw ones
    under ``raw_params`` (the reference's ``--raw_params``; an
    ``ema_bf16`` checkpoint has none and raises ``ValueError``); a plain
    state dict or an ``.npz`` holds one set of weights, which loads as it
    is.  The log says which set loaded."""
    import torch

    from diff3d_tpu_torch.convert import load_flax_params, load_npz
    from diff3d_tpu_torch.train.checkpoint import CheckpointManager

    which = "raw" if raw_params else "EMA"
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        step = mgr.restore_ema(dict(model.named_parameters()),
                               raw=raw_params)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        logging.info("loaded the %s weights of step %d from %s (mode %s)",
                     which, step, path, mgr.mode)
        return step
    if path.endswith(".npz"):
        load_flax_params(model, load_npz(path))
        logging.info("loaded the Flax parameters of %s (one set of "
                     "weights)", path)
        return None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and {"ema", "step"} <= set(ckpt):
        if raw_params:
            if "model" not in ckpt:
                raise ValueError(f"{path} is an ema_bf16 checkpoint: it has "
                                 "no raw parameters (--raw_params "
                                 "unavailable)")
            model.load_state_dict(ckpt["model"])
        else:
            params = dict(model.named_parameters())
            if set(ckpt["ema"]) != set(params):
                raise KeyError(f"{path}: the EMA's parameter names differ "
                               "from the model's")
            with torch.no_grad():
                for name, t in ckpt["ema"].items():
                    params[name].copy_(t)
        step = int(ckpt["step"])
        logging.info("loaded the %s weights of step %d from %s", which,
                     step, path)
        return step
    model.load_state_dict(ckpt)
    logging.info("loaded the state dict %s as it is (one set of weights%s)",
                 path, "; --raw_params has no other set to pick"
                 if raw_params else "")
    return None
