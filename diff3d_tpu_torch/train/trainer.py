"""Trainer: model, train state, step, checkpoints and metrics (counterpart:
``diff3d_tpu/train/trainer.py``, ``init_params`` and ``Trainer.train``
:295-452).

JSONL metrics (loss, lr, grad_norm, steps/s, examples/s, wall seconds) at
the log cadence; checkpoints at the checkpoint cadence and the last step;
a non-finite loss or gradient norm halts with ``FloatingPointError``
before anything poisoned is saved; any other exception inside the loop
writes an emergency checkpoint and re-raises, so ``transfer=True``
resumes there (build the loader with ``start_step=trainer.state.step``).
Checkpoints are written in ``cfg.train.ckpt_mode``
(:mod:`~diff3d_tpu_torch.train.checkpoint`); ``train()`` returns once
they are on disk.  ``transfer=True`` on an ``ema_bf16`` directory is a
warm restart: parameters and EMA from the checkpoint's EMA, fresh Adam
moments, the schedule at its step.
The preemption handler, in-training evaluation, the elastic supervisor
and data parallelism wait for later slices.

Runs on the card unless ``device`` names another; there the train step
runs as CUDA graphs (``cuda_graphs=False`` runs it eagerly, for
comparison).  An exact resume on the card also needs deterministic cuDNN (``torch.backends.cudnn.deterministic
= True``, which ``cli/train_cli.py`` sets): the kernels of this package
use no float atomics.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Iterator, Optional, Union

import torch

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.graphs import use_cuda_graphs
from diff3d_tpu_torch.models import xunet
from diff3d_tpu_torch.train.checkpoint import CheckpointManager
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          set_schedule_step)
from diff3d_tpu_torch.train.step import make_train_step

log = logging.getLogger(__name__)


def init_params(model: xunet.XUNet, cfg: Config) -> xunet.XUNet:
    """Initialise ``model``'s parameters from ``cfg.train.seed`` (Flax's
    initialisers: see :func:`diff3d_tpu_torch.models.xunet.init_params`);
    returns the model."""
    xunet.init_params(model, torch.Generator().manual_seed(cfg.train.seed))
    return model


class Trainer:
    def __init__(self, cfg: Config, loader: Optional[Iterator] = None,
                 workdir: str = ".", transfer: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 cuda_graphs: Optional[bool] = None):
        """``loader`` yields batches on the trainer's device; it may be
        attached after construction (``self.loader``), so a resuming
        caller can seek it to ``self.state.step``.  ``cuda_graphs``: None
        captures the step on a CUDA device and runs it eagerly elsewhere,
        False runs it eagerly, True off a CUDA device raises."""
        cfg.validate()
        self.cfg = cfg
        self.loader = loader
        self.workdir = workdir
        self.device = resolve_device(device)
        graphs = use_cuda_graphs(cuda_graphs, self.device)
        model = init_params(xunet.XUNet(cfg.model), cfg)
        model = model.to(self.device).train()
        log.info("XUNet: %.1fM params",
                 sum(p.numel() for p in model.parameters()) / 1e6)
        self.state: TrainState = create_train_state(model, cfg.train)
        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.train.checkpoint_dir),
            keep=cfg.train.keep_checkpoints, mode=cfg.train.ckpt_mode,
            async_writes=cfg.train.ckpt_async)
        if transfer and self.ckpt.mode == "ema_bf16":
            # Warm restart: the checkpoint holds the EMA only, so the
            # parameters and the EMA both start from it, Adam's moments
            # from zero, and the schedule at the step (no second warmup).
            step = self.ckpt.restore_ema(self.state.ema)
            if step is not None:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        p.copy_(self.state.ema[name])
                set_schedule_step(self.state, step)
                self.state.step = step
                log.info("warm-restarted (ema_bf16) at step %d", step)
        elif transfer and self.ckpt.restore(self.state) is not None:
            log.info("resumed at step %d", self.state.step)
        self.step_fn = make_train_step(cfg, cuda_graphs=graphs)
        self._metrics_path = os.path.join(workdir, "metrics.jsonl")

    def _log(self, record: dict) -> None:
        os.makedirs(self.workdir, exist_ok=True)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        """Run the loop to ``max_steps`` (default ``cfg.train.max_steps``)
        and return the state."""
        if self.loader is None:
            raise ValueError("attach a loader before train()")
        cfg = self.cfg.train
        max_steps = max_steps if max_steps is not None else cfg.max_steps
        t0 = time.monotonic()
        step = self.state.step
        window_start, window_t = step, t0
        try:
            while step < max_steps:
                metrics = self.step_fn(self.state, next(self.loader))
                step = self.state.step
                last = step >= max_steps
                if (cfg.log_every > 0 and step % cfg.log_every == 0) or last:
                    loss = float(metrics["loss"])      # waits for the card
                    gnorm = float(metrics["grad_norm"])
                    now = time.monotonic()
                    sps = (step - window_start) / max(now - window_t, 1e-9)
                    window_start, window_t = step, now
                    self._log({"step": step, "loss": loss,
                               "lr": metrics["lr"], "grad_norm": gnorm,
                               "steps_per_sec": sps,
                               "examples_per_sec": sps * cfg.global_batch,
                               "wall_s": now - t0})
                    log.info("step %d loss %.4f (%.3f steps/s)", step, loss,
                             sps)
                    if not math.isfinite(loss):
                        raise FloatingPointError(
                            f"non-finite loss {loss} at step {step}; last "
                            "finite checkpoint preserved")
                if (cfg.ckpt_every > 0 and step % cfg.ckpt_every == 0) \
                        or last:
                    # Never persist a poisoned state: the loss comes from
                    # the pre-update parameters, so the gradient norm is
                    # checked too.
                    loss = float(metrics["loss"])
                    gnorm = float(metrics["grad_norm"])
                    if not (math.isfinite(loss) and math.isfinite(gnorm)):
                        raise FloatingPointError(
                            f"non-finite loss {loss} / grad_norm {gnorm} "
                            f"at step {step}; last finite checkpoint "
                            "preserved")
                    self.ckpt.save(self.state)
        except FloatingPointError:
            raise
        except BaseException:
            # Keep the last state so transfer=True loses at most the
            # interrupted step.
            try:
                self.ckpt.save(self.state, force=True)
                self.ckpt.wait_until_finished()
            except Exception:  # best effort; the original error wins
                log.exception("emergency checkpoint failed")
            raise
        # Durability: a returned train() means its checkpoints landed.
        self.ckpt.wait_until_finished()
        return self.state
