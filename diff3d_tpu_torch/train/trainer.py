"""Trainer: model, train state, step, checkpoints, metrics, in-training
evaluation and graceful preemption (counterpart:
``diff3d_tpu/train/trainer.py``, ``init_params`` and ``Trainer`` :75-452).

JSONL metrics (loss, lr, grad_norm, steps/s, examples/s, wall seconds) at
the log cadence; checkpoints at the checkpoint cadence and the last step;
with ``cfg.train.eval_every`` and a ``val_loader`` attached, the val loss
of the EMA weights (``{"step", "val_loss"}``) every ``eval_every`` steps
and at the last step.  A non-finite loss or gradient norm halts with
``FloatingPointError`` before anything poisoned is saved; any other
exception inside the loop writes an emergency checkpoint and re-raises,
so ``transfer=True`` resumes there (build the loader with
``start_step=trainer.state.step``).  With
:meth:`Trainer.install_preemption_handler`, SIGTERM or SIGINT stops the
loop at the next step boundary with that exact step checkpointed and on
disk; ``train()`` then returns.  Transient backend errors in a step's
microbatch phase are retried (``_STEP_RETRY``).
Checkpoints are written in ``cfg.train.ckpt_mode``
(:mod:`~diff3d_tpu_torch.train.checkpoint`); ``train()`` returns once
they are on disk.  ``transfer=True`` on an ``ema_bf16`` directory is a
warm restart: parameters and EMA from the checkpoint's EMA, fresh Adam
moments, the schedule at its step.
The elastic supervisor, the multi-process stop agreement and data
parallelism wait for the parallel slice (ROADMAP A10).

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
import signal
import threading
import time
from typing import Iterator, Optional, Union

import torch

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.data.images import dequantize
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.diffusion import TrainDraws, p_losses
from diff3d_tpu_torch.graphs import use_cuda_graphs
from diff3d_tpu_torch.models import xunet
from diff3d_tpu_torch.runtime.retry import (RetryPolicy,
                                            is_transient_backend_error)
from diff3d_tpu_torch.train.checkpoint import CheckpointManager
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          set_schedule_step)
from diff3d_tpu_torch.train.step import (EVAL_TAG, INPUTS, make_train_step,
                                         step_seed)

log = logging.getLogger(__name__)

#: Retry around each step's microbatch phase.  Only errors the shared
#: classifier calls transient are retried (never a sticky CUDA error);
#: that phase starts from zeroed sums and a reseeded generator, so a
#: retry gives the same bits, and the in-place update after it is never
#: retried.  A real failure propagates to the emergency checkpoint.
_STEP_RETRY = RetryPolicy(max_attempts=3, base_delay_s=5.0,
                          max_delay_s=30.0,
                          classify=is_transient_backend_error)


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
        self.step_fn = make_train_step(cfg, cuda_graphs=graphs,
                                       retry=_STEP_RETRY)
        self._metrics_path = os.path.join(workdir, "metrics.jsonl")
        self._preempted = threading.Event()
        self.preempt_observed_step: Optional[int] = None
        self._preempt_uninstall = None   # cached by install_preemption_handler
        self._in_handler = False         # re-entrancy guard (main thread only)
        self._eval_gen: Optional[torch.Generator] = None
        self.val_loader: Optional[Iterator] = None

    def install_preemption_handler(
            self, signals=(signal.SIGTERM, signal.SIGINT)):
        """Catch preemption signals and stop gracefully: the loop
        checkpoints the step it is at, waits until the checkpoint is on
        disk, and returns.  Resume with ``transfer=True``.  The handler
        only sets a flag and chains the previous handler; it touches
        neither the card nor the checkpoint writer.

        Returns an ``uninstall()`` callable that puts the previous
        handlers back where this one is still installed (a handler
        installed later is left alone).  Idempotent: a second install
        returns the same uninstaller, a second ``uninstall()`` does
        nothing, and a signal that arrives while the handler runs only
        sets the flag.  SIGINT's default handler is not chained: its
        ``KeyboardInterrupt`` would turn the graceful stop into the
        emergency-checkpoint path.
        """
        if self._preempt_uninstall is not None:
            return self._preempt_uninstall

        prev = {}

        def handler(signum, frame):
            log.warning("signal %d: checkpointing and stopping", signum)
            self._preempted.set()
            if self._in_handler:
                return
            self._in_handler = True
            try:
                p = prev.get(signum)
                if callable(p) and p is not signal.default_int_handler:
                    p(signum, frame)
            finally:
                self._in_handler = False

        for s in signals:
            prev[s] = signal.getsignal(s)
            signal.signal(s, handler)

        def uninstall():
            if self._preempt_uninstall is not uninstall:
                return
            self._preempt_uninstall = None
            for s, p in prev.items():
                if signal.getsignal(s) is handler:
                    signal.signal(s, p if p is not None else signal.SIG_DFL)

        self._preempt_uninstall = uninstall
        return uninstall

    def _stop_requested(self, step: int) -> bool:
        """Whether a preemption signal arrived (one process: the local
        flag; the agreement across processes comes with ROADMAP A10)."""
        return self._preempted.is_set()

    def eval_draws(self, step: int) -> TrainDraws:
        """The val draws of step ``step``: the trainer's eval generator
        (never the train step's) seeded from ``(seed, step, 0xE7A1)``."""
        if self._eval_gen is None:
            self._eval_gen = torch.Generator(self.device)
        self._eval_gen.manual_seed(step_seed(self.cfg.train.seed, step,
                                             EVAL_TAG))
        return TrainDraws(self._eval_gen)

    def _eval_step(self, state: TrainState, batch, draws) -> torch.Tensor:
        """The val loss of ``batch`` under the EMA weights: ``p_losses``
        on the dequantized images with ``draws``, dropout off, no grad.
        The EMA tensors stand in for the parameters for the one call
        (``torch.func.functional_call``): no copy of the model, and no
        parameter of the train state moves."""
        model = state.model
        dcfg = self.cfg.diffusion
        batch = {k: torch.as_tensor(batch[k], device=self.device)
                 for k in INPUTS}

        def denoise(model_batch, cond_mask):
            return torch.func.functional_call(model, state.ema,
                                              (model_batch, cond_mask))

        model.eval()
        try:
            with torch.no_grad():
                return p_losses(
                    denoise, dequantize(batch["imgs"]), batch["R"],
                    batch["T"], batch["K"], draws, cond_prob=dcfg.cond_prob,
                    loss_type=dcfg.loss_type, logsnr_min=dcfg.logsnr_min,
                    logsnr_max=dcfg.logsnr_max)
        finally:
            model.train()

    def _log(self, record: dict) -> None:
        os.makedirs(self.workdir, exist_ok=True)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train(self, max_steps: Optional[int] = None,
              profile_steps: Optional[tuple] = None) -> TrainState:
        """Run the loop to ``max_steps`` (default ``cfg.train.max_steps``)
        and return the state.  ``profile_steps=(start, stop)`` traces
        steps ``start + 1 .. stop`` with ``torch.profiler`` into
        ``<workdir>/profile/trace_<start>_<stop>.json`` (start after the
        first step, so the capture is not traced)."""
        if self.loader is None:
            raise ValueError("attach a loader before train()")
        cfg = self.cfg.train
        max_steps = max_steps if max_steps is not None else cfg.max_steps
        t0 = time.monotonic()
        step = self.state.step
        window_start, window_t = step, t0
        prof = None
        try:
            while step < max_steps:
                if profile_steps and step == profile_steps[0]:
                    prof = self._start_profile()
                metrics = self.step_fn(self.state, next(self.loader))
                step = self.state.step
                last = step >= max_steps
                if prof is not None and step >= profile_steps[1]:
                    self._stop_profile(prof, *profile_steps)
                    prof = None
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
                saved_this_step = False
                if (cfg.ckpt_every > 0 and step % cfg.ckpt_every == 0) \
                        or last:
                    # Never persist a poisoned state: the loss comes from
                    # the pre-update parameters, so the gradient norm is
                    # checked too.
                    self._check_finite(metrics, f"at step {step}")
                    saved_this_step = self.ckpt.save(self.state)
                if (self.val_loader is not None and cfg.eval_every
                        and (step % cfg.eval_every == 0 or last)):
                    vloss = float(self._eval_step(
                        self.state, next(self.val_loader),
                        self.eval_draws(step)))
                    self._log({"step": step, "val_loss": vloss})
                    log.info("step %d val_loss %.4f", step, vloss)
                if self._stop_requested(step):
                    # Graceful preemption: persist the exact step and stop;
                    # a checkpoint the periodic branch wrote this step is
                    # not rewritten (a rewrite would reopen the window a
                    # kill mid-write could lose).
                    self.preempt_observed_step = step
                    log.warning("preemption flag observed at step %d", step)
                    if not saved_this_step:
                        self._check_finite(metrics,
                                           f"at preemption (step {step})")
                        self.ckpt.save(self.state, force=True)
                    self.ckpt.wait_until_finished()
                    log.warning("preempted at step %d; state saved", step)
                    break
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
        finally:
            if prof is not None:
                prof.stop()
        # Durability: a returned train() means its checkpoints landed.
        self.ckpt.wait_until_finished()
        return self.state

    @staticmethod
    def _check_finite(metrics, where: str) -> None:
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise FloatingPointError(
                f"non-finite loss {loss} / grad_norm {gnorm} {where}; "
                "last finite checkpoint preserved")

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, start: int, stop: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.workdir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            out, f"trace_{start}_{stop}.json"))
