"""Trainer: model, train state, step, checkpoints, metrics, in-training
evaluation, graceful preemption, data parallelism and the elastic
supervisor (counterpart: ``diff3d_tpu/train/trainer.py``).

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

``env`` (a :class:`~diff3d_tpu_torch.parallel.MeshEnv`; default
``make_mesh(cfg.mesh)``, the one-process mesh without a process group)
makes it data-parallel: each rank's loader yields its ``global_batch /
world`` rows (``InfiniteLoader(host_id=rank, num_hosts=world)``), the
step all-reduces the gradients (:mod:`~diff3d_tpu_torch.train.step`),
metrics and checkpoint files are written by rank 0 only, an evaluation
scores one global val batch (each rank its rows, the losses averaged),
and the stop flag is an agreement: at every step boundary the local flags
are all-reduced with MAX over a gloo group of every rank of the mesh (a
host op, no device synchronisation), so every rank stops and saves at the
same step.  Under ``tp`` / ``fsdp+tp`` the ranks of one model group share
their data rank (its loader rows, the step's draws) and the parameters,
Adam's moments and the EMA are split over the model axis; checkpoints
gather them whole (:mod:`~diff3d_tpu_torch.train.checkpoint`).  Under
``context_parallel`` the ranks of one model group share their data rank
too and each runs the model on its image rows; the state is whole on
every rank (rank 0 writes it), or placed as ``fsdp`` / ``tp`` /
``fsdp+tp`` place it (gathered whole for a checkpoint); the step runs
eagerly.
:class:`ElasticSupervisor` re-meshes and resumes around
:meth:`Trainer.train` after preemptions and transient faults.

Runs on the card unless ``device`` names another; there the train step
runs as CUDA graphs (``cuda_graphs=False`` runs it eagerly, for
comparison).  An exact resume on the card also needs deterministic cuDNN (``torch.backends.cudnn.deterministic
= True``, which ``cli/train_cli.py`` sets): the kernels of this package
use no float atomics.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import random
import signal
import threading
import time
from typing import Callable, Iterator, List, Optional, Union

import torch
import torch.distributed as dist

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.data.images import dequantize
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.diffusion import TrainDraws, p_losses
from diff3d_tpu_torch.graphs import use_cuda_graphs
from diff3d_tpu_torch.models import xunet
from diff3d_tpu_torch.parallel.mesh import MeshEnv, make_mesh
from diff3d_tpu_torch.parallel.multihost import (is_primary,
                                                 reinitialize_distributed,
                                                 shard_host_local)
from diff3d_tpu_torch.runtime.retry import (RetryBudget, RetryPolicy,
                                            is_transient_backend_error)
from diff3d_tpu_torch.train.checkpoint import CheckpointManager
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          set_schedule_step)
from diff3d_tpu_torch.train.step import (EVAL_TAG, INPUTS, RankDraws,
                                         _local, make_train_step, step_seed)

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
                 cuda_graphs: Optional[bool] = None,
                 env: Optional[MeshEnv] = None):
        """``loader`` yields batches on the trainer's device (this rank's
        rows under data parallelism); it may be attached after
        construction (``self.loader``), so a resuming caller can seek it to
        ``self.state.step``.  ``cuda_graphs``: None captures the step on a
        CUDA device and runs it eagerly elsewhere, False runs it eagerly,
        True off a CUDA device raises; under ``fsdp`` the step always runs
        eagerly (True raises).  ``env``: the mesh (default
        ``make_mesh(cfg.mesh)``)."""
        cfg.validate()
        self.cfg = cfg
        self.loader = loader
        self.workdir = workdir
        self.env = env if env is not None else make_mesh(cfg.mesh,
                                                         model=cfg.model)
        self.device = resolve_device(device)
        eager = self.env.eager_only
        if eager and cuda_graphs is None and self.device.type == "cuda":
            log.info("param_sharding=%r%s: the train step runs eagerly "
                     "(FSDP2's all-gathers and the model axis's "
                     "collectives are not captured)",
                     self.env.cfg.param_sharding,
                     " with context_parallel"
                     if self.env.context_parallel else "")
            cuda_graphs = False
        graphs = use_cuda_graphs(cuda_graphs, self.device)
        model = init_params(xunet.XUNet(cfg.model), cfg)
        model = self.env.params(model.to(self.device).train())
        log.info("XUNet: %.1fM params",
                 sum(p.numel() for p in model.parameters()) / 1e6)
        self.state: TrainState = create_train_state(
            model, cfg.train, capturable=False if eager else None)
        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.train.checkpoint_dir),
            keep=cfg.train.keep_checkpoints, mode=cfg.train.ckpt_mode,
            async_writes=cfg.train.ckpt_async)
        # Stamped before any restore: a restore into another topology is
        # then a recognised reshard.
        self.ckpt.mesh_info = self.env.topology_summary()
        if self.env.tensor_parallel:
            self.ckpt.placement = self.env
        if transfer and self.ckpt.mode == "ema_bf16":
            # Warm restart: the checkpoint holds the EMA only, so the
            # parameters and the EMA both start from it, Adam's moments
            # from zero, and the schedule at the step (no second warmup).
            step = self.ckpt.restore_ema(self.state.ema)
            if step is not None:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        _local(p).copy_(_local(self.state.ema[name]))
                set_schedule_step(self.state, step)
                self.state.step = step
                log.info("warm-restarted (ema_bf16) at step %d", step)
        elif transfer and self.ckpt.restore(self.state) is not None:
            log.info("resumed at step %d", self.state.step)
        self.step_fn = make_train_step(
            cfg, cuda_graphs=graphs, retry=_STEP_RETRY,
            env=self.env if self.env.group is not None else None)
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
        """Whether to stop at this step boundary.  One process: the local
        flag.  Several: an agreement, the MAX of every rank's flag over
        the mesh's gloo group (a host op), so a signal seen by any rank
        stops every rank at the same step (a local flag alone would split
        the ranks between a collective save and a collective step)."""
        local = self._preempted.is_set()
        if self.env.data_size * self.env.model_size == 1:
            return local
        flag = torch.tensor([1 if local else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=self.env.cpu_world_group)
        return bool(flag.item())

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
        parameter of the train state moves.  Under data parallelism
        ``batch`` is this rank's rows of one global val batch: the draws
        are the global batch's (:class:`RankDraws`) and the ranks' losses
        are averaged.  An FSDP state swaps the EMA's shards into the
        parameters' for the call (FSDP2 gathers from its own shards)."""
        model = state.model
        dcfg = self.cfg.diffusion
        batch = shard_host_local({k: batch[k] for k in INPUTS}, self.device)
        world, group = self.env.data_size, self.env.group
        if world > 1:
            draws = RankDraws(draws, self.env.data_rank, world)
        sharded = self.env.sharded(model)

        def denoise(model_batch, cond_mask):
            if sharded:
                return model(model_batch, cond_mask)
            return torch.func.functional_call(model, state.ema,
                                              (model_batch, cond_mask))

        model.eval()
        stash = None
        try:
            with torch.no_grad():
                if sharded:
                    stash = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
                    for n, p in model.named_parameters():
                        _local(p).copy_(_local(state.ema[n]))
                loss = p_losses(
                    denoise, dequantize(batch["imgs"]), batch["R"],
                    batch["T"], batch["K"], draws, cond_prob=dcfg.cond_prob,
                    loss_type=dcfg.loss_type, logsnr_min=dcfg.logsnr_min,
                    logsnr_max=dcfg.logsnr_max)
                if world > 1:
                    dist.all_reduce(loss, group=group)
                    loss = loss / world
                return loss
        finally:
            if stash is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        _local(p).copy_(_local(stash[n]))
            model.train()

    def _log(self, record: dict) -> None:
        if not is_primary():
            return
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
            # interrupted step.  A sharded state's save gathers over every
            # rank, which a rank failing alone cannot do.
            if (self.env.data_size > 1 and self.env.sharded(
                    self.state.model)) or self.env.tensor_parallel:
                log.error("no emergency checkpoint of a sharded state")
                raise
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


# ---- elasticity -----------------------------------------------------

#: The elastic loop's states (the JAX package's ``ELASTIC_*``): they go
#: into the log and ``metrics.jsonl`` as ``{"elastic": <state>, ...}``.
ELASTIC_RUNNING = "RUNNING"
ELASTIC_REMESHING = "REMESHING"
ELASTIC_RESUMED = "RESUMED"
ELASTIC_GAVE_UP = "GAVE_UP"


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """One transition of the elastic loop."""

    state: str          # one of the ELASTIC_* constants
    cycle: int          # 1-based re-mesh cycle
    step: int           # the trainer's step at the transition
    n_devices: int      # devices of the cycle's mesh (0: unknown)
    reason: str = ""
    wall_s: float = 0.0

    def record(self) -> dict:
        return {"elastic": self.state, "cycle": self.cycle,
                "step": self.step, "n_devices": self.n_devices,
                "reason": self.reason, "wall_s": round(self.wall_s, 3)}


class ElasticityGaveUp(RuntimeError):
    """The supervisor spent its no-progress budget; ``events`` is the whole
    history."""

    def __init__(self, msg: str, events: List[ElasticEvent]):
        super().__init__(msg)
        self.events = list(events)


class ElasticSupervisor:
    """Re-mesh-and-resume loop around :meth:`Trainer.train` (reference
    ``trainer.py:496-668``).

    On a preemption (the trainer's handler saw SIGTERM / SIGINT and
    ``train()`` returned early) or a transient backend fault (a failed
    collective, a reset connection), the cycle is torn down, the process
    group re-initialised (``destroy_process_group`` then
    :func:`~diff3d_tpu_torch.parallel.multihost.reinitialize_distributed`),
    the mesh rebuilt, the latest durable checkpoint restored (a restore
    into another topology is recorded as a reshard) and the input stream
    resumed at the restored step (``make_loader(step, env)``: the loader's
    global stream is a pure function of ``(seed, step)``, so a new
    partition neither replays nor skips).  Under torchrun, a change of
    the rank set itself comes from the elastic agent
    (``torchrun --nnodes MIN:MAX --max-restarts K``), which restarts the
    workers; the restarted run resumes here with the reshard recorded.

    Give-up: ``retry.max_attempts`` cycles in a row without progress (the
    step never advanced) spend the :class:`RetryBudget` and raise
    :class:`ElasticityGaveUp`; a cycle that advanced refills it.

    Seams: ``make_loader(step, env)`` builds the cycle's iterator;
    ``topology_fn()`` returns the cycle's :class:`MeshEnv` (default
    ``make_mesh(cfg.mesh)``); ``reinit_fn()`` re-dials the process group
    (default: :func:`reinitialize_distributed` from the second cycle on,
    where a group is up); ``fault_hook(site)`` fires at
    ``"elastic.cycle"`` each bring-up (``testing.faults``).
    """

    def __init__(self, cfg: Config,
                 make_loader: Callable[[int, MeshEnv], Iterator],
                 workdir: str = ".",
                 topology_fn: Optional[Callable[[], MeshEnv]] = None,
                 reinit_fn: Optional[Callable[[], object]] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_hook: Optional[Callable[[str], None]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 cuda_graphs: Optional[bool] = None):
        self.cfg = cfg
        self.make_loader = make_loader
        self.workdir = workdir
        self.topology_fn = topology_fn
        self.reinit_fn = reinit_fn
        self.device = device
        self.cuda_graphs = cuda_graphs
        self.retry = retry or RetryPolicy(
            max_attempts=8, base_delay_s=2.0, max_delay_s=60.0,
            classify=is_transient_backend_error)
        self._budget = RetryBudget(self.retry.max_attempts)
        self._fire = fault_hook or (lambda site: None)
        self._metrics_path = os.path.join(workdir, "metrics.jsonl")
        self._lock = threading.Lock()
        self._events: List[ElasticEvent] = []  # guarded by _lock
        self.trainer: Optional[Trainer] = None

    @property
    def events(self) -> List[ElasticEvent]:
        with self._lock:
            return list(self._events)

    def _emit(self, ev: ElasticEvent) -> None:
        with self._lock:
            self._events.append(ev)
        log.warning("elastic %s: cycle %d step %d on %d devices%s",
                    ev.state, ev.cycle, ev.step, ev.n_devices,
                    f" ({ev.reason})" if ev.reason else "")
        if is_primary():
            os.makedirs(self.workdir, exist_ok=True)
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(ev.record()) + "\n")

    def _give_up(self, cycle: int, step: int, n_dev: int, reason: str,
                 t0: float) -> None:
        self._emit(ElasticEvent(ELASTIC_GAVE_UP, cycle, step, n_dev,
                                reason, time.monotonic() - t0))
        raise ElasticityGaveUp(
            f"elasticity budget exhausted: {self._budget.spent} "
            f"consecutive no-progress cycles (last: {reason})", self.events)

    def _bring_up(self, cycle: int) -> MeshEnv:
        if self.reinit_fn is not None:
            self.reinit_fn()
        elif cycle > 1 and dist.is_initialized():
            reinitialize_distributed(
                device=None if self.device is None else str(self.device))
        if self.topology_fn is not None:
            return self.topology_fn()
        return make_mesh(self.cfg.mesh, model=self.cfg.model)

    def run(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``max_steps`` (default ``cfg.train.max_steps``),
        surviving preemptions and transient faults by re-meshing; returns
        the final state."""
        max_steps = (max_steps if max_steps is not None
                     else self.cfg.train.max_steps)
        t0 = time.monotonic()
        rng = random.Random(self.retry.seed)
        cycle = 0
        while True:
            cycle += 1
            trainer = loader = uninstall = None
            step0, n_dev = -1, 0
            try:
                self._fire("elastic.cycle")
                env = self._bring_up(cycle)
                n_dev = int(env.topology_summary()["n_devices"])
                trainer = Trainer(self.cfg, env=env, workdir=self.workdir,
                                  transfer=True, device=self.device,
                                  cuda_graphs=self.cuda_graphs)
                self.trainer = trainer
                step0 = trainer.state.step
                reshard = trainer.ckpt.last_restore_reshard
                reason = ""
                if reshard is not None:
                    reason = (f"resharded step {reshard['step']}: "
                              f"{reshard['from']['n_devices']} -> "
                              f"{reshard['to']['n_devices']} devices")
                loader = self.make_loader(step0, env)
                trainer.loader = loader
                self._emit(ElasticEvent(
                    ELASTIC_RESUMED if cycle > 1 else ELASTIC_RUNNING,
                    cycle, step0, n_dev, reason, time.monotonic() - t0))
                uninstall = trainer.install_preemption_handler()
                state = trainer.train(max_steps)
                step = state.step
                if step >= max_steps:
                    return state
                # Returned early: a graceful preemption.  Progress refills
                # the budget; a storm pinning the run to one step spends it.
                if step > step0:
                    self._budget.reset()
                elif not self._budget.spend():
                    self._give_up(cycle, step, n_dev,
                                  "preempted without progress", t0)
                self._emit(ElasticEvent(
                    ELASTIC_REMESHING, cycle, step, n_dev, "preemption",
                    time.monotonic() - t0))
            except (FloatingPointError, ElasticityGaveUp):
                raise   # a poisoned state or a spent budget: not elastic
            except Exception as exc:
                if not is_transient_backend_error(exc):
                    raise
                fail_step = step0 if trainer is None else trainer.state.step
                if trainer is not None and fail_step > step0 >= 0:
                    self._budget.reset()
                elif not self._budget.spend():
                    self._give_up(cycle, max(fail_step, 0), n_dev,
                                  f"{type(exc).__name__}: {exc}", t0)
                self._emit(ElasticEvent(
                    ELASTIC_REMESHING, cycle, max(fail_step, 0), n_dev,
                    f"{type(exc).__name__}: {exc}", time.monotonic() - t0))
                self.retry.sleep(self.retry.delay_for(
                    max(1, self._budget.spent), rng))
            finally:
                if uninstall is not None:
                    uninstall()
                if loader is not None and hasattr(loader, "close"):
                    try:
                        loader.close()
                    except Exception:  # best effort
                        log.exception("loader close failed during re-mesh")
                if trainer is not None:
                    trainer.step_fn.release()
                    try:
                        trainer.ckpt.close()
                    except Exception:  # best effort
                        log.exception("ckpt close failed during re-mesh")
