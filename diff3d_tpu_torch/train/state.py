"""Train state: the model, Adam, its warmup schedule, and the EMA
(counterpart: ``diff3d_tpu/train/state.py``).

Adam with betas (0.9, 0.99) and eps 1e-8 (optax's default), a linear
warmup over examples as a ``LambdaLR``, optional global-norm clipping
(applied by the train step), and an EMA of the parameters with a
half-life in examples, kept as a plain dict of f32 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from diff3d_tpu_torch.config import TrainConfig

ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """``step`` counts optimizer updates taken; ``ema`` maps each
    parameter name of ``model`` to its f32 moving average."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: Dict[str, torch.Tensor]


def warmup_fraction(cfg: TrainConfig) -> Callable[[int], float]:
    """``step -> clip((step + 1) / warmup_steps, 0, 1)``, warmup_steps =
    ``warmup_examples // global_batch`` (at least 1): step 0 already
    takes a non-zero lr (``diff3d_tpu/train/state.py:30-45``)."""
    warmup_steps = max(1, cfg.warmup_examples // cfg.global_batch)

    def frac(step: int) -> float:
        return min(max((step + 1.0) / warmup_steps, 0.0), 1.0)

    return frac


def warmup_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at ``step``: ``cfg.lr * warmup_fraction``."""
    frac = warmup_fraction(cfg)
    return lambda step: cfg.lr * frac(step)


def make_optimizer(params, cfg: TrainConfig):
    """``(Adam, LambdaLR)``: Adam over ``params`` with ``cfg.betas`` and
    eps 1e-8, its lr ``cfg.lr`` scaled by the warmup fraction of the
    scheduler's step.  (Global-norm clipping, ``cfg.grad_clip``, happens
    in the train step, before the update.)"""
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas),
                           eps=ADAM_EPS)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, warmup_fraction(cfg))


def set_schedule_step(state: TrainState, step: int) -> None:
    """Put the warmup schedule at ``step`` (the lr the next update takes
    is ``warmup_schedule(cfg)(step)``) -- for a state carried from
    elsewhere, whose schedule count need not be its step."""
    sched = state.scheduler
    sched.last_epoch = step
    for group, base, lam in zip(state.optimizer.param_groups, sched.base_lrs,
                                sched.lr_lambdas):
        group["lr"] = base * lam(step)
    sched._last_lr = [g["lr"] for g in state.optimizer.param_groups]


def ema_decay_per_step(cfg: TrainConfig) -> float:
    """Per-step decay of an EMA with half-life ``ema_halflife_examples``:
    ``0.5 ** (global_batch / halflife)`` (0 when the half-life is 0)."""
    if cfg.ema_halflife_examples <= 0:
        return 0.0
    return float(0.5 ** (cfg.global_batch / cfg.ema_halflife_examples))


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Step 0: fresh Adam moments, the schedule at 0, the EMA a copy of
    the parameters."""
    opt, sched = make_optimizer(model.parameters(), cfg)
    ema = {name: p.detach().clone().float()
           for name, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      ema=ema)
