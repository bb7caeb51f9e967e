"""Train state: the model, Adam, its warmup schedule, and the EMA
(counterpart: ``diff3d_tpu/train/state.py``).

Adam with betas (0.9, 0.99) and eps 1e-8 (optax's default), a linear
warmup over examples as a ``LambdaLR``, optional global-norm clipping
(applied by the train step), and an EMA of the parameters with a
half-life in examples, kept as a plain dict of f32 tensors.  On a CUDA
device Adam is ``capturable`` and its lr a device tensor that the
schedule writes in place, so the update can run as a CUDA graph
(:mod:`diff3d_tpu_torch.train.step`); the eager step there uses the same
optimizer, so the two paths compute the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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


def make_optimizer(params, cfg: TrainConfig,
                   capturable: Optional[bool] = None):
    """``(Adam, LambdaLR)``: Adam over ``params`` with ``cfg.betas`` and
    eps 1e-8, its lr ``cfg.lr`` scaled by the warmup fraction of the
    scheduler's step.  Parameters on a CUDA device get a ``capturable``
    Adam whose lr is a device tensor (``capturable=False``: the plain one,
    for a step that is never captured, the FSDP one).  (Global-norm
    clipping, ``cfg.grad_clip``, happens in the train step, before the
    update.)"""
    params = list(params)
    if capturable is None:
        capturable = bool(params) and params[0].is_cuda
    if capturable:
        opt = torch.optim.Adam(
            params, lr=torch.tensor(cfg.lr, device=params[0].device),
            betas=tuple(cfg.betas), eps=ADAM_EPS, capturable=True,
            foreach=True)
    else:
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas),
                               eps=ADAM_EPS)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, warmup_fraction(cfg))


def settle_lr(optimizer: torch.optim.Optimizer) -> None:
    """Keep each group's lr where its kind of Adam needs it: a tensor on
    the parameters' device for a ``capturable`` group, a float otherwise
    (a loaded state dict carries the saving run's lr as it was)."""
    for group in optimizer.param_groups:
        lr, dev = group["lr"], group["params"][0].device
        if group.get("capturable"):
            if not torch.is_tensor(lr) or lr.device != dev:
                group["lr"] = torch.as_tensor(
                    float(lr), dtype=torch.float32, device=dev)
        elif torch.is_tensor(lr):
            group["lr"] = float(lr)


def set_schedule_step(state: TrainState, step: int) -> None:
    """Put the warmup schedule at ``step`` (the lr the next update takes
    is ``warmup_schedule(cfg)(step)``) -- for a state carried from
    elsewhere, whose schedule count need not be its step."""
    sched = state.scheduler
    sched.last_epoch = step
    for group, base, lam in zip(state.optimizer.param_groups, sched.base_lrs,
                                sched.lr_lambdas):
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(base * lam(step))
        else:
            group["lr"] = base * lam(step)
    sched._last_lr = [g["lr"].clone() if torch.is_tensor(g["lr"]) else g["lr"]
                      for g in state.optimizer.param_groups]


def ema_decay_per_step(cfg: TrainConfig) -> float:
    """Per-step decay of an EMA with half-life ``ema_halflife_examples``:
    ``0.5 ** (global_batch / halflife)`` (0 when the half-life is 0)."""
    if cfg.ema_halflife_examples <= 0:
        return 0.0
    return float(0.5 ** (cfg.global_batch / cfg.ema_halflife_examples))


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       capturable: Optional[bool] = None) -> TrainState:
    """Step 0: fresh Adam moments, the schedule at 0, the EMA a copy of
    the parameters (sharded like them under FSDP)."""
    opt, sched = make_optimizer(model.parameters(), cfg, capturable)
    ema = {name: p.detach().clone().float()
           for name, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched,
                      ema=ema)
