"""The train step (counterpart: ``diff3d_tpu/train/step.py:31-112``).

``loss -> backward`` over ``accum_steps`` microbatches (gradients and
loss averaged), optional global-norm clipping, Adam, then the EMA
``e = d e + (1 - d) p`` of the updated parameters.  PyTorch runs it
eagerly, in place on the :class:`~diff3d_tpu_torch.train.state.
TrainState`.  The step's random draws (diffusion times, noise, CFG mask,
unconditional frames, dropout) come from one generator seeded by
``(seed, step)``, so a resumed run replays the same draws -- the property
of the JAX package's ``jax.random.fold_in(rng, state.step)``.  Tests pass
their own draws instead (:class:`~diff3d_tpu_torch.diffusion.TrainDraws`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.data.images import dequantize
from diff3d_tpu_torch.diffusion import TrainDraws, p_losses
from diff3d_tpu_torch.train.state import (TrainState, ema_decay_per_step,
                                          warmup_schedule)

TrainStepFn = Callable[..., Dict[str, object]]


def step_seed(seed: int, step: int) -> int:
    """The 63-bit seed of step ``step``'s generator."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


def make_train_step(cfg: Config) -> TrainStepFn:
    """Build ``step(state, batch, draws=None) -> metrics``.

    ``batch``: ``imgs [B, 2, H, W, 3]`` (uint8, dequantized here),
    ``R [B, 2, 3, 3]``, ``T [B, 2, 3]``, ``K [B, 3, 3]`` on
    the model's device, ``B = global_batch``.  ``draws``: one
    :class:`TrainDraws`-like object per microbatch, or None for the step's
    own generator.  Returns ``{'loss': tensor, 'lr': float, 'grad_norm':
    tensor}`` -- the mean loss, the lr of this update (the schedule at the
    pre-update step) and the global norm of the averaged gradients (before
    clipping); the tensors stay on the device, unsynchronised."""
    tcfg, dcfg = cfg.train, cfg.diffusion
    accum = tcfg.accum_steps
    sched = warmup_schedule(tcfg)
    decay = ema_decay_per_step(tcfg)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[Sequence] = None) -> Dict[str, object]:
        model = state.model
        model.train()
        names, params = zip(*model.named_parameters())
        imgs = dequantize(batch["imgs"])
        B = imgs.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not divisible by accum_steps "
                             f"{accum}")
        mb = B // accum
        if draws is None:
            gen = torch.Generator(imgs.device).manual_seed(
                step_seed(tcfg.seed, state.step))
            draws = [TrainDraws(gen)] * accum
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")

        state.optimizer.zero_grad(set_to_none=True)
        total = None
        for i, d in enumerate(draws):
            sl = slice(i * mb, (i + 1) * mb)
            gen = getattr(d, "generator", None)

            def denoise(model_batch, cond_mask, gen=gen):
                return model(model_batch, cond_mask, generator=gen)

            loss = p_losses(
                denoise, imgs[sl], batch["R"][sl], batch["T"][sl],
                batch["K"][sl], d, cond_prob=dcfg.cond_prob,
                loss_type=dcfg.loss_type, logsnr_min=dcfg.logsnr_min,
                logsnr_max=dcfg.logsnr_max)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()

        for p in params:      # optax updates every leaf, a zero grad too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            total = total / accum
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if tcfg.grad_clip > 0:
            # optax.clip_by_global_norm: g * clip / norm when norm >= clip.
            torch._foreach_mul_(grads, torch.where(
                grad_norm < tcfg.grad_clip, 1.0, tcfg.grad_clip / grad_norm))
        lr = sched(state.step)
        state.optimizer.step()
        state.scheduler.step()
        with torch.no_grad():
            ema = [state.ema[n] for n in names]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for p in params],
                                alpha=1.0 - decay)
        state.step += 1
        return {"loss": total, "lr": lr, "grad_norm": grad_norm}

    return step
