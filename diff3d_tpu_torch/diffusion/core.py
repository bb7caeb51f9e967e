"""Continuous-time logSNR-parameterised VP diffusion: the training loss
and the sampling side (counterpart: ``diff3d_tpu/diffusion/core.py``).

Images are ``[B, H, W, 3]`` as in the JAX package.  The reverse loop is a
Python loop of eager steps (the JAX package's ``lax.scan``); each step is
one 2B-batched cond + uncond model call.  Every random draw goes through
an injectable object, so a test can replay the JAX package's key stream:
:class:`TrainDraws` for :func:`p_losses` (t, the noise, the CFG mask and
the unconditional frames), :class:`Draws` for the sampler (init noise,
the stochastic-conditioning indices, the uncond frames and the step
noise).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from diff3d_tpu_torch.geometry import pinhole_rays_cam

# A denoiser: (batch dict, cond_mask [B] bool) -> eps_hat [B, H, W, 3].
DenoiseFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]

SAMPLER_KINDS = ("ancestral", "ddim")


def logsnr_schedule_cosine(t: torch.Tensor, *, logsnr_min: float = -20.0,
                           logsnr_max: float = 20.0) -> torch.Tensor:
    """``logsnr(t) = -2 log(tan(a t + b))``: t in [0, 1] maps to logsnr in
    [logsnr_max, logsnr_min] (reference ``train.py:30-34``)."""
    b = float(np.arctan(np.exp(-0.5 * logsnr_max)))
    a = float(np.arctan(np.exp(-0.5 * logsnr_min))) - b
    return -2.0 * torch.log(torch.tan(a * t + b))


def alpha_sigma(logsnr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``alpha = sqrt(sigmoid(logsnr))``, ``sigma = sqrt(sigmoid(-logsnr))``."""
    return (torch.sqrt(torch.sigmoid(logsnr)),
            torch.sqrt(torch.sigmoid(-logsnr)))


def q_sample(z: torch.Tensor, logsnr: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward process ``z_t = alpha z + sigma eps``; ``logsnr`` is
    ``[B]``."""
    alpha, sigma = alpha_sigma(logsnr)
    return alpha[:, None, None, None] * z + sigma[:, None, None, None] * noise


def make_model_batch(x: torch.Tensor, z: torch.Tensor, logsnr: torch.Tensor,
                     R: torch.Tensor, t: torch.Tensor, K: torch.Tensor, *,
                     logsnr_max: float = 20.0) -> Dict[str, torch.Tensor]:
    """The model input dict: the conditioning frame gets the schedule's
    max logSNR (clean), stacked with the target's into ``[B, 2]``."""
    cond_logsnr = torch.full_like(logsnr, logsnr_max)
    return {"x": x, "z": z, "logsnr": torch.stack([cond_logsnr, logsnr], 1),
            "R": R, "t": t, "K": K}


def _cfg_x0(eps_cond, eps_uncond, z, alpha, sigma, w, clip_x0):
    w = w[:, None, None, None]
    eps = (1.0 + w) * eps_cond - w * eps_uncond
    z_start = (z - sigma * eps) / alpha
    if clip_x0:
        z_start = torch.clamp(z_start, -1.0, 1.0)
    return eps, z_start


class TrainDraws:
    """The random draws of one :func:`p_losses` call, taken from one
    ``torch.Generator`` in this order: ``t``, ``noise``, ``cond_u``,
    ``x_noise``; the same generator feeds the model's dropout.  A test
    replays the JAX package's four ``jax.random.split(rng, 4)`` draws by
    passing an object with the same methods (and ``generator``)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def t(self, n: int, device: torch.device) -> torch.Tensor:
        """Diffusion times, uniform in ``[0, 1)``, ``[n]``."""
        return torch.rand((n,), generator=self.generator, device=device)

    def noise(self, shape: Sequence[int],
              device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)

    def cond_u(self, n: int, device: torch.device) -> torch.Tensor:
        """Uniforms of the CFG mask, ``[n]``: conditional where
        ``> cond_prob``."""
        return torch.rand((n,), generator=self.generator, device=device)

    def x_noise(self, shape: Sequence[int],
                device: torch.device) -> torch.Tensor:
        """The noise that replaces the conditioning frame where
        unconditional."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)


LOSS_TYPES = ("l1", "l2", "huber")


def p_losses(denoise_fn: DenoiseFn, imgs: torch.Tensor, R: torch.Tensor,
             T: torch.Tensor, K: torch.Tensor, draws, *,
             cond_prob: float = 0.1, loss_type: str = "l2",
             logsnr_min: float = -20.0, logsnr_max: float = 20.0
             ) -> torch.Tensor:
    """epsilon-prediction loss with classifier-free-guidance dropout
    (``diff3d_tpu/diffusion/core.py:76-115``).  ``imgs`` is ``[B, 2, H, W,
    3]`` f32: frame 0 is the source view ``x``, frame 1 the target ``z``.
    With probability ``cond_prob`` an element is trained unconditionally:
    its conditioning frame is replaced by N(0, 1) noise and its
    ``cond_mask`` is False.  Returns the scalar mean loss (f32)."""
    if loss_type not in LOSS_TYPES:
        raise NotImplementedError(loss_type)
    B = imgs.shape[0]
    device = imgs.device
    x, z = imgs[:, 0], imgs[:, 1]
    logsnr = logsnr_schedule_cosine(draws.t(B, device),
                                    logsnr_min=logsnr_min,
                                    logsnr_max=logsnr_max)
    noise = draws.noise(z.shape, device)
    z_noisy = q_sample(z, logsnr, noise)
    cond_mask = draws.cond_u(B, device) > cond_prob
    x_cond = torch.where(cond_mask[:, None, None, None], x,
                         draws.x_noise(x.shape, device))
    batch = make_model_batch(x_cond, z_noisy, logsnr, R, T, K,
                             logsnr_max=logsnr_max)
    d = noise - denoise_fn(batch, cond_mask)
    if loss_type == "l1":
        return d.abs().mean()
    if loss_type == "l2":
        return (d * d).mean()
    # torch smooth_l1 with beta = 1.
    a = d.abs()
    return torch.where(a < 1.0, 0.5 * a * a, a - 0.5).mean()


def p_mean_variance(eps_cond: torch.Tensor, eps_uncond: torch.Tensor,
                    z: torch.Tensor, logsnr: torch.Tensor,
                    logsnr_next: torch.Tensor, w: torch.Tensor, *,
                    clip_x0: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step in logSNR form (reference ``train.py:131-166``):
    CFG combine ``eps = (1+w) eps_cond - w eps_uncond``, clipped x0,
    posterior mean ``alpha_next (z (1-c)/alpha + c z0)`` and variance
    ``sigmoid(-logsnr_next) c`` with ``c = -expm1(logsnr - logsnr_next)``."""
    c = -torch.expm1(logsnr - logsnr_next)
    alpha, sigma = alpha_sigma(logsnr)
    alpha_next, _ = alpha_sigma(logsnr_next)
    _, z_start = _cfg_x0(eps_cond, eps_uncond, z, alpha, sigma, w, clip_x0)
    mean = alpha_next * (z * (1.0 - c) / alpha + c * z_start)
    return mean, torch.sigmoid(-logsnr_next) * c


def ddim_step(eps_cond: torch.Tensor, eps_uncond: torch.Tensor,
              z: torch.Tensor, logsnr: torch.Tensor,
              logsnr_next: torch.Tensor, w: torch.Tensor, *,
              clip_x0: bool = True) -> torch.Tensor:
    """One deterministic DDIM step (eta = 0): after clipping x0, eps is
    re-derived from it, then ``z_next = alpha_next x0 + sigma_next eps``."""
    alpha, sigma = alpha_sigma(logsnr)
    alpha_next, sigma_next = alpha_sigma(logsnr_next)
    eps, z_start = _cfg_x0(eps_cond, eps_uncond, z, alpha, sigma, w,
                           clip_x0)
    if clip_x0:
        eps = (z - alpha * z_start) / sigma
    return alpha_next * z_start + sigma_next * eps


class ScheduleError(ValueError):
    """A sampling-schedule parameter is off the valid grid."""


def schedule_start_index(steps: int, start_t: float, *,
                         timesteps: int) -> int:
    """Index of ``start_t`` in the ``[steps + 1]`` grid ``t_i = 1 -
    i/steps``; raises :class:`ScheduleError` off the grid or at
    ``start_t <= 0``."""
    start_t = float(start_t)
    idx = round((1.0 - start_t) * steps)
    if (not 0 <= idx < steps
            or abs((1.0 - idx / steps) - start_t) > 1e-6):
        pts = [round(1.0 - i / steps, 6) for i in range(steps)]
        raise ScheduleError(
            f"start_t={start_t} is not a grid point of the {steps}-step "
            f"schedule (timesteps={timesteps}): valid start points are "
            f"{pts} (start_t=1.0 runs the whole grid; 0.0 would leave "
            "no reverse steps)")
    return idx


def sample_schedule_ts(steps: Optional[int], *, timesteps: int,
                       start_t: Optional[float] = None) -> torch.Tensor:
    """The float32 time grid of a ``steps``-step run: the stride
    ``timesteps // steps`` subset of ``linspace(1, 0, timesteps + 1)``,
    truncated to ``[start_t, 0]`` when ``start_t`` is given.  ``steps``
    must divide ``timesteps``; ``None`` means the full grid."""
    steps = timesteps if steps is None else int(steps)
    if steps < 1 or timesteps % steps:
        divisors = [d for d in range(1, timesteps + 1) if timesteps % d == 0]
        raise ScheduleError(
            f"steps={steps} must be a positive divisor of the dense "
            f"schedule (timesteps={timesteps}); valid step counts are "
            f"{divisors}")
    ts = torch.linspace(1.0, 0.0, timesteps + 1,
                        dtype=torch.float32)[::timesteps // steps]
    if start_t is not None:
        ts = ts[schedule_start_index(steps, start_t, timesteps=timesteps):]
    return ts


class Draws:
    """The random draws of one view's reverse diffusion, taken from one
    ``torch.Generator`` in the order the loop asks for them.  A test
    replays another stream by passing an object with the same four
    methods."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init_noise(self, shape: Sequence[int],
                   device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)

    def cond_idx(self, n_steps: int, record_len: int,
                 device: torch.device) -> torch.Tensor:
        """Stochastic-conditioning indices, uniform in ``[0, record_len)``."""
        return torch.randint(0, record_len, (n_steps,),
                             generator=self.generator, device=device)

    def x_uncond(self, shape: Sequence[int],
                 device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)

    def step_noise(self, shape: Sequence[int],
                   device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)


def sample_loop_prepare(*, record_len: int, draws, timesteps: int, shape,
                        logsnr_min: float, logsnr_max: float,
                        device: torch.device, steps: Optional[int] = None,
                        start_t: Optional[float] = None,
                        draft: Optional[torch.Tensor] = None):
    """Initial image and per-step inputs ``(logsnrs, logsnr_nexts,
    cond_idx)`` of one view's reverse loop.  ``shape`` is ``(B, H, W, 3)``.

    With ``start_t`` and ``draft`` (cascade refinement) the grid is
    truncated to ``[start_t, 0]`` and the init is the draft renoised to
    ``start_t`` with the same init-noise draw; at ``start_t = 1.0`` the
    draft is ignored and the init is that noise as it is."""
    ts = sample_schedule_ts(steps, timesteps=timesteps, start_t=start_t)
    n_steps = ts.shape[0] - 1
    logsnrs = logsnr_schedule_cosine(ts[:-1], logsnr_min=logsnr_min,
                                     logsnr_max=logsnr_max).to(device)
    logsnr_nexts = logsnr_schedule_cosine(ts[1:], logsnr_min=logsnr_min,
                                          logsnr_max=logsnr_max).to(device)
    noise = draws.init_noise(shape, device)
    if draft is None or start_t is None or float(start_t) >= 1.0:
        init_img = noise
    else:
        logsnr_start = logsnr_schedule_cosine(
            torch.tensor(float(start_t), dtype=torch.float32),
            logsnr_min=logsnr_min, logsnr_max=logsnr_max).to(device)
        init_img = q_sample(draft.to(device, torch.float32),
                            logsnr_start.expand(shape[0]), noise)
    cond_idx = draws.cond_idx(n_steps, record_len, device)
    return init_img, (logsnrs, logsnr_nexts, cond_idx)


def sample_loop_scan(denoise_fn: DenoiseFn, img: torch.Tensor, xs, *,
                     draws, record_imgs: torch.Tensor,
                     record_R: torch.Tensor, record_T: torch.Tensor,
                     target_R: torch.Tensor, target_T: torch.Tensor,
                     K: torch.Tensor, w: torch.Tensor, logsnr_max: float,
                     clip_x0: bool, deterministic: bool = False
                     ) -> torch.Tensor:
    """Run the reverse steps in ``xs`` from ``img``, one eager step each
    (the JAX package's ``lax.scan`` body).  ``deterministic`` selects the
    DDIM update.  The intrinsics-only ray stage is computed once, before
    the loop, and handed to the model as ``batch['cam_dirs']``.  Nothing
    here waits for the device."""
    logsnrs, logsnr_nexts, cond_idx = xs
    B = w.shape[0]
    device = img.device
    Kb = K[None].expand(B, 3, 3)
    K2 = torch.cat([Kb, Kb])
    w_mask_2b = torch.cat([torch.ones(B, dtype=torch.bool, device=device),
                           torch.zeros(B, dtype=torch.bool, device=device)])
    H, W = record_imgs.shape[-3:-1]
    cam_dirs = pinhole_rays_cam(K2[:, None].float(), H, W)  # [2B,1,H,W,3]
    w = w.to(img.dtype)

    for i in range(logsnrs.shape[0]):
        logsnr, logsnr_next = logsnrs[i], logsnr_nexts[i]
        idx = cond_idx[i:i + 1]
        cond_img = record_imgs.index_select(0, idx)[0]      # [B, H, W, 3]
        R = torch.cat([record_R.index_select(0, idx), target_R[None]])
        T = torch.cat([record_T.index_select(0, idx), target_T[None]])
        Rb = R[None].expand(B, 2, 3, 3)
        Tb = T[None].expand(B, 2, 3)
        # Fold the CFG cond + uncond passes into one 2B model call.
        x_uncond = draws.x_uncond(cond_img.shape, device)
        batch = make_model_batch(
            torch.cat([cond_img, x_uncond]), torch.cat([img, img]),
            logsnr.expand(2 * B), torch.cat([Rb, Rb]), torch.cat([Tb, Tb]),
            K2, logsnr_max=logsnr_max)
        batch["cam_dirs"] = cam_dirs
        eps = denoise_fn(batch, w_mask_2b)
        eps_cond, eps_uncond = eps[:B], eps[B:]
        if deterministic:
            img = ddim_step(eps_cond, eps_uncond, img, logsnr, logsnr_next,
                            w, clip_x0=clip_x0)
        else:
            mean, var = p_mean_variance(eps_cond, eps_uncond, img, logsnr,
                                        logsnr_next, w, clip_x0=clip_x0)
            noise = draws.step_noise(img.shape, device)
            # Reference guard `if logsnr_next == 0: return mean`
            # (train.py:125-126), kept for parity.
            img = torch.where(logsnr_next == 0.0, mean,
                              mean + torch.sqrt(var) * noise)
    return img


def sample_loop(denoise_fn: DenoiseFn, *, record_imgs: torch.Tensor,
                record_R: torch.Tensor, record_T: torch.Tensor,
                record_len: int, target_R: torch.Tensor,
                target_T: torch.Tensor, K: torch.Tensor, w: torch.Tensor,
                draws, timesteps: int = 256, logsnr_min: float = -20.0,
                logsnr_max: float = 20.0, clip_x0: bool = True,
                steps: Optional[int] = None,
                sampler_kind: str = "ancestral",
                start_t: Optional[float] = None,
                draft: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full reverse diffusion for one novel view with stochastic
    conditioning: at every step a conditioning view is drawn uniformly
    from the first ``record_len`` entries of the record
    (``record_imgs [N, B, H, W, 3]``, poses ``[N, 3, 3]`` / ``[N, 3]``).
    Returns the ``[B, H, W, 3]`` view, one image per guidance weight."""
    if sampler_kind not in SAMPLER_KINDS:
        raise ValueError(
            f"sampler_kind={sampler_kind!r} not in {SAMPLER_KINDS}")
    img, xs = sample_loop_prepare(
        record_len=record_len, draws=draws, timesteps=timesteps,
        shape=(w.shape[0],) + tuple(record_imgs.shape[-3:]),
        logsnr_min=logsnr_min, logsnr_max=logsnr_max,
        device=record_imgs.device, steps=steps, start_t=start_t,
        draft=draft)
    return sample_loop_scan(
        denoise_fn, img, xs, draws=draws, record_imgs=record_imgs,
        record_R=record_R, record_T=record_T, target_R=target_R,
        target_T=target_T, K=K, w=w, logsnr_max=logsnr_max,
        clip_x0=clip_x0, deterministic=(sampler_kind == "ddim"))


def sample_view(denoise_fn: DenoiseFn, *, record_imgs: torch.Tensor,
                record_R: torch.Tensor, record_T: torch.Tensor,
                record_len: int, K: torch.Tensor, w: torch.Tensor, draws,
                timesteps: int = 256, logsnr_min: float = -20.0,
                logsnr_max: float = 20.0, clip_x0: bool = True,
                steps: Optional[int] = None,
                sampler_kind: str = "ancestral",
                start_t: Optional[float] = None,
                draft: Optional[torch.Tensor] = None):
    """One autoregressive view step over a device-resident record.  The
    pose buffers hold every view's pose up front: the conditioning draw
    reads only entries ``< record_len``, so entry ``record_len`` is the
    target pose.  The view is written into the record at ``record_len``,
    in place (the JAX package's ``dynamic_update_slice`` on a donated
    buffer).  Returns ``(out, record_imgs, record_len + 1)``."""
    out = sample_loop(
        denoise_fn, record_imgs=record_imgs, record_R=record_R,
        record_T=record_T, record_len=record_len,
        target_R=record_R[record_len], target_T=record_T[record_len], K=K,
        w=w, draws=draws, timesteps=timesteps, logsnr_min=logsnr_min,
        logsnr_max=logsnr_max, clip_x0=clip_x0, steps=steps,
        sampler_kind=sampler_kind, start_t=start_t, draft=draft)
    record_imgs[record_len] = out.to(record_imgs.dtype)
    return out, record_imgs, record_len + 1
