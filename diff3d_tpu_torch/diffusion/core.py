"""Continuous-time logSNR-parameterised VP diffusion: the training loss
and the sampling side (counterpart: ``diff3d_tpu/diffusion/core.py``).

Images are ``[B, H, W, 3]`` as in the JAX package.  The reverse loop (the
JAX package's ``lax.scan``) is :class:`ReverseLoop`: static buffers and
one step body, which the sampler runs eagerly or captures as a CUDA graph;
each step is one 2B-batched cond + uncond model call per object.  Every
random draw goes through an injectable object, so a test can replay the
JAX package's key stream:
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


def draw_steps(draws, n_steps: int, shape: Sequence[int],
               device: torch.device, deterministic: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The per-step draws of a view's reverse loop, taken before the loop
    in the order an eager loop takes them: for each step its
    unconditional frame, then (ancestral only) its step noise.  Returns
    ``(x_uncond, step_noise)`` stacked into ``[n_steps, *shape]``;
    ``step_noise`` is None for DDIM, which draws none."""
    xs, noise = [], []
    for _ in range(n_steps):
        xs.append(draws.x_uncond(shape, device))
        if not deterministic:
            noise.append(draws.step_noise(shape, device))
    return torch.stack(xs), (torch.stack(noise) if noise else None)


class ReverseLoop:
    """The reverse steps of N objects' views as static buffers and one
    step body: the JAX package's ``lax.scan`` body, batched over objects
    as its ``vmap`` is.

    :meth:`load` fills the buffers for one view of every object (each at
    its own record depth, with its own draws and target pose);
    :meth:`step` runs one reverse step: it reads the step index ``i`` (a
    device scalar), takes the step's schedule entries, conditioning
    indices and draws with ``index_select``, makes one model call of
    ``N * 2B`` examples (per object its B conditional then its B
    unconditional rows), writes the new image into :attr:`img` in place
    and increments ``i``.  It reads no host value and allocates its
    outputs anew each call, so the sampler captures it as a CUDA graph
    and replays it; on the CPU it runs as it is.
    """

    def __init__(self, denoise_fn: DenoiseFn, *, n_objects: int,
                 capacity: int, n_steps: int, w: torch.Tensor, H: int,
                 W: int, record_dtype: torch.dtype, logsnr_max: float,
                 clip_x0: bool, deterministic: bool):
        device = w.device
        N, B = n_objects, int(w.shape[0])
        self.denoise_fn = denoise_fn
        self.shape = (N, B, H, W, 3)
        self.logsnr_max, self.clip_x0 = logsnr_max, clip_x0
        self.deterministic = deterministic

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.img = zeros(N, B, H, W, 3)
        self.i = zeros(1, dtype=torch.long)
        self.logsnrs = zeros(n_steps)
        self.logsnr_nexts = zeros(n_steps)
        self.cond_idx = zeros(N, n_steps, dtype=torch.long)
        self.x_uncond = zeros(N, n_steps, B, H, W, 3)
        self.noise = None if deterministic else zeros(N, n_steps, B, H, W, 3)
        self.record_imgs = zeros(N, capacity, B, H, W, 3, dtype=record_dtype)
        self.record_R = zeros(N, capacity, 3, 3)
        self.record_T = zeros(N, capacity, 3)
        self.target_R = zeros(N, 3, 3)
        self.target_T = zeros(N, 3)
        self.K2 = zeros(N * 2 * B, 3, 3)
        self.cam_dirs = zeros(N * 2 * B, 1, H, W, 3)
        self.w = w.to(torch.float32)
        self.base = torch.arange(N, device=device) * capacity
        self.w_mask = torch.cat([torch.ones(B, dtype=torch.bool),
                                 torch.zeros(B, dtype=torch.bool)]
                                ).repeat(N).to(device)

    def load(self, img, logsnrs, logsnr_nexts, cond_idx, x_uncond, noise,
             record_imgs, record_R, record_T, target_R, target_T,
             K) -> None:
        """Fill the buffers for one view and set ``i`` to 0: ``img [N, B,
        H, W, 3]``, the schedule ``[n]``, ``cond_idx [N, n]``, the draws
        ``[N, n, B, H, W, 3]`` (``noise`` None for DDIM), the records, the
        target poses ``[N, 3, 3]`` / ``[N, 3]`` and the intrinsics
        ``K [N, 3, 3]``.  The intrinsics-only ray stage is computed here,
        once per view, and handed to the model as ``batch['cam_dirs']``."""
        N, B, H, W, _ = self.shape
        for dst, src in ((self.img, img), (self.logsnrs, logsnrs),
                         (self.logsnr_nexts, logsnr_nexts),
                         (self.cond_idx, cond_idx),
                         (self.x_uncond, x_uncond),
                         (self.record_imgs, record_imgs),
                         (self.record_R, record_R), (self.record_T, record_T),
                         (self.target_R, target_R), (self.target_T, target_T)):
            dst.copy_(src)
        if self.noise is not None:
            self.noise.copy_(noise)
        K2 = K.to(self.K2)[:, None].expand(N, 2 * B, 3, 3).reshape(
            N * 2 * B, 3, 3)
        self.K2.copy_(K2)
        self.cam_dirs.copy_(pinhole_rays_cam(K2[:, None].float(), H, W))
        self.i.zero_()

    def step(self) -> None:
        """One reverse step of every object (see the class docstring)."""
        N, B, H, W, _ = self.shape
        i = self.i
        logsnr = self.logsnrs.index_select(0, i)
        logsnr_next = self.logsnr_nexts.index_select(0, i)
        idx = self.cond_idx.index_select(1, i)[:, 0] + self.base
        cond_img = self.record_imgs.flatten(0, 1).index_select(0, idx)

        def pair(cond, target):      # [N, 2, ...] -> [N * 2B, 2, ...]
            both = torch.stack([cond, target], 1)[:, None]
            return both.expand(N, 2 * B, *both.shape[2:]).reshape(
                N * 2 * B, *both.shape[2:])

        R = pair(self.record_R.flatten(0, 1).index_select(0, idx),
                 self.target_R)
        T = pair(self.record_T.flatten(0, 1).index_select(0, idx),
                 self.target_T)
        # Fold the CFG cond + uncond passes into one model call.
        x = torch.stack([cond_img, self.x_uncond.index_select(1, i)[:, 0]],
                        1).reshape(N * 2 * B, H, W, 3)
        z = self.img[:, None].expand(N, 2, B, H, W, 3).reshape(
            N * 2 * B, H, W, 3)
        batch = make_model_batch(x, z, logsnr.expand(N * 2 * B), R, T,
                                 self.K2, logsnr_max=self.logsnr_max)
        batch["cam_dirs"] = self.cam_dirs
        eps = self.denoise_fn(batch, self.w_mask).reshape(N, 2, B, H, W, 3)
        img, w = self.img, self.w.to(self.img.dtype)
        if self.deterministic:
            new = ddim_step(eps[:, 0], eps[:, 1], img, logsnr, logsnr_next,
                            w, clip_x0=self.clip_x0)
        else:
            mean, var = p_mean_variance(eps[:, 0], eps[:, 1], img, logsnr,
                                        logsnr_next, w, clip_x0=self.clip_x0)
            noise = self.noise.index_select(1, i)[:, 0]
            # Reference guard `if logsnr_next == 0: return mean`
            # (train.py:125-126), kept for parity.
            new = torch.where(logsnr_next == 0.0, mean,
                              mean + torch.sqrt(var) * noise)
        self.img.copy_(new)
        self.i.add_(1)


def sample_loop_scan(denoise_fn: DenoiseFn, img: torch.Tensor, xs, *,
                     draws, record_imgs: torch.Tensor,
                     record_R: torch.Tensor, record_T: torch.Tensor,
                     target_R: torch.Tensor, target_T: torch.Tensor,
                     K: torch.Tensor, w: torch.Tensor, logsnr_max: float,
                     clip_x0: bool, deterministic: bool = False
                     ) -> torch.Tensor:
    """Run the reverse steps in ``xs`` from ``img`` for one object (the
    JAX package's ``lax.scan``): the steps' draws are taken first
    (:func:`draw_steps`), then :class:`ReverseLoop`'s step body runs once
    per step, eagerly.  ``deterministic`` selects the DDIM update.
    Nothing here waits for the device."""
    logsnrs, logsnr_nexts, cond_idx = xs
    n = logsnrs.shape[0]
    x_uncond, noise = draw_steps(draws, n, img.shape, img.device,
                                 deterministic)
    H, W = record_imgs.shape[-3:-1]
    loop = ReverseLoop(denoise_fn, n_objects=1,
                       capacity=record_imgs.shape[0], n_steps=n, w=w, H=H,
                       W=W, record_dtype=record_imgs.dtype,
                       logsnr_max=logsnr_max, clip_x0=clip_x0,
                       deterministic=deterministic)
    loop.load(img[None], logsnrs, logsnr_nexts, cond_idx[None],
              x_uncond[None], None if noise is None else noise[None],
              record_imgs[None], record_R[None], record_T[None],
              target_R[None], target_T[None], K[None])
    for _ in range(n):
        loop.step()
    return loop.img[0]


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
