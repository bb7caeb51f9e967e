"""Autoregressive novel-view synthesis with stochastic conditioning
(counterpart: ``diff3d_tpu/sampling/runtime.py``).

Seed the record with the first view, then for every remaining pose run
the reverse diffusion, drawing a fresh conditioning view from the record
at each step, with the guidance weights ``w = [0..7]`` as the batch axis;
each generated view is appended to the record, so later views condition
on earlier generations.  The record buffers live on the device for the
whole object; the only device-to-host copy is one fetch at the end.

``step_many`` / ``synthesize_many`` (object-batched), ``scan_chunks`` and
``start_t`` (truncated refinement) come with the serving slice.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.diffusion import SAMPLER_KINDS, Draws, sample_view


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 255] uint8."""
    return np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    """Save one ``[H, W, 3]`` image in [-1, 1]; parent dirs created."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def record_capacity(n_views: int) -> int:
    """Record-buffer capacity for an object synthesised to ``n_views``
    views, rounded up to a power of two (the serving layer buckets by
    it).  The conditioning draw reads only the first ``record_len``
    entries, so the padding never reaches sampling."""
    if n_views < 2:
        raise ValueError(f"n_views={n_views}: need at least 2 views "
                         "(one conditioning + one target)")
    return 1 << (n_views - 1).bit_length()


class Sampler:
    """Runs the autoregressive view loop for one object.

    Args:
      model: the X-UNet (:func:`diff3d_tpu_torch.models.build_model`),
        moved to ``device`` and put in eval mode.
      cfg: full config (``diffusion.timesteps``, ``guidance_weights`` ...).
      device: where it runs — the card unless the caller names another;
        raises without CUDA when none is named.
      sampler_kind: ``"ancestral"`` (the paper's stochastic sampler) or
        ``"ddim"`` (deterministic, eta = 0).
      steps: reverse steps per view; must divide ``timesteps``.
    """

    def __init__(self, model: torch.nn.Module, cfg: Config, *,
                 device: Optional[Union[str, torch.device]] = None,
                 sampler_kind: str = "ancestral",
                 steps: Optional[int] = None):
        cfg.validate()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.w = torch.tensor(cfg.diffusion.guidance_weights,
                              dtype=torch.float32, device=self.device)
        d = cfg.diffusion
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(
                f"sampler_kind={sampler_kind!r} not in {SAMPLER_KINDS}")
        self.sampler_kind = sampler_kind
        steps = d.timesteps if steps is None else int(steps)
        if steps < 1 or d.timesteps % steps:
            raise ValueError(
                f"steps={steps} must be a positive divisor of "
                f"timesteps={d.timesteps}")
        self.steps = steps

    @property
    def model_calls_per_view(self) -> int:
        """Denoiser calls per view: one 2B-batched CFG call per step."""
        return self.steps

    @torch.inference_mode()
    def step(self, record_imgs: torch.Tensor, record_R: torch.Tensor,
             record_T: torch.Tensor, step: int, K: torch.Tensor,
             draws) -> tuple:
        """One view's reverse diffusion for one object.

        ``record_imgs [capacity, B, H, W, 3]`` and the pose buffers
        ``[capacity, 3, 3]`` / ``[capacity, 3]`` are device tensors; the
        pose buffers hold every view's pose (entry ``step`` is the target).
        ``draws`` supplies the view's random draws (:class:`Draws`).
        Returns ``(out [B, H, W, 3], record_imgs, step + 1)``; the record
        is updated in place.
        """
        d = self.cfg.diffusion
        return sample_view(
            self.model, record_imgs=record_imgs, record_R=record_R,
            record_T=record_T, record_len=int(step), K=K, w=self.w,
            draws=draws, timesteps=d.timesteps, logsnr_min=d.logsnr_min,
            logsnr_max=d.logsnr_max, clip_x0=d.clip_x0, steps=self.steps,
            sampler_kind=self.sampler_kind)

    def _record_init(self, imgs0, R, T, n_views):
        """Record buffers on the device: view 0 seeded, all poses
        pre-filled."""
        B = int(self.w.shape[0])
        H, W = imgs0.shape[-3:-1]
        capacity = record_capacity(n_views)
        record_imgs = np.zeros((capacity, B, H, W, 3), np.float32)
        record_R = np.zeros((capacity, 3, 3), np.float32)
        record_T = np.zeros((capacity, 3), np.float32)
        record_imgs[0] = imgs0[None]
        record_R[:n_views] = R[:n_views]
        record_T[:n_views] = T[:n_views]
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (record_imgs, record_R, record_T))

    def synthesize(self, views: Dict[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   out_dir: Optional[str] = None,
                   max_views: Optional[int] = None,
                   draws: Optional[Sequence] = None) -> np.ndarray:
        """Autoregressively synthesise every view of ``views`` (``imgs
        [V, H, W, 3]`` in [-1, 1], ``R [V, 3, 3]``, ``T [V, 3]``,
        ``K [3, 3]``) from view 0.

        Random draws come from ``generator`` (a generator on the sampler's
        device; seed 0 when omitted), or from ``draws``, one object per
        generated view, to replay another stream.  Returns
        ``[n_views-1, B, H, W, 3]`` float32.  With ``out_dir``, writes
        ``{out_dir}/{step}/gt.png`` and ``{out_dir}/{step}/{i}.png``.
        """
        imgs = np.asarray(views["imgs"], np.float32)
        R = np.asarray(views["R"], np.float32)
        T = np.asarray(views["T"], np.float32)
        n_views = imgs.shape[0] if max_views is None else min(
            imgs.shape[0], max_views)
        B = int(self.w.shape[0])
        H, W = imgs.shape[1:3]
        if n_views < 2:
            return np.zeros((0, B, H, W, 3), np.float32)
        if draws is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            draws = [Draws(generator)] * (n_views - 1)
        elif len(draws) != n_views - 1:
            raise ValueError(f"draws: need {n_views - 1} (one per "
                             f"generated view), got {len(draws)}")

        rec_i, rec_R, rec_T = self._record_init(imgs[0], R, T, n_views)
        K = torch.as_tensor(np.asarray(views["K"], np.float32),
                            device=self.device)
        step = 1
        for view_draws in draws:
            _, rec_i, step = self.step(rec_i, rec_R, rec_T, step, K,
                                       view_draws)
        outs = rec_i[1:n_views].cpu().numpy()

        if out_dir is not None:
            for s in range(1, n_views):
                save_image(os.path.join(out_dir, str(s), "gt.png"), imgs[s])
                for i in range(B):
                    save_image(os.path.join(out_dir, str(s), f"{i}.png"),
                               outs[s - 1, i])
        return outs
