"""Matched-seed sampler parity: how far a few-step schedule drifts from
the full-grid ancestral oracle (counterpart:
``diff3d_tpu/evaluation/parity.py``).

The sampler takes every draw of a view (init image, conditioning indices,
unconditional frames) from the object's own stream whatever the step
schedule, so two samplers run from the same per-object generator seed
differ only by their reverse-process updates; scoring one against the
other isolates the quality cost of the schedule.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from diff3d_tpu_torch.evaluation.metrics import psnr, ssim

#: PSNR values are capped here before averaging: identical outputs have
#: zero MSE, which would poison the mean and strict-JSON consumers.
PSNR_CAP = 99.0


def resize_bilinear(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    """``[..., h, w, C]`` -> ``[..., hw[0], hw[1], C]``, the JAX package's
    ``jax.image.resize(method="bilinear")``: half-pixel centres, and an
    antialiased triangle filter when it downsamples."""
    lead, (h, w, C) = x.shape[:-3], x.shape[-3:]
    y = x.reshape(-1, h, w, C).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, hw[0], hw[1], C)


def _resize_to(g: np.ndarray, hw: tuple) -> np.ndarray:
    """Bilinearly resize ``[V, B, h, w, 3]`` generations to ``hw``: the
    interpolation the cascade upsamples drafts with."""
    return resize_bilinear(torch.from_numpy(np.asarray(g, np.float32)),
                           hw).numpy()


def matched_seed_parity(gens: Sequence[np.ndarray],
                        oracle_gens: Sequence[np.ndarray],
                        w_index: int = 0,
                        resize: bool = False) -> dict:
    """PSNR / SSIM of per-object generations ``[V, B, H, W, 3]`` (B the
    guidance sweep) against matched-seed oracle generations, at guidance
    column ``w_index``; ``resize`` upsamples ``gens`` to the oracle's
    resolution first.  Returns ``{"psnr", "psnr_std", "ssim", "views"}``
    pooled over every view (PSNR capped at :data:`PSNR_CAP`)."""
    if len(gens) != len(oracle_gens):
        raise ValueError(
            f"{len(gens)} generations vs {len(oracle_gens)} oracle "
            "generations — the object lists must align")
    psnrs, ssims = [], []
    for g, o in zip(gens, oracle_gens):
        if resize and g.shape[:2] == o.shape[:2] \
                and g.shape[2:4] != o.shape[2:4]:
            g = _resize_to(np.asarray(g), o.shape[2:4])
        if g.shape != o.shape:
            raise ValueError(
                f"shape mismatch {g.shape} vs {o.shape}: matched-seed "
                "runs must share view count, sweep, and resolution "
                "(pass resize=True to score across resolutions)")
        if g.shape[0] == 0:
            continue
        a = np.asarray(g[:, w_index], np.float32)
        b = np.asarray(o[:, w_index], np.float32)
        psnrs.extend(np.minimum(psnr(a, b).cpu().numpy(),
                                PSNR_CAP).tolist())
        ssims.extend(ssim(a, b).cpu().numpy().tolist())
    if not psnrs:
        raise ValueError("no views to score: every object was empty")
    return {
        "psnr": round(float(np.mean(psnrs)), 3),
        "psnr_std": round(float(np.std(psnrs)), 3),
        "ssim": round(float(np.mean(ssims)), 4),
        "views": len(psnrs),
    }


def cascade_parity(draft_gens: Sequence[np.ndarray],
                   refined_gens: Sequence[np.ndarray],
                   oracle_gens: Sequence[np.ndarray],
                   w_index: int = 0,
                   max_objects: Optional[int] = None) -> dict:
    """A cascade run against the single-pass full-resolution oracle,
    draft (upsampled here) and refined side by side: ``{"draft": {...},
    "refined": {...}, "objects"}``, each a :func:`matched_seed_parity`
    record."""
    if max_objects is not None:
        draft_gens = list(draft_gens)[:max_objects]
        refined_gens = list(refined_gens)[:max_objects]
        oracle_gens = list(oracle_gens)[:max_objects]
    if not (len(draft_gens) == len(refined_gens) == len(oracle_gens)):
        raise ValueError(
            f"{len(draft_gens)} draft vs {len(refined_gens)} refined vs "
            f"{len(oracle_gens)} oracle objects — the lists must align")
    return {
        "draft": matched_seed_parity(draft_gens, oracle_gens,
                                     w_index=w_index, resize=True),
        "refined": matched_seed_parity(refined_gens, oracle_gens,
                                       w_index=w_index),
        "objects": len(oracle_gens),
    }
