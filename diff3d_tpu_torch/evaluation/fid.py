"""Frechet distance between Gaussian fits to image features (counterpart:
``diff3d_tpu/evaluation/fid.py``).

FID = |mu_r - mu_g|^2 + tr(C_r + C_g - 2 (C_r C_g)^{1/2}).  The feature
extractor is pluggable; with no pretrained weights in the repository the
default is a fixed random embedding (4x4/4 patch filter -> ReLU -> mean
and std pool -> projection), seeded, which makes relative comparisons
within one package meaningful.  Its weights come from a CPU
``torch.Generator``, which cannot reproduce the JAX package's
``jax.random`` draws: the port's ``fid_randfeat`` is a different random
embedding from the JAX package's, and the two numbers must not be
compared.  (Given the same weights, both compute the same features.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class FIDStats:
    mu: np.ndarray      # [D]
    cov: np.ndarray     # [D, D]
    n: int


def default_feature_fn(dim: int = 256, seed: int = 0,
                       weights: Optional[Sequence[np.ndarray]] = None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed random features of ``[B, H, W, C]`` images: a 4x4 stride-4
    patch filter ``w [4, 4, C, dim]`` (HWIO) -> ReLU -> the spatial mean
    and std (population) -> the projection ``p [2 dim, dim]``.  ``w`` is
    normal / sqrt(16 C) and ``p`` normal / sqrt(2 dim), drawn from a CPU
    generator seeded with ``seed`` when first called (C is the images'),
    or given as ``weights = (w, p)``.  Runs in float32 on the images'
    device."""
    cache = {}
    if weights is not None:
        w, p = weights
        cache["w"] = torch.as_tensor(np.array(w, np.float32))
        cache["p"] = torch.as_tensor(np.array(p, np.float32))

    def feats(imgs) -> torch.Tensor:
        x = torch.as_tensor(imgs).float()
        C = x.shape[-1]
        if "w" not in cache:
            gen = torch.Generator().manual_seed(seed)
            cache["w"] = torch.randn(4, 4, C, dim, generator=gen) \
                / math.sqrt(4 * 4 * C)
            cache["p"] = torch.randn(2 * dim, dim, generator=gen) \
                / math.sqrt(2 * dim)
        w = cache["w"].to(x.device).permute(3, 2, 0, 1)      # OIHW
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            h = F.relu(F.conv2d(x.permute(0, 3, 1, 2), w, stride=4))
        pooled = torch.cat([h.mean(dim=(2, 3)),
                            h.std(dim=(2, 3), unbiased=False)], dim=-1)
        return pooled @ cache["p"].to(x.device)

    return feats


def gaussian_stats(batches: Iterable, feature_fn: Optional[Callable] = None
                   ) -> FIDStats:
    """Streaming mean and covariance (float64, on the host) of the
    features of image batches ``[B, H, W, C]``."""
    feature_fn = feature_fn or default_feature_fn()
    s = None
    with torch.no_grad():
        for batch in batches:
            x = feature_fn(batch).double().cpu().numpy()
            if s is None:
                s = {"sum": np.zeros(x.shape[1]),
                     "outer": np.zeros((x.shape[1], x.shape[1])), "n": 0}
            s["sum"] += x.sum(0)
            s["outer"] += x.T @ x
            s["n"] += x.shape[0]
    if s is None or s["n"] < 2:
        raise ValueError("need at least 2 images for FID stats")
    mu = s["sum"] / s["n"]
    cov = (s["outer"] - s["n"] * np.outer(mu, mu)) / (s["n"] - 1)
    return FIDStats(mu=mu, cov=cov, n=s["n"])


def frechet_distance(a: FIDStats, b: FIDStats, eps: float = 1e-6) -> float:
    """``|mu_a-mu_b|^2 + tr(Ca + Cb - 2 (Ca Cb)^{1/2})``, with
    ``tr((Ca Cb)^{1/2}) = tr((Ca^{1/2} Cb Ca^{1/2})^{1/2})`` and the PSD
    square root by eigendecomposition; ``eps`` on each diagonal."""
    diff = a.mu - b.mu

    def sqrtm_psd(m):
        vals, vecs = np.linalg.eigh(m)
        vals = np.clip(vals, 0.0, None)
        return (vecs * np.sqrt(vals)) @ vecs.T

    ca = a.cov + eps * np.eye(a.cov.shape[0])
    cb = b.cov + eps * np.eye(b.cov.shape[0])
    sa = sqrtm_psd(ca)
    inner = sa @ cb @ sa
    vals = np.clip(np.linalg.eigvalsh(inner), 0.0, None)
    tr_sqrt = float(np.sqrt(vals).sum())
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * tr_sqrt)


def fid_from_stats(real: FIDStats, gen: FIDStats) -> float:
    return frechet_distance(real, gen)
