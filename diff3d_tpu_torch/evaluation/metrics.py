"""Image-quality metrics on torch tensors (counterpart:
``diff3d_tpu/evaluation/metrics.py``).

Images are ``[..., H, W, C]`` in [-1, 1] (data range 2.0); numpy arrays
are taken as tensors.  Both metrics compute in float32 on the inputs'
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(a, b):
    a = torch.as_tensor(a).float()
    return a, torch.as_tensor(b, device=a.device).float()


def psnr(a, b, max_val: float = 2.0) -> torch.Tensor:
    """Peak signal-to-noise ratio per image pair, ``[...]`` dB; the MSE is
    floored at 1e-12 (identical images give a finite value)."""
    a, b = _pair(a, b)
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def ssim(a, b, max_val: float = 2.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004) with the separable 11-tap
    Gaussian window (sigma 1.5) and edge padding; the mean SSIM over
    pixels and channels per image, ``[...]``."""
    a, b = _pair(a, b)
    kern = _gaussian_kernel(filter_size, filter_sigma).tolist()
    pad = filter_size // 2

    def blur(x):
        lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
        y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)       # [M, C, H, W]
        yp = F.pad(y, (0, 0, pad, pad), mode="replicate")
        y = sum(kern[i] * yp[:, :, i:i + H] for i in range(filter_size))
        yp = F.pad(y, (pad, pad, 0, 0), mode="replicate")
        y = sum(kern[i] * yp[..., i:i + W] for i in range(filter_size))
        return y.permute(0, 2, 3, 1).reshape(*lead, H, W, C)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(-3, -2, -1))
