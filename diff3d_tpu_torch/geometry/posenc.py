"""Positional encodings (counterpart: ``diff3d_tpu/geometry/posenc.py``).

Both run in float32 whatever the model's compute dtype: their sinusoid
arguments reach ~2e4 (``posenc_ddpm``'s x1000 scaling) and 2^14 (NeRF
degree 15), far past bf16's mantissa.  Callers compute them outside any
autocast region.
"""

from __future__ import annotations

import numpy as np
import torch


def posenc_ddpm(timesteps: torch.Tensor, emb_ch: int,
                max_time: float = 1000.0) -> torch.Tensor:
    """DDPM sinusoidal embedding ``[...] -> [..., emb_ch]`` (reference
    ``xunet.py:32-46``): input scaled by ``1000/max_time``, frequencies
    ``exp(-arange(half) * ln(10000)/(half-1))``, ``concat([sin, cos])``."""
    timesteps = timesteps.to(torch.float32) * (1000.0 / max_time)
    half_dim = emb_ch // 2
    freq = np.exp(np.arange(half_dim) * -(np.log(10000.0) / (half_dim - 1)))
    emb = timesteps[..., None] * torch.as_tensor(
        freq, dtype=torch.float32, device=timesteps.device)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def posenc_nerf(x: torch.Tensor, min_deg: int = 0,
                max_deg: int = 15) -> torch.Tensor:
    """NeRF encoding concatenated with the input (reference
    ``xunet.py:49-59``): ``xb[..., i, c] = x[..., c] * 2**i`` flattened
    scale-major, then ``sin(concat([xb, xb + pi/2]))`` appended to ``x``.
    Output channels: ``C + 2*C*(max_deg - min_deg)``."""
    if min_deg == max_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]
    xb = xb.reshape(*x.shape[:-1], -1)
    emb = torch.sin(torch.cat([xb, xb + np.pi / 2.0], dim=-1))
    return torch.cat([x, emb], dim=-1)


def posenc_nerf_channels(min_deg: int, max_deg: int, base: int = 3) -> int:
    """Output channel count of :func:`posenc_nerf` for a ``base``-dim
    input."""
    if min_deg == max_deg:
        return base
    return base + 2 * base * (max_deg - min_deg)
