"""Positional encodings (counterpart: ``diff3d_tpu/geometry/posenc.py``).

Both run in float32 whatever the model's compute dtype: their sinusoid
arguments reach ~2e4 (``posenc_ddpm``'s x1000 scaling) and 2^14 (NeRF
degree 15), far past bf16's mantissa.  Callers compute them outside any
autocast region.  Their constant tables are made once per device and
kept there: a captured CUDA graph may not copy from the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cached_table(values: tuple, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _tracing() -> bool:
    """Whether a fake-tensor or tracing mode is active (a table made there
    is fake and must not be cached for real calls)."""
    key = torch._C._TorchDispatchModeKey
    return any(torch._C._get_dispatch_mode(k) is not None
               for k in (key.FAKE, key.PROXY))


def _table(values: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once (a plain tensor even
    when first asked for under ``inference_mode``); under a trace on fake
    tensors (``analysis/ir.py``) made anew each time."""
    if _tracing():
        return torch.tensor(values, dtype=dtype, device=device)
    return _cached_table(values, dtype, device)


def posenc_ddpm(timesteps: torch.Tensor, emb_ch: int,
                max_time: float = 1000.0) -> torch.Tensor:
    """DDPM sinusoidal embedding ``[...] -> [..., emb_ch]`` (reference
    ``xunet.py:32-46``): input scaled by ``1000/max_time``, frequencies
    ``exp(-arange(half) * ln(10000)/(half-1))``, ``concat([sin, cos])``."""
    timesteps = timesteps.to(torch.float32) * (1000.0 / max_time)
    half_dim = emb_ch // 2
    freq = np.exp(np.arange(half_dim) * -(np.log(10000.0) / (half_dim - 1)))
    emb = timesteps[..., None] * _table(tuple(freq.tolist()), torch.float32,
                                        timesteps.device)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def posenc_nerf(x: torch.Tensor, min_deg: int = 0,
                max_deg: int = 15) -> torch.Tensor:
    """NeRF encoding concatenated with the input (reference
    ``xunet.py:49-59``): ``xb[..., i, c] = x[..., c] * 2**i`` flattened
    scale-major, then ``sin(concat([xb, xb + pi/2]))`` appended to ``x``.
    Output channels: ``C + 2*C*(max_deg - min_deg)``."""
    if min_deg == max_deg:
        return x
    scales = _table(tuple(2.0 ** i for i in range(min_deg, max_deg)),
                    x.dtype, x.device)
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
