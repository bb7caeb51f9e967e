"""Image quantization at the host->device boundary (counterpart:
``diff3d_tpu/data/images.py``).

Batches cross to the card as uint8 (4x less host RAM and copy traffic
than float32); the train step dequantizes to [-1, 1] on the device.  The
[-1, 1] float pipeline quantizes to the same 1/127.5 grid the 8-bit
sources came from.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)


def quantize_uint8(imgs: np.ndarray,
                   warn_state: Optional[dict] = None) -> np.ndarray:
    """Host-side ``[-1, 1] float`` -> ``[0, 255] uint8`` (round to
    nearest, clipped).  ``warn_state`` is a per-caller dict: the first
    array it sees is range-checked and an out-of-range source logged once
    (values outside [-1, 1] are clipped)."""
    imgs = np.asarray(imgs)
    if warn_state is not None and not warn_state.get("checked"):
        warn_state["checked"] = True
        lo, hi = float(imgs.min()), float(imgs.max())
        if lo < -1.0001 or hi > 1.0001:
            log.warning("quantize_uint8: input range [%.3f, %.3f] exceeds "
                        "[-1, 1]; values will be clipped", lo, hi)
    return np.clip((imgs + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def dequantize(imgs: torch.Tensor) -> torch.Tensor:
    """``uint8 [0, 255]`` -> ``float32 [-1, 1]``."""
    if imgs.dtype != torch.uint8:
        raise TypeError(f"dequantize: expected uint8 images, got {imgs.dtype}")
    return imgs.float() / 127.5 - 1.0
