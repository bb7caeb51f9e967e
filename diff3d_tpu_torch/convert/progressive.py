"""Progressive resolution transfer: reuse trained weights across H/W
(counterpart: ``diff3d_tpu/convert/progressive.py``), on the port's state
dicts.

The X-UNet is resolution-independent everywhere except the conditioning
processor's learned per-pixel embedding ``pos_emb [H, W, 144]``: convs
slide, GroupNorm and FiLM act per channel, attention runs over whatever
tokens arrive, and the ray embeddings come from the camera at the current
resolution.  So a model trained at 64² seeds a 128² run by copying every
parameter and resizing ``pos_emb`` bilinearly -- the 128² run costs about
4x the 64² per example, and this hands it everything
resolution-independent.

The resize is ``jax.image.resize(..., "bilinear")``'s: half-pixel
centres (``align_corners=False``) and, where a dimension shrinks, an
antialiasing triangle filter widened by the scale (``antialias=True``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

POS_EMB = "conditioningprocessor.pos_emb"


def adapt_params_resolution(params: Mapping[str, torch.Tensor],
                            dst_hw: Tuple[int, int]
                            ) -> Dict[str, torch.Tensor]:
    """``params`` (an X-UNet state dict) adapted to a model of resolution
    ``dst_hw``: every tensor as it is, except ``pos_emb [H, W, C]``,
    resized bilinearly.  Raises ``KeyError`` on a dict with no
    conditioning processor (not an X-UNet's: an optimizer state here would
    otherwise pass through unchanged)."""
    if not any(k.startswith("conditioningprocessor.") for k in params):
        raise KeyError("conditioningprocessor: not an X-UNet state dict")
    out = dict(params)
    pe = out.get(POS_EMB)
    if pe is not None and tuple(pe.shape[:2]) != tuple(dst_hw):
        out[POS_EMB] = resize_bilinear(pe, dst_hw).to(pe.dtype)
    return out


def resize_bilinear(x: torch.Tensor, dst_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """``x [..., H, W, C]`` resized to ``dst_hw`` as
    ``jax.image.resize(x, ..., "bilinear")`` does (see the module
    docstring), in float32; contiguous."""
    H, W, C = x.shape[-3:]
    H2, W2 = dst_hw
    lead = x.shape[:-3]
    y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2).float()  # [N, C, H, W]
    y = F.interpolate(y, size=(H2, W2), mode="bilinear",
                      align_corners=False, antialias=H2 < H or W2 < W)
    return y.permute(0, 2, 3, 1).reshape(*lead, H2, W2, C).contiguous()


def init_student_from_teacher(params: Mapping[str, torch.Tensor],
                              dst_hw: Optional[Tuple[int, int]] = None
                              ) -> Dict[str, torch.Tensor]:
    """A fresh copy of ``params`` (optionally resolution-adapted first):
    the student of a distillation round starts as its teacher but must
    never share its tensors."""
    if dst_hw is not None:
        params = adapt_params_resolution(params, dst_hw)
    return {k: v.detach().clone() for k, v in params.items()}


def check_resolution_compatible(src: Mapping[str, torch.Tensor],
                                dst: Mapping[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` naming the first mismatch unless ``src``
    (adapted) has ``dst``'s names and shapes: the widths must agree, only
    ``pos_emb`` may have differed (e.g. seeding a ``--ch 128`` run from a
    ``--ch 64`` checkpoint is refused)."""
    if src.keys() != dst.keys():
        missing = sorted(dst.keys() - src.keys())
        extra = sorted(src.keys() - dst.keys())
        raise ValueError(
            f"init_from checkpoint tree mismatch: missing={missing[:4]} "
            f"extra={extra[:4]} — the source model's width/depth "
            "(--ch/--emb_ch/--num_res_blocks) must equal the target's")
    for k in dst:
        if tuple(src[k].shape) != tuple(dst[k].shape):
            raise ValueError(
                f"init_from shape mismatch at {k}: source "
                f"{tuple(src[k].shape)} vs target {tuple(dst[k].shape)} — "
                "source width must equal target width (only H/W may "
                "differ)")
