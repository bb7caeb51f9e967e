"""Pose / noise-level conditioning (counterpart:
``diff3d_tpu/models/conditioning.py``; reference ``xunet.py:259-352``)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff3d_tpu_torch.geometry import (pinhole_rays_cam, pinhole_rays_world,
                                       posenc_ddpm, posenc_nerf)
from diff3d_tpu_torch.geometry.posenc import posenc_nerf_channels
from diff3d_tpu_torch.models.layers import Conv, Dense

# 93 (pos, degrees 0..15) + 51 (dir, degrees 0..8) = 144 channels.
POS_DEG = 15
DIR_DEG = 8
POSE_EMB_CH = (posenc_nerf_channels(0, POS_DEG)
               + posenc_nerf_channels(0, DIR_DEG))


class ConditioningProcessor(nn.Module):
    """Produces ``(logsnr_emb [B, F, emb_ch], pose_embs[level])``, each
    pose embedding ``[B*F, H/2^i, W/2^i, emb_ch]``.

      1. clip logsnr to the schedule bounds, DDPM-posenc it (f32,
         ``max_time=1``) and MLP it to ``emb_ch``;
      2. per-pixel rays from (R, t, K), NeRF-posenc pos (deg 15) and dir
         (deg 8) -> 144 channels, in f32;
      3. zero the pose embedding of both frames where ``cond_mask`` is
         False (classifier-free guidance);
      4. add the learnable per-pixel ``pos_emb`` and per-frame
         ``first_emb`` / ``other_emb``;
      5. 3x3 convs 144 -> emb_ch at stride ``2^level`` with explicit
         padding 1 (not SAME, which aligns the strided grid differently).

    Placed over a model axis (``tp``), the MLP's Dense layers and the
    level convs are column-parallel: every embedding comes out as this
    rank's block of ``emb_ch`` (whole where ``emb_ch`` does not split).
    """

    def __init__(self, emb_ch: int, H: int, W: int, num_resolutions: int,
                 use_pos_emb: bool = True, use_ref_pose_emb: bool = True,
                 logsnr_clip: float = 20.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        D = POSE_EMB_CH
        self.emb_ch, self.H, self.W = emb_ch, H, W
        self.num_resolutions = num_resolutions
        self.logsnr_clip = logsnr_clip
        self.Dense_0 = Dense(emb_ch, emb_ch, compute_dtype)
        self.Dense_1 = Dense(emb_ch, emb_ch, compute_dtype)
        self.pos_emb = (nn.Parameter(torch.zeros(H, W, D))
                        if use_pos_emb else None)
        if use_ref_pose_emb:
            self.first_emb = nn.Parameter(torch.zeros(1, 1, 1, 1, D))
            self.other_emb = nn.Parameter(torch.zeros(1, 1, 1, 1, D))
        else:
            self.first_emb = self.other_emb = None
        for i in range(num_resolutions):
            setattr(self, f"level_conv_{i}",
                    Conv(D, emb_ch, 3, stride=2 ** i, padding=1,
                         compute_dtype=compute_dtype))
        self.tp = None

    def forward(self, batch: Dict[str, torch.Tensor],
                cond_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        H, W = self.H, self.W
        logsnr = torch.clamp(batch["logsnr"].float(), -self.logsnr_clip,
                             self.logsnr_clip)                   # [B, F]
        logsnr_emb = posenc_ddpm(logsnr, self.emb_ch, max_time=1.0)
        axis, E = self.tp, self.emb_ch
        if axis is not None:
            logsnr_emb = axis.input_for(logsnr_emb, E, [self.Dense_0])
        h = F.silu(self.Dense_0(logsnr_emb))
        if axis is not None:
            h = axis.input_for(h, E, [self.Dense_1])
        logsnr_emb = self.Dense_1(h)

        # The intrinsics-only half may arrive precomputed as
        # batch['cam_dirs'] (the sampler computes it once per trajectory).
        cam_dirs = batch.get("cam_dirs")
        if cam_dirs is None:
            cam_dirs = pinhole_rays_cam(batch["K"][:, None].float(), H, W)
        pos, dirs = pinhole_rays_world(batch["R"].float(),
                                       batch["t"].float(), cam_dirs)
        pose_emb = torch.cat([posenc_nerf(pos, 0, POS_DEG),
                              posenc_nerf(dirs, 0, DIR_DEG)], dim=-1)
        pose_emb = torch.where(cond_mask[:, None, None, None, None],
                               pose_emb, torch.zeros_like(pose_emb))
        if self.pos_emb is not None:
            pose_emb = pose_emb + self.pos_emb[None, None]
        B, Fr = pose_emb.shape[:2]
        if self.first_emb is not None:
            ref_emb = torch.cat([self.first_emb]
                                + [self.other_emb] * (Fr - 1), dim=1)
            pose_emb = pose_emb + ref_emb

        flat = pose_emb.reshape(B * Fr, H, W, POSE_EMB_CH)
        convs = [getattr(self, f"level_conv_{i}")
                 for i in range(self.num_resolutions)]
        if axis is not None:
            flat = axis.input_for(flat, POSE_EMB_CH, convs)
        return logsnr_emb, [conv(flat) for conv in convs]
