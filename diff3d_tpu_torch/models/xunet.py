"""The X-UNet (Watson et al., 3DiM) as a PyTorch module (counterpart:
``diff3d_tpu/models/xunet.py``; reference ``xunet.py:355-536``).

Forward contract, the JAX package's: a batch dict with ``x [B, H, W, 3]``,
``z [B, H, W, 3]``, ``logsnr [B, 2]``, ``R [B, 2, 3, 3]``, ``t [B, 2, 3]``,
``K [B, 3, 3]`` (and optionally the precomputed ``cam_dirs``) plus
``cond_mask [B] bool``; returns the predicted noise of the target frame,
``[B, H, W, 3]`` float32.  Parity traps: the up path concatenates
``[h, skip]`` in that order, and the head keeps frame 1 only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
from torch import nn

from diff3d_tpu_torch.config import ModelConfig
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.models.conditioning import (POSE_EMB_CH,
                                                  ConditioningProcessor)
from diff3d_tpu_torch.models.layers import (Conv, Dense, FrameGroupNorm,
                                            ResnetBlock, XUNetBlock)

FRAMES = 2      # source view + target view


class XUNet(nn.Module):
    """Submodules carry the Flax names (``stem_conv``, ``down_{i}_{b}``,
    ``down_{i}_downsample``, ``middle``, ``up_{i}_{b}``,
    ``up_{i}_upsample``, ``last_gn``, ``last_conv``,
    ``conditioningprocessor``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dt = cfg.torch_dtype
        kw = dict(compute_dtype=dt, dropout=cfg.dropout)
        num_res = cfg.num_resolutions
        dim_out = [cfg.ch * m for m in cfg.ch_mult]
        E = cfg.emb_ch

        self.conditioningprocessor = ConditioningProcessor(
            E, cfg.H, cfg.W, num_res, use_pos_emb=cfg.use_pos_emb,
            use_ref_pose_emb=cfg.use_ref_pose_emb,
            logsnr_clip=cfg.logsnr_clip, compute_dtype=dt)
        self.stem_conv = Conv(3, cfg.ch, 3, compute_dtype=dt)

        # Channel bookkeeping of the skip stack (Flax infers input widths).
        ch = cfg.ch
        skips = [ch]
        for i in range(num_res):
            for b in range(cfg.num_res_blocks):
                setattr(self, f"down_{i}_{b}", XUNetBlock(
                    ch, dim_out[i], E, use_attn=i in cfg.attn_levels,
                    num_heads=cfg.attn_heads, **kw))
                ch = dim_out[i]
                skips.append(ch)
            if i != num_res - 1:
                setattr(self, f"down_{i}_downsample", ResnetBlock(
                    ch, dim_out[i], E, resample="down", **kw))
                skips.append(ch)
        self.middle = XUNetBlock(ch, dim_out[-1], E,
                                 use_attn=num_res in cfg.attn_levels,
                                 num_heads=cfg.attn_heads, **kw)
        ch = dim_out[-1]
        for i in reversed(range(num_res)):
            for b in range(cfg.num_res_blocks + 1):
                setattr(self, f"up_{i}_{b}", XUNetBlock(
                    ch + skips.pop(), dim_out[i], E,
                    use_attn=i in cfg.attn_levels,
                    num_heads=cfg.attn_heads, **kw))
                ch = dim_out[i]
            if i != 0:
                setattr(self, f"up_{i}_upsample", ResnetBlock(
                    ch, dim_out[i], E, resample="up", **kw))
        assert not skips
        self.last_gn = FrameGroupNorm(dim_out[0], silu=True)
        self.last_conv = Conv(dim_out[0], 3, 3, compute_dtype=dt,
                              zero_init=True)

    def forward(self, batch: Dict[str, torch.Tensor],
                cond_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` feeds dropout in ``train()`` mode (every
        ResnetBlock draws from it in call order)."""
        cfg = self.cfg
        num_res = cfg.num_resolutions
        B, H, W, C = batch["x"].shape
        if (H, W) != (cfg.H, cfg.W) or cond_mask.shape != (B,):
            raise ValueError(
                f"batch x {tuple(batch['x'].shape)} / cond_mask "
                f"{tuple(cond_mask.shape)} do not fit H={cfg.H} W={cfg.W}")
        logsnr_emb, pose_embs = self.conditioningprocessor(batch, cond_mask)
        logsnr_emb = logsnr_emb.reshape(B * FRAMES, 1, 1, cfg.emb_ch)

        def level_emb(i):
            return logsnr_emb + pose_embs[i]        # [B*F, h, w, emb_ch]

        h = torch.stack([batch["x"], batch["z"]], dim=1).to(
            cfg.torch_dtype).reshape(B * FRAMES, H, W, C)
        h = self.stem_conv(h)

        hs = [h]
        for i in range(num_res):
            emb = level_emb(i)
            for b in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{i}_{b}")(h, emb, FRAMES,
                                                   generator)
                hs.append(h)
            if i != num_res - 1:
                h = getattr(self, f"down_{i}_downsample")(h, emb, generator)
                hs.append(h)
        h = self.middle(h, level_emb(num_res - 1), FRAMES, generator)
        for i in reversed(range(num_res)):
            emb = level_emb(i)
            for b in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=-1)
                h = getattr(self, f"up_{i}_{b}")(h, emb, FRAMES, generator)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h, emb, generator)
        assert not hs

        h = self.last_conv(self.last_gn(h))
        return h.reshape(B, FRAMES, H, W, 3)[:, 1].float()


def init_params(model: nn.Module, generator: torch.Generator,
                randomize_zero_init: bool = False) -> None:
    """Initialise every parameter from ``generator`` (a CPU generator), as
    Flax does: Dense/Conv kernels normal with variance 1/fan_in, biases
    zero, GroupNorm scale one and bias zero, the pose embeddings normal
    with std 1/sqrt(144); the convs Flax zero-initialises stay zero unless
    ``randomize_zero_init`` (random weights that exercise every layer)."""

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Dense, Conv)):
                fan_in = math.prod(mod.weight.shape[1:])
                if getattr(mod, "zero_init", False) \
                        and not randomize_zero_init:
                    mod.weight.zero_()
                else:
                    normal(mod.weight, 1.0 / math.sqrt(fan_in))
                mod.bias.zero_()
            elif isinstance(mod, FrameGroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ConditioningProcessor):
                for p in (mod.pos_emb, mod.first_emb, mod.other_emb):
                    if p is not None:
                        normal(p, 1.0 / math.sqrt(POSE_EMB_CH))


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None, *,
                seed: int = 0, randomize_zero_init: bool = False) -> XUNet:
    """An :class:`XUNet` with weights initialised from ``seed``, in eval
    mode on ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    model = XUNet(cfg)
    init_params(model, torch.Generator().manual_seed(seed),
                randomize_zero_init=randomize_zero_init)
    return model.to(device).eval()
