"""The X-UNet (Watson et al., 3DiM) as a PyTorch module (counterpart:
``diff3d_tpu/models/xunet.py``; reference ``xunet.py:355-536``).

Forward contract, the JAX package's: a batch dict with ``x [B, H, W, 3]``,
``z [B, H, W, 3]``, ``logsnr [B, 2]``, ``R [B, 2, 3, 3]``, ``t [B, 2, 3]``,
``K [B, 3, 3]`` (and optionally the precomputed ``cam_dirs``) plus
``cond_mask [B] bool``; returns the predicted noise of the target frame,
``[B, H, W, 3]`` float32.  Parity traps: the up path concatenates
``[h, skip]`` in that order, and the head keeps frame 1 only.

With ``cfg.remat`` every ``XUNetBlock`` and resampling ``ResnetBlock``
is rematerialised in training, the counterpart of ``nn.remat(...,
policy=...)`` (reference ``xunet.py:56-69``): ``remat_policy="nothing"``
keeps only the block's input and recomputes the rest in the backward;
``"dots"`` also keeps every convolution and matrix-product output
(``jax.checkpoint_policies.dots_saveable``).  The recompute applies the
same dropout masks as the forward (:func:`remat_call`).

Placed over a model axis (``MeshEnv.place_model_axis``), the stream
between blocks is this rank's channel block, the up path's concatenation
is taken on the whole tensors (so the next layer sees the unsharded
model's channel order), each level's conditioning embedding is gathered
once for all its FiLM layers, and the head's output is whole on every
rank (``layers.py`` says how each layer splits).

Split by image rows (``MeshEnv.place_context_axis``, ``cp``), the stream
between blocks is this rank's rows of every level: the stem conv reads
this rank's rows of ``x`` / ``z`` with one row above and below (sliced
from the whole inputs every rank holds, zeros at the edges), the level
embeddings are by rows (``conditioning.py``), the up path's concatenation
is local (the rows match), and the head's 3 output channels are gathered
into the whole image, whose gradient each rank takes back for its rows
only.  Remat recomputes a block's collectives in the backward, in the
same order on every rank; its dropout mask is this rank's rows of the
whole mask.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from diff3d_tpu_torch.config import ModelConfig
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.models.conditioning import (POSE_EMB_CH,
                                                  ConditioningProcessor)
from diff3d_tpu_torch.models.layers import (FiLM, Conv, Dense,
                                            FrameGroupNorm, ResnetBlock,
                                            XUNetBlock, dropout_keep)
from diff3d_tpu_torch.parallel.context import with_halo
from diff3d_tpu_torch.parallel.tensor import ColumnInput

FRAMES = 2      # source view + target view

# The ops whose outputs the "dots" policy keeps: every convolution and
# matrix product (F.linear and the plain attention decompose into these).
# The kernel wrappers' outputs (``torch.empty`` that a ctypes kernel fills)
# are recomputed, never kept.
_DOTS = frozenset({torch.ops.aten.convolution.default,
                   torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """A bool mask as uint8 bits (little-endian within each byte); a mask
    whose size is not a multiple of 8 stays as it is."""
    if keep.numel() % 8:
        return keep
    shifts = torch.arange(8, dtype=torch.uint8, device=keep.device)
    return (keep.reshape(-1, 8).to(torch.uint8) << shifts).sum(
        -1, dtype=torch.uint8)


def _unpack_bits(bits: torch.Tensor, shape) -> torch.Tensor:
    if bits.dtype == torch.bool:
        return bits
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).bool().reshape(shape)


def _draw_dropout(block: nn.Module, h: torch.Tensor,
                  generator: Optional[torch.Generator]):
    """``(bits, shape)``: the keep mask ``block`` would draw from
    ``generator`` in its forward, drawn now (its one random draw, so the
    generator's sequence is unchanged) and packed to bits; ``(None,
    None)`` where its dropout does not draw."""
    res = block.resnetblock if isinstance(block, XUNetBlock) else block
    rate = res.dropout_rate
    if not res.training or rate in (0.0, 1.0):
        return None, None
    shape = tuple(h.shape[:3]) + (res.features,)
    return _pack_bits(dropout_keep(shape, rate, generator, h.device,
                                   res.cp)), shape


def remat_call(block: nn.Module, policy: str, *args,
               generator: Optional[torch.Generator] = None):
    """``block(*args, generator)`` under ``torch.utils.checkpoint``
    (non-reentrant; the default generators are left alone: the model
    draws only from ``generator``).

    ``checkpoint(preserve_rng_state=True)`` restores only the default
    generators, so a block that drew its dropout mask from ``generator``
    would draw a new one in the recompute.  Its mask is drawn before the
    block runs instead, in the order the block would draw it, and kept as
    bits (1/16 of a bf16 activation) for the forward and the recompute;
    the generator is not drawn from again, so it ends where a run without
    remat leaves it.  (Snapshotting the generator and replaying its state
    in the recompute would need ``Generator.clone_state()`` inside the
    captured backward, which PyTorch refuses during a CUDA graph
    capture.)"""
    bits, shape = _draw_dropout(block, args[0], generator)

    def run(*a):
        *a, b = a
        keep = None if b is None else _unpack_bits(b, shape)
        return block(*a, generator, keep)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return _ckpt.checkpoint(run, *args, bits, use_reentrant=False,
                            preserve_rng_state=False, **kw)


def concat_channels(axis, h: torch.Tensor, skip: torch.Tensor, ch: int,
                    cs: int) -> torch.Tensor:
    """The up path's ``[h, skip]`` (``ch`` and ``cs`` channels whole).
    Over a model axis (``axis``) two blocks do not join into the block of
    their concatenation: both are taken whole, joined, and this rank's
    block of the result is kept (whole where ``ch + cs`` does not split),
    so the next layer sees the unsharded model's channel order."""
    if axis is None:
        return torch.cat([h, skip], dim=-1)
    h = torch.cat([axis.whole(h, ch), axis.whole(skip, cs)], dim=-1)
    return axis.to_block(h, ch + cs) if (ch + cs) % axis.size == 0 else h


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
        #: The widths of each up block's concatenation ``[h, skip]``.
        self._concat = {}
        for i in reversed(range(num_res)):
            for b in range(cfg.num_res_blocks + 1):
                self._concat[f"up_{i}_{b}"] = (ch, skips[-1])
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
        self.tp = None
        self.cp = None

    def forward(self, batch: Dict[str, torch.Tensor],
                cond_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` feeds dropout in ``train()`` mode (every
        ResnetBlock draws from it in call order).  Remat acts only in
        ``train()`` mode with autograd recording; otherwise the blocks run
        as they are."""
        cfg = self.cfg
        num_res = cfg.num_resolutions
        B, H, W, C = batch["x"].shape
        if (H, W) != (cfg.H, cfg.W) or cond_mask.shape != (B,):
            raise ValueError(
                f"batch x {tuple(batch['x'].shape)} / cond_mask "
                f"{tuple(cond_mask.shape)} do not fit H={cfg.H} W={cfg.W}")
        logsnr_emb, pose_embs = self.conditioningprocessor(batch, cond_mask)
        logsnr_emb = logsnr_emb.reshape(B * FRAMES, 1, 1,
                                        logsnr_emb.shape[-1])

        remat = cfg.remat and self.training and torch.is_grad_enabled()

        def block(name, *args):
            mod = getattr(self, name)
            if remat:
                return remat_call(mod, cfg.remat_policy, *args,
                                  generator=generator)
            return mod(*args, generator)

        axis = self.tp
        # Every FiLM column-parallel: each level's embedding is gathered
        # once for all of them.
        once = axis is not None and all(
            m.Dense_0.tp_mode == "column" for m in self.modules()
            if isinstance(m, FiLM))

        def level_emb(i):
            emb, pose = logsnr_emb, pose_embs[i]    # [B*F, h, w, emb_ch]
            if axis is None:
                return emb + pose
            emb, pose = axis.align(emb, pose, cfg.emb_ch)
            emb = emb + pose
            return ColumnInput(axis.column_input(emb, cfg.emb_ch)) \
                if once else emb

        h = torch.stack([batch["x"], batch["z"]], dim=1).to(
            cfg.torch_dtype).reshape(B * FRAMES, H, W, C)
        if axis is not None:
            h = axis.input_for(h, C, [self.stem_conv])
        if self.cp is not None:
            h = self.stem_conv(with_halo(h, *self.cp.rows(H)),
                               rows_padded=True)
        else:
            h = self.stem_conv(h)

        hs = [h]
        for i in range(num_res):
            emb = level_emb(i)
            for b in range(cfg.num_res_blocks):
                h = block(f"down_{i}_{b}", h, emb, FRAMES)
                hs.append(h)
            if i != num_res - 1:
                h = block(f"down_{i}_downsample", h, emb)
                hs.append(h)
        h = block("middle", h, level_emb(num_res - 1), FRAMES)
        for i in reversed(range(num_res)):
            emb = level_emb(i)
            for b in range(cfg.num_res_blocks + 1):
                h = concat_channels(axis, h, hs.pop(),
                                    *self._concat[f"up_{i}_{b}"])
                h = block(f"up_{i}_{b}", h, emb, FRAMES)
            if i != 0:
                h = block(f"up_{i}_upsample", h, emb)
        assert not hs

        h = self.last_gn(h)
        if axis is not None:
            h = axis.input_for(h, self.last_gn.weight.shape[0],
                               [self.last_conv])
        h = self.last_conv(h)
        if axis is not None:
            h = axis.whole(h, 3)
        h = h.reshape(B, FRAMES, h.shape[1], W, 3)[:, 1]
        if self.cp is not None:
            h = self.cp.gather_rows(h)
        return h.float()


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
