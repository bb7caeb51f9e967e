"""X-UNet building blocks (counterpart: ``diff3d_tpu/models/layers.py``).

Feature maps are ``[N, H, W, C]`` with the frames folded into N
(``N = B * F``, frame-major within each example), the JAX package's
``[B, F, H, W, C]`` reshaped.  A contiguous NHWC tensor permuted to NCHW
is a ``channels_last`` tensor, so cuDNN runs its NHWC convolutions and the
GroupNorm kernel reads ``[N, H*W, C]`` with no copy.

Compute follows Flax's ``dtype=`` semantics: parameters are float32, and
:class:`Dense` / :class:`Conv` cast their input, weight and bias to the
compute dtype.  Submodule attribute names are the Flax module names
(``FrameGroupNorm_0``, ``FiLM_0``, ``conv1`` ...), so a Flax parameter
path names its port parameter (:mod:`diff3d_tpu_torch.convert.from_jax`).

Parity traps the JAX package paid for, kept here: GroupNorm eps 1e-5;
cross attention rolls the frames by -1 and both frames share one
``AttnLayer``; residuals are divided by sqrt(2); downsampling is an average
pool and upsampling nearest.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diff3d_tpu_torch.ops import dispatch
from diff3d_tpu_torch.ops import cuda_film  # noqa: F401 - registers 'groupnorm'
from diff3d_tpu_torch.ops.attention import multi_head_attention

_SQRT2 = math.sqrt(2.0)


def nearest_neighbor_upsample(h: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample of ``[N, H, W, C]``."""
    N, H, W, C = h.shape
    return h[:, :, None, :, None, :].expand(N, H, 2, W, 2, C).reshape(
        N, 2 * H, 2 * W, C)


def avgpool_downsample(h: torch.Tensor, k: int = 2) -> torch.Tensor:
    """kxk average-pool downsample of ``[N, H, W, C]``."""
    N, H, W, C = h.shape
    return h.reshape(N, H // k, k, W // k, k, C).mean(dim=(2, 4))


def _num_groups(C: int, preferred: int = 32) -> int:
    """Largest group count <= preferred that divides C."""
    g = min(preferred, C)
    while C % g:
        g -= 1
    return g


class Dense(nn.Module):
    """``flax.linen.Dense`` with ``dtype=``: float32 ``weight [out, in]``
    and ``bias``, computed in ``compute_dtype``."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """``flax.linen.Conv`` on NHWC: float32 ``weight [out, in, kh, kw]``,
    ``padding`` defaults to SAME at stride 1 (``k // 2``); the level convs
    pass explicit ``padding=1`` at stride 2^i (not SAME)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 stride: int = 1, padding: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 zero_init: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.compute_dtype = compute_dtype
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w, self.bias.to(dt),
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def set_kernels(model: nn.Module, impl: str) -> None:
    """Route every GroupNorm and attention site of ``model`` to ``impl``:
    ``"cuda"`` (the default: the kernels on CUDA tensors, their plain
    versions on CPU tensors) or ``"torch"`` (the plain versions
    everywhere — the reference a card check holds the kernels against,
    as ``kernels="xla"`` is in the JAX package)."""
    if impl not in dispatch.IMPLS:
        raise ValueError(f"impl {impl!r} not in {dispatch.IMPLS}")
    for m in model.modules():
        if isinstance(m, (FrameGroupNorm, AttnLayer)):
            m.kernels = impl


class FrameGroupNorm(nn.Module):
    """GroupNorm per frame with optional fused FiLM/SiLU epilogues,
    dispatched to the CUDA kernel or its plain version
    (:mod:`diff3d_tpu_torch.ops.cuda_film`; see :func:`set_kernels`).
    ``weight`` / ``bias`` are the Flax ``GroupNorm_0`` ``scale`` /
    ``bias``."""

    def __init__(self, features: int, silu: bool = False,
                 num_groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.num_groups = _num_groups(features, num_groups)
        self.kernels = "cuda"
        self.silu = silu

    def forward(self, h: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``h [N, H, W, C]``; ``scale`` / ``shift`` (both or neither) are
        ``[N, H*W, C]``, views allowed."""
        N, H, W, C = h.shape
        kw = {} if scale is None else {"scale": scale, "shift": shift}
        out = dispatch.dispatch("groupnorm", self.kernels,
                                h.reshape(N, H * W, C), self.weight,
                                self.bias, num_groups=self.num_groups,
                                silu=self.silu, **kw)
        return out.reshape(N, H, W, C)


class FiLM(nn.Module):
    """Feature-wise linear modulation (reference ``xunet.py:74-87``):
    ``Dense(emb_ch -> 2*features)`` on SiLU(emb), split into
    ``(scale, shift)``.  The port always hands them to the GroupNorm
    epilogue, as the JAX package's fused path does; they are returned as
    the two halves of the Dense output (strided views, row stride
    ``2*features``)."""

    def __init__(self, emb_ch: int, features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.Dense_0 = Dense(emb_ch, 2 * features, compute_dtype)

    def forward(self, emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``emb [N, h, w, emb_ch]`` -> ``(scale, shift)`` each
        ``[N, h*w, features]``."""
        N, H, W, E = emb.shape
        e = self.Dense_0(F.silu(emb)).reshape(N, H * W, 2 * self.features)
        return e[..., :self.features], e[..., self.features:]


def dropout(h: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout``: identity when not training or at rate 0,
    zeros at rate 1, else ``h / (1 - rate)`` where a uniform draw from
    ``generator`` is below ``1 - rate`` and 0 elsewhere.  The draw needs
    an explicit generator (on ``h``'s device)."""
    if not training or rate == 0.0:
        return h
    if rate == 1.0:
        return torch.zeros_like(h)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(h.shape, generator=generator, device=h.device) \
        < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class ResnetBlock(nn.Module):
    """BigGAN-style residual block over frames (reference
    ``xunet.py:90-152``): GN -> SiLU -> conv3x3 -> GN -> FiLM -> dropout
    -> conv3x3(zero-init) -> (+ 1x1-projected skip) -> /sqrt(2) ->
    optional up/down resample.  Dropout is active in ``train()`` mode
    only, drawing from the generator passed to :meth:`forward`."""

    def __init__(self, in_ch: int, features: int, emb_ch: int, *,
                 resample: Optional[str] = None, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.resample = resample
        self.dropout_rate = dropout
        self.FrameGroupNorm_0 = FrameGroupNorm(in_ch, silu=True)
        self.conv1 = Conv(in_ch, features, 3, compute_dtype=dt)
        self.FiLM_0 = FiLM(emb_ch, features, dt)
        self.FrameGroupNorm_1 = FrameGroupNorm(features)
        self.conv2 = Conv(features, features, 3, compute_dtype=dt,
                          zero_init=True)
        self.skip_proj = (Conv(in_ch, features, 1, compute_dtype=dt)
                          if in_ch != features else None)

    def forward(self, h_in: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = self.conv1(self.FrameGroupNorm_0(h_in))
        scale, shift = self.FiLM_0(emb)
        h = dropout(self.FrameGroupNorm_1(h, scale, shift),
                    self.dropout_rate, self.training, generator)
        h = self.conv2(h)
        if self.skip_proj is not None:
            h_in = self.skip_proj(h_in)
        out = (h + h_in) / _SQRT2
        if self.resample == "up":
            out = nearest_neighbor_upsample(out)
        elif self.resample == "down":
            out = avgpool_downsample(out)
        return out


class AttnLayer(nn.Module):
    """q/k/v/out projections with bias around the dispatched sdpa core
    (reference ``xunet.py:154-177``)."""

    def __init__(self, features: int, num_heads: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.kernels = "cuda"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(features, features, compute_dtype))

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        out = multi_head_attention(self.q_proj(q), self.k_proj(kv),
                                   self.v_proj(kv), self.num_heads,
                                   impl=self.kernels)
        return self.out_proj(out)


class AttnBlock(nn.Module):
    """Frame self/cross attention over ``H*W`` tokens (reference
    ``xunet.py:179-220``): GN, one shared ``AttnLayer`` for all frames,
    zero-init 1x1 output conv, residual /sqrt(2)."""

    def __init__(self, attn_type: str, features: int, num_heads: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_type not in ("self", "cross"):
            raise NotImplementedError(attn_type)
        self.attn_type = attn_type
        self.FrameGroupNorm_0 = FrameGroupNorm(features)
        self.attn = AttnLayer(features, num_heads, compute_dtype)
        self.out_conv = Conv(features, features, 1,
                             compute_dtype=compute_dtype, zero_init=True)

    def forward(self, h_in: torch.Tensor, frames: int) -> torch.Tensor:
        N, H, W, C = h_in.shape
        q = self.FrameGroupNorm_0(h_in).reshape(N, H * W, C)
        if self.attn_type == "self":
            kv = q
        else:
            # Each frame attends to the next one, cyclically.
            kv = q.reshape(N // frames, frames, H * W, C).roll(
                -1, dims=1).reshape(N, H * W, C)
        h = self.out_conv(self.attn(q, kv).reshape(N, H, W, C))
        return (h + h_in) / _SQRT2


class XUNetBlock(nn.Module):
    """ResnetBlock, then optional self- and cross-attention (reference
    ``xunet.py:222-256``)."""

    def __init__(self, in_ch: int, features: int, emb_ch: int, *,
                 use_attn: bool = False, num_heads: int = 4,
                 dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnetblock = ResnetBlock(in_ch, features, emb_ch,
                                       dropout=dropout,
                                       compute_dtype=compute_dtype)
        self.use_attn = use_attn
        if use_attn:
            self.attnblock_self = AttnBlock("self", features, num_heads,
                                            compute_dtype)
            self.attnblock_cross = AttnBlock("cross", features, num_heads,
                                             compute_dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, frames: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.resnetblock(x, emb, generator)
        if self.use_attn:
            h = self.attnblock_cross(self.attnblock_self(h, frames), frames)
        return h
