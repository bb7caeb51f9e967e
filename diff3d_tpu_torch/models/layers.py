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

Tensor parallelism (``MeshEnv.place_model_axis``): each layer that holds a
``tp`` attribute (a :class:`~diff3d_tpu_torch.parallel.tensor.ModelAxis`,
None unplaced) runs on its blocks of the split parameters.  A
:class:`Dense` / :class:`Conv` is column-parallel (``tp_mode="column"``:
a whole input, this rank's block of the output channels), row-parallel
(``"row"``, ``out_proj``: this rank's block of the input, the partial
sums reduced in float32, then the bias) or replicated (None).  The blocks
own the data flow between layers (:mod:`diff3d_tpu_torch.parallel.tensor`
names the two layouts): a GroupNorm runs on this rank's channel block
(``C/mp`` channels, ``G/mp`` groups) where the groups split over the
ranks, else on the whole activation; attention runs on ``heads/mp`` heads
where the heads split, else on the gathered whole heads; dropout's mask is
drawn whole and sliced to the block.

Context parallelism (``MeshEnv.place_context_axis``): each layer that
holds a ``cp`` attribute (a :class:`~diff3d_tpu_torch.parallel.context.
RowAxis`, None unplaced) runs on this rank's image rows.  A 3x3
:class:`Conv` at stride 1 takes one halo row from each neighbour and pads
only the width; a 1x1 one is local; a :class:`FrameGroupNorm` takes the
statistics of the whole sample (split statistics: sums over the model
axis); :class:`AttnLayer` projects this rank's queries and attends them
to every rank's keys and values (their input gathered in model-rank
order, its backward summed over the ranks); dropout's
mask is drawn whole and sliced to the rows; FiLM, the residuals and the
resampling are local (each rank's rows are even at a level that
downsamples).

Both at once (context parallelism with the ``tp`` / ``fsdp+tp``
placement): the split leaves stay this rank's blocks, but no layer takes
a channel-block path (``tp`` None everywhere).  A :class:`Dense` /
:class:`Conv` whose leaves are split holds ``leaves`` (a
:class:`~diff3d_tpu_torch.parallel.tensor.LeafGather`) and takes each
split leaf whole through it in its forward, whose backward sums the
leaf's gradient over the model axis and keeps the block; every layer then
computes whole channels on this rank's rows, as under context
parallelism alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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
        self.tp = None
        self.tp_mode: Optional[str] = None
        self.leaves = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp_mode == "row":
            # Each rank's partial product in float32 (bf16 products are
            # exact there), summed over the model axis, then the bias
            # once, then one rounding: the unsharded layer's arithmetic.
            part = F.linear(x.to(dt).float(), self.weight.to(dt).float())
            return (self.tp.reduce(part) + self.bias.to(dt).float()).to(dt)
        return F.linear(x.to(dt), _leaf(self, "weight").to(dt),
                        _bias_block(self).to(dt))


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
        self.tp = None
        self.tp_mode: Optional[str] = None
        self.leaves = None
        self.cp = None

    def forward(self, x: torch.Tensor,
                rows_padded: bool = False) -> torch.Tensor:
        """``rows_padded``: ``x`` already holds the rows the padding would
        add (a halo, or zero rows at the image's edge), so only the width
        is padded.  Split by rows (``cp``), a stride-1 conv wider than 1x1
        takes its halo from the neighbours."""
        dt = self.compute_dtype
        pad = self.padding
        if self.cp is not None and not rows_padded and pad > 0:
            if self.stride != 1:
                raise ValueError("a strided conv split by rows takes its "
                                 "input rows padded (rows_padded=True)")
            x, rows_padded = self.cp.halo(x, pad), True
        w = _leaf(self, "weight").to(dt, memory_format=torch.channels_last)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), w,
                     _bias_block(self).to(dt), stride=self.stride,
                     padding=(0, pad) if rows_padded else pad)
        return y.permute(0, 2, 3, 1)


def _leaf(layer, name: str) -> torch.Tensor:
    """``layer``'s leaf ``name``, whole where its split leaves are
    gathered (``leaves``: in the compute dtype), else as the layer holds
    it."""
    g = layer.leaves
    return getattr(layer, name) if g is None else g(layer, name)


def _bias_block(layer) -> torch.Tensor:
    """The bias a column-parallel layer adds: its block (the JAX rule
    leaves a bias of at most 4 entries whole where it splits the
    kernel)."""
    b = _leaf(layer, "bias")
    if layer.tp_mode == "column" and b.shape[0] != layer.weight.shape[0]:
        return layer.tp.scatter(b)
    return b


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
        self.tp = None
        self.cp = None

    def forward(self, h: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``h [N, H, W, C]``; ``scale`` / ``shift`` (both or neither) are
        ``[N, H*W, C]``, views allowed.  Placed over a model axis, ``h``,
        ``scale`` and ``shift`` may each be whole or a block; the result is
        this rank's block where the groups split over the ranks (the
        statistics of whole groups), else whole."""
        weight, bias, groups = self.weight, self.bias, self.num_groups
        if self.tp is not None:
            axis, C = self.tp, self.weight.shape[0]
            if C % axis.size == 0 and groups % axis.size == 0:
                move = lambda t: axis.to_block(t, C)  # noqa: E731
                weight, bias = axis.scatter(weight), axis.scatter(bias)
                groups //= axis.size
            else:
                move = lambda t: axis.whole(t, C)  # noqa: E731
            h = move(h)
            if scale is not None:
                scale, shift = move(scale), move(shift)
        N, H, W, C = h.shape
        kw = {} if scale is None else {"scale": scale, "shift": shift}
        if self.cp is not None:          # this rank's rows, whole groups
            kw["rows"] = self.cp
        out = dispatch.dispatch("groupnorm", self.kernels,
                                h.reshape(N, H * W, C), weight, bias,
                                num_groups=groups, silu=self.silu, **kw)
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
        self.tp = None
        #: Placed over a model axis: whether this rank's block of the Dense
        #: output is ``[scale block | shift block]`` (``MeshEnv._halved``).
        self.halves = False

    def forward(self, emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``emb [N, h, w, emb_ch]`` -> ``(scale, shift)`` each
        ``[N, h*w, features]``.  Placed over a model axis, ``emb`` may be a
        block, whole, or a ``parallel.tensor.ColumnInput``; the halves are
        this rank's channel blocks (``halves``) or whole."""
        Fe = self.features
        if self.tp is not None:
            axis = self.tp
            E = self.Dense_0.weight.shape[1]
            emb = axis.input_for(emb, E, [self.Dense_0])
        N, H, W, _ = emb.shape
        e = self.Dense_0(F.silu(emb))
        e = e.reshape(N, H * W, e.shape[-1])
        if self.tp is not None:
            if self.halves:
                Fe //= axis.size
            else:
                e = axis.whole(e, 2 * Fe)
        return e[..., :Fe], e[..., Fe:]


class RowShard(NamedTuple):
    """A data-parallel rank's dropout source, passed where the model takes
    its ``generator``: each mask is drawn from ``generator`` at the global
    batch's size (``world`` ranks' rows, rank-major) and rank ``rank``
    keeps its rows, so that ``world`` ranks draw what one process training
    the global batch draws (the property of ``jax.random`` under
    sharding)."""

    generator: torch.Generator
    rank: int
    world: int


def dropout_keep(shape, rate: float,
                 generator: Optional[torch.Generator | RowShard],
                 device: torch.device, rows=None) -> torch.Tensor:
    """The keep mask of :func:`dropout`: a uniform draw from ``generator``
    (a ``torch.Generator``, or a :class:`RowShard`: this rank's rows of the
    global batch's draw) below ``1 - rate``.  ``rows`` (a ``RowAxis``):
    ``shape`` is this rank's image rows (dim 1) of the activation; the
    draw is the whole activation's, then this rank's rows of it."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    shape = tuple(shape)
    h = shape[1]
    if rows is not None:
        shape = shape[:1] + (h * rows.size,) + shape[2:]
    if isinstance(generator, RowShard):
        gen, rank, world = generator
        n = shape[0]
        u = torch.rand((n * world,) + shape[1:], generator=gen,
                       device=device)[rank * n:(rank + 1) * n]
    else:
        u = torch.rand(shape, generator=generator, device=device)
    if rows is not None:
        u = u[:, rows.rank * h:(rows.rank + 1) * h]
    return u < 1.0 - rate


def dropout(h: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            keep: Optional[torch.Tensor] = None, axis=None,
            channels: Optional[int] = None, rows=None) -> torch.Tensor:
    """``flax.linen.Dropout``: identity when not training or at rate 0,
    zeros at rate 1, else ``h / (1 - rate)`` where ``keep``
    (:func:`dropout_keep`, drawn here from ``generator`` unless given) is
    true and 0 elsewhere.  The draw needs an explicit generator (on
    ``h``'s device).  Over a model ``axis``, ``h`` is this rank's block of
    a ``channels``-wide activation or whole: the mask is the whole
    activation's (the draw one process makes), then this rank's
    channels of it; split by ``rows`` (a ``RowAxis``), this rank's image
    rows of it."""
    if not training or rate == 0.0:
        return h
    if rate == 1.0:
        return torch.zeros_like(h)
    if keep is None:
        shape = h.shape if axis is None else h.shape[:-1] + (channels,)
        keep = dropout_keep(shape, rate, generator, h.device, rows)
    if axis is not None and axis.is_block(h, channels):
        keep = axis.block(keep)
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


def _input_for(axis, x: torch.Tensor, channels: int, layers):
    """``x`` prepared for ``layers`` over the model ``axis``
    (:meth:`~diff3d_tpu_torch.parallel.tensor.ModelAxis.input_for`);
    ``x`` itself unplaced."""
    return x if axis is None else axis.input_for(x, channels, layers)


def _align(axis, a: torch.Tensor, b: torch.Tensor, channels: int):
    """``(a, b)`` in one layout over the model ``axis``
    (:meth:`~diff3d_tpu_torch.parallel.tensor.ModelAxis.align`); as they
    are unplaced."""
    return (a, b) if axis is None else axis.align(a, b, channels)


class ResnetBlock(nn.Module):
    """BigGAN-style residual block over frames (reference
    ``xunet.py:90-152``): GN -> SiLU -> conv3x3 -> GN -> FiLM -> dropout
    -> conv3x3(zero-init) -> (+ 1x1-projected skip) -> /sqrt(2) ->
    optional up/down resample.  Dropout is active in ``train()`` mode
    only, drawing from the generator passed to :meth:`forward` (or taking
    its keep mask, ``[N, H, W, features]``, as ``keep``)."""

    def __init__(self, in_ch: int, features: int, emb_ch: int, *,
                 resample: Optional[str] = None, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.resample = resample
        self.features = features
        self.dropout_rate = dropout
        self.FrameGroupNorm_0 = FrameGroupNorm(in_ch, silu=True)
        self.conv1 = Conv(in_ch, features, 3, compute_dtype=dt)
        self.FiLM_0 = FiLM(emb_ch, features, dt)
        self.FrameGroupNorm_1 = FrameGroupNorm(features)
        self.conv2 = Conv(features, features, 3, compute_dtype=dt,
                          zero_init=True)
        self.skip_proj = (Conv(in_ch, features, 1, compute_dtype=dt)
                          if in_ch != features else None)
        self.tp = None
        self.cp = None

    def forward(self, h_in: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Over the model axis, ``h_in`` is a block or whole and the
        result a block where ``features`` splits over the ranks."""
        axis, Fe = self.tp, self.features
        C = self.FrameGroupNorm_0.weight.shape[0]
        h = self.conv1(_input_for(axis, self.FrameGroupNorm_0(h_in), C,
                                  [self.conv1]))
        scale, shift = self.FiLM_0(emb)
        h = dropout(self.FrameGroupNorm_1(h, scale, shift),
                    self.dropout_rate, self.training, generator, keep,
                    axis, Fe, self.cp)
        h = self.conv2(_input_for(axis, h, Fe, [self.conv2]))
        if self.skip_proj is not None:
            h_in = self.skip_proj(_input_for(axis, h_in, C,
                                             [self.skip_proj]))
        h, h_in = _align(axis, h, h_in, Fe)
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
        self.tp = None
        self.cp = None
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(features, features, compute_dtype))

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Placed over a model axis, ``q`` and ``kv`` are whole and
        prepared for the projections (``AttnBlock`` does it); the result
        is whole.  Split by rows (``cp``), ``q`` and ``kv`` are this rank's
        tokens: the keys' and values' input is gathered from every rank
        (the frame's tokens in order; one gather for both, and each key
        projected whole, as one process projects it), and the result is
        this rank's queries'."""
        if self.cp is not None:
            kv = self.cp.gather_kv(kv)
        q, k, v = self.q_proj(q), self.k_proj(kv), self.v_proj(kv)
        heads = self.num_heads
        if self.tp is not None:
            axis, C = self.tp, self.out_proj.weight.shape[0]
            if axis.is_block(q, C) and heads % axis.size == 0:
                heads //= axis.size        # whole heads: heads are outer
            else:
                q, k, v = (axis.whole(t, C) for t in (q, k, v))
        out = multi_head_attention(q, k, v, heads, impl=self.kernels)
        if self.tp is not None:
            out = (axis.to_block(out, C) if self.out_proj.tp_mode == "row"
                   else axis.whole(out, C))
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
        self.tp = None

    def forward(self, h_in: torch.Tensor, frames: int) -> torch.Tensor:
        C = self.FrameGroupNorm_0.weight.shape[0]
        N, H, W, _ = h_in.shape
        a = self.FrameGroupNorm_0(h_in)
        axis, attn = self.tp, self.attn
        q = _input_for(axis, a.reshape(N, H * W, a.shape[-1]), C,
                       [attn.q_proj, attn.k_proj, attn.v_proj])
        if self.attn_type == "self":
            kv = q
        else:
            # Each frame attends to the next one, cyclically.
            kv = q.reshape(N // frames, frames, H * W, C).roll(
                -1, dims=1).reshape(N, H * W, C)
        o = self.attn(q, kv).reshape(N, H, W, C)
        h = self.out_conv(_input_for(axis, o, C, [self.out_conv]))
        h, h_in = _align(axis, h, h_in, C)
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
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.resnetblock(x, emb, generator, keep)
        if self.use_attn:
            h = self.attnblock_cross(self.attnblock_self(h, frames), frames)
        return h
