"""Tensor parallelism's collectives over the mesh's model axis
(the ``tp`` / ``fsdp+tp`` policies; counterpart: the gathers and reductions
GSPMD inserts around ``diff3d_tpu/parallel/mesh.py::tp_param_sharding``'s
seed shardings).

Every activation between two layers is in one of two layouts:

  * **block** -- channel-sharded: model rank ``r`` of ``mp`` holds channels
    ``[r C/mp, (r+1) C/mp)`` of the last dim.  Its gradient is exact: the
    gradient of exactly those channels.
  * **whole** -- every rank holds all ``C`` channels, the same values.
    Its gradient is whole too: every rank holds the full gradient.

The autograd functions below move between them and keep both
conventions:

  ============== ======================== ===============================
  function       forward                  backward
  ============== ======================== ===============================
  ``gather``     all-gather (block→whole) take this rank's block
  ``scatter``    take this rank's block   all-gather
  ``copy``       identity (whole)         all-reduce (sum)
  ``reduce``     all-reduce (sum, f32)    identity
  ``gather_in``  all-gather               all-reduce (sum), then the block
  ============== ======================== ===============================

A parameter's block goes through :meth:`ModelAxis.gather_leaf` (context
parallelism with a split placement: each layer computes whole channels on
this rank's image rows): its forward casts the block to the layer's
compute dtype and all-gathers the blocks along the leaf's split dim into
the whole leaf, in the JAX package's order (the same bits as a cast of
the gathered float32 leaf, in half the bytes under bf16); its backward
sums the whole leaf's gradients over the ranks in float32 and keeps this
rank's block, in the parameter's dtype.  Each rank's gradient of the whole leaf covers
its own rows only, so that sum is exactly the block's gradient, and the
train step must not sum it over the model axis again.

A column-parallel layer (its output channels sharded) computes a block
from a whole input, so the input's gradient it gives back is this rank's
share of a sum over the ranks: its input goes through ``copy`` (a whole
input) or ``gather_in`` (a block input, gathered for it), whose backward
sums the shares.  A row-parallel layer (``out_proj``: its input channels
sharded) sums its ranks' partial outputs with ``reduce``.  A replicated
leaf that a rank applies only in its block (a GroupNorm scale) is taken
through ``scatter``, whose backward gathers the blocks' gradients into the
whole one; a replicated leaf applied to whole activations gets the whole
gradient on every rank and is never summed.  Sums run in float32 whatever
the activations' dtype, and the result is cast back.

Under NCCL the collectives take the CUDA tensors as they are (an
all-gather into one buffer; a float32 all-reduce).  Under gloo (two ranks
sharing one card: NCCL refuses two ranks on one GPU) a CUDA tensor is
staged through pinned host memory: each rank's block is copied into its
slot of a pinned ``[ranks, ...]`` buffer and every slot broadcast from its
owner (gloo's broadcast moves a block several times faster than its
all-gather), then the buffer goes to the card; a sum gathers the ranks'
partials so and adds them there in float32, in rank order (the same bits
on every rank).  The transport, not the computation, goes through the
host: the kernels run on the card either way.  :attr:`ModelAxis.stats`
counts the collectives, the bytes each rank put in and the host seconds
they took.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class ColumnInput(NamedTuple):
    """A whole activation already passed through ``copy`` / ``gather_in``
    for column-parallel consumers (its backward sums their shares once):
    the X-UNet prepares each level's conditioning embedding once for all
    the FiLM layers that read it."""

    t: torch.Tensor


class ModelAxis:
    """This rank's place on the model axis: ``group`` (None: a model axis
    of one rank), ``rank`` and ``size``."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.gloo = group is not None and dist.get_backend(group) == "gloo"
        #: The global rank of each rank of the axis.
        self.ranks = (list(range(self.size)) if group is None
                      else dist.get_process_group_ranks(group))
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        #: The parameter gathers alone (:meth:`gather_leaf`'s forwards,
        #: counted in :attr:`stats` too).
        self.leaf_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    def __repr__(self) -> str:
        return (f"ModelAxis(rank={self.rank}, size={self.size}, "
                f"gloo={self.gloo})")

    def reset_stats(self) -> None:
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self.leaf_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

    # ---- raw collectives (no autograd) ------------------------------

    def _count(self, t0: float, t: torch.Tensor) -> None:
        self.stats["calls"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        self.stats["seconds"] += time.perf_counter() - t0

    def _parts(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x``, rank-major, on
        ``x``'s device (exact copies)."""
        x = x.contiguous()
        if self.gloo:
            staged = x.is_cuda
            buf = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                              pin_memory=staged)
            buf[self.rank].copy_(x)
            for r, src in enumerate(self.ranks):
                dist.broadcast(buf[r], src=src, group=self.group)
            return buf.to(x.device) if staged else buf
        buf = torch.empty((self.size * x.numel(),), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(buf, x.reshape(-1), group=self.group)
        return buf.view((self.size,) + tuple(x.shape))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., c]`` on every rank -> ``[..., size * c]``, rank-major."""
        t0 = time.perf_counter()
        out = torch.cat(self._parts(x).unbind(0), dim=-1)
        self._count(t0, x)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 sum over the ranks of ``x`` (a new tensor)."""
        t0 = time.perf_counter()
        if self.gloo:
            y = self._parts(x).float().sum(0)
        else:
            y = x.to(torch.float32, copy=True).contiguous()
            dist.all_reduce(y, group=self.group)
        self._count(t0, x)
        return y

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's channel block of a whole ``x`` (a contiguous copy)."""
        c = x.shape[-1] // self.size
        return x[..., self.rank * c:(self.rank + 1) * c].contiguous()

    # ---- autograd functions -----------------------------------------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _Scatter.apply(x, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather_in(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherIn.apply(x, self)

    def gather_leaf(self, p: torch.Tensor, dim: int, halves: bool,
                    dtype: torch.dtype) -> torch.Tensor:
        """The whole leaf of this rank's block ``p`` (split along ``dim``;
        ``halves``: a FiLM ``[scale | shift]`` block, see
        :func:`block_of`) in ``dtype``, in the JAX package's order."""
        return _GatherLeaf.apply(p, self, dim, halves, dtype)

    # ---- layouts ------------------------------------------------------

    def is_block(self, x: torch.Tensor, channels: int) -> bool:
        """Whether ``x`` is a block of a ``channels``-wide activation (else
        it is whole; anything else is refused)."""
        c = x.shape[-1]
        if c == channels:
            return False
        if self.size > 1 and channels % self.size == 0 \
                and c == channels // self.size:
            return True
        raise ValueError(f"activation of {c} channels is neither whole "
                         f"({channels}) nor a block of {self.size} ranks")

    def whole(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """``x`` whole (gathered if it is a block)."""
        return self.gather(x) if self.is_block(x, channels) else x

    def to_block(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """``x`` as this rank's block (sliced if it is whole)."""
        return x if self.is_block(x, channels) else self.scatter(x)

    def column_input(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """``x`` whole, for column-parallel consumers only."""
        if isinstance(x, ColumnInput):
            return x.t
        return (self.gather_in(x) if self.is_block(x, channels)
                else self.copy(x))

    def input_for(self, x, channels: int, layers) -> torch.Tensor:
        """``x`` whole, prepared for ``layers`` (Dense / Conv modules that
        all read it): through :meth:`column_input` when every one of them
        is column-parallel, else gathered (every one replicated)."""
        modes = {getattr(m, "tp_mode", None) for m in layers}
        if modes == {"column"}:
            return self.column_input(x, channels)
        if modes == {None}:
            if isinstance(x, ColumnInput):
                raise ValueError("a ColumnInput reached a replicated layer")
            return self.whole(x, channels)
        raise ValueError(f"layers of modes {modes} read one input")

    def align(self, a: torch.Tensor, b: torch.Tensor, channels: int):
        """``(a, b)`` in one layout: blocks where ``channels`` splits over
        the ranks, else whole."""
        if channels % self.size == 0:
            return self.to_block(a, channels), self.to_block(b, channels)
        return self.whole(a, channels), self.whole(b, channels)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.block(g), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.block(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.block(ctx.axis.all_reduce(g)).to(g.dtype), None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, axis, dim, halves, dtype):
        ctx.axis, ctx.dim, ctx.halves, ctx.dtype = axis, dim, halves, p.dtype
        t0 = time.perf_counter()
        q = p.to(dtype)
        parts = axis._parts(q)
        if dim == 0 and not halves:          # rank-major is the order
            out = parts.reshape((axis.size * q.shape[0],)
                                + tuple(q.shape[1:]))
        else:
            out = join_blocks(parts.unbind(0), dim, halves)
        axis._count(t0, q)
        for k, v in (("calls", 1), ("bytes", q.numel() * q.element_size()),
                     ("seconds", time.perf_counter() - t0)):
            axis.leaf_stats[k] += v
        return out

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return (block_of(a.all_reduce(g), ctx.dim, a.rank, a.size,
                         ctx.halves).to(ctx.dtype), None, None, None, None)


def block_of(whole: torch.Tensor, dim: int, rank: int, size: int,
             halves: bool = False) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``whole`` along ``dim`` (a
    copy); ``halves``: the block of each half (``[scale | shift]``), the
    two joined."""
    if halves:
        F = whole.shape[dim] // 2
        f = F // size
        idx = torch.cat([torch.arange(rank * f, (rank + 1) * f),
                         torch.arange(F + rank * f, F + (rank + 1) * f)])
        return whole.index_select(dim, idx.to(whole.device)).contiguous()
    n = whole.shape[dim] // size
    return whole.narrow(dim, rank * n, n).contiguous().clone()


def join_blocks(parts, dim: int, halves: bool = False) -> torch.Tensor:
    """The whole tensor of every rank's :func:`block_of` ``parts`` (in
    rank order): the inverse of :func:`block_of`."""
    if not halves:
        return torch.cat(list(parts), dim=dim)
    h = [p.chunk(2, dim=dim) for p in parts]
    return torch.cat([x[0] for x in h] + [x[1] for x in h], dim=dim)


class LeafGather(NamedTuple):
    """A layer's split leaves, taken whole through
    :meth:`ModelAxis.gather_leaf` in its forward: ``dims`` maps a leaf
    name (``"weight"`` / ``"bias"``) to ``(split dim, halves)``."""

    axis: ModelAxis
    dims: dict

    def __call__(self, layer: torch.nn.Module, leaf: str) -> torch.Tensor:
        """``layer``'s leaf ``leaf``, whole; a split one cast to the
        layer's compute dtype before its gather."""
        p = getattr(layer, leaf)
        spec = self.dims.get(leaf)
        return (p if spec is None else
                self.axis.gather_leaf(p, *spec, layer.compute_dtype))


def model_axis_of(module: torch.nn.Module) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` a placed model's layers carry (None: not
    placed over a model axis): a layer's ``tp``, or the axis its split
    leaves are gathered over (``leaves``)."""
    for m in module.modules():
        axis = getattr(m, "tp", None)
        if axis is None and getattr(m, "leaves", None) is not None:
            axis = m.leaves.axis
        if axis is not None:
            return axis
    return None
