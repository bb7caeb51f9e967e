"""Context parallelism's collectives over the mesh's model axis: the image
rows of every activation split over the axis's ranks (counterpart: the
halo exchanges, GroupNorm reductions and K/V gathers GSPMD inserts around
``diff3d_tpu/parallel/mesh.py::MeshEnv.activation_constraint``'s
``P(data, None, model)``).

Between two layers every ``[N, h, w, C]`` activation is **its rows**:
model rank ``r`` of ``mp`` holds rows ``[r h/mp, (r+1) h/mp)`` at every
level of the X-UNet, and the gradient it holds is the gradient of exactly
those rows.  The parameters are whole on every rank; each rank's
gradient of a parameter covers its rows only, so the train step sums the
gradients over the model axis (``train/step.py``).

The autograd functions below keep that convention:

  =============== ================================ ==========================
  function        forward                          backward
  =============== ================================ ==========================
  ``halo``        ``k`` rows of each neighbour     each neighbour's halo
                  above and below (zeros at the    gradient sent back and
                  image's edges)                   **added** to the edge rows
  ``gather_kv``   all-gather of the tokens, in     reduce-scatter with a
                  model-rank order                 **sum** (every rank's
                                                   queries read every key)
  ``gather_rows`` all-gather of the rows           this rank's rows, **no
                                                   sum** (every rank takes
                                                   the same loss of the
                                                   whole output)
  =============== ================================ ==========================

:meth:`RowAxis.sum` is the plain sum of per-rank statistics (no
autograd): float64 stays float64 (the GroupNorm forward's ``Σx``, ``Σx²``),
anything else sums in float32.  The transport is
:class:`~diff3d_tpu_torch.parallel.tensor.ModelAxis`'s (its ``_parts``:
NCCL's all-gather, or gloo's broadcasts of CUDA tensors staged through
pinned host memory), and its :attr:`~ModelAxis.stats` count these
collectives too.
"""

from __future__ import annotations

import time
from typing import Tuple

import torch
import torch.nn.functional as F

from diff3d_tpu_torch.parallel.tensor import ModelAxis


class RowAxis:
    """This rank's place on the model axis, read as a split of the image
    rows (``axis``: the axis's :class:`ModelAxis`, whose transport and
    counters it uses)."""

    def __init__(self, axis: ModelAxis):
        self.axis = axis
        self.rank, self.size = axis.rank, axis.size

    def __repr__(self) -> str:
        return f"RowAxis(rank={self.rank}, size={self.size})"

    @property
    def stats(self) -> dict:
        return self.axis.stats

    def reset_stats(self) -> None:
        self.axis.reset_stats()

    def rows(self, H: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's rows of an ``H``-row image."""
        h = H // self.size
        return self.rank * h, (self.rank + 1) * h

    def parts(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in model-rank order
        (one counted collective)."""
        t0 = time.perf_counter()
        out = self.axis._parts(x)
        self.axis._count(t0, x)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (a new tensor, the same bits on
        every rank): float64 in float64, anything else in float32."""
        p = self.parts(x)
        return p.sum(0) if x.dtype == torch.float64 else p.float().sum(0)

    def halo(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        """``x [N, h, w, C]`` (this rank's rows) with ``k`` rows of the
        rank above prepended and ``k`` of the rank below appended (zeros
        at the top and bottom of the image)."""
        return _Halo.apply(x, self, k)

    def gather_kv(self, t: torch.Tensor) -> torch.Tensor:
        """``[N, l, C]`` tokens of this rank's rows -> ``[N, size l, C]``,
        the frame's tokens in row-major order (attention's key / value
        input: every rank's queries read every key)."""
        return _GatherKV.apply(t, self)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, h, ...]`` rows -> ``[N, size h, ...]`` (for a loss every
        rank takes of the whole tensor)."""
        return _GatherRows.apply(x, self)


def place_rows(model: torch.nn.Module, rows) -> torch.nn.Module:
    """Set the row split of every layer of ``model`` that takes one (its
    ``cp`` attribute) to ``rows`` (a :class:`RowAxis`, or None: whole
    rows), in place."""
    for m in model.modules():
        if hasattr(m, "cp"):
            m.cp = rows
    return model


def with_halo(x: torch.Tensor, start: int, stop: int, above: int = 1,
              below: int = 1) -> torch.Tensor:
    """Rows ``[start - above, stop + below)`` of a whole ``[N, H, ...]``
    tensor ``x`` that every rank holds (a model input), zero rows where
    they fall outside ``[0, H)``: a local slice, no collective."""
    H = x.shape[1]
    a, b = max(start - above, 0), min(stop + below, H)
    rows = x[:, a:b]
    top, bottom = a - (start - above), (stop + below) - b
    if top or bottom:
        pad = [0, 0] * (x.dim() - 2) + [top, bottom]
        rows = F.pad(rows, pad)
    return rows


def check_rows(model_cfg, mp: int) -> None:
    """Raise unless every level of ``model_cfg``'s X-UNet splits its rows
    over ``mp`` ranks: each level's height ``H / 2^i`` divides by ``mp``,
    and each rank's rows are even at every level that downsamples (the
    2x2 average pool and the next level's rows stay local)."""
    levels = model_cfg.num_resolutions
    for i in range(levels):
        h = model_cfg.H // 2 ** i
        if h % mp:
            raise ValueError(
                f"context parallelism: level {i} has {h} rows "
                f"(H={model_cfg.H}, W={model_cfg.W}), which do not split "
                f"over {mp} ranks")
        if i != levels - 1 and (h // mp) % 2:
            raise ValueError(
                f"context parallelism: level {i} has {h} rows "
                f"(H={model_cfg.H}, W={model_cfg.W}): {h // mp} a rank "
                f"over {mp} ranks, odd at a level that downsamples")


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, k):
        ctx.rows, ctx.k = rows, k
        if x.shape[1] < k:
            raise ValueError(f"halo of {k} rows from {x.shape[1]}")
        edges = torch.stack([x[:, :k], x[:, -k:]])   # [2, N, k, w, C]
        p = rows.parts(edges)
        r, n = rows.rank, rows.size
        zeros = torch.zeros_like(edges[0])
        above = p[r - 1, 1] if r > 0 else zeros       # the bottom rows
        below = p[r + 1, 0] if r < n - 1 else zeros   # the top rows
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, k = ctx.rows, ctx.k
        r, n = rows.rank, rows.size
        # [gradient of the rows taken from above, of those from below]
        sent = torch.stack([g[:, :k], g[:, -k:]]).contiguous()
        p = rows.parts(sent)
        dx = g[:, k:-k].clone()
        if r > 0:                 # the rank above read our top rows
            dx[:, :k] += p[r - 1, 1]
        if r < n - 1:             # the rank below read our bottom rows
            dx[:, -k:] += p[r + 1, 0]
        return dx, None, None


class _GatherKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rows):
        ctx.rows, ctx.n = rows, t.shape[1]
        return torch.cat(rows.parts(t).unbind(0), dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, n = ctx.rows, ctx.n
        r = rows.rank
        # Every rank's gradient of every key, then this rank's keys summed
        # over the ranks in float32.
        mine = rows.parts(g.contiguous())[:, :, r * n:(r + 1) * n]
        return mine.float().sum(0).to(g.dtype), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows, ctx.n = rows, x.shape[1]
        return torch.cat(rows.parts(x).unbind(0), dim=1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.rows.rank, ctx.n
        return g[:, r * n:(r + 1) * n].contiguous(), None
