"""Sequence parallelism: ring attention and all-to-all (Ulysses)
(counterpart: ``diff3d_tpu/parallel/ring_attention.py``).

Both are sdpa cores over local token shards ``[B, L/n, H, D]`` of a
global ``[B, L, H, D]`` sequence split over the ``n`` ranks of a process
group, rank ``r`` holding tokens ``[r L/n, (r+1) L/n)``.

* :func:`ring_sdpa` -- K and V rotate around the ring (rank ``r`` sends
  to ``r + 1``) for ``n - 1`` steps; each step's block ``(o, lse)`` comes
  from :func:`~diff3d_tpu_torch.ops.cuda_attention.flash_attention_lse`
  (row 4's kernel on the card, its plain version on the CPU) and is folded
  into the running result by the exact log-sum-exp combine.  The rotation
  is an autograd function whose backward rotates the gradients the other
  way, so autograd runs the backward kernels (rows 5 and 6) on every
  block with the lse cotangent the combine gives it.
* :func:`ulysses_sdpa` -- an all-to-all reshards tokens to heads (each
  rank holds every token of ``H/n`` heads), the port's sdpa runs, and a
  second all-to-all reshards back.  Needs ``H % n == 0``.

``impl="cuda"`` (the default) is the flash wrapper: on a CUDA tensor whose
shapes its kernel does not take it raises, as
:func:`diff3d_tpu_torch.ops.dispatch.resolve` does -- there is no fallback.
``impl="einsum"`` is the plain block engine (explicit f32 matmuls), for
the tests and for the card check's plain timing.  On a gloo group, which takes no CUDA tensor for point-to-point
or all-to-all transfers, the transfers of CUDA tensors are staged through
pinned host memory; the attention itself stays on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from diff3d_tpu_torch.ops.cuda_attention import flash_attention_lse, supports

IMPLS = ("cuda", "einsum")


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` must go through host memory on ``group`` (a CUDA
    tensor on a gloo group)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _sendrecv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on and receive the tensor of
    the rank ``shift`` places back (group ranks, cyclically)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    staged = _staged(group, x)
    send = _host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device, non_blocking=True) if staged else recv


class _Rotate(torch.autograd.Function):
    """``x`` of the previous rank on the ring; the backward sends the
    gradient back to it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sendrecv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, ctx.group, -1), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 of ``x`` (split equally)."""
    staged = _staged(group, x)
    src = _host(x) if staged else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device, non_blocking=True) if staged else out


class _AllToAll(torch.autograd.Function):
    """Differentiable :func:`_all_to_all` (it is its own inverse on the
    chunk layout used here)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def block_olse_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float):
    """One KV block's attention, the plain engine: ``(o [B, Lq, H, D]
    f32, lse [B, Lq, H] f32)`` (``ring_attention.py:38-49``)."""
    s = torch.einsum("blhd,bmhd->blhm", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("blhm,bmhd->blhd", p.to(v.dtype).float(),
                     v.float()) / l[..., None]
    return o, m[..., 0] + torch.log(l)


def block_olse_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float):
    """One KV block through :func:`flash_attention_lse` (row 4)."""
    o, lse = flash_attention_lse(q, k, v, scale=scale)
    return o.float(), lse


def _pick_engine(q, k, v, impl: str):
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl == "einsum":
        return block_olse_einsum
    if q.is_cuda and not supports(q, k, v):
        raise ValueError(f"ring_sdpa: the flash kernel does not take "
                         f"q {tuple(q.shape)} {q.dtype}")
    return block_olse_flash


def ring_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
              scale: Optional[float] = None,
              impl: str = "cuda") -> torch.Tensor:
    """Ring attention over a token axis split across ``group``.

    ``q, k, v``: this rank's shards ``[B, L/n, H, D]``; every query
    attends to every global key.  ``impl``: the block engine, ``'cuda'``
    (the flash wrapper: its kernel on the card, where shapes it does not
    take raise, its plain version on the CPU) or ``'einsum'`` (the plain
    engine).
    Returns this rank's output shard ``[B, L/n, H, D]`` in ``q.dtype``."""
    n = dist.get_world_size(group)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    block = _pick_engine(q, k, v, impl)
    o, lse = block(q, k, v, scale)
    for _ in range(n - 1):
        k = _Rotate.apply(k, group)
        v = _Rotate.apply(v, group)
        bo, blse = block(q, k, v, scale)
        lse_new = torch.logaddexp(lse, blse)
        o = (o * torch.exp(lse - lse_new)[..., None]
             + bo * torch.exp(blse - lse_new)[..., None])
        lse = lse_new
    return o.to(q.dtype)


def _scatter_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[B, L/n, H, D]`` -> ``[B, L, H/n, D]``: rank ``j`` gets head group
    ``j`` of every rank's tokens, in rank order."""
    B, Ll, H, D = x.shape
    chunks = x.reshape(B, Ll, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(chunks.contiguous(), group)   # [n, B, Ll, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Ll, H // n, D)


def _gather_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[B, L, H/n, D]`` -> ``[B, L/n, H, D]``, the inverse."""
    B, L, Hn, D = x.shape
    chunks = x.reshape(B, n, L // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(chunks.contiguous(), group)   # [n, B, Ll, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, L // n, n * Hn, D)


def ulysses_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                 scale: Optional[float] = None,
                 impl: str = "cuda") -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: reshard
    ``[B, L/n, H, D]`` -> ``[B, L, H/n, D]``, run the port's sdpa
    (``impl``: ``'cuda'`` the flash wrapper, ``'torch'`` the plain
    version) on the local heads, reshard back.  Requires ``H % n == 0``."""
    from diff3d_tpu_torch.ops.attention import sdpa

    n = dist.get_world_size(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"heads {H} not divisible by axis size {n}")
    if scale is not None and scale != 1.0 / math.sqrt(q.shape[-1]):
        raise ValueError("ulysses_sdpa: the sdpa core takes the default "
                         "scale 1/sqrt(D) only")
    qg, kg, vg = (_scatter_heads(t, group, n) for t in (q, k, v))
    return _gather_heads(sdpa(qg, kg, vg, impl=impl), group, n)
