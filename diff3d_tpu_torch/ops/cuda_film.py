"""Fused GroupNorm -> (FiLM) -> (SiLU) epilogues, forward and backward
(counterpart: ``diff3d_tpu/ops/pallas_film.py``).

:func:`fused_groupnorm` is the wrapper of the hand-written CUDA forward
kernel in ``csrc/film.cu`` (it replaces the Pallas ``_fwd_kernel``,
``pallas_film.py:174-288``, with ``save_stats`` when autograd records);
:func:`groupnorm_backward` wraps the backward kernel beside it (it
replaces ``_bwd_kernel``, ``pallas_film.py:296-433``).  Both run one
thread-block cluster per sample, with the cluster size and whether the
CTAs keep their rows in shared memory chosen per call by
:func:`forward_plan` and :func:`backward_plan`.
:func:`groupnorm_reference` and :func:`groupnorm_backward_reference` are
the plain PyTorch versions.  Both follow the Pallas kernels' semantics,
which differ from the JAX package's ``xla`` path in bf16: every
intermediate stays f32 and each result is rounded once
(``pallas_film.py:212-220, 359-368``).

The wrappers run the plain versions only for a tensor on the CPU; for a
CUDA tensor they launch the kernel or raise.  Each launch adds one to
``fused_groupnorm.launches`` or ``groupnorm_backward.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from diff3d_tpu_torch.ops import build, dispatch

EPS = 1e-5          # torch / Flax-parity GroupNorm epsilon
MAX_C = 4096        # channel cap (srn128's widest up-path concat is 2048)
MAX_GROUPS = MAX_C  # any G dividing C, as the Pallas kernel takes
_SMS = 132          # streaming multiprocessors of an H100 SXM
# The cluster kernels (``film.cu``): threads of a CTA, the largest
# cluster, the most shared memory a CTA takes when two should share an SM
# (2 x (113 KB + 1 KB reserved)) and when one does, and the cluster that
# re-reads its rows where they do not fit.
FWD_THREADS = 256
BWD_THREADS = 256
MAX_CLUSTER = 16
SMEM_TWO_PER_SM = 113 * 1024
SMEM_MAX = 232448
OFFCHIP_CLUSTER = 8
# The forward's plan (measured, PERF.md): about one CTA per SM, and the
# bytes of x above which a CTA of so small a grid is split further.
FWD_MIN_CTAS = 128
FWD_SLAB = 128 * 1024

_c_ll = ctypes.c_longlong
_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_SIGNATURES = {    # ctypes argument types of film.cu's C entry points
    "gn_fused_forward": ((_c_p, _c_ll, _c_ll, _c_p, _c_p, _c_p, _c_ll,
                          _c_ll, _c_p, _c_ll, _c_ll, _c_p, _c_p)
                         + (_c_i,) * 10 + (ctypes.c_float, _c_p)),
    "gn_forward_max_clusters": (_c_i,) * 10 + (ctypes.POINTER(_c_i),),
    "gn_fused_backward": ((_c_p, _c_ll, _c_ll, _c_p, _c_ll, _c_ll, _c_p,
                           _c_p, _c_p, _c_ll, _c_ll, _c_p, _c_ll, _c_ll)
                          + (_c_p,) * 7 + (_c_i,) * 10 + (_c_p,)),
    "gn_split_sums": (_c_p, _c_ll, _c_ll, _c_p) + (_c_i,) * 5 + (_c_p,),
    "gn_split_apply": ((_c_p, _c_ll, _c_ll, _c_p, _c_p, _c_p, _c_ll, _c_ll,
                        _c_p, _c_ll, _c_ll, _c_p, _c_p, _c_p)
                       + (_c_i,) * 8 + (ctypes.c_float, _c_p)),
    "gn_split_backward_sums": ((_c_p, _c_ll, _c_ll, _c_p, _c_ll, _c_ll,
                                _c_p, _c_p, _c_p, _c_ll, _c_ll, _c_p, _c_ll,
                                _c_ll) + (_c_p,) * 5 + (_c_i,) * 7
                               + (_c_p,)),
    "gn_split_backward_apply": ((_c_p, _c_ll, _c_ll, _c_p, _c_ll, _c_ll,
                                 _c_p, _c_p, _c_p, _c_ll, _c_ll, _c_p, _c_ll,
                                 _c_ll) + (_c_p,) * 5 + (_c_i,) * 8
                                + (_c_p,)),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The split-statistics sums kernels give each group one block of this many
# threads, one channel of the group a thread at least.
SPLIT_THREADS = 256


def supports(x: torch.Tensor, *args, num_groups: int = 32,
             rows=None, **kwargs) -> bool:
    """Operands the kernel takes: ``[N, L, C]`` f32/bf16 with unit
    channel stride, C divisible by ``num_groups``, C <= 4096; with
    ``rows`` (split statistics) at most ``SPLIT_THREADS`` channels a
    group."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODE or x.stride(-1) != 1:
        return False
    C = x.shape[-1]
    if rows is not None and (num_groups < 1
                             or C // num_groups > SPLIT_THREADS):
        return False
    return (0 < num_groups <= MAX_GROUPS and C % num_groups == 0
            and 0 < C <= MAX_C)


def groupnorm_stats_reference(x: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    """Per-group f32 statistics ``[2, N, G]`` (mean, rstd) of ``x
    [N, L, C]``: ``E[x^2] - mean^2`` clamped at 0 (``pallas_film.py:
    509-531``), eps 1e-5 -- the forward's residual under ``save_stats``."""
    N, L, C = x.shape
    xf = x.float().reshape(N, L, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3))
    mean2 = (xf * xf).mean(dim=(1, 3))
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + EPS)])


def _per_channel(stat: torch.Tensor, C: int) -> torch.Tensor:
    """``[N, G]`` -> ``[N, 1, C]`` (each group's value on its channels)."""
    N, G = stat.shape
    return stat[:, None, :, None].expand(N, 1, G, C // G).reshape(N, 1, C)


def groupnorm_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, num_groups: int,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        silu: bool = False,
                        stats: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain version: f32 statistics (:func:`groupnorm_stats_reference`,
    or the given ``stats``), then gamma/beta, FiLM ``y * (1 + scale) +
    shift`` and SiLU in f32, rounded once to ``x.dtype``."""
    C = x.shape[-1]
    if stats is None:
        stats = groupnorm_stats_reference(x, num_groups)
    y = (x.float() - _per_channel(stats[0], C)) * _per_channel(stats[1], C)
    y = y * gamma.float() + beta.float()
    if scale is not None:
        y = y * (1.0 + scale.float()) + shift.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _backward_chain(x, g, gamma, beta, scale, shift, stats, silu):
    """The backward's element chain in f32: ``(rstd, xhat, y_gn, dy_f,
    dy_gn, dxhat)`` from the saved ``stats``, SiLU's derivative
    recomputed from y."""
    C = x.shape[-1]
    rstd = _per_channel(stats[1], C)
    xhat = (x.float() - _per_channel(stats[0], C)) * rstd
    y_gn = xhat * gamma.float() + beta.float()
    film = scale is not None
    if film:
        sc1 = 1.0 + scale.float()
        y = y_gn * sc1 + shift.float()
    else:
        y = y_gn
    dy_f = g.float()
    if silu:
        sig = torch.sigmoid(y)
        dy_f = dy_f * (sig * (1.0 + y * (1.0 - sig)))
    dy_gn = dy_f * sc1 if film else dy_f
    return rstd, xhat, y_gn, dy_f, dy_gn, dy_gn * gamma.float()


def groupnorm_backward_reference(
        x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
        beta: torch.Tensor, scale: Optional[torch.Tensor],
        shift: Optional[torch.Tensor], stats: torch.Tensor, *,
        num_groups: int, silu: bool):
    """The plain version of the backward, the explicit formula of the
    Pallas ``_bwd_kernel`` (``pallas_film.py:296-368``): x_hat from the
    saved ``stats``, SiLU's derivative recomputed from y,
    ``dx = rstd (dxhat - mean_g(dxhat) - x_hat mean_g(dxhat x_hat))``,
    ``dscale = dy_f y_gn``, ``dshift = dy_f``, dgamma / dbeta summed over
    N and L.  All f32; returns ``(dx, dscale, dshift, dgamma, dbeta)`` with
    dx in ``x.dtype``, dscale / dshift in ``scale.dtype`` (None without
    FiLM) and dgamma / dbeta f32."""
    N, L, C = x.shape
    gs = C // num_groups
    rstd, xhat, y_gn, dy_f, dy_gn, dxhat = _backward_chain(
        x, g, gamma, beta, scale, shift, stats, silu)

    def group_mean(t):
        return _per_channel(
            t.reshape(N, L, num_groups, gs).mean(dim=(1, 3)), C)

    dx = rstd * (dxhat - group_mean(dxhat) - xhat * group_mean(dxhat * xhat))
    dgamma = (dy_gn * xhat).sum(dim=(0, 1))
    dbeta = dy_gn.sum(dim=(0, 1))
    if scale is not None:
        return (dx.to(x.dtype), (dy_f * y_gn).to(scale.dtype),
                dy_f.to(shift.dtype), dgamma, dbeta)
    return dx.to(x.dtype), None, None, dgamma, dbeta


# ---- split statistics (context parallelism) -------------------------------
#
# Under context parallelism a group's rows lie on several ranks, so each
# pass splits in two around a sum over the model axis
# (``parallel/context.py``): the forward into (a) the per-group f64 sums
# of x and x^2 over this rank's rows and (b) the apply from the summed
# ones, with the one-rank kernel's f32 formula for mean / rstd; the
# backward into (c) the per-group f32 sums of dxhat and dxhat * x_hat over
# this rank's rows (with this rank's dgamma / dbeta) and (d) dx, dscale,
# dshift from the summed ones.  ``length`` below is the whole image's L
# (its pixels, every rank's rows): each group's mean divides by
# ``length * C / G``.


def _group_sums(t: torch.Tensor, num_groups: int) -> torch.Tensor:
    N, L, C = t.shape
    return t.reshape(N, L, num_groups, C // num_groups).sum(dim=(1, 3))


def groupnorm_partial_sums_reference(x: torch.Tensor,
                                     num_groups: int) -> torch.Tensor:
    """(a), plain: ``[2, N, G]`` float64 ``Σx`` and ``Σx²`` per group over
    this rank's rows of ``x [N, l, C]`` (x² of an f32 is exact in f64)."""
    xd = x.double()
    return torch.stack([_group_sums(xd, num_groups),
                        _group_sums(xd * xd, num_groups)])


def stats_from_sums(sums: torch.Tensor, length: int, C: int,
                    num_groups: int) -> torch.Tensor:
    """``[2, N, G]`` f32 mean / rstd from the summed f64 ``sums`` of
    ``length`` pixels a sample: the cluster kernel's f32 operations
    (``film.cu``), each rounded: ``mean = f32(Σx) * (1 / count)``, ``var =
    E[x²] - mean²`` clamped at 0, ``rstd = rsqrt(var + eps)``."""
    inv = torch.tensor(1.0, dtype=torch.float32) / (
        torch.tensor(float(length), dtype=torch.float32)
        * torch.tensor(float(C // num_groups), dtype=torch.float32))
    inv = inv.to(sums.device)
    mean = sums[0].float() * inv
    mean2 = sums[1].float() * inv
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + EPS)])


def groupnorm_apply_sums_reference(
        x, gamma, beta, scale, shift, sums, *, length: int,
        num_groups: int, silu: bool):
    """(b), plain: ``(out, stats)``: the statistics of the summed
    ``sums`` (:func:`stats_from_sums`), then :func:`groupnorm_reference`'s
    element chain."""
    stats = stats_from_sums(sums, length, x.shape[-1], num_groups)
    out = groupnorm_reference(x, gamma, beta, num_groups=num_groups,
                              scale=scale, shift=shift, silu=silu,
                              stats=stats)
    return out, stats


def groupnorm_backward_partial_sums_reference(
        x, g, gamma, beta, scale, shift, stats, *, num_groups: int,
        silu: bool):
    """(c), plain: ``(sums, dgamma, dbeta)``: ``[2, N, G]`` f32 ``Σdxhat``
    and ``Σdxhat x_hat`` per group over this rank's rows, and this rank's
    f32 dgamma / dbeta (summed over N and its rows)."""
    _, xhat, _, _, dy_gn, dxhat = _backward_chain(
        x, g, gamma, beta, scale, shift, stats, silu)
    sums = torch.stack([_group_sums(dxhat, num_groups),
                        _group_sums(dxhat * xhat, num_groups)])
    return sums, (dy_gn * xhat).sum(dim=(0, 1)), dy_gn.sum(dim=(0, 1))


def groupnorm_backward_apply_sums_reference(
        x, g, gamma, beta, scale, shift, stats, sums, *, length: int,
        num_groups: int, silu: bool):
    """(d), plain: ``(dx, dscale, dshift)`` from the summed f32 ``sums``
    of ``length`` pixels a sample: ``mean_g(t) = Σt / count`` in f32, then
    the unsplit backward's formula (dscale / dshift None without
    FiLM)."""
    C = x.shape[-1]
    rstd, xhat, y_gn, dy_f, _, dxhat = _backward_chain(
        x, g, gamma, beta, scale, shift, stats, silu)
    count = torch.tensor(float(length), dtype=torch.float32) * torch.tensor(
        float(C // num_groups), dtype=torch.float32)
    m = sums.float() / count.to(sums.device)
    dx = rstd * (dxhat - _per_channel(m[0], C)
                 - xhat * _per_channel(m[1], C))
    if scale is None:
        return dx.to(x.dtype), None, None
    return (dx.to(x.dtype), (dy_f * y_gn).to(scale.dtype),
            dy_f.to(shift.dtype))


def _fwd_aux_bytes(C: int, G: int, itemsize: int) -> int:
    """Shared memory of a forward CTA's f64 fold buffers (``film.cu``
    ``fwd_aux_doubles`` at 16-byte lanes)."""
    return 8 * ((2 * C + 2 * G + FWD_THREADS * (16 // itemsize) + 1)
                // 2 * 2)


@functools.lru_cache(maxsize=None)
def forward_plan(N: int, L: int, C: int, G: int, itemsize: int,
                 film: bool) -> Tuple[int, int, bool]:
    """``(cluster, rows_per_cta, onchip)`` of the forward's cluster kernel:
    each sample's L rows split over ``cluster`` CTAs (1..16) of
    ``rows_per_cta`` rows.  The smallest cluster that gives the grid
    about one CTA per SM (``FWD_MIN_CTAS``); where the grid is no larger
    and a CTA would still stream more than ``FWD_SLAB`` bytes of x,
    16-CTA clusters.  A FiLM site, which streams scale and shift beside
    x, takes clusters at least large enough that a CTA's x is at most
    ``FWD_SLAB`` bytes and so is re-read from L2.  Rows stay on chip only
    in 16-CTA clusters that still fit two CTAs on an SM.  Measured
    against every plan at every srn64 site
    (``tools/bench_gn_forward.py``, ``PERF.md``)."""
    def slab(cs):
        return -(-L // cs) * C * itemsize

    cs = 1
    while cs < MAX_CLUSTER and N * cs < FWD_MIN_CTAS:
        cs *= 2
    if N * cs <= FWD_MIN_CTAS and slab(cs) > FWD_SLAB:
        cs = MAX_CLUSTER
    while film and cs < MAX_CLUSTER and slab(cs) > FWD_SLAB:
        cs *= 2
    onchip = (cs == MAX_CLUSTER and _fwd_aux_bytes(C, G, itemsize)
              + slab(cs) <= SMEM_TWO_PER_SM)
    return cs, -(-L // cs), onchip


@functools.lru_cache(maxsize=None)
def backward_plan(N: int, L: int, C: int, G: int,
                  itemsize: int) -> Tuple[int, int, bool]:
    """``(cluster, rows_per_cta, onchip)`` of the backward's cluster
    kernel: each sample's L rows split over ``cluster`` CTAs (1..16) of
    ``rows_per_cta`` rows.  The smallest cluster whose CTAs keep their
    rows of x and g on chip in at most 113 KB, so that two CTAs share an
    SM; else a cluster of 8 that re-reads x and g (measured faster than
    16-CTA clusters keeping them on chip at one CTA per SM, PERF.md);
    then doubled while there are fewer than two CTAs per SM and a CTA
    would take more than 64 rows."""
    aux = 4 * ((4 * C + 2 * G + BWD_THREADS * (16 // itemsize) + 3) // 4 * 4)
    stash = 2 * C * itemsize                  # x and g, one row
    cs, onchip = OFFCHIP_CLUSTER, False
    for c in (1, 2, 4, 8, 16):
        if aux + -(-L // c) * stash <= SMEM_TWO_PER_SM:
            cs, onchip = c, True
            break
    while cs < MAX_CLUSTER and N * cs < 2 * _SMS and -(-L // cs) > 64:
        cs *= 2
    return cs, -(-L // cs), onchip


@functools.lru_cache(maxsize=None)
def _function(lib, name: str):
    """``lib.<name>`` with its ctypes signature, set on first use."""
    fn = getattr(lib, name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = _c_i
    return fn


def _raise(lib, name: str, rc: int) -> None:
    if rc != 0:
        err = lib.gn_error_string
        err.argtypes = [_c_i]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} failed: {err(rc).decode()} (code {rc})")


def launch(lib, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], *,
           num_groups: int, silu: bool, stream: Optional[int],
           save_stats: bool = False,
           plan: Optional[Tuple[int, int, bool]] = None):
    """One call of ``gn_fused_forward`` in ``lib`` on checked operands;
    allocates the contiguous output like ``x`` and, with ``save_stats``,
    the ``[2, N, G]`` f32 statistics (returned as a pair then), and nothing
    else.  ``plan`` overrides :func:`forward_plan`."""
    fn = _function(lib, "gn_fused_forward")
    N, L, C = x.shape
    film = scale is not None
    cluster, rows_per_cta, onchip = plan or forward_plan(
        N, L, C, num_groups, x.element_size(), film)
    out = torch.empty((N, L, C), dtype=x.dtype, device=x.device)
    stats = (torch.empty((2, N, num_groups), dtype=torch.float32,
                         device=x.device) if save_stats else None)
    sc = scale if film else x
    sh = shift if film else x
    sxn, sxl, _ = x.stride()
    ssn, ssl, _ = sc.stride()
    shn, shl, _ = sh.stride()
    rc = fn(x.data_ptr(), sxn, sxl, gamma.data_ptr(), beta.data_ptr(),
            sc.data_ptr(), ssn, ssl, sh.data_ptr(), shn, shl,
            out.data_ptr(), 0 if stats is None else stats.data_ptr(),
            N, L, C, num_groups, cluster, rows_per_cta, int(onchip),
            _DTYPE_CODE[x.dtype], int(film), int(silu), EPS, stream)
    _raise(lib, "gn_fused_forward", rc)
    return (out, stats) if save_stats else out


def max_active_clusters(lib, L: int, C: int, G: int,
                        plan: Tuple[int, int, bool], dtype: torch.dtype,
                        film: bool, silu: bool, vec: bool = True) -> int:
    """How many clusters of the forward kernel under ``plan`` the current
    card holds at once (``cudaOccupancyMaxActiveClusters``); 0 means the
    plan cannot launch there."""
    fn = _function(lib, "gn_forward_max_clusters")
    out = _c_i(0)
    cluster, rows_per_cta, onchip = plan
    rc = fn(L, C, G, cluster, rows_per_cta, int(onchip), _DTYPE_CODE[dtype],
            int(film), int(silu), int(vec), ctypes.byref(out))
    _raise(lib, "gn_forward_max_clusters", rc)
    return out.value


def launch_backward(lib, x: torch.Tensor, g: torch.Tensor,
                    gamma: torch.Tensor, beta: torch.Tensor,
                    scale: Optional[torch.Tensor],
                    shift: Optional[torch.Tensor], stats: torch.Tensor, *,
                    num_groups: int, silu: bool, stream: Optional[int],
                    plan: Optional[Tuple[int, int, bool]] = None):
    """One call of ``gn_fused_backward`` in ``lib`` on checked operands;
    allocates contiguous ``dx`` (and ``dscale`` / ``dshift``) like ``x``,
    f32 ``dgamma`` / ``dbeta`` and the ``[2, N, C]`` partial-sum scratch.
    ``plan`` overrides :func:`backward_plan`."""
    fn = _function(lib, "gn_fused_backward")
    N, L, C = x.shape
    cluster, rows_per_cta, onchip = plan or backward_plan(
        N, L, C, num_groups, x.element_size())
    film = scale is not None
    dx = torch.empty((N, L, C), dtype=x.dtype, device=x.device)
    dscale = torch.empty_like(dx) if film else None
    dshift = torch.empty_like(dx) if film else None
    dgb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    partial = torch.empty(2 * N * C, dtype=torch.float32, device=x.device)
    sc = scale if film else x
    sh = shift if film else x
    rc = fn(x.data_ptr(), x.stride(0), x.stride(1), g.data_ptr(),
            g.stride(0), g.stride(1), gamma.data_ptr(), beta.data_ptr(),
            sc.data_ptr(), sc.stride(0), sc.stride(1), sh.data_ptr(),
            sh.stride(0), sh.stride(1), stats.data_ptr(), dx.data_ptr(),
            dscale.data_ptr() if film else 0,
            dshift.data_ptr() if film else 0, dgb[0].data_ptr(),
            dgb[1].data_ptr(), partial.data_ptr(), N, L, C, num_groups,
            cluster, rows_per_cta, int(onchip), _DTYPE_CODE[x.dtype],
            int(film), int(silu), stream)
    _raise(lib, "gn_fused_backward", rc)
    return dx, dscale, dshift, dgb[0], dgb[1]


def _check(x, gamma, beta, scale, shift, num_groups):
    """Raise unless the kernels take these operands, on the current
    device (integer device checks, as the attention wrappers do: a
    ``torch.device`` per comparison costs host time on every call)."""
    if not supports(x, num_groups=num_groups):
        raise ValueError(
            f"fused_groupnorm: the kernel does not take x "
            f"{tuple(x.shape)} {x.dtype} stride {x.stride()} with "
            f"num_groups={num_groups}")
    dev = x.get_device()
    C = x.shape[-1]
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (C,) or p.dtype != torch.float32 \
                or not p.is_contiguous() or p.get_device() != dev:
            raise ValueError(f"fused_groupnorm: {name} must be a "
                             f"contiguous float32 [{C}] on {x.device}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.dtype != x.dtype or t.get_device() != dev
                              or t.stride(-1) != 1):
            raise ValueError(f"fused_groupnorm: {name} must share x's "
                             "dtype and device, with unit channel stride")
    if dev != torch.cuda.current_device():
        raise ValueError("fused_groupnorm: x is not on the current device")


def _stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, as the raw handle (without
    building a ``torch.cuda.Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


class _FusedGroupNormFn(torch.autograd.Function):
    """The differentiable fused GroupNorm (``jax.custom_vjp`` of
    ``pallas_film.py:441-473``): the forward saves x, gamma, beta,
    scale, shift and the ``[2, N, G]`` statistics; the backward is
    :func:`groupnorm_backward`.  On CPU tensors both passes are the plain
    versions; on CUDA tensors both are the kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, silu):
        if x.is_cuda:
            out, stats = launch(build.library("film"), x, gamma, beta, scale,
                                shift, num_groups=num_groups, silu=silu,
                                stream=_stream(x), save_stats=True)
            fused_groupnorm.launches += 1
        else:
            stats = groupnorm_stats_reference(x, num_groups)
            out = groupnorm_reference(x, gamma, beta, num_groups=num_groups,
                                      scale=scale, shift=shift, silu=silu,
                                      stats=stats)
        ctx.save_for_backward(x, gamma, beta, scale, shift, stats)
        ctx.num_groups, ctx.silu = num_groups, silu
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, gamma, beta, scale, shift, stats = ctx.saved_tensors
        dx, dscale, dshift, dgamma, dbeta = groupnorm_backward(
            x, g, gamma, beta, scale, shift, stats,
            num_groups=ctx.num_groups, silu=ctx.silu)
        return dx, dgamma, dbeta, dscale, dshift, None, None


def groupnorm_backward(x: torch.Tensor, g: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor,
                       scale: Optional[torch.Tensor],
                       shift: Optional[torch.Tensor], stats: torch.Tensor,
                       *, num_groups: int, silu: bool):
    """Backward of the fused GroupNorm given the upstream gradient ``g``
    and the forward's ``[2, N, G]`` statistics: ``(dx, dscale, dshift,
    dgamma, dbeta)``.  ``dscale`` / ``dshift`` are two contiguous tensors
    (None without FiLM); autograd scatters them into the two halves of the
    FiLM Dense output's gradient.  On a CPU tensor this is
    :func:`groupnorm_backward_reference`; on a CUDA tensor the kernel runs
    or the call raises.  Each launch adds one to
    ``groupnorm_backward.launches``."""
    if not x.is_cuda:
        return groupnorm_backward_reference(
            x, g, gamma, beta, scale, shift, stats, num_groups=num_groups,
            silu=silu)
    _check(x, gamma, beta, scale, shift, num_groups)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"groupnorm_backward: g {tuple(g.shape)} {g.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    N, C = x.shape[0], x.shape[-1]
    if stats.shape != (2, N, num_groups) or stats.dtype != torch.float32 \
            or not stats.is_contiguous():
        raise ValueError(f"groupnorm_backward: stats must be a contiguous "
                         f"float32 [2, {N}, {num_groups}]")
    out = launch_backward(build.library("film"), x, g, gamma, beta, scale,
                          shift, stats, num_groups=num_groups, silu=silu,
                          stream=_stream(x))
    groupnorm_backward.launches += 1
    return out


# ---- the split-statistics wrappers -----------------------------------------


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1)


def _film_views(x, scale, shift):
    """``(scale, shift)`` as the kernels take them (x itself without FiLM)
    and the flag."""
    film = scale is not None
    return (scale if film else x), (shift if film else x), int(film)


def _check_split(name, x, gamma, beta, scale, shift, num_groups):
    _check(x, gamma, beta, scale, shift, num_groups)
    if x.shape[-1] // num_groups > SPLIT_THREADS:
        raise ValueError(f"{name}: {x.shape[-1] // num_groups} channels a "
                         f"group, the split kernels take <= "
                         f"{SPLIT_THREADS}")


def _check_stats(name, t, x, G, dtype):
    N = x.shape[0]
    if t.shape != (2, N, G) or t.dtype != dtype or not t.is_contiguous() \
            or t.get_device() != x.get_device():
        raise ValueError(f"{name}: expected a contiguous {dtype} "
                         f"[2, {N}, {G}] on {x.device}")


def groupnorm_partial_sums(x: torch.Tensor, *,
                           num_groups: int) -> torch.Tensor:
    """(a) of the split statistics: ``[2, N, G]`` float64 ``Σx`` and
    ``Σx²`` per group over this rank's rows of ``x [N, l, C]``
    (``gn_split_sums_kernel``; the plain version on a CPU tensor).  Each
    launch adds one to ``groupnorm_partial_sums.launches``."""
    if not x.is_cuda:
        return groupnorm_partial_sums_reference(x, num_groups)
    if not supports(x, num_groups=num_groups, rows=True):
        raise ValueError(f"groupnorm_partial_sums: the kernel does not take "
                         f"x {tuple(x.shape)} {x.dtype} stride {x.stride()} "
                         f"with num_groups={num_groups}")
    N, L, C = x.shape
    sums = torch.empty((2, N, num_groups), dtype=torch.float64,
                       device=x.device)
    lib = build.library("film")
    rc = _function(lib, "gn_split_sums")(
        x.data_ptr(), *_strides(x), sums.data_ptr(), N, L, C, num_groups,
        _DTYPE_CODE[x.dtype], _stream(x))
    _raise(lib, "gn_split_sums", rc)
    groupnorm_partial_sums.launches += 1
    return sums


def groupnorm_apply_sums(x, gamma, beta, scale, shift, sums, *,
                         length: int, num_groups: int, silu: bool):
    """(b) of the split statistics: ``(out, stats)`` of this rank's rows
    from the ``[2, N, G]`` f64 ``sums`` of every rank's (``length``
    pixels a sample): mean / rstd with the one-rank kernel's f32 formula,
    then the GN -> (FiLM) -> (SiLU) chain; ``stats`` the ``[2, N, G]`` f32
    mean / rstd for the backward (``gn_split_apply_kernel``; the plain
    version on a CPU tensor).  Each launch adds one to
    ``groupnorm_apply_sums.launches``."""
    if not x.is_cuda:
        return groupnorm_apply_sums_reference(
            x, gamma, beta, scale, shift, sums, length=length,
            num_groups=num_groups, silu=silu)
    _check_split("groupnorm_apply_sums", x, gamma, beta, scale, shift,
                 num_groups)
    N, L, C = x.shape
    _check_stats("groupnorm_apply_sums: sums", sums, x, num_groups,
                 torch.float64)
    out = torch.empty((N, L, C), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, N, num_groups), dtype=torch.float32,
                        device=x.device)
    sc, sh, film = _film_views(x, scale, shift)
    lib = build.library("film")
    rc = _function(lib, "gn_split_apply")(
        x.data_ptr(), *_strides(x), gamma.data_ptr(), beta.data_ptr(),
        sc.data_ptr(), *_strides(sc), sh.data_ptr(), *_strides(sh),
        sums.data_ptr(), out.data_ptr(), stats.data_ptr(), N, L, int(length),
        C, num_groups, _DTYPE_CODE[x.dtype], film, int(silu), EPS,
        _stream(x))
    _raise(lib, "gn_split_apply", rc)
    groupnorm_apply_sums.launches += 1
    return out, stats


def groupnorm_backward_partial_sums(x, g, gamma, beta, scale, shift, stats,
                                    *, num_groups: int, silu: bool):
    """(c) of the split statistics: ``(sums, dgamma, dbeta)``: the
    ``[2, N, G]`` f32 ``Σdxhat`` and ``Σdxhat x_hat`` per group over this
    rank's rows, and this rank's f32 dgamma / dbeta
    (``gn_split_bwd_sums_kernel``, then ``gn_bwd_param_kernel``'s fold
    over N; the plain version on a CPU tensor).  Each launch adds one to
    ``groupnorm_backward_partial_sums.launches``."""
    if not x.is_cuda:
        return groupnorm_backward_partial_sums_reference(
            x, g, gamma, beta, scale, shift, stats, num_groups=num_groups,
            silu=silu)
    _check_split("groupnorm_backward_partial_sums", x, gamma, beta, scale,
                 shift, num_groups)
    N, L, C = x.shape
    _check_grad("groupnorm_backward_partial_sums", x, g)
    _check_stats("groupnorm_backward_partial_sums: stats", stats, x,
                 num_groups, torch.float32)
    sums = torch.empty((2, N, num_groups), dtype=torch.float32,
                       device=x.device)
    partial = torch.empty(2 * N * C, dtype=torch.float32, device=x.device)
    dgb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    sc, sh, film = _film_views(x, scale, shift)
    lib = build.library("film")
    rc = _function(lib, "gn_split_backward_sums")(
        x.data_ptr(), *_strides(x), g.data_ptr(), *_strides(g),
        gamma.data_ptr(), beta.data_ptr(), sc.data_ptr(), *_strides(sc),
        sh.data_ptr(), *_strides(sh), stats.data_ptr(), sums.data_ptr(),
        partial.data_ptr(), dgb[0].data_ptr(), dgb[1].data_ptr(), N, L, C,
        num_groups, _DTYPE_CODE[x.dtype], film, int(silu), _stream(x))
    _raise(lib, "gn_split_backward_sums", rc)
    groupnorm_backward_partial_sums.launches += 1
    return sums, dgb[0], dgb[1]


def groupnorm_backward_apply_sums(x, g, gamma, beta, scale, shift, stats,
                                  sums, *, length: int, num_groups: int,
                                  silu: bool):
    """(d) of the split statistics: ``(dx, dscale, dshift)`` of this
    rank's rows from the ``[2, N, G]`` f32 ``sums`` of every rank's
    (``length`` pixels a sample); dscale / dshift None without FiLM
    (``gn_split_bwd_apply_kernel``; the plain version on a CPU tensor).
    Each launch adds one to ``groupnorm_backward_apply_sums.launches``."""
    if not x.is_cuda:
        return groupnorm_backward_apply_sums_reference(
            x, g, gamma, beta, scale, shift, stats, sums, length=length,
            num_groups=num_groups, silu=silu)
    _check_split("groupnorm_backward_apply_sums", x, gamma, beta, scale,
                 shift, num_groups)
    N, L, C = x.shape
    _check_grad("groupnorm_backward_apply_sums", x, g)
    for name, t in (("stats", stats), ("sums", sums)):
        _check_stats(f"groupnorm_backward_apply_sums: {name}", t, x,
                     num_groups, torch.float32)
    film = scale is not None
    dx = torch.empty((N, L, C), dtype=x.dtype, device=x.device)
    dscale = torch.empty_like(dx) if film else None
    dshift = torch.empty_like(dx) if film else None
    sc, sh, _ = _film_views(x, scale, shift)
    lib = build.library("film")
    rc = _function(lib, "gn_split_backward_apply")(
        x.data_ptr(), *_strides(x), g.data_ptr(), *_strides(g),
        gamma.data_ptr(), beta.data_ptr(), sc.data_ptr(), *_strides(sc),
        sh.data_ptr(), *_strides(sh), stats.data_ptr(), sums.data_ptr(),
        dx.data_ptr(), dscale.data_ptr() if film else 0,
        dshift.data_ptr() if film else 0, N, L, int(length), C, num_groups,
        _DTYPE_CODE[x.dtype], int(film), int(silu), _stream(x))
    _raise(lib, "gn_split_backward_apply", rc)
    groupnorm_backward_apply_sums.launches += 1
    return dx, dscale, dshift


def _check_grad(name, x, g):
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or g.stride(-1) != 1:
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} must match "
                         f"x {tuple(x.shape)} {x.dtype}, unit channel "
                         "stride")


def _split_forward(x, gamma, beta, scale, shift, num_groups, silu, rows):
    """(a), the f64 sums over the model axis, (b): ``(out, stats)``."""
    sums = rows.sum(groupnorm_partial_sums(x, num_groups=num_groups))
    return groupnorm_apply_sums(x, gamma, beta, scale, shift, sums,
                                length=x.shape[1] * rows.size,
                                num_groups=num_groups, silu=silu)


class _SplitGroupNormFn(torch.autograd.Function):
    """The differentiable GroupNorm of this rank's rows with split
    statistics (``rows``: a :class:`~diff3d_tpu_torch.parallel.context.
    RowAxis`): the forward is (a), the f64 sum over the model axis, (b);
    the backward (c), the f32 sum over the model axis, (d).  dgamma /
    dbeta are this rank's (the train step sums every parameter's gradient
    over the model axis)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, silu, rows):
        out, stats = _split_forward(x, gamma, beta, scale, shift,
                                    num_groups, silu, rows)
        ctx.save_for_backward(x, gamma, beta, scale, shift, stats)
        ctx.num_groups, ctx.silu, ctx.rows = num_groups, silu, rows
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, gamma, beta, scale, shift, stats = ctx.saved_tensors
        G, silu, rows = ctx.num_groups, ctx.silu, ctx.rows
        if g.stride(-1) != 1:
            g = g.contiguous()
        sums, dgamma, dbeta = groupnorm_backward_partial_sums(
            x, g, gamma, beta, scale, shift, stats, num_groups=G, silu=silu)
        dx, dscale, dshift = groupnorm_backward_apply_sums(
            x, g, gamma, beta, scale, shift, stats, rows.sum(sums),
            length=x.shape[1] * rows.size, num_groups=G, silu=silu)
        return dx, dgamma, dbeta, dscale, dshift, None, None, None


def fused_groupnorm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, *, num_groups: int,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    silu: bool = False, rows=None) -> torch.Tensor:
    """Fused GroupNorm -> (FiLM) -> (SiLU) over ``x [N, L, C]``.

    ``gamma`` / ``beta`` are the ``[C]`` float32 affine parameters;
    ``scale`` / ``shift`` (both or neither) are per-pixel FiLM tensors
    shaped like ``x`` — strided views are taken as they are (the FiLM
    Dense output's two halves, row stride 2C).  Returns a contiguous
    ``[N, L, C]`` of ``x.dtype``.  On a CPU tensor this is
    :func:`groupnorm_reference`; on a CUDA tensor the kernel runs or the
    call raises.  When autograd records (an operand requires grad), the
    call goes through :class:`_FusedGroupNormFn`, whose forward saves the
    statistics (``save_stats``) and whose backward is
    :func:`groupnorm_backward`; under ``no_grad`` / ``inference_mode``
    nothing is saved, as in the Pallas primal (``pallas_film.py:441-448``).

    ``rows`` (a :class:`~diff3d_tpu_torch.parallel.context.RowAxis`):
    ``x`` is this rank's rows of each sample, and the statistics are the
    whole sample's, by the split-statistics entry points and sums over
    the model axis (:class:`_SplitGroupNormFn`); the unsplit kernel is
    not launched.
    """
    film = scale is not None
    if film != (shift is not None):
        raise ValueError("scale and shift come together")
    if film and (scale.shape != x.shape or shift.shape != x.shape):
        raise ValueError(f"scale {tuple(scale.shape)} / shift "
                         f"{tuple(shift.shape)} must match x "
                         f"{tuple(x.shape)}")
    if x.is_cuda:
        _check(x, gamma, beta, scale, shift, num_groups)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, gamma, beta, scale, shift))
    if rows is not None:
        if grad:
            return _SplitGroupNormFn.apply(x, gamma, beta, scale, shift,
                                           num_groups, silu, rows)
        return _split_forward(x, gamma, beta, scale, shift, num_groups,
                              silu, rows)[0]
    if grad:
        return _FusedGroupNormFn.apply(x, gamma, beta, scale, shift,
                                       num_groups, silu)
    if not x.is_cuda:
        return groupnorm_reference(x, gamma, beta, num_groups=num_groups,
                                   scale=scale, shift=shift, silu=silu)
    out = launch(build.library("film"), x, gamma, beta, scale, shift,
                 num_groups=num_groups, silu=silu, stream=_stream(x))
    fused_groupnorm.launches += 1
    return out


fused_groupnorm.launches = 0
groupnorm_backward.launches = 0
groupnorm_partial_sums.launches = 0
groupnorm_apply_sums.launches = 0
groupnorm_backward_partial_sums.launches = 0
groupnorm_backward_apply_sums.launches = 0

dispatch.register("groupnorm", "cuda", fused_groupnorm, supports=supports)
dispatch.register("groupnorm", "torch", groupnorm_reference)
