"""Fused GroupNorm -> (FiLM) -> (SiLU) epilogues, forward (counterpart:
``diff3d_tpu/ops/pallas_film.py``).

:func:`fused_groupnorm` is the wrapper of the hand-written CUDA kernel in
``csrc/film.cu`` (it replaces the Pallas ``_fwd_kernel``,
``pallas_film.py:174-288``); :func:`groupnorm_reference` beside it is the
plain PyTorch version of the same function.  Both follow the Pallas
kernel's semantics, which differ from the JAX package's ``xla`` path in
bf16: statistics, affine, FiLM and SiLU all stay f32 and the result is
rounded once at the output (``pallas_film.py:212-220``).

The wrapper runs the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.  Each launch adds one to
``fused_groupnorm.launches``.  The backward kernel and ``save_stats``
come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from diff3d_tpu_torch.ops import build, dispatch

EPS = 1e-5          # torch / Flax-parity GroupNorm epsilon
MAX_C = 4096        # channel cap (srn128's widest up-path concat is 2048)
MAX_GROUPS = 1024   # group cap (shared-memory sizing of the apply pass)
_SMS = 132          # streaming multiprocessors of an H100 SXM

_c_ll = ctypes.c_longlong
_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_ARGTYPES = [_c_p, _c_ll, _c_ll, _c_p, _c_p, _c_p, _c_ll, _c_ll, _c_p,
             _c_ll, _c_ll, _c_p, _c_p, _c_i, _c_i, _c_i, _c_i, _c_i, _c_i,
             _c_i, _c_i, _c_i, _c_i, ctypes.c_float, _c_p]
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(x: torch.Tensor, *args, num_groups: int = 32,
             **kwargs) -> bool:
    """Operands the kernel takes: ``[N, L, C]`` f32/bf16 with unit
    channel stride, C divisible by ``num_groups``, C <= 4096."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODE or x.stride(-1) != 1:
        return False
    C = x.shape[-1]
    return (0 < num_groups <= MAX_GROUPS and C % num_groups == 0
            and 0 < C <= MAX_C)


def groupnorm_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, *, num_groups: int,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        silu: bool = False) -> torch.Tensor:
    """The plain version: f32 statistics as ``E[x^2] - mean^2`` clamped at
    0 (``pallas_film.py:509-531``), eps 1e-5, then gamma/beta, FiLM
    ``y * (1 + scale) + shift`` and SiLU in f32, rounded once to
    ``x.dtype``."""
    N, L, C = x.shape
    xf = x.float().reshape(N, L, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).reshape(N, L, C)
    y = y * gamma.float() + beta.float()
    if scale is not None:
        y = y * (1.0 + scale.float()) + shift.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def launch_shape(N: int, L: int) -> Tuple[int, int, int]:
    """``(splits, rows_per_split, rows_per_block)``: the stats pass splits
    L until there are ~4 blocks per SM (at least 32 rows a split); the
    apply pass takes 32-row tiles, or 8-row ones when that leaves fewer
    than two blocks per SM."""
    splits = max(1, min(-(-L // 32), -(-4 * _SMS // N)))
    rows_per_split = -(-L // splits)
    splits = -(-L // rows_per_split)
    rows_per_block = 32 if N * -(-L // 32) >= 2 * _SMS else 8
    return splits, rows_per_split, rows_per_block


def launch(lib, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], *,
           num_groups: int, silu: bool, stream: Optional[int]
           ) -> torch.Tensor:
    """One call of ``gn_fused_forward`` in ``lib`` on checked operands;
    allocates the output and the partial-sum scratch like ``x``."""
    fn = lib.gn_fused_forward
    fn.argtypes = _ARGTYPES
    fn.restype = _c_i
    N, L, C = x.shape
    splits, rows_per_split, rows_per_block = launch_shape(N, L)
    out = torch.empty((N, L, C), dtype=x.dtype, device=x.device)
    partial = torch.empty((2, N, num_groups, splits), dtype=torch.float32,
                          device=x.device)
    film = scale is not None
    sc = scale if film else x
    sh = shift if film else x
    rc = fn(x.data_ptr(), x.stride(0), x.stride(1), gamma.data_ptr(),
            beta.data_ptr(), sc.data_ptr(), sc.stride(0), sc.stride(1),
            sh.data_ptr(), sh.stride(0), sh.stride(1), out.data_ptr(),
            partial.data_ptr(), N, L, C, num_groups, splits,
            rows_per_split, rows_per_block, _DTYPE_CODE[x.dtype],
            int(film), int(silu), EPS, stream)
    if rc != 0:
        err = lib.gn_error_string
        err.argtypes = [_c_i]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"gn_fused_forward failed: {err(rc).decode()} (code {rc})")
    return out


def _check(x, gamma, beta, scale, shift, num_groups):
    if not supports(x, num_groups=num_groups):
        raise ValueError(
            f"fused_groupnorm: the kernel does not take x "
            f"{tuple(x.shape)} {x.dtype} stride {x.stride()} with "
            f"num_groups={num_groups}")
    C = x.shape[-1]
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (C,) or p.dtype != torch.float32 \
                or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"fused_groupnorm: {name} must be a "
                             f"contiguous float32 [{C}] on {x.device}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device
                              or t.stride(-1) != 1):
            raise ValueError(f"fused_groupnorm: {name} must share x's "
                             "dtype and device, with unit channel stride")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("fused_groupnorm: x is not on the current device")


def fused_groupnorm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, *, num_groups: int,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    silu: bool = False) -> torch.Tensor:
    """Fused GroupNorm -> (FiLM) -> (SiLU) over ``x [N, L, C]``.

    ``gamma`` / ``beta`` are the ``[C]`` float32 affine parameters;
    ``scale`` / ``shift`` (both or neither) are per-pixel FiLM tensors
    shaped like ``x`` — strided views are taken as they are (the FiLM
    Dense output's two halves, row stride 2C).  Returns a contiguous
    ``[N, L, C]`` of ``x.dtype``.  On a CPU tensor this is
    :func:`groupnorm_reference`; on a CUDA tensor the kernel runs or the
    call raises.
    """
    film = scale is not None
    if film != (shift is not None):
        raise ValueError("scale and shift come together")
    if film and (scale.shape != x.shape or shift.shape != x.shape):
        raise ValueError(f"scale {tuple(scale.shape)} / shift "
                         f"{tuple(shift.shape)} must match x "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        return groupnorm_reference(x, gamma, beta, num_groups=num_groups,
                                   scale=scale, shift=shift, silu=silu)
    _check(x, gamma, beta, scale, shift, num_groups)
    out = launch(build.library("film"), x, gamma, beta, scale, shift,
                 num_groups=num_groups, silu=silu,
                 stream=torch.cuda.current_stream(x.device).cuda_stream)
    fused_groupnorm.launches += 1
    return out


fused_groupnorm.launches = 0

dispatch.register("groupnorm", "cuda", fused_groupnorm, supports=supports)
dispatch.register("groupnorm", "torch", groupnorm_reference)
