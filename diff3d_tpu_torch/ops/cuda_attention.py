"""Flash attention, forward (counterpart:
``diff3d_tpu/ops/pallas_attention.py``).

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel in
``csrc/attention.cu`` (it replaces the Pallas ``_fwd_kernel`` with
``save_lse=False``, ``pallas_attention.py:119-197``, reached through
``flash_attention`` :417 -> ``_flash`` :361 -> ``_run_fwd`` :337);
:func:`attention_reference` beside it is the plain PyTorch version,
``softmax(q k^T / sqrt(D)) v`` with explicit f32 matmuls.

Layout is the JAX package's ``[B, L, H, D]``.  The kernel takes q/k/v as
strided views (head-dim stride 1), so the ``[B, L, C]`` projection outputs
are passed as ``view(B, L, H, D)`` with no permute copy.  The wrapper runs
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  Each launch adds one to
``flash_attention.launches``.  The log-sum-exp output (ring attention) and
the backward kernels come with later slices.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from diff3d_tpu_torch.ops import build

MAX_D = 256         # head-dim cap (srn128's deep levels use D = 256)

_c_ll = ctypes.c_longlong
_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_ARGTYPES = ([_c_p, _c_ll, _c_ll, _c_ll] * 4
             + [_c_i] * 5 + [ctypes.c_float, _c_i, _c_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Operands the kernel takes: ``[B, L, H, D]`` f32/bf16, one dtype,
    D <= 256, unit head-dim stride, matching batch/heads and k/v
    shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return False
    B, _, H, D = q.shape
    return (0 < D <= MAX_D and k.shape == v.shape
            and (k.shape[0], k.shape[2], k.shape[3]) == (B, H, D)
            and q.stride(-1) == k.stride(-1) == v.stride(-1) == 1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version over ``[B, L, H, D]``: f32 ``q k^T * scale``,
    softmax over keys, times v, rounded to ``q.dtype``.  ``scale``
    defaults to ``1/sqrt(D)`` (``jax.nn.dot_product_attention``'s)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float().transpose(1, 2)                     # [B, H, Lq, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    o = torch.matmul(torch.softmax(s, dim=-1), vf)     # [B, H, Lq, D]
    return o.transpose(1, 2).to(q.dtype)


def launch(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, stream: Optional[int]) -> torch.Tensor:
    """One call of ``flash_attention_forward`` in ``lib`` on checked
    operands; allocates the contiguous ``[B, Lq, H, D]`` output."""
    fn = lib.flash_attention_forward
    fn.argtypes = _ARGTYPES
    fn.restype = _c_i
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    args = []
    for t in (q, k, v, o):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    rc = fn(*args, B, H, Lq, Lk, D, scale, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        err = lib.flash_error_string
        err.argtypes = [_c_i]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"flash_attention_forward failed: {err(rc).decode()} "
            f"(code {rc})")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[B, L, H, D]`` (Lq != Lk allowed); ``scale``
    defaults to ``1/sqrt(D)``.  On a CPU tensor this is
    :func:`attention_reference`; on a CUDA tensor the kernel runs or the
    call raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return attention_reference(q, k, v, scale)
    if not supports(q, k, v):
        raise ValueError(
            f"flash_attention: the kernel does not take q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} {q.dtype} (D <= "
            f"{MAX_D}, unit head-dim stride)")
    if not (k.is_cuda and v.is_cuda) \
            or q.device.index != torch.cuda.current_device():
        raise ValueError("flash_attention: q/k/v must be on the current "
                         "CUDA device")
    o = launch(build.library("attention"), q, k, v, scale=scale,
               stream=torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
