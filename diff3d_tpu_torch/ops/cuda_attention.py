"""Flash attention, forward and backward (counterpart:
``diff3d_tpu/ops/pallas_attention.py``).

:func:`flash_attention` and :func:`flash_attention_lse` wrap the
hand-written CUDA forward kernel in ``csrc/attention.cu`` (it replaces the
Pallas ``_fwd_kernel``, ``pallas_attention.py:119-197``: ``save_lse=False``
for inference, ``save_lse=True`` when autograd records or the caller asks
for the log-sum-exp); :func:`attention_backward` wraps the backward
kernels beside it (they replace ``_bwd_dkdv_kernel`` and
``_bwd_dq_kernel``, ``pallas_attention.py:204-317``).  bf16 at D <= 256
runs on the tensor cores; f32, and bf16 at 256 < D <= 512, on the CUDA
cores.
:func:`attention_reference`, :func:`attention_lse_reference` and
:func:`attention_backward_reference` are the plain PyTorch versions with
explicit f32 matmuls.

Layout is the JAX package's ``[B, L, H, D]``.  The kernels take q/k/v (and
o, dO) as strided views (head-dim stride 1), so the ``[B, L, C]``
projection outputs are passed as ``view(B, L, H, D)`` with no permute copy.
The lse residual is f32 ``[B, H, Lq]``.  Each kernel entry point is a
dispatcher op (:mod:`diff3d_tpu_torch.ops.library`: ``flash_forward``,
``flash_forward_lse``, ``flash_backward_dkdv``, ``flash_backward_dq``):
the plain versions run only for a tensor on the CPU; for a CUDA tensor
the wrappers launch the kernel or raise.  Each launch adds one to ``flash_attention.launches``
(the forward, with or without lse), ``attention_backward_dkdv.launches``
or ``attention_backward_dq.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from diff3d_tpu_torch.ops import build, library

MAX_D = 512         # head-dim cap, the Pallas kernel's (pallas_attention.py:52)

_c_ll = ctypes.c_longlong
_c_p = ctypes.c_void_p
_c_i = ctypes.c_int
_ARGTYPES = ([_c_p, _c_ll, _c_ll, _c_ll] * 4
             + [_c_p] + [_c_i] * 5 + [ctypes.c_float, _c_i, _c_p])
_BWD_ARGTYPES = ([_c_p, _c_ll, _c_ll, _c_ll] * 5 + [_c_p] * 6
                 + [_c_i] * 5 + [ctypes.c_float, _c_i, _c_i, _c_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Operands the kernel takes: ``[B, L, H, D]`` f32/bf16, one dtype,
    D <= 512 (the Pallas kernel's domain), unit head-dim stride, matching
    batch/heads and k/v shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return False
    B, _, H, D = q.shape
    return (0 < D <= MAX_D and k.shape == v.shape
            and (k.shape[0], k.shape[2], k.shape[3]) == (B, H, D)
            and q.stride(-1) == k.stride(-1) == v.stride(-1) == 1)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: Optional[float] = None):
    """The plain version with the log-sum-exp: f32 ``s = q k^T * scale``,
    ``lse = logsumexp(s)`` over keys, ``o = exp(s - lse) v`` rounded to
    ``q.dtype``; returns ``(o [B, Lq, H, D], lse [B, H, Lq] f32)``."""
    qf = q.float().transpose(1, 2)                     # [B, H, Lq, D]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * _scale(q, scale)
    lse = torch.logsumexp(s, dim=-1)                   # [B, H, Lq]
    o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    return o.transpose(1, 2).to(q.dtype), lse


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain version over ``[B, L, H, D]``: f32 ``q k^T * scale``,
    softmax over keys, times v, rounded to ``q.dtype``.  ``scale``
    defaults to ``1/sqrt(D)`` (``jax.nn.dot_product_attention``'s)."""
    return attention_lse_reference(q, k, v, scale)[0]


def attention_delta_reference(o: torch.Tensor, do: torch.Tensor,
                              glse: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``delta = rowsum(dO * O) - glse``, f32 ``[B, H, Lq]`` (``glse``
    None means zero): the backward's per-row term."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    return delta if glse is None else delta - glse


def _backward_reference(q, k, v, lse, do, delta, scale):
    """f32 ``(dq, dk, dv)`` as ``[B, H, L, D]`` from ``delta``."""
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
              - delta[..., None]) * scale
    return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
            torch.matmul(p.transpose(-1, -2), dof))


def _rounded(q, t):
    return t.transpose(1, 2).to(q.dtype).contiguous()


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor,
                                 glse: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None):
    """The plain version of the backward, the explicit formula of the
    Pallas kernels (``pallas_attention.py:204-275``): with ``p = exp(q
    k^T * scale - lse)`` and ``delta = rowsum(dO * O) - glse``,
    ``dS = p (dO v^T - delta) * scale``, ``dq = dS k``,
    ``dk = dS^T q``, ``dv = p^T dO``; f32 throughout, rounded to
    ``q.dtype``.  ``lse`` / ``glse`` are ``[B, H, Lq]`` (``glse`` None
    means zero).  Returns contiguous ``(dq, dk, dv)``."""
    delta = attention_delta_reference(o, do, glse)
    grads = _backward_reference(q, k, v, lse, do, delta, _scale(q, scale))
    return tuple(_rounded(q, t) for t in grads)


def _function(lib, name: str, argtypes):
    """``lib.<name>`` with its ctypes signature, set on first use."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _c_i
    return fn


def _views(*tensors) -> list:
    """``[ptr, stride 0, stride 1, stride 2]`` of each ``[B, L, H, D]``."""
    args = []
    for t in tensors:
        s = t.stride()
        args += (t.data_ptr(), s[0], s[1], s[2])
    return args


def launch(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           scale: float, stream: Optional[int], save_lse: bool = False):
    """One call of ``flash_attention_forward`` in ``lib`` on checked
    operands; allocates the contiguous ``[B, Lq, H, D]`` output and, with
    ``save_lse``, the f32 ``[B, H, Lq]`` log-sum-exp (returned as a pair
    then)."""
    fn = _function(lib, "flash_attention_forward", _ARGTYPES)
    B, Lq, H, D = q.shape
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    rc = fn(*_views(q, k, v, o), 0 if lse is None else lse.data_ptr(), B, H,
            Lq, k.shape[1], D, scale, _DTYPE_CODE[q.dtype], stream)
    _raise(lib, "flash_attention_forward", rc)
    return (o, lse) if save_lse else o


def launch_backward(lib, q, k, v, o, do, lse, glse, *, scale: float,
                    stream: Optional[int], part: int, delta: torch.Tensor,
                    grads: tuple) -> None:
    """One call of ``flash_attention_backward`` in ``lib``: ``part`` 0 the
    delta pre-pass and the dK/dV kernel into ``grads[1:]``, 1 the dQ kernel
    into ``grads[0]``."""
    fn = _function(lib, "flash_attention_backward", _BWD_ARGTYPES)
    B, Lq, H, D = q.shape
    rc = fn(*_views(q, k, v, o, do), lse.data_ptr(),
            0 if glse is None else glse.data_ptr(),
            delta.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in grads), B, H, Lq,
            k.shape[1], D, scale, _DTYPE_CODE[q.dtype], part, stream)
    _raise(lib, "flash_attention_backward", rc)


def _raise(lib, name: str, rc: int) -> None:
    if rc != 0:
        err = lib.flash_error_string
        err.argtypes = [_c_i]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} failed: {err(rc).decode()} (code {rc})")


def _check(q, k, v) -> None:
    """Raise unless the kernels take these operands (metadata only, so a
    fake tensor is checked as a real one is; the ops' CUDA
    implementations check the current device)."""
    if not supports(q, k, v):
        raise ValueError(
            f"flash_attention: the kernel does not take q {tuple(q.shape)} "
            f"k {tuple(k.shape)} v {tuple(v.shape)} {q.dtype} (D <= "
            f"{MAX_D}, unit head-dim stride)")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q/k/v must be on the current "
                         "CUDA device")


def _current(q: torch.Tensor) -> None:
    if q.get_device() != torch.cuda.current_device():
        raise ValueError("flash_attention: q/k/v must be on the current "
                         "CUDA device")


def _stream(q: torch.Tensor) -> int:
    """PyTorch's current stream on q's device, as the raw handle (without
    building a ``torch.cuda.Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(q.get_device())


# ---- the kernels as dispatcher ops (``ops/library.py``) --------------------


def _fwd_cuda(q, k, v, scale, save_lse):
    _current(q)
    out = launch(build.library("attention"), q, k, v, scale=scale,
                 stream=_stream(q), save_lse=save_lse)
    flash_attention.launches += 1
    return out


def _rows(q: torch.Tensor) -> torch.Tensor:
    B, Lq, H, _ = q.shape
    return q.new_empty((B, H, Lq), dtype=torch.float32)


_QKV = "Tensor q, Tensor k, Tensor v"
_flash_forward = library.define(
    "flash_forward", f"({_QKV}, float scale) -> Tensor",
    wrapper="flash_attention",
    cpu=lambda q, k, v, scale: attention_reference(q, k, v, scale),
    cuda=lambda q, k, v, scale: _fwd_cuda(q, k, v, scale, False),
    fake=lambda q, k, v, scale: q.new_empty(q.shape))
_flash_forward_lse = library.define(
    "flash_forward_lse", f"({_QKV}, float scale) -> (Tensor, Tensor)",
    wrapper="flash_attention",
    cpu=lambda q, k, v, scale: attention_lse_reference(q, k, v, scale),
    cuda=lambda q, k, v, scale: _fwd_cuda(q, k, v, scale, True),
    fake=lambda q, k, v, scale: (q.new_empty(q.shape), _rows(q)))


def _dkdv_cpu(q, k, v, o, lse, do, glse, scale):
    delta = attention_delta_reference(o, do, glse)
    _, dk, dv = _backward_reference(q, k, v, lse, do, delta, scale)
    return _rounded(q, dk), _rounded(q, dv), delta


def _dkdv_cuda(q, k, v, o, lse, do, glse, scale):
    _current(q)
    B, Lq, H, D = q.shape
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    launch_backward(build.library("attention"), q, k, v, o, do, lse, glse,
                    scale=scale, stream=_stream(q), part=0, delta=delta,
                    grads=(None, dk, dv))
    attention_backward_dkdv.launches += 1
    return dk, dv, delta


def _dq_cuda(q, k, v, o, lse, do, delta, scale):
    _current(q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_backward(build.library("attention"), q, k, v, o, do, lse, None,
                    scale=scale, stream=_stream(q), part=1, delta=delta,
                    grads=(dq, None, None))
    attention_backward_dq.launches += 1
    return dq


_flash_backward_dkdv = library.define(
    "flash_backward_dkdv",
    f"({_QKV}, Tensor o, Tensor lse, Tensor do, Tensor? glse, float scale) "
    "-> (Tensor, Tensor, Tensor)",
    wrapper="attention_backward_dkdv",
    cpu=_dkdv_cpu, cuda=_dkdv_cuda,
    fake=lambda q, k, v, o, lse, do, glse, scale: (
        k.new_empty(k.shape, dtype=q.dtype),
        k.new_empty(k.shape, dtype=q.dtype), _rows(q)))
_flash_backward_dq = library.define(
    "flash_backward_dq",
    f"({_QKV}, Tensor o, Tensor lse, Tensor do, Tensor delta, float scale) "
    "-> Tensor",
    wrapper="attention_backward_dq",
    cpu=lambda q, k, v, o, lse, do, delta, scale: _rounded(
        q, _backward_reference(q, k, v, lse, do, delta, scale)[0]),
    cuda=_dq_cuda,
    fake=lambda q, k, v, o, lse, do, delta, scale: q.new_empty(q.shape))


def _forward(q, k, v, scale: float, save_lse: bool):
    """The forward kernel (CUDA) or the plain version (CPU), as an op."""
    if save_lse:
        return _flash_forward_lse(q, k, v, scale)
    return _flash_forward(q, k, v, scale)


class _FlashAttentionFn(torch.autograd.Function):
    """The differentiable flash attention (``jax.custom_vjp`` of
    ``pallas_attention.py:386-414``): the forward saves q, k, v, o and the
    f32 lse; the backward is :func:`attention_backward`, with the lse
    cotangent folded into dS.  Returns ``(o, lse [B, H, Lq])``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _forward(q, k, v, scale, save_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, glse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        if glse is not None:
            glse = glse.float().contiguous()
        dq, dk, dv = attention_backward(q, k, v, o, lse, do, glse,
                                        scale=ctx.scale)
        return dq, dk, dv, None


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_backward(q, k, v, o, do, **rows) -> None:
    """Raise unless the kernels take these operands; ``rows`` are the
    f32 ``[B, H, Lq]`` per-row inputs (lse, glse, delta)."""
    _check(q, k, v)
    B, Lq, H, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(f"attention_backward: {name} must be shaped "
                             f"and typed like q, with unit head-dim stride")
    for name, t in rows.items():
        if t is not None and (t.shape != (B, H, Lq)
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"attention_backward: {name} must be a "
                             f"contiguous float32 [{B}, {H}, {Lq}]")


def attention_backward_dkdv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            glse: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None):
    """``(dk, dv, delta)``: the delta pre-pass and the dK/dV kernel (row
    5, the op ``flash_backward_dkdv``).  ``delta = rowsum(dO * O) - glse``
    is f32 ``[B, H, Lq]``, the input of :func:`attention_backward_dq`.  On
    a CPU tensor these are the plain versions; on a CUDA tensor the
    kernels run or the call raises."""
    scale = _scale(q, scale)
    if q.is_cuda:
        _check_backward(q, k, v, o, do, lse=lse, glse=glse)
    return _flash_backward_dkdv(q, k, v, o, lse, do, glse, scale)


def attention_backward_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, delta: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``dq`` from :func:`attention_backward_dkdv`'s ``delta``: the dQ
    kernel (row 6, the op ``flash_backward_dq``).  On a CPU tensor this is
    the plain version; on a CUDA tensor the kernel runs or the call
    raises."""
    scale = _scale(q, scale)
    if q.is_cuda:
        _check_backward(q, k, v, o, do, lse=lse, delta=delta)
    return _flash_backward_dq(q, k, v, o, lse, do, delta, scale)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       glse: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None):
    """``(dq, dk, dv)``, contiguous ``[B, L, H, D]`` of ``q.dtype``, from the
    forward's ``o`` and f32 ``lse [B, H, Lq]``, the upstream ``do`` and the
    lse cotangent ``glse [B, H, Lq]`` (None: zero):
    :func:`attention_backward_dkdv`, then :func:`attention_backward_dq`."""
    dk, dv, delta = attention_backward_dkdv(q, k, v, o, lse, do, glse, scale)
    dq = attention_backward_dq(q, k, v, o, lse, do, delta, scale)
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over ``[B, L, H, D]`` (Lq != Lk allowed); ``scale``
    defaults to ``1/sqrt(D)``.  On a CPU tensor this is
    :func:`attention_reference`; on a CUDA tensor the kernel runs or the
    call raises (the op ``flash_forward``).  When autograd records, the
    call goes through :class:`_FlashAttentionFn` (the forward saves the
    lse, ``flash_forward_lse``; the backward is a kernel); under
    ``no_grad`` / ``inference_mode`` no lse is written, as in the Pallas
    primal (``pallas_attention.py:360-363``)."""
    scale = _scale(q, scale)
    if q.is_cuda:
        _check(q, k, v)
    if _recording(q, k, v):
        return _FlashAttentionFn.apply(q, k, v, scale)[0]
    return _forward(q, k, v, scale, save_lse=False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None):
    """Like :func:`flash_attention` but also returns the per-row
    log-sum-exp: ``(o [B, L, H, D], lse [B, L, H] float32)``, the
    counterpart of ``pallas_attention.py:438``.  Differentiable in both
    outputs (the lse cotangent folds into the backward kernels' dS)."""
    scale = _scale(q, scale)
    if q.is_cuda:
        _check(q, k, v)
    if _recording(q, k, v):
        o, lse = _FlashAttentionFn.apply(q, k, v, scale)
    else:
        o, lse = _forward(q, k, v, scale, save_lse=True)
    return o, lse.transpose(1, 2)


flash_attention.launches = 0
attention_backward_dkdv.launches = 0
attention_backward_dq.launches = 0

