"""Kernel-dispatch registry for the hot-path ops (counterpart:
``diff3d_tpu/ops/dispatch.py``).

Every dispatched op — the fused GroupNorm epilogues
(:mod:`diff3d_tpu_torch.ops.cuda_film`) and attention's sdpa core
(:mod:`diff3d_tpu_torch.ops.attention`) — registers two implementations:

  * ``"cuda"``  — the hand-written kernel's wrapper.  On a CUDA tensor it
    launches the kernel; on a CPU tensor it runs the plain version (the
    tensor's device alone decides).  A CUDA tensor whose shape the
    kernel's ``supports`` rejects raises: there is no fallback.
  * ``"torch"`` — the plain PyTorch version, on any device.  It is what
    the CPU tests hold against the JAX package, and what the card check
    holds the kernels against
    (:func:`diff3d_tpu_torch.models.layers.set_kernels`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

IMPLS = ("cuda", "torch")


def _always(*args, **kwargs) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of a dispatched op; ``supports``
    says which operands the kernel takes at all."""

    op: str
    name: str
    fn: Callable
    supports: Callable[..., bool] = _always


_REGISTRY: Dict[str, Dict[str, KernelImpl]] = {}


def register(op: str, name: str, fn: Callable, *,
             supports: Callable[..., bool] = _always) -> KernelImpl:
    """Register ``fn`` as implementation ``name`` ('cuda' | 'torch') of
    ``op``; re-registering replaces the entry."""
    if name not in IMPLS:
        raise ValueError(f"impl {name!r} not in {IMPLS}")
    impl = KernelImpl(op=op, name=name, fn=fn, supports=supports)
    _REGISTRY.setdefault(op, {})[name] = impl
    return impl


def resolve(op: str, requested: str, x: torch.Tensor, *args,
            **kwargs) -> KernelImpl:
    """The implementation of ``op`` that runs for operands ``(x, *args)``.

    ``requested="torch"`` is the plain version.  ``requested="cuda"`` is
    the kernel's wrapper, after checking, for a CUDA ``x``, that the
    kernel takes these operands (it raises if not)."""
    impls = _REGISTRY.get(op)
    if not impls:
        raise KeyError(f"no implementations registered for op {op!r}")
    if requested not in IMPLS:
        raise ValueError(
            f"op {op!r}: requested impl {requested!r} not in {IMPLS}")
    impl = impls[requested]
    if requested == "cuda" and x.is_cuda \
            and not impl.supports(x, *args, **kwargs):
        raise ValueError(
            f"op {op!r}: the CUDA kernel does not take operands of shape "
            f"{tuple(x.shape)} / dtype {x.dtype} ({kwargs or ''})")
    return impl


def dispatch(op: str, requested: str, x: torch.Tensor, *args, **kwargs):
    """Resolve and call in one step."""
    return resolve(op, requested, x, *args, **kwargs).fn(x, *args, **kwargs)
