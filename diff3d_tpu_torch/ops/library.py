"""The port's kernels as dispatcher ops (namespace ``diff3d_tpu_torch``).

Each kernel entry point is one operator with three implementations, and
the dispatcher's device key picks among them:

  * ``CUDA`` -- the ctypes launch of the hand-written kernel on the current
    stream (so a CUDA graph captures it); it adds one to its wrapper's
    launch count;
  * ``CPU`` -- the kernel's plain PyTorch version;
  * fake -- the exact output shapes and dtypes, for tracing on fake
    tensors (:mod:`diff3d_tpu_torch.analysis.ir`): a traced program holds
    each kernel call as one node, ``torch.ops.diff3d_tpu_torch.<name>``,
    as a StableHLO program holds a ``pallas_call`` as one custom call.

The Python wrappers (:func:`~diff3d_tpu_torch.ops.cuda_film.fused_groupnorm`
and the rest) keep their checks and ``torch.autograd.Function``\\ s and call
these ops; ``supports`` still refuses, for a CUDA tensor, operands the
kernel does not take (no fallback).  The ops are defined with
``torch.library.Library`` rather than ``custom_op``: the eager paths call
them several hundred times a step, and ``custom_op``'s Python layer costs
about twice the host time per call.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

NAMESPACE = "diff3d_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")

#: Every op, by name: its overload (``torch.ops.diff3d_tpu_torch.<name>
#: .default``).
OPS: Dict[str, torch._ops.OpOverload] = {}
#: Every op, by name: the wrapper (``ops.KERNEL_WRAPPERS`` name) whose
#: launch count its CUDA implementation adds to.
WRAPPER: Dict[str, str] = {}


def define(name: str, schema: str, *, wrapper: str, cpu: Callable,
           cuda: Callable, fake: Callable) -> torch._ops.OpOverload:
    """Define ``diff3d_tpu_torch::<name><schema>`` with its CPU, CUDA and
    fake implementations, the CUDA one counting its launches on
    ``wrapper``; returns its overload."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default
    OPS[name] = op
    WRAPPER[name] = wrapper
    return op


def op_name(target) -> str:
    """The op's name if ``target`` (an FX node's target) is one of these
    ops, else ``""``."""
    name = getattr(target, "name", None)
    if not callable(name):
        return ""
    full = name()                                   # "ns::op" or "ns::op.ov"
    ns, _, rest = full.partition("::")
    return rest.split(".")[0] if ns == NAMESPACE else ""
