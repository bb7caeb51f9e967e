"""Attention core with backend dispatch (counterpart:
``diff3d_tpu/ops/attention.py``).

The softmax(QK^T)V core is registered with
:mod:`diff3d_tpu_torch.ops.dispatch`: ``"cuda"`` is the hand-written flash
kernel (:mod:`diff3d_tpu_torch.ops.cuda_attention`), ``"torch"`` its plain
version.  Shapes are ``[B, L, n_heads, head_dim]`` as in the JAX package.
``impl`` may also name a sequence-parallel core, ``'ring:<axis>'`` or
``'ulysses:<axis>'`` (:mod:`diff3d_tpu_torch.parallel.ring_attention`):
q/k/v are then this rank's token shards of a sequence split over mesh axis
``<axis>`` of the current mesh (:func:`~diff3d_tpu_torch.parallel.
make_mesh`), whose process group the name resolves to.
"""

from __future__ import annotations

import torch

from diff3d_tpu_torch.ops import dispatch
from diff3d_tpu_torch.ops.cuda_attention import (attention_reference,
                                                 flash_attention, supports)

dispatch.register("sdpa", "cuda", flash_attention, supports=supports)
dispatch.register("sdpa", "torch", attention_reference)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str = "cuda") -> torch.Tensor:
    """Scaled dot-product attention over ``[B, L, H, D]`` tensors."""
    if ":" in impl:
        from diff3d_tpu_torch.parallel import (axis_group, ring_sdpa,
                                               ulysses_sdpa)

        kind, _, axis = impl.partition(":")
        fn = {"ring": ring_sdpa, "ulysses": ulysses_sdpa}[kind]
        return fn(q, k, v, axis_group(axis))
    return dispatch.dispatch("sdpa", impl, q, k, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, impl: str = "cuda") -> torch.Tensor:
    """Splits projected ``[B, L, C]`` q/k/v into heads (views, no copy),
    runs sdpa, merges heads back to ``[B, Lq, C]``."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    D = C // num_heads
    out = sdpa(q.view(B, Lq, num_heads, D), k.view(B, Lk, num_heads, D),
               v.view(B, Lk, num_heads, D), impl=impl)
    return out.reshape(B, Lq, C)
