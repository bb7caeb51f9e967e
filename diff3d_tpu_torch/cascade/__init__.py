"""Cascades: a low-resolution draft feeding a truncated high-resolution
refinement (counterpart: ``diff3d_tpu/cascade``)."""

from diff3d_tpu_torch.cascade.plan import CascadePlan, PhaseSpec
from diff3d_tpu_torch.cascade.sampler import (CascadeSampler,
                                              downsample_views, phase_seed,
                                              upsample_draft)
from diff3d_tpu_torch.cascade.request import CascadeRequest

__all__ = [
    "CascadePlan",
    "CascadeRequest",
    "CascadeSampler",
    "PhaseSpec",
    "downsample_views",
    "phase_seed",
    "upsample_draft",
]
