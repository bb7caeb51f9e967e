"""Cascade plans (counterpart: ``diff3d_tpu/cascade``).  The service
parses and refuses a plan with :class:`CascadePlan`; the cascade sampler
and request wait for ROADMAP A9b."""

from diff3d_tpu_torch.cascade.plan import CascadePlan, PhaseSpec

__all__ = ["CascadePlan", "PhaseSpec"]
