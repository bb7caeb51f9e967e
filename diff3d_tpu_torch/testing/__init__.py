"""Test support: deterministic fault injection (counterpart:
``diff3d_tpu/testing``)."""

from diff3d_tpu_torch.testing.faults import (FaultInjected, FaultInjector,
                                            FaultSpec, arm_replica,
                                            replica_site, wrap_iter,
                                            wrap_sampler)

__all__ = ["FaultInjected", "FaultInjector", "FaultSpec", "arm_replica",
           "replica_site", "wrap_iter", "wrap_sampler"]
