"""Batched novel-view inference service, one engine on one card
(counterpart: ``diff3d_tpu/serving``).

Turns the offline :class:`diff3d_tpu_torch.sampling.Sampler` into a
long-running service: a bounded scheduler microbatches concurrent
requests into fixed-shape device batches (bucketed by image size and
record capacity), one engine thread drives the object-batched view step
(each a captured CUDA graph replayed per reverse step on the card) and
admits new requests *between* views, and a stdlib HTTP frontend exposes
submit/poll, health and metrics endpoints.  The fleet router, the
cross-process workers and cascades are ROADMAP A9b.
"""

from diff3d_tpu_torch.serving.cache import (ParamsRegistry, ProgramCache,
                                           ResultCache)
from diff3d_tpu_torch.serving.engine import (HEALTH_DEGRADED,
                                            HEALTH_DRAINING, HEALTH_OK,
                                            Engine, EngineStopTimeout,
                                            lane_count)
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.scheduler import (Bucket, EngineDraining,
                                               EngineOverloaded,
                                               EngineStepError,
                                               EngineStopped,
                                               QueueFullError,
                                               RequestCancelled,
                                               RequestTimeout, Scheduler,
                                               TrajectoryRequest,
                                               UnsupportedSchedule,
                                               ViewRequest)
from diff3d_tpu_torch.serving.server import (ServingService, build_request,
                                            build_trajectory_request,
                                            make_http_server)

__all__ = [
    "Bucket", "Engine", "EngineDraining", "EngineOverloaded",
    "EngineStepError", "EngineStopTimeout", "EngineStopped",
    "HEALTH_DEGRADED", "HEALTH_DRAINING", "HEALTH_OK", "MetricsRegistry",
    "ParamsRegistry", "ProgramCache", "QueueFullError", "RequestCancelled",
    "RequestTimeout", "ResultCache", "Scheduler", "ServingService",
    "TrajectoryRequest", "UnsupportedSchedule", "ViewRequest",
    "build_request", "build_trajectory_request", "lane_count",
    "make_http_server",
]
