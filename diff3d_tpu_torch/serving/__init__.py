"""Batched novel-view inference service (counterpart:
``diff3d_tpu/serving``).

Turns the offline :class:`diff3d_tpu_torch.sampling.Sampler` into a
long-running service: a bounded scheduler microbatches concurrent
requests into fixed-shape device batches (bucketed by image size and
record capacity), an engine thread drives the object-batched view step
(each a captured CUDA graph replayed per reverse step on the card) and
admits new requests *between* views, and a stdlib HTTP frontend exposes
submit/poll, health and metrics endpoints.  Above the single engine, the
fleet router (``serving/router.py`` + ``serving/fleet.py``) runs N
replicas behind one front door with session affinity (records never
migrate), typed fleet backpressure, rolling weight rollouts and
schedule-aware placement.  The cross-process fleet
(``serving/transport.py`` + ``serving/worker.py``) puts the same replica
surface behind a socket: each worker runs its replica on a card of its
own, the router fronts it through :class:`RemoteReplica` with zero
placement changes, and memory-budgeted admission rejects at the door
with a typed :class:`ReplicaOverBudget`.  Cascades (``POST /cascade``)
serve a draft and a truncated refinement through the same engines.
"""

from diff3d_tpu_torch.serving.cache import (ParamsRegistry, ProgramCache,
                                           ResultCache)
from diff3d_tpu_torch.serving.engine import (HEALTH_DEGRADED,
                                            HEALTH_DRAINING, HEALTH_OK,
                                            Engine, EngineStopTimeout,
                                            device_turns, lane_count)
from diff3d_tpu_torch.serving.fleet import HEALTH_DEAD, Replica, build_fleet
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.router import FleetService, Router
from diff3d_tpu_torch.serving.scheduler import (Bucket, EngineDraining,
                                               EngineOverloaded,
                                               EngineStepError,
                                               EngineStopped,
                                               FleetOverloaded,
                                               QueueFullError,
                                               ReplicaDraining,
                                               ReplicaOverBudget,
                                               RequestCancelled,
                                               RequestTimeout, Scheduler,
                                               SessionLost,
                                               TrajectoryRequest,
                                               UnsupportedSchedule,
                                               ViewRequest)
from diff3d_tpu_torch.serving.server import (ServingService,
                                            build_cascade_request,
                                            build_request,
                                            build_trajectory_request,
                                            make_http_server)
from diff3d_tpu_torch.serving.transport import (FrameGarbage,
                                               FrameTooLarge,
                                               FrameTruncated,
                                               RemoteReplica,
                                               TransportError)
from diff3d_tpu_torch.serving.worker import (HbmAdmission, Worker,
                                            boot_worker)

__all__ = [
    "Bucket", "Engine", "EngineDraining", "EngineOverloaded",
    "EngineStepError", "EngineStopTimeout", "EngineStopped",
    "FleetOverloaded", "FleetService", "FrameGarbage", "FrameTooLarge",
    "FrameTruncated", "HEALTH_DEAD", "HEALTH_DEGRADED",
    "HEALTH_DRAINING", "HEALTH_OK", "HbmAdmission", "MetricsRegistry",
    "ParamsRegistry", "ProgramCache", "QueueFullError", "RemoteReplica",
    "Replica", "ReplicaDraining", "ReplicaOverBudget", "RequestCancelled",
    "RequestTimeout", "ResultCache", "Router", "Scheduler",
    "ServingService", "SessionLost", "TransportError",
    "TrajectoryRequest", "UnsupportedSchedule", "ViewRequest",
    "Worker", "boot_worker", "build_cascade_request", "build_fleet",
    "build_request", "build_trajectory_request", "device_turns",
    "lane_count", "make_http_server",
]
