"""Device-executor engine: continuous batching at view granularity
(counterpart: ``diff3d_tpu/serving/engine.py``).

One thread owns the card.  Its loop is:

    admit pending requests (same bucket) into free lanes
      -> run ONE view's reverse diffusion for every active request
         (one ``Sampler.step_many``: the captured reverse step replayed
         ``steps`` times)
      -> write each lane's view back into its request's record buffer,
         resolve finished requests, free their lanes
      -> repeat

Because admission happens *between* view steps, a freshly submitted
request of the same bucket rides along with an in-flight many-view job at
the very next view boundary instead of waiting behind it —
iteration-level (Orca-style) scheduling where the iteration is a whole
fixed-length reverse loop.

Each request keeps the exact random stream of the offline path: its
slot owns ``torch.Generator(device).manual_seed(seed)`` and takes each
view's draws from it through :class:`~diff3d_tpu_torch.diffusion.Draws`,
as ``Sampler.synthesize_many`` does with the same seed, so a served
result is bit-identical to ``synthesize_many`` over the same lanes (the
lane count decides the batch shape, and with it the kernels' algorithms).
A request may carry its own per-view draw sources instead
(``ViewRequest.draws``).

Batch shapes are quantised: the active set is padded to the next power of
two lanes (<= ``ServingConfig.max_batch``), so each bucket owns a
logarithmic number of captured graphs.  A padding lane repeats lane 0's
record but draws from a throwaway generator of its own: repeating lane
0's generator would advance lane 0's stream twice.  Padding lanes burn
real FLOPs — the occupancy/padding histograms make that waste visible.

The engine keeps each request's record on the HOST and stages the active
set to the card every view step: continuous batching re-forms the lane
set at every view boundary, so per-slot host buffers let a request join
mid-flight without reshuffling device memory.  The fetch of the view
(``.cpu()``) is the step's one synchronisation.  The
``serving_host_{upload,fetch}_bytes_total`` counters measure what crosses
the host boundary.

Only the engine threads touch CUDA.  A capture in the default (global)
error mode is broken by a CUDA call from any other thread, so the HTTP
handlers build requests as numpy arrays, the watchdog only reads
deadlines, and :meth:`ProgramCache.warmup` runs before :meth:`start`.
Several engines on one device (a fleet's replicas) take turns: each view
step (its staging, replays or first-use capture, and fetch) runs under
the device's FIFO turn lock (:func:`device_turns`), so no engine's CUDA
call can fall inside another's capture, and a first use's peak-memory
reading is its own.  Each engine issues its work on a CUDA stream of its
own.

A cascade (:class:`~diff3d_tpu_torch.cascade.CascadeSampler`) adds two
phase samplers reached only through phase-tagged buckets: a
:class:`~diff3d_tpu_torch.cascade.CascadeRequest` never queues itself;
its draft child is queued at submit, and when the draft child retires,
its result chains the refine child (the upsampled drafts) into the
queue, on the engine thread.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diff3d_tpu_torch.config import ServingConfig
from diff3d_tpu_torch.diffusion import Draws
from diff3d_tpu_torch.runtime.retry import (RetryPolicy,
                                           is_transient_backend_error)
from diff3d_tpu_torch.serving.cache import (ParamsRegistry, ProgramCache,
                                           ResultCache)
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.scheduler import (EngineDraining,
                                               EngineOverloaded,
                                               EngineStepError,
                                               EngineStopped,
                                               RequestCancelled,
                                               RequestTimeout, Scheduler,
                                               UnsupportedSchedule,
                                               ViewRequest)
from diff3d_tpu_torch.utils.profiling import StepTimer

log = logging.getLogger(__name__)

#: Engine health states.  ``ok`` -> full capacity; ``degraded`` -> halved
#: batch ceiling, queue soft limit, shed lower-priority buckets,
#: Retry-After on rejected admissions; returns to ``ok`` after
#: ``degraded_recovery_steps`` consecutive clean steps.  ``draining`` ->
#: no new admissions, existing work runs to completion.
HEALTH_OK = "ok"
HEALTH_DEGRADED = "degraded"
HEALTH_DRAINING = "draining"
_HEALTH_GAUGE = {HEALTH_OK: 0, HEALTH_DEGRADED: 1, HEALTH_DRAINING: 2}

#: Seed of the throwaway generators of padding lanes (their views are
#: discarded; any seed will do).
PAD_SEED = 0x5EED


class _Turns:
    """A FIFO lock: waiters enter in the order they asked, so an engine
    that releases and at once asks again cannot starve another."""

    def __init__(self):
        self._cv = threading.Condition()
        self._queue: collections.deque = (
            collections.deque())  # guarded-by: self._cv
        self._held = False  # guarded-by: self._cv

    def __enter__(self) -> "_Turns":
        me = object()
        with self._cv:
            self._queue.append(me)
            while self._held or self._queue[0] is not me:
                self._cv.wait()
            self._queue.popleft()
            self._held = True
        return self

    def __exit__(self, *exc) -> None:
        with self._cv:
            self._held = False
            self._cv.notify_all()


_turns_lock = threading.Lock()
# One turn lock per device for the whole process: the device is
# process-wide, whoever builds the engines on it.
_turns: Dict[Tuple[str, int], _Turns] = {}  # guarded-by: _turns_lock


def device_turns(device: torch.device) -> _Turns:
    """The process-wide turn lock of ``device``, shared by every engine
    that runs on it (see the module docstring)."""
    key = (device.type, 0 if device.index is None else device.index)
    with _turns_lock:
        return _turns.setdefault(key, _Turns())


class EngineStopTimeout(RuntimeError):
    """``Engine.stop(timeout)`` could not join the worker thread — it is
    leaked (most likely wedged in a device call).  Operator-facing and
    NOT retryable: the process needs external attention."""


def lane_count(n: int, max_batch: int, multiple: int = 1) -> int:
    """Launch lanes for ``n`` live requests: smallest power of two >= n,
    rounded up to ``multiple`` (the sampler's mesh quantum, 1 without a
    mesh), clamped to ``max_batch``."""
    if not n:
        return 0
    lanes = 1 << (n - 1).bit_length()
    lanes = -(-lanes // multiple) * multiple
    return min(lanes, max_batch)


class _Slot:
    """Engine-side state of one admitted request (built on the engine
    thread: its generator lives on the card)."""

    def __init__(self, req: ViewRequest, guidance_B: int,
                 device: torch.device):
        self.req = req
        cap = req.bucket.capacity
        H, W = req.bucket.H, req.bucket.W
        self.record_imgs = np.zeros((cap, guidance_B, H, W, 3), np.float32)
        self.record_R = np.zeros((cap, 3, 3), np.float32)
        self.record_T = np.zeros((cap, 3), np.float32)
        self.record_imgs[0] = req.imgs0[None]
        # All poses pre-filled: entry ``step`` doubles as the target pose
        # of the view being synthesised (the stochastic-conditioning draw
        # reads only entries < step).
        self.record_R[:req.n_views] = req.R[:req.n_views]
        self.record_T[:req.n_views] = req.T[:req.n_views]
        self.step = 1                       # next view index to synthesise
        self.draws = req.draws
        # A cascade phase child runs its own stream of the request seed.
        seed = getattr(req, "stream_seed", req.seed)
        self.gen = (torch.Generator(device).manual_seed(seed)
                    if self.draws is None else None)
        # Refine-phase children carry the [n_views-1, B, H, W, 3]
        # upsampled drafts their truncated loops renoise from.
        self.drafts = getattr(req, "drafts", None)
        self.outs: List[np.ndarray] = []

    def view_draws(self):
        """The draw source of the view this slot synthesises next."""
        if self.draws is not None:
            return self.draws[self.step - 1]
        return Draws(self.gen)


class Engine:
    """Single consumer of the :class:`Scheduler`; owner of device work.

    ``extra_samplers`` maps ``(sampler_kind, steps)`` to further samplers
    over the same model (the replica's extra schedules); ``cascade`` is an
    optional :class:`~diff3d_tpu_torch.cascade.CascadeSampler` over the
    same model.  On the card every sampler's graphs, the cascade's too,
    are captured into one memory pool of this engine's own.
    """

    def __init__(self, sampler, scheduler: Scheduler,
                 metrics: MetricsRegistry, cfg: ServingConfig,
                 params_registry: Optional[ParamsRegistry] = None,
                 result_cache: Optional[ResultCache] = None,
                 program_cache: Optional[ProgramCache] = None,
                 extra_samplers: Optional[dict] = None,
                 cascade=None):
        self.sampler = sampler
        self.scheduler = scheduler
        self.metrics = metrics
        self.cfg = cfg
        # Schedule registry: the replica serves exactly these
        # (sampler_kind, steps) pairs, one Sampler each, all over the
        # default sampler's model (the registry's swaps reach them all).
        # Other schedules are rejected at submit with UnsupportedSchedule;
        # graphs are never captured on client demand.
        self.default_schedule = (sampler.sampler_kind, sampler.steps)
        self.samplers = {self.default_schedule: sampler}
        for key, extra in (extra_samplers or {}).items():
            kind, steps = key
            if extra.model is not sampler.model:
                raise ValueError(
                    f"extra sampler {key}: not the default sampler's model "
                    "— a weight swap must reach every schedule")
            if extra.lane_multiple != sampler.lane_multiple:
                raise ValueError(
                    f"extra sampler {key}: lane_multiple differs from the "
                    "default sampler's — all schedules must share a mesh")
            self.samplers[(kind, int(steps))] = extra
        self.device = sampler.device
        # Cascade serving: the two phase samplers are reached only
        # through phase-tagged buckets, never through the (kind, steps)
        # schedule registry, so plain clients cannot address them.
        self.cascade = cascade
        phase_samplers = []
        if cascade is not None:
            if cascade.refine.model is not sampler.model:
                raise ValueError(
                    "cascade: its refine sampler is not over the default "
                    "sampler's model — the served model IS the refine "
                    "phase")
            phase_samplers = [cascade.draft, cascade.refine]
        if sampler.cuda_graphs:
            pool = torch.cuda.graph_pool_handle()
            for s in list(self.samplers.values()) + phase_samplers:
                s.graph_pool = pool
        self.num_devices = (torch.cuda.device_count()
                            if self.device.type == "cuda" else 1)
        self.registry = params_registry or ParamsRegistry(sampler.model)
        self.result_cache = result_cache or ResultCache(
            cfg.result_cache_entries, metrics)
        self.programs = program_cache or ProgramCache(
            self.samplers if len(self.samplers) > 1 else sampler, metrics)
        if cascade is not None:
            # The draft shares the served weights but for its resized
            # pos_emb, which a swap leaves stale: refreshed in place
            # before the draft's first step after each applied swap.
            self.programs.register_phase("draft", cascade.draft,
                                         adapt=cascade.refresh_draft)
            self.programs.register_phase("refine", cascade.refine)
        self.turns = device_turns(self.device)
        self.guidance_B = int(sampler.w.shape[0])
        self.lane_multiple = int(sampler.lane_multiple)
        self.max_batch = (-(-cfg.max_batch // self.lane_multiple)
                          * self.lane_multiple)
        self.step_timer = StepTimer(window=512)
        self._last_version = self.registry.version

        m = metrics
        self._submitted = m.counter("serving_requests_total",
                                    "requests accepted for scheduling")
        self._completed = m.counter("serving_requests_completed_total",
                                    "requests finished successfully")
        self._failed = m.counter("serving_requests_failed_total",
                                 "requests resolved with an error")
        self._views_done = m.counter("serving_views_completed_total",
                                     "novel views synthesised")
        self._active_g = m.gauge("serving_active_requests",
                                 "requests currently holding a lane")
        self._occupancy = m.histogram(
            "serving_batch_occupancy",
            "live requests per launched view-step batch")
        self._padding = m.histogram(
            "serving_batch_padding_fraction",
            "fraction of launched lanes that were padding")
        self._ttfv = m.histogram(
            "serving_time_to_first_view_seconds",
            "submit -> first synthesised view")
        self._view_lat = m.histogram("serving_view_step_seconds",
                                     "wall time of one view-step batch")
        self._e2e = m.histogram("serving_e2e_latency_seconds",
                                "submit -> full result")
        self._queue_wait = m.histogram("serving_queue_wait_seconds",
                                       "submit -> admission to a lane")
        self._upload_bytes = m.counter(
            "serving_host_upload_bytes_total",
            "host->device bytes staged for view-step batches")
        self._fetch_bytes = m.counter(
            "serving_host_fetch_bytes_total",
            "device->host bytes fetched from view-step batches")
        self._step_faults = m.counter(
            "serving_engine_step_faults_total",
            "view-step dispatches that failed after retries")
        self._watchdog_trips = m.counter(
            "serving_engine_watchdog_trips_total",
            "stuck view steps detected by the watchdog")
        self._restarts_ctr = m.counter(
            "serving_engine_restarts_total",
            "engine loop threads respawned after dying")
        self._stop_timeouts = m.counter(
            "serving_engine_stop_timeout_total",
            "stop() calls that leaked the worker thread")
        self._sched_rejects = m.counter(
            "serving_unsupported_schedule_total",
            "submissions naming a (sampler_kind, steps) with no sampler")
        self._traj_requests = m.counter(
            "serving_trajectory_requests_total",
            "trajectory (camera-path) requests accepted for scheduling")
        self._traj_frames = m.counter(
            "serving_trajectory_frames_total",
            "trajectory frames committed to records")
        self._traj_active_g = m.gauge(
            "serving_active_trajectories",
            "trajectory requests admitted but not yet resolved")
        self._cascade_requests = m.counter(
            "serving_cascade_requests_total",
            "cascade (progressive-preview) requests accepted")
        self._cascade_frames = m.counter(
            "serving_cascade_frames_total",
            "cascade phase frames committed (draft + refine)")
        self._health_g = m.gauge(
            "serving_engine_health",
            "engine health (0=ok, 1=degraded, 2=draining)")

        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._stop = threading.Event()

        # Transient-fault retry around each view step.  Its inputs are
        # restaged from the host records and the slots' generators are
        # put back to their state before the step, so a retry is
        # bit-exact; real errors (and CUDA's sticky ones) are classified
        # non-retryable and surface at once.
        self.step_policy = RetryPolicy(
            max_attempts=max(1, cfg.step_retry_attempts),
            base_delay_s=cfg.step_retry_backoff_s,
            max_delay_s=max(cfg.step_retry_backoff_s * 8, 1e-9),
            classify=is_transient_backend_error)
        self._health = HEALTH_OK  # guarded-by: self._health_lock
        self._health_lock = threading.Lock()
        # Clean steps since the last fault.
        self._ok_streak = 0  # guarded-by: self._health_lock
        self._restarts = 0
        # Admitted-but-unresolved requests, so the watchdog thread can
        # fail them with typed retryable errors when the loop wedges.
        self._inflight: dict = {}  # guarded-by: self._inflight_lock
        self._inflight_lock = threading.Lock()
        # Monotonic deadline of the step currently on the card (None when
        # none is running); read by the watchdog.
        self._step_deadline: Optional[float] = None

    # -- client surface --------------------------------------------------

    def supported_schedules(self) -> List[str]:
        """Sorted ``"kind:steps"`` strings this replica can serve."""
        return sorted(f"{k[0]}:{k[1]}" for k in self.samplers)

    def supports_schedule(self, sampler_kind: Optional[str] = None,
                          steps: Optional[int] = None) -> bool:
        """Would :meth:`submit` accept this ``(sampler_kind, steps)``?
        ``None`` fields resolve to the replica default."""
        kind = (sampler_kind if sampler_kind is not None
                else self.default_schedule[0])
        steps = steps if steps is not None else self.default_schedule[1]
        return (kind, int(steps)) in self.samplers

    def submit(self, req: ViewRequest) -> ViewRequest:
        """Schedule a request (or answer it from the result cache).

        ``None`` schedule fields take the replica default; a
        ``(sampler_kind, steps)`` outside the schedule registry raises
        :class:`UnsupportedSchedule` (typed retryable, carrying the
        supported list).
        """
        kind = (req.sampler_kind if req.sampler_kind is not None
                else self.default_schedule[0])
        steps = (req.steps if req.steps is not None
                 else self.default_schedule[1])
        if (kind, steps) not in self.samplers:
            self._sched_rejects.inc()
            raise UnsupportedSchedule(
                f"{req.id}: schedule {kind}:{steps} has no sampler on this "
                f"replica (supported: "
                f"{', '.join(self.supported_schedules())})",
                supported=self.supported_schedules(),
                retry_after_s=self.cfg.retry_after_s)
        req.resolve_schedule(kind, steps)
        if req.draws is None:
            hit = self.result_cache.get(
                req.content_key(self.registry.version))
            if hit is not None:
                req.cached = True
                req.submit_time = req.done_time = time.monotonic()
                req._resolve(hit)
                return req
        self._submitted.inc()
        if req.is_trajectory:
            self._traj_requests.inc()
        return self.scheduler.submit(req)

    def supports_cascade(self, plan_spec: Optional[str] = None) -> bool:
        """Would :meth:`submit_cascade` accept a request?  With a plan
        spec, the replica must serve exactly that plan (cascade samplers
        are built at boot, never on client demand)."""
        if self.cascade is None:
            return False
        return (plan_spec is None
                or plan_spec == self.cascade.plan.spec())

    def submit_cascade(self, req) -> ViewRequest:
        """Schedule a :class:`~diff3d_tpu_torch.cascade.CascadeRequest`.

        The parent never queues; its draft child is submitted now under
        the ``(draft_resolution, "draft")`` bucket, and when every draft
        view has resolved the refine child — carrying the upsampled
        drafts — is chained in under ``(H, "refine")`` (the chaining
        callback runs on the engine thread at the draft's retire).  The
        parent resolves with the refine child's result; any child
        failure rejects the parent.
        """
        if self.cascade is None:
            raise UnsupportedSchedule(
                f"{req.id}: this replica serves no cascade plan",
                supported=self.supported_schedules(),
                retry_after_s=self.cfg.retry_after_s)
        if req.plan.spec() != self.cascade.plan.spec():
            raise UnsupportedSchedule(
                f"{req.id}: cascade plan {req.plan.spec()} does not "
                f"match the replica's {self.cascade.plan.spec()}",
                supported=[self.cascade.plan.spec()],
                retry_after_s=self.cfg.retry_after_s)

        def chain_refine(draft_result: np.ndarray) -> None:
            # Runs on the engine thread inside the draft child's
            # _resolve; a submit failure propagates back into the
            # child's resolve hook, which rejects the parent.
            self.scheduler.submit(req.make_refine_child(draft_result))

        draft = req.make_draft_child(chain_refine)
        self._submitted.inc()
        self._cascade_requests.inc()
        req.submit_time = time.monotonic()
        try:
            self.scheduler.submit(draft)
        except BaseException as e:
            req._reject(e)
            raise
        return req

    def start(self) -> "Engine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="diff3d-serving-engine",
                                        daemon=True)
        self._thread.start()
        if self.cfg.watchdog_timeout_s > 0 and self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop,
                name="diff3d-serving-watchdog", daemon=True)
            self._watchdog.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the engine, joining the worker within ``timeout``.

        A worker that fails to exit (wedged in a device call) is a
        LEAKED thread: ``serving_engine_stop_timeout_total`` is bumped
        and :class:`EngineStopTimeout` is raised.
        """
        self._stop.set()
        self.scheduler.close(reject_pending=True)
        thread, self._thread = self._thread, None
        watchdog, self._watchdog = self._watchdog, None
        if watchdog is not None:
            watchdog.join(timeout=5.0)
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                self._stop_timeouts.inc()
                self._reject_inflight(EngineStopped(
                    "engine stopped with the worker thread wedged"))
                raise EngineStopTimeout(
                    f"engine worker {thread.name!r} did not exit within "
                    f"{timeout}s — thread leaked (likely wedged in a "
                    "device call)")

    def drain(self, timeout: Optional[float] = 30.0,
              poll_s: float = 0.05) -> bool:
        """Graceful rollout/shutdown: stop admitting, finish everything.

        Health moves to ``draining`` and new submissions are rejected
        with :class:`EngineDraining`.  Blocks until the queue and all
        in-flight work are resolved, up to ``timeout`` (None = wait
        forever).  Returns True once empty; the caller then calls
        :meth:`stop`.
        """
        self._set_health(HEALTH_DRAINING)
        self.scheduler.freeze(lambda: EngineDraining(
            "replica draining for shutdown/rollout: retry elsewhere",
            retry_after_s=self.cfg.retry_after_s))
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while self.scheduler.depth() or self._inflight_count():
            if not self.alive:
                break            # nothing will make progress; report below
            if deadline is not None and time.monotonic() > deadline:
                log.warning(
                    "drain timed out with %d queued / %d in flight",
                    self.scheduler.depth(), self._inflight_count())
                return False
            time.sleep(poll_s)
        drained = not (self.scheduler.depth() or self._inflight_count())
        log.info("drain complete" if drained else "drain incomplete")
        return drained

    def resume(self) -> None:
        """Re-admit after :meth:`drain`: lift the drain freeze and any
        degraded soft limit, and return health to ``ok``."""
        self.scheduler.unfreeze()
        self.scheduler.clear_soft_limit()
        with self._health_lock:
            self._ok_streak = 0
        self._set_health(HEALTH_OK)

    def kill(self, exc: BaseException) -> None:
        """Hard, non-blocking stop: the stop flag is set, queued requests
        are rejected by the scheduler close, and in-flight requests
        resolve with ``exc`` at once.  Safe from any thread, the engine
        loop included."""
        self._stop.set()
        self.scheduler.close(reject_pending=True)
        n = self._reject_inflight(exc)
        log.warning("engine killed (%s); rejected %d in-flight requests",
                    exc, n)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def health(self) -> str:
        with self._health_lock:
            return self._health

    def snapshot_extra(self, include_memory: bool = False) -> dict:
        """Engine-level details merged into the metrics snapshot;
        ``include_memory`` adds each program's recorded bytes.  Host
        reads only."""
        return {
            "engine": {
                "alive": self.alive,
                "health": self.health,
                "restarts": self._restarts,
                "params_version": self.registry.version,
                "lane_multiple": self.lane_multiple,
                "max_batch": self.max_batch,
                "effective_max_batch": self._effective_max_batch(),
                "num_devices": self.num_devices,
                "step_timer": self.step_timer.summary(),
                "program_cache": self.programs.stats(
                    include_memory=include_memory),
                "result_cache_entries": len(self.result_cache),
                "default_schedule": (
                    f"{self.default_schedule[0]}:{self.default_schedule[1]}"),
                "supported_schedules": self.supported_schedules(),
                "cascade": (self.cascade.plan.spec()
                            if self.cascade is not None else None),
                "trajectories": self.trajectory_progress(),
            }
        }

    # -- health machinery ------------------------------------------------

    def _set_health(self, state: str) -> None:
        with self._health_lock:
            if self._health == state:
                return
            log.warning("engine health: %s -> %s", self._health, state)
            self._health = state
            self._health_g.set(_HEALTH_GAUGE[state])

    def _effective_max_batch(self) -> int:
        """Batch ceiling under the current health: degraded mode halves
        it (rounded up to the mesh quantum)."""
        with self._health_lock:
            degraded = self._health == HEALTH_DEGRADED
        if not degraded:
            return self.max_batch
        half = max(1, self.max_batch // 2)
        half = -(-half // self.lane_multiple) * self.lane_multiple
        return min(half, self.max_batch)

    def _note_fault(self, reason: str) -> None:
        """A step failed or stuck: degrade (unless draining) and shed."""
        self._step_faults.inc()
        with self._health_lock:
            self._ok_streak = 0
            draining = self._health == HEALTH_DRAINING
            was_ok = self._health == HEALTH_OK
        if draining or not was_ok:
            return
        self._set_health(HEALTH_DEGRADED)
        shed = self.scheduler.shed(
            lambda req: EngineOverloaded(
                f"{req.id}: shed while replica degrades ({reason}); "
                "retry later",
                retry_after_s=self.cfg.retry_after_s))
        self.scheduler.set_soft_limit(
            max(1, self.scheduler.max_queue // 4),
            lambda: EngineOverloaded(
                "replica degraded: admission reduced; retry later",
                retry_after_s=self.cfg.retry_after_s))
        log.warning("engine degraded (%s); shed %d queued requests",
                    reason, shed)

    def _note_step_ok(self) -> None:
        with self._health_lock:
            degraded = self._health == HEALTH_DEGRADED
            if degraded:
                self._ok_streak += 1
                recovered = (self._ok_streak
                             >= self.cfg.degraded_recovery_steps)
            else:
                recovered = False
        if recovered:
            self.scheduler.clear_soft_limit()
            self._set_health(HEALTH_OK)
            log.info("engine recovered: %d consecutive clean steps",
                     self.cfg.degraded_recovery_steps)

    # -- in-flight registry (shared with the watchdog) -------------------

    def _register(self, req: ViewRequest) -> None:
        with self._inflight_lock:
            self._inflight[req.id] = req
            self._traj_active_g.set(sum(
                1 for r in self._inflight.values() if r.is_trajectory))

    def _unregister(self, req: ViewRequest) -> None:
        with self._inflight_lock:
            self._inflight.pop(req.id, None)
            self._traj_active_g.set(sum(
                1 for r in self._inflight.values() if r.is_trajectory))

    def _inflight_count(self) -> int:
        with self._inflight_lock:
            return len(self._inflight)

    def inflight(self) -> int:
        """Admitted-but-unresolved requests."""
        return self._inflight_count()

    def trajectory_progress(self) -> List[dict]:
        """Progress of admitted-but-unresolved trajectory requests, read
        from each request's own frame buffer (safe from any thread)."""
        with self._inflight_lock:
            trajs = [r for r in self._inflight.values() if r.is_trajectory]
        return [{
            "id": r.id,
            "session_id": r.session_id,
            "frames_done": r.frames_done(),
            "n_frames": r.n_frames,
        } for r in trajs]

    def _reject_inflight(self, exc: BaseException) -> int:
        with self._inflight_lock:
            reqs, self._inflight = list(self._inflight.values()), {}
        for req in reqs:
            self._failed.inc()
            req._reject(exc)
        return len(reqs)

    # -- watchdog --------------------------------------------------------

    def _watchdog_loop(self) -> None:
        """Detect a stuck step or a dead loop thread and keep the
        replica's contract: every admitted request resolves, with a
        typed retryable error if nothing better is possible.  Touches no
        device state."""
        poll = max(0.05, min(0.25, self.cfg.watchdog_timeout_s / 4.0))
        while not self._stop.wait(poll):
            deadline = self._step_deadline
            if deadline is not None and time.monotonic() > deadline:
                # Clear the deadline first so one stuck step trips once;
                # degrade before failing the in-flight requests, so a
                # client woken by the failure sees the degraded state.
                self._step_deadline = None
                self._watchdog_trips.inc()
                self._note_fault("stuck view step")
                n = self._reject_inflight(EngineStepError(
                    f"view step stuck > {self.cfg.watchdog_timeout_s}s "
                    "(watchdog); retry later",
                    retry_after_s=self.cfg.retry_after_s))
                log.error("watchdog: stuck view step; failed %d "
                          "in-flight requests", n)
            thread = self._thread
            if (thread is not None and not thread.is_alive()
                    and not self._stop.is_set()):
                n = self._reject_inflight(EngineStepError(
                    "engine loop died; retry later",
                    retry_after_s=self.cfg.retry_after_s))
                self._note_fault("engine loop died")
                if self._restarts < self.cfg.engine_max_restarts:
                    self._restarts += 1
                    self._restarts_ctr.inc()
                    log.error(
                        "watchdog: engine loop died (%d in flight); "
                        "respawning (restart %d/%d)", n, self._restarts,
                        self.cfg.engine_max_restarts)
                    self._thread = threading.Thread(
                        target=self._loop, name="diff3d-serving-engine",
                        daemon=True)
                    self._thread.start()
                else:
                    log.critical(
                        "watchdog: engine loop died and the restart "
                        "budget (%d) is exhausted; failing fast",
                        self.cfg.engine_max_restarts)
                    self.scheduler.freeze(lambda: EngineStopped(
                        "engine loop dead (restart budget exhausted)"))
                    return           # nothing left to watch

    # -- executor loop ---------------------------------------------------

    def _loop(self) -> None:
        if self.device.type == "cuda":
            with self.turns:
                stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                self._serve()
        else:
            self._serve()

    def _serve(self) -> None:
        active: List[_Slot] = []
        try:
            while not self._stop.is_set():
                active = self._admit(active)
                if not active:
                    continue
                try:
                    self._run_view_step(active)
                except Exception as e:   # resolve, don't kill the server
                    log.exception("view step failed (after retries)")
                    self._note_fault(str(e).splitlines()[0][:120]
                                     if str(e) else type(e).__name__)
                    for slot in active:
                        self._failed.inc()
                        self._unregister(slot.req)
                        slot.req._reject(EngineStepError(
                            f"{slot.req.id}: view step failed ({e}); "
                            "retry later",
                            retry_after_s=self.cfg.retry_after_s))
                    active = []
                    self._active_g.set(0)
                    continue
                self._note_step_ok()
                active = self._retire(active)
        finally:
            for slot in active:
                self._unregister(slot.req)
                slot.req._reject(EngineStopped(
                    f"{slot.req.id}: engine stopped"))
            self._active_g.set(0)

    def _admit(self, active: List[_Slot]) -> List[_Slot]:
        # Drop slots whose request was resolved out from under the loop
        # (watchdog rejection, client cancel racing completion).
        done = [s for s in active if s.req.done()]
        if done:
            for slot in done:
                self._unregister(slot.req)
            active = [s for s in active if not s.req.done()]
        limit = self._effective_max_batch()
        free = limit - len(active)
        if active:
            got = self.scheduler.acquire(active[0].req.bucket, free,
                                         block=False) if free > 0 else []
        else:
            got = self.scheduler.acquire(None, limit,
                                         block=True, poll_s=0.2)
        now = time.monotonic()
        for req in got:
            self._queue_wait.observe(now - req.submit_time)
            self._register(req)
            active.append(_Slot(req, self.guidance_B, self.device))
        if got or done or not active:
            self._active_g.set(len(active))
        return active

    def _run_view_step(self, active: List[_Slot]) -> None:
        n = len(active)
        lanes = lane_count(n, self.max_batch, self.lane_multiple)
        pad = lanes - n
        # Padding lanes repeat lane 0's record (live data: zero-filled
        # lanes would still run the whole loop, and denormal/NaN paths
        # can be slower) with draws of their own; their views are
        # discarded.
        idx = list(range(n)) + [0] * pad
        record_imgs = np.stack([active[i].record_imgs for i in idx])
        record_R = np.stack([active[i].record_R for i in idx])
        record_T = np.stack([active[i].record_T for i in idx])
        steps = [active[i].step for i in idx]
        Ks = np.stack([active[i].req.K for i in idx])
        self._upload_bytes.inc(record_imgs.nbytes + record_R.nbytes
                               + record_T.nbytes + Ks.nbytes)
        bucket = active[0].req.bucket
        # Refine-phase batches add the per-lane draft operand: lane i's
        # upsampled draft of the view it synthesises now (slot.step is
        # 1-based; drafts index 0 is view 1).
        drafts = None
        if bucket.phase == "refine":
            drafts = np.stack([active[i].drafts[active[i].step - 1]
                               for i in idx])
            self._upload_bytes.inc(drafts.nbytes)
        saved = [(s.gen, s.gen.get_state()) for s in active
                 if s.gen is not None]
        device = self.device

        def _dispatch():
            # Arm the watchdog per attempt: a retry gets a fresh step
            # budget, and the deadline is cleared even on failure so the
            # backoff sleep can't be mistaken for a stuck device.  The
            # device turn is taken per attempt too, never across the
            # backoff.
            with self.turns:
                if self.cfg.watchdog_timeout_s > 0:
                    self._step_deadline = (time.monotonic()
                                           + self.cfg.watchdog_timeout_s)
                try:
                    for gen, state in saved:  # a retry redraws the same
                        gen.set_state(state)
                    draws = [s.view_draws() for s in active] + [
                        Draws(torch.Generator(device).manual_seed(PAD_SEED))
                        for _ in range(pad)]
                    out, _, _ = self.programs.step_many(
                        bucket, lanes,
                        torch.from_numpy(record_imgs).to(device),
                        torch.from_numpy(record_R).to(device),
                        torch.from_numpy(record_T).to(device), steps,
                        torch.from_numpy(Ks).to(device), draws,
                        drafts=(None if drafts is None
                                else torch.from_numpy(drafts).to(device)),
                        generation=self.registry.applied)
                    return out[:n].cpu().numpy()  # the step's one sync
                finally:
                    self._step_deadline = None

        # One weights version per view step: a staged swap lands here,
        # between steps, and never inside one.
        with self.turns:
            version = self.registry.apply()
        t0 = time.monotonic()

        out = self.step_policy.call(_dispatch,
                                    describe=f"view step {bucket}")
        dt = time.monotonic() - t0
        self._fetch_bytes.inc(out.nbytes)
        self.step_timer.tick()
        self._view_lat.observe(dt)
        self._occupancy.observe(n)
        self._padding.observe(pad / lanes if lanes else 0.0)
        self._views_done.inc(n)

        now = time.monotonic()
        for i, slot in enumerate(active):
            view = out[i]
            slot.record_imgs[slot.step] = view
            slot.outs.append(view)
            if slot.req.first_view_time is None:
                slot.req.first_view_time = now
                self._ttfv.observe(now - slot.req.submit_time)
            # Per-view commit hook: streams the frame to a trajectory
            # client the moment it lands in the record (no-op for plain
            # view requests).
            slot.req._commit_frame(slot.step, view)
            if slot.req.is_trajectory:
                self._traj_frames.inc()
            if bucket.phase is not None:
                self._cascade_frames.inc()
            slot.step += 1
        # Remember the version for the result-cache key of requests that
        # finish this step.
        self._last_version = version

    def _retire(self, active: List[_Slot]) -> List[_Slot]:
        still: List[_Slot] = []
        now = time.monotonic()
        for slot in active:
            req = slot.req
            if req.done():            # resolved elsewhere (watchdog/cancel)
                self._unregister(req)
                continue
            if req.cancelled:
                self._failed.inc()
                req._reject(RequestCancelled(f"{req.id}: cancelled"))
            elif req.expired(now):
                self._failed.inc()
                req._reject(RequestTimeout(
                    f"{req.id}: deadline exceeded mid-run at view "
                    f"{slot.step - 1}/{req.n_views - 1}"))
            elif slot.step >= req.n_views:
                result = np.stack(slot.outs)
                if req.draws is None:
                    self.result_cache.put(
                        req.content_key(self._last_version), result)
                self._completed.inc()
                self._e2e.observe(now - req.submit_time)
                req._resolve(result)
            else:
                still.append(slot)
                continue
            self._unregister(req)     # resolved or rejected above
        if len(still) != len(active):
            self._active_g.set(len(still))
        return still
