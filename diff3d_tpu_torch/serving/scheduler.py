"""Request queue + microbatcher for the inference service (counterpart:
``diff3d_tpu/serving/scheduler.py``, a copy on the port's
``SAMPLER_KINDS``, ``record_capacity`` and ``RetryableError``; a request
may carry its own per-view draw sources, :attr:`ViewRequest.draws`).

Requests are grouped into **shape buckets** ``(H, W, record capacity)`` —
the tuple that determines the captured graph of a view step (the batch
lane count is handled by the engine's power-of-two padding).  Capacity
comes from :func:`diff3d_tpu_torch.sampling.record_capacity`, so a served
request lands on exactly the graph shape the offline sampler would
capture for the same view count.

Scheduling policy (Orca-style iteration-level scheduling, adapted to
fixed-length diffusion scans):
  * the engine asks for work *between view steps*, so a long 20-view job
    never blocks a 1-view job for more than one view's worth of compute;
  * an idle engine blocks until a request arrives, then waits at most
    ``max_wait`` (measured from the oldest pending request's submit time)
    for co-batchable requests before launching underfull;
  * the queue is **bounded**: submissions beyond ``max_queue`` raise
    :class:`QueueFullError` immediately (explicit backpressure, HTTP 429),
    and every request carries a deadline after which it is resolved with
    :class:`RequestTimeout` instead of silently rotting in the queue.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np

from diff3d_tpu_torch.diffusion import SAMPLER_KINDS
from diff3d_tpu_torch.runtime.retry import RetryableError
from diff3d_tpu_torch.sampling.runtime import record_capacity


class Bucket(NamedTuple):
    """Shape key of a captured view-step graph (minus the lane count).

    ``steps`` / ``sampler`` extend the key to the *schedule* of the
    reverse loop: a 16-step DDIM loop and a 256-step ancestral one
    differ in trip count and update rule, so they can never share a
    graph.  ``None`` (the defaults, kept for positional
    compatibility) means "the engine's default schedule" — the engine
    resolves them to concrete values at submit time, before any request
    reaches the scheduler or the program cache.

    ``phase`` extends the key to the cascade's ``(resolution, phase)``
    space: ``"draft"`` runs the low-resolution student schedule,
    ``"refine"`` the truncated high-resolution one.  ``None`` — every
    non-cascade request, and every request of the single-engine service
    — keeps the tuple positionally backward compatible.
    """

    H: int
    W: int
    capacity: int
    steps: Optional[int] = None
    sampler: Optional[str] = None
    phase: Optional[str] = None


class QueueFullError(RuntimeError):
    """Bounded queue is full — request rejected at submit time."""


class RequestTimeout(RuntimeError):
    """Request deadline expired before (or while) running."""


class RequestCancelled(RuntimeError):
    """Request was cancelled by the client before completion."""


# Typed retryable rejections (see diff3d_tpu_torch/runtime/retry.py): the
# request did not fail on its own merits — the *replica* faulted, shed,
# or is going away — so the client (or a future multi-replica router)
# should retry it elsewhere or after `retry_after_s`.

class EngineStepError(RetryableError):
    """A view step failed or stuck; in-flight requests were resolved
    with this instead of hanging their futures."""


class EngineOverloaded(RetryableError):
    """Degraded-mode admission control: shed or rejected to protect the
    replica while it recovers."""


class EngineDraining(RetryableError):
    """Replica is draining for shutdown/rollout; resubmit elsewhere."""


class EngineStopped(RetryableError):
    """Replica stopped before the request could run."""


class UnsupportedSchedule(RetryableError):
    """The request's ``(sampler_kind, steps)`` has no sampler on this
    replica.  Capturing on demand would let clients mint unbounded
    program-cache variants, so the request is rejected with the replica's
    ``supported`` schedules (a list of ``"kind:steps"`` strings) — a
    router can resubmit to a replica that serves the schedule."""

    def __init__(self, msg: str, *,
                 supported: Optional[List[str]] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.supported = list(supported or [])


# Fleet-level typed rejections (serving/router.py).  Same
# taxonomy, one level up: the *fleet*, not a single replica, could not
# place the request right now.

class FleetOverloaded(RetryableError):
    """No eligible replica can admit the request: every replica that
    serves the schedule is full, degraded past its soft limit, draining,
    or dead.  Purely a capacity signal — retry the same request after
    ``retry_after_s``."""


class ReplicaDraining(RetryableError):
    """The session's owning replica is draining (blue/green rollout).
    The device-resident record stays where it is — the session must NOT
    be restarted elsewhere; retry the same session after
    ``retry_after_s`` and it will land on the re-admitted replica."""

    def __init__(self, msg: str, *, replica: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.replica = replica


class SessionLost(RetryableError):
    """The session's owning replica is gone (killed/dead), and the
    device-resident record died with it.  ``replica`` names the lost
    owner.  Retryable in the *session* sense: the client restarts the
    session from its committed views — a bare resubmit of view N would
    condition on state that no longer exists anywhere."""

    def __init__(self, msg: str, *, replica: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.replica = replica


class ReplicaOverBudget(RetryableError):
    """Memory-budgeted admission control (serving/worker.py): admitting
    this request would push the replica's device slice past its HBM
    budget — resident session-record bytes plus the program's peak
    exceed ``hbm_budget_bytes``.  Rejected *at the door*, before any device
    work; purely a capacity signal, so retry after ``retry_after_s``
    (or place the request on a replica with headroom)."""

    def __init__(self, msg: str, *, replica: Optional[str] = None,
                 retry_after_s: Optional[float] = None,
                 budget_bytes: int = 0, resident_bytes: int = 0,
                 program_peak_bytes: int = 0):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.replica = replica
        self.budget_bytes = int(budget_bytes)
        self.resident_bytes = int(resident_bytes)
        self.program_peak_bytes = int(program_peak_bytes)

    @property
    def headroom_bytes(self) -> int:
        """Bytes left under the budget before this request's footprint
        (negative means resident state alone is already over)."""
        return self.budget_bytes - self.resident_bytes


_req_ids = itertools.count()


class ViewRequest:
    """One novel-view synthesis job: autoregressively generate views
    ``1..n_views-1`` of an object from its view-0 image and the target
    poses, with the per-request random stream of ``Sampler.synthesize(
    views, torch.Generator(device).manual_seed(seed))`` (same seed =>
    bit-equal result on the same device and lane count).

    ``views`` is the ``all_views``-style dict: ``imgs [>=1, H, W, 3]``
    (only view 0 is consumed), ``R [n, 3, 3]``, ``T [n, 3]``,
    ``K [3, 3]``.

    ``sampler_kind`` / ``steps`` select the reverse-process schedule;
    ``None`` means "replica default" and is resolved by the engine at
    submit time (:meth:`resolve_schedule`) — a request never queues with
    an unresolved schedule.

    ``session_id`` names the object session this request extends (the
    fleet router's affinity key).  ``None`` = sessionless.  The id does
    not enter :meth:`content_key` — identical inputs produce identical
    results whichever session asked.

    ``draws`` (an attribute, None by default) may hold one draw source
    per generated view (the interface of
    :class:`~diff3d_tpu_torch.diffusion.Draws`) to replay another stream
    in place of the seed's generator; such a request bypasses the result
    cache, whose key knows only the seed.
    """

    def __init__(self, views: dict, seed: int = 0,
                 n_views: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 sampler_kind: Optional[str] = None,
                 steps: Optional[int] = None,
                 session_id: Optional[str] = None):
        imgs = np.asarray(views["imgs"], np.float32)
        R = np.asarray(views["R"], np.float32)
        T = np.asarray(views["T"], np.float32)
        K = np.asarray(views["K"], np.float32)
        if imgs.ndim != 4 or imgs.shape[-1] != 3:
            raise ValueError(f"imgs must be [n, H, W, 3], got {imgs.shape}")
        if R.ndim != 3 or R.shape[-2:] != (3, 3):
            raise ValueError(f"R must be [n, 3, 3], got {R.shape}")
        if T.ndim != 2 or T.shape[-1] != 3:
            raise ValueError(f"T must be [n, 3], got {T.shape}")
        if K.shape != (3, 3):
            raise ValueError(f"K must be [3, 3], got {K.shape}")
        if R.shape[0] != T.shape[0]:
            raise ValueError(
                f"R/T view counts differ: {R.shape[0]} vs {T.shape[0]}")
        avail = R.shape[0]
        self.n_views = avail if n_views is None else min(int(n_views),
                                                         avail)
        if self.n_views < 2:
            raise ValueError(
                f"n_views={self.n_views}: need >= 2 (view 0 conditions, "
                "views 1.. are synthesised)")
        self.imgs0 = imgs[0]
        self.R = R[:self.n_views]
        self.T = T[:self.n_views]
        self.K = K
        self.seed = int(seed)
        self.timeout_s = timeout_s
        if sampler_kind is not None and sampler_kind not in SAMPLER_KINDS:
            raise ValueError(
                f"sampler_kind={sampler_kind!r} not in {SAMPLER_KINDS}")
        if steps is not None:
            steps = int(steps)
            if steps < 1:
                raise ValueError(f"steps={steps} must be >= 1")
        self.sampler_kind = sampler_kind
        self.steps = steps
        self.session_id = None if session_id is None else str(session_id)
        H, W = imgs.shape[1:3]
        self._HW = (H, W)
        self.bucket = Bucket(H, W, record_capacity(self.n_views),
                             steps, sampler_kind)
        self.id = request_id or f"req-{next(_req_ids)}"
        self.draws = None

        self.submit_time: Optional[float] = None
        self.deadline: Optional[float] = None
        self.first_view_time: Optional[float] = None
        self.done_time: Optional[float] = None
        self.cached = False

        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[np.ndarray] = None  # guarded-by: self._lock
        self._error: Optional[BaseException] = None  # guarded-by: self._lock
        self._cancelled = False  # guarded-by: self._lock

    # -- result plumbing ------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        # Read-after-done: _resolve/_reject write under _lock and then
        # Event.set; callers look only after done(), so the Event
        # publish gives the happens-before the lock normally would.
        return self._error  # lockcheck: disable=LC302(happens-before via _event.set)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the result ``[n_views-1, B, H, W, 3]``; raises the
        request's error (:class:`RequestTimeout`, ...) if it failed."""
        if not self._event.wait(timeout):
            raise RequestTimeout(
                f"{self.id}: no result within {timeout}s")
        # Event.wait returned True, so the writes in _resolve/_reject
        # happen-before these reads — no lock needed.
        err = self._error  # lockcheck: disable=LC302(happens-before via _event.wait)
        if err is not None:
            raise err
        return self._result  # lockcheck: disable=LC302(happens-before via _event.wait)

    def _resolve(self, result: np.ndarray) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = result
            self.done_time = time.monotonic()
            self._event.set()

    def _reject(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._error = exc
            self.done_time = time.monotonic()
            self._event.set()

    def cancel(self) -> bool:
        """Best-effort cancel; returns False once the request finished.
        A request already admitted to the engine finishes its in-flight
        view step, then is dropped before the next one."""
        with self._lock:
            if self._event.is_set():
                return False
            self._cancelled = True
        return True

    @property
    def cancelled(self) -> bool:
        # Monotonic flag: a stale False only delays the drop to the
        # scheduler's next sweep.
        return self._cancelled  # lockcheck: disable=LC302(racy read of monotonic flag is benign)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline

    def resolve_schedule(self, sampler_kind: str, steps: int) -> None:
        """Fill in replica defaults and rebuild the bucket with a fully
        concrete schedule.  Called by the engine at submit time, before
        the request can reach the scheduler, result cache, or program
        cache — so every queued request's bucket names the exact captured
        graph that will serve it."""
        self.sampler_kind = str(sampler_kind)
        self.steps = int(steps)
        H, W = self._HW
        self.bucket = Bucket(H, W, record_capacity(self.n_views),
                             self.steps, self.sampler_kind,
                             self.bucket.phase)

    def content_key(self, params_version: str, extra: str = "") -> str:
        """Content hash for the result cache: identical inputs + seed +
        schedule + params version => identical output (the sampler is
        deterministic given the key), so replays can skip the chip
        entirely."""
        h = hashlib.sha256()
        for a in (self.imgs0, self.R, self.T, self.K):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(f"|{self.seed}|{self.n_views}|{self.sampler_kind}"
                 f"|{self.steps}|{params_version}|{extra}".encode())
        return h.hexdigest()

    # -- per-view commit hook (trajectory streaming) ---------------------

    def _commit_frame(self, view_index: int, frame: np.ndarray) -> None:
        """Engine hook, called once per synthesised view right after the
        view step that produced it.  No-op for plain view requests —
        :class:`TrajectoryRequest` overrides it to stream frames to the
        client before the request resolves."""

    @property
    def is_trajectory(self) -> bool:
        return False


class TrajectoryRequest(ViewRequest):
    """A camera-path rendering job: one request = render every pose of a
    trajectory, streaming frames to the client *as they commit* to the
    record instead of only resolving at the end.

    Same device contract as :class:`ViewRequest` — views 1..n_views-1
    synthesised autoregressively from the view-0 conditioning image,
    identical random stream, same Bucket space (so trajectory chunks from
    different objects co-batch with each other and with plain view
    requests through the shared captured step).  What it adds is a
    monotonic frame buffer with its own condition variable: the engine
    calls :meth:`_commit_frame` after each view step, and HTTP handler
    threads block in :meth:`wait_frames` to stream them out (incremental
    poll with ``?from=K``, or chunked NDJSON).

    ``frame k`` (0-based) is synthesised view ``k + 1`` — the
    conditioning view is never echoed back.  Frames arrive strictly in
    commit order; on a result-cache hit (or any resolve that skipped
    the engine) the buffer is backfilled from the full result so the
    streaming surface behaves identically.
    """

    def __init__(self, views: dict, **kwargs):
        super().__init__(views, **kwargs)
        self._frames_lock = threading.Lock()
        self._frames_cv = threading.Condition(self._frames_lock)
        # Committed frames, strictly in order; index k = view k+1.
        self._frames: List[np.ndarray] = []  # guarded-by: self._frames_lock

    @property
    def is_trajectory(self) -> bool:
        return True

    @property
    def n_frames(self) -> int:
        """Frames this trajectory renders (poses past the conditioning
        view)."""
        return self.n_views - 1

    def _commit_frame(self, view_index: int, frame: np.ndarray) -> None:
        with self._frames_cv:
            # The engine commits views in order; anything else would
            # break the autoregressive record, so drop out-of-order
            # duplicates (watchdog rejection racing a late commit).
            if view_index != len(self._frames) + 1:
                return
            self._frames.append(frame)
            self._frames_cv.notify_all()

    def frames_done(self) -> int:
        with self._frames_lock:
            return len(self._frames)

    def frames_since(self, start: int = 0) -> List[np.ndarray]:
        """Committed frames ``start..`` (non-blocking snapshot)."""
        with self._frames_lock:
            return list(self._frames[max(0, int(start)):])

    def wait_frames(self, start: int,
                    timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block until at least one frame past ``start`` is committed
        (or the request resolves), then return frames ``start..``.
        Returns ``[]`` only on timeout or when the request finished with
        ``start`` >= the final frame count; a failed request raises its
        error once every committed frame has been consumed — frames
        that did commit are always deliverable."""
        start = max(0, int(start))
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._frames_cv:
            while len(self._frames) <= start and not self._event.is_set():
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self._frames_cv.wait(remaining)
            got = list(self._frames[start:])
        if not got and self._event.is_set():
            err = self.error
            if err is not None:
                raise err
        return got

    # Resolution overrides: backfill the frame buffer on resolve (the
    # result-cache path never runs the engine, so nothing committed) and
    # wake streaming waiters on both resolve and reject — a client
    # blocked in wait_frames must observe terminal states promptly.

    def _resolve(self, result: np.ndarray) -> None:
        super()._resolve(result)
        with self._frames_cv:
            for k in range(len(self._frames), result.shape[0]):
                self._frames.append(result[k])
            self._frames_cv.notify_all()

    def _reject(self, exc: BaseException) -> None:
        super()._reject(exc)
        with self._frames_cv:
            self._frames_cv.notify_all()


class Scheduler:
    """Bounded, bucketed FIFO with deadline sweeping.

    The engine is the single consumer; producers are HTTP handler
    threads calling :meth:`submit`.
    """

    def __init__(self, max_queue: int = 64, max_wait_s: float = 0.05,
                 default_timeout_s: float = 300.0, metrics=None):
        self.max_queue = max_queue
        self.max_wait_s = max_wait_s
        self.default_timeout_s = default_timeout_s
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending: "OrderedDict[Bucket, Deque[ViewRequest]]" = (
            OrderedDict())  # guarded-by: self._lock
        self._closed = False  # guarded-by: self._lock
        # Fault-tolerance admission policy (set by the engine): when
        # frozen, every submission is rejected with the factory's typed
        # error (drain mode / dead engine); a soft limit rejects
        # submissions beyond a reduced depth while degraded.
        self._frozen: Optional[Callable[[], BaseException]] = (
            None)  # guarded-by: self._lock
        self._soft_limit: Optional[int] = None  # guarded-by: self._lock
        self._soft_exc: Optional[Callable[[], BaseException]] = (
            None)  # guarded-by: self._lock
        m = metrics
        self._depth_gauge = m.gauge(
            "serving_queue_depth",
            "requests waiting for admission") if m else None
        self._timeouts = m.counter(
            "serving_requests_timeout_total",
            "requests expired before completion") if m else None
        self._rejects = m.counter(
            "serving_requests_rejected_total",
            "submissions rejected by the bounded queue") if m else None
        self._shed = m.counter(
            "serving_requests_shed_total",
            "pending requests shed by degraded/drain admission control"
        ) if m else None

    # -- producer side --------------------------------------------------

    def submit(self, req: ViewRequest) -> ViewRequest:
        # Admission decisions happen under the lock; the rejection
        # *callbacks* run after it is released — an exc_factory that
        # re-enters the scheduler (depth(), another submit) must not
        # find this thread still holding _lock (LC306).
        reject: Optional[Callable[[], BaseException]] = None
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._frozen is not None:
                if self._rejects:
                    self._rejects.inc()
                reject = self._frozen
            elif (self._soft_limit is not None
                    and self._depth_locked() >= self._soft_limit):
                if self._rejects:
                    self._rejects.inc()
                reject = self._soft_exc if self._soft_exc is not None \
                    else lambda: EngineOverloaded(
                        "replica degraded: queue soft limit reached")
            elif self._depth_locked() >= self.max_queue:
                if self._rejects:
                    self._rejects.inc()
                raise QueueFullError(
                    f"queue full ({self.max_queue} pending): retry later")
            else:
                now = time.monotonic()
                req.submit_time = now
                timeout = (self.default_timeout_s if req.timeout_s is None
                           else req.timeout_s)
                req.deadline = now + timeout
                self._pending.setdefault(req.bucket, deque()).append(req)
                self._update_depth()
                self._nonempty.notify_all()
        if reject is not None:
            raise reject()
        return req

    # -- consumer (engine) side -----------------------------------------

    def acquire(self, bucket: Optional[Bucket], max_n: int,
                block: bool = True,
                poll_s: float = 0.2) -> List[ViewRequest]:
        """Take up to ``max_n`` runnable requests.

        ``bucket`` given (engine already has active work of that shape):
        non-blocking grab of co-batchable requests — continuous batching
        admits them at the next view boundary.

        ``bucket`` None (engine idle): block until any request is pending
        (up to ``poll_s``, so the engine can re-check shutdown), pick the
        bucket of the *oldest* pending request, then hold until that
        request has aged ``max_wait_s`` (the microbatch flush deadline)
        or ``max_n`` co-batchable requests are available.
        """
        with self._lock:
            self._sweep_locked()
            if bucket is not None:
                got = self._take_locked(bucket, max_n)
                self._update_depth()
                return got
            if not block:
                b = self._oldest_bucket_locked()
                got = self._take_locked(b, max_n) if b else []
                self._update_depth()
                return got

            deadline = time.monotonic() + poll_s
            while not self._closed:
                self._sweep_locked()
                b = self._oldest_bucket_locked()
                if b is not None:
                    head = self._pending[b][0]
                    flush_at = head.submit_time + self.max_wait_s
                    while (len(self._pending.get(b) or ()) < max_n
                           and time.monotonic() < flush_at
                           and not self._closed):
                        self._nonempty.wait(
                            max(0.0, flush_at - time.monotonic()))
                        self._sweep_locked()
                        # The head may have expired during the wait; fall
                        # back to whatever is oldest now.
                        nb = self._oldest_bucket_locked()
                        if nb is None:
                            break
                        if nb != b:
                            b = nb
                            flush_at = (self._pending[b][0].submit_time
                                        + self.max_wait_s)
                    got = self._take_locked(b, max_n)
                    if got:
                        self._update_depth()
                        return got
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(remaining)
            self._update_depth()
            return []

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    # -- fault-tolerance admission control (engine side) -----------------

    def freeze(self, exc_factory: Callable[[], BaseException]) -> None:
        """Reject all new submissions with ``exc_factory()`` (drain mode,
        dead engine).  Pending/in-flight work keeps running."""
        with self._lock:
            self._frozen = exc_factory

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen = None

    def set_soft_limit(self, limit: int,
                       exc_factory: Optional[Callable[[], BaseException]]
                       = None) -> None:
        """Degraded-mode admission: reject submissions once the queue
        holds ``limit`` requests (below ``max_queue``)."""
        with self._lock:
            self._soft_limit = max(1, int(limit))
            self._soft_exc = exc_factory

    def clear_soft_limit(self) -> None:
        with self._lock:
            self._soft_limit = None
            self._soft_exc = None

    def shed(self, exc_factory: Callable[[ViewRequest], BaseException],
             keep_oldest: bool = True) -> int:
        """Reject pending requests to cut load on a degraded replica.

        Priority is age: the bucket holding the *oldest* pending request
        (the next one the engine would serve) is kept; every other
        bucket's requests are resolved with ``exc_factory(req)`` — a
        typed retryable error, so clients know to go elsewhere.  Returns
        the number shed.
        """
        victims: List[ViewRequest] = []
        with self._lock:
            keep = self._oldest_bucket_locked() if keep_oldest else None
            for b in list(self._pending):
                if b == keep:
                    continue
                victims.extend(self._pending.pop(b))
            self._update_depth()
        # Resolve outside the lock: exc_factory is caller code (LC306),
        # and _reject takes each request's own lock — no reason to hold
        # the scheduler lock across either.
        for req in victims:
            req._reject(exc_factory(req))
            if self._shed:
                self._shed.inc()
        return len(victims)

    def close(self, reject_pending: bool = True) -> None:
        """Stop accepting work; optionally reject everything queued."""
        with self._lock:
            self._closed = True
            if reject_pending:
                for q in self._pending.values():
                    for req in q:
                        req._reject(EngineStopped(
                            f"{req.id}: server shutting down"))
                self._pending.clear()
            self._update_depth()
            self._nonempty.notify_all()

    # -- internals (lock held) ------------------------------------------

    def _depth_locked(self) -> int:  # guarded-by: self._lock
        return sum(len(q) for q in self._pending.values())

    def _update_depth(self) -> None:  # guarded-by: self._lock
        if self._depth_gauge:
            self._depth_gauge.set(self._depth_locked())

    def _sweep_locked(self) -> None:  # guarded-by: self._lock
        """Resolve expired / drop cancelled requests in place."""
        now = time.monotonic()
        for b in list(self._pending):
            q = self._pending[b]
            kept: Deque[ViewRequest] = deque()
            for req in q:
                if req.cancelled:
                    req._reject(RequestCancelled(f"{req.id}: cancelled"))
                elif req.expired(now):
                    if self._timeouts:
                        self._timeouts.inc()
                    req._reject(RequestTimeout(
                        f"{req.id}: deadline exceeded after "
                        f"{now - req.submit_time:.2f}s in queue"))
                else:
                    kept.append(req)
            if kept:
                self._pending[b] = kept
            else:
                del self._pending[b]

    def _oldest_bucket_locked(self) -> Optional[Bucket]:  # guarded-by: self._lock
        best, best_t = None, None
        for b, q in self._pending.items():
            if q and (best_t is None or q[0].submit_time < best_t):
                best, best_t = b, q[0].submit_time
        return best

    def _take_locked(self, bucket: Optional[Bucket],  # guarded-by: self._lock
                     max_n: int) -> List[ViewRequest]:
        if bucket is None or bucket not in self._pending or max_n <= 0:
            return []
        q = self._pending[bucket]
        got = []
        while q and len(got) < max_n:
            got.append(q.popleft())
        if not q:
            del self._pending[bucket]
        return got
