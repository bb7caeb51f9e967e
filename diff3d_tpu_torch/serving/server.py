"""Stdlib HTTP frontend for the inference service (counterpart:
``diff3d_tpu/serving/server.py``: the same endpoints, statuses,
``Retry-After`` headers and payloads).

``ThreadingHTTPServer`` + ``BaseHTTPRequestHandler`` only, no web
framework.  Handler threads do pure host work (JSON <-> numpy, queue
submit, event wait) and never touch CUDA; the engine threads own every
device call, so ``GET /healthz`` and ``GET /metrics`` stay responsive
while a long job is on the card (and a graph capture on an engine
thread is never broken by another thread's CUDA call).

Surface:
  * ``POST /synthesize`` — submit a job.  Body: ``{"views": {"imgs",
    "R", "T", "K"}, "seed": 0, "n_views"?: int, "timeout_s"?: float,
    "block"?: bool, "sampler_kind"?: "ancestral"|"ddim",
    "steps"?: int}``.  ``block=true`` (default) waits for the result;
    ``block=false`` returns ``202 {"id"}`` for later polling.  A
    ``(sampler_kind, steps)`` pair the replica has no sampler for is
    rejected ``503`` with the supported schedules.
  * ``POST /trajectory`` — render a camera path as one request.  Body:
    either ``{"views": {...}}`` with explicit poses (view 0 is the
    conditioning view) or ``{"cond": {"img", "R", "T", "K"}, "path":
    {"kind": "orbit"|"spiral"|"keyframes", "frames": N, ...}}`` (the
    ``diff3d_tpu_torch/trajectory`` spec grammar), plus the /synthesize
    options and ``"stream"?: bool``.  Three response modes:
    ``stream=true`` streams chunked NDJSON — a header line, then one
    line per frame *as it commits to the record*, then a terminal
    status line; ``block=false`` returns ``202 {"id", "n_frames"}``
    for incremental polling; ``block=true`` (default) waits and
    returns all frames at once.
  * ``POST /cascade`` — progressive-preview synthesis: the same
    ``{"views": ...}`` payload at the served (refine) resolution; the
    replica's cascade plan decides both phase schedules
    (``sampler_kind``/``steps`` are rejected).  Response modes mirror
    /trajectory, but the streamed/polled unit is a *phase-tagged
    event*: draft frames arrive first (preview), each refined frame
    then replaces its draft at the same ``frame`` index.  ``503`` when
    the replica serves no cascade plan.
  * ``GET /result/<id>`` — poll a submitted job.  For trajectory
    requests ``?from=K`` returns frames ``K..`` committed so far plus
    progress (``200`` even while running) — the incremental-poll
    streaming surface.  For cascade requests ``?from=K`` walks the
    phase-tagged event buffer the same way (``next`` continues the
    cursor without gaps).
  * ``GET /healthz`` — liveness + engine/queue state (incl. supported
    schedules).
  * ``GET /metrics`` — text exposition; ``/metrics?format=json`` for the
    structured snapshot (per-trajectory progress under
    ``engine.trajectories``).
  * ``GET /stats`` — the structured snapshot (alias of
    ``/metrics?format=json``): per-bucket program-cache entries carry
    their step count and sampler kind.
  * ``GET /fleet`` — fleet topology + per-replica health/depth/sessions
    and trajectory progress (404 on a single-replica service; served
    when the front door is the router's
    :class:`~diff3d_tpu_torch.serving.router.FleetService`).

Backpressure maps to status codes, never to silent queuing: a full queue
is ``429``, a request deadline is ``504``, a cancelled request ``409``,
malformed input ``400``.  A trajectory request hits the same bounded
queue as everything else — its typed rejection arrives before the
stream starts, as a plain JSON error response.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

# Only the (dependency-free) plan module at import time: cascade.request
# subclasses scheduler.ViewRequest, so importing it here would close an
# import cycle through the serving package __init__.
from diff3d_tpu_torch.cascade.plan import CascadePlan
from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.runtime.retry import RetryableError
from diff3d_tpu_torch.serving.cache import (ParamsRegistry, ProgramCache,
                                           ResultCache)
from diff3d_tpu_torch.serving.engine import Engine
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.scheduler import (QueueFullError,
                                               RequestCancelled,
                                               RequestTimeout, Scheduler,
                                               TrajectoryRequest,
                                               UnsupportedSchedule,
                                               ViewRequest)
from diff3d_tpu_torch.trajectory import path_from_spec, trajectory_views

log = logging.getLogger(__name__)


def _error_status(exc: BaseException) -> int:
    if isinstance(exc, QueueFullError):
        return 429
    if isinstance(exc, RequestTimeout):
        return 504
    if isinstance(exc, RequestCancelled):
        return 409
    if isinstance(exc, RetryableError):
        # Typed retryable rejection (degraded/draining/step fault): the
        # replica, not the request, is the problem — 503 + Retry-After.
        return 503
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return 400
    return 500


def _retry_after(exc: BaseException) -> Optional[int]:
    after = getattr(exc, "retry_after_s", None)
    return max(1, int(round(after))) if after else None


def _request_kwargs(payload: dict, cfg: Config) -> dict:
    """The ViewRequest/TrajectoryRequest keyword options shared by both
    builders, with the ``n_views`` ceiling pre-checked."""
    n_views = payload.get("n_views")
    if n_views is not None:
        n_views = int(n_views)
        if n_views > cfg.serving.max_views:
            raise ValueError(
                f"n_views={n_views} exceeds the service ceiling "
                f"{cfg.serving.max_views}")
    steps = payload.get("steps")
    return dict(
        seed=int(payload.get("seed", 0)),
        n_views=n_views,
        timeout_s=payload.get("timeout_s"),
        sampler_kind=payload.get("sampler_kind"),
        steps=None if steps is None else int(steps),
        session_id=payload.get("session_id"))


def _check_against_model(req: ViewRequest, cfg: Config) -> ViewRequest:
    """Post-construction ceilings every front door enforces before any
    replica is chosen."""
    if req.n_views > cfg.serving.max_views:
        raise ValueError(
            f"request spans {req.n_views} views, service ceiling is "
            f"{cfg.serving.max_views} (pass n_views to truncate)")
    H, W = req.bucket.H, req.bucket.W
    if (H, W) != (cfg.model.H, cfg.model.W):
        raise ValueError(
            f"image size {H}x{W} does not match the served model "
            f"({cfg.model.H}x{cfg.model.W})")
    return req


def build_request(payload: dict, cfg: Config) -> ViewRequest:
    """Validate a JSON-shaped payload against the served model and build
    the :class:`ViewRequest`.  Shared by the single-replica
    :class:`ServingService` and the fleet router's front door — both
    enforce the same ceilings before any replica is chosen."""
    if "views" not in payload:
        raise ValueError("payload must carry a 'views' object with "
                         "imgs/R/T/K")
    req = ViewRequest(
        {k: np.asarray(v) for k, v in payload["views"].items()},
        **_request_kwargs(payload, cfg))
    return _check_against_model(req, cfg)


def build_trajectory_request(payload: dict,
                             cfg: Config) -> TrajectoryRequest:
    """Build a :class:`TrajectoryRequest` from a JSON-shaped payload.

    Two input shapes: ``{"views": {...}}`` with explicit poses (view 0
    conditions, views 1.. are the path), or ``{"cond": {"img", "R",
    "T", "K"}, "path": <spec>}`` where the spec is compiled through
    :func:`diff3d_tpu_torch.trajectory.path_from_spec` — a path of N frames
    becomes an (N+1)-view request, so the frame budget is
    ``max_views - 1``.  Same ceilings as :func:`build_request`.
    """
    if "views" in payload:
        views = {k: np.asarray(v) for k, v in payload["views"].items()}
    else:
        cond, path = payload.get("cond"), payload.get("path")
        if cond is None or path is None:
            raise ValueError(
                "trajectory payload must carry either a 'views' object "
                "or 'cond' ({img, R, T, K}) + 'path' (spec)")
        missing = [k for k in ("img", "R", "T", "K") if k not in cond]
        if missing:
            raise ValueError(f"cond is missing {missing}")
        path_R, path_T = path_from_spec(path)
        views = trajectory_views(
            np.asarray(cond["img"], np.float32),
            np.asarray(cond["R"], np.float32),
            np.asarray(cond["T"], np.float32),
            np.asarray(cond["K"], np.float32), path_R, path_T)
    req = TrajectoryRequest(views, **_request_kwargs(payload, cfg))
    return _check_against_model(req, cfg)


def build_cascade_request(payload: dict, cfg: Config,
                          plan: CascadePlan) -> ViewRequest:
    """Build a :class:`~diff3d_tpu_torch.cascade.CascadeRequest` from a
    JSON-shaped payload.

    The payload is the plain /synthesize shape at the served (refine)
    resolution; the cascade *plan* owns both phase schedules, so a
    payload naming its own ``sampler_kind``/``steps`` is rejected —
    cascade samplers are built at boot, never minted per request.
    """
    if "views" not in payload:
        raise ValueError("payload must carry a 'views' object with "
                         "imgs/R/T/K")
    from diff3d_tpu_torch.cascade.request import CascadeRequest

    kw = _request_kwargs(payload, cfg)
    if kw.pop("sampler_kind") is not None or kw.pop("steps") is not None:
        raise ValueError(
            "cascade requests take their schedules from the replica's "
            "cascade plan — drop sampler_kind/steps from the payload")
    req = CascadeRequest(
        {k: np.asarray(v) for k, v in payload["views"].items()},
        plan, **kw)
    return _check_against_model(req, cfg)


def remember_request(requests: "OrderedDict[str, ViewRequest]",
                     lock: threading.Lock, req: ViewRequest,
                     cap: int) -> None:
    """Record an accepted request in a front door's id->request map,
    evicting the oldest *finished* entries past ``cap`` (shared by the
    single-replica service and the fleet front door)."""
    with lock:
        requests[req.id] = req
        while len(requests) > cap:
            oldest = next(iter(requests))
            if not requests[oldest].done():
                break
            del requests[oldest]


def result_payload(req: ViewRequest) -> dict:
    """The terminal JSON body of a finished request (raises the
    request's error if it failed).  Trajectory requests additionally
    report their frame count — ``views`` and the streamed frames are
    the same arrays in the same order."""
    out = req.result(timeout=0)
    body = {
        "id": req.id,
        "status": "done",
        "cached": req.cached,
        "n_views": req.n_views,
        "shape": list(out.shape),
        "views": out.tolist(),
    }
    if req.is_trajectory:
        body["n_frames"] = req.n_frames
        body["frames_committed"] = req.frames_done()
    return body


def trajectory_poll_payload(req: TrajectoryRequest, start: int) -> dict:
    """Incremental-poll body for ``GET /result/<id>?from=K``: frames
    ``K..`` committed so far, plus progress.  ``next`` is the ``from``
    value that continues the stream without gaps or repeats."""
    frames = req.frames_since(start)
    done = req.done()
    committed = req.frames_done()
    body = {
        "id": req.id,
        "status": "done" if done and req.error is None else (
            "failed" if done else "running"),
        "n_frames": req.n_frames,
        "frames_committed": committed,
        "from": start,
        "next": start + len(frames),
        "frames": [f.tolist() for f in frames],
    }
    if done and req.error is not None:
        body["error"] = str(req.error)
    return body


def _event_body(event: dict, seq: int) -> dict:
    """One phase-tagged frame event on the wire: ``frame`` is the
    0-based preview slot (view k -> frame k-1) a client renders draft
    events into and overwrites with the matching refine event."""
    return {
        "event": seq,
        "phase": event["phase"],
        "frame": event["view"] - 1,
        "view": event["frame"].tolist(),
    }


def cascade_poll_payload(req: ViewRequest, start: int) -> dict:
    """Incremental-poll body for a cascade's ``GET /result/<id>?from=K``:
    phase-tagged events ``K..`` committed so far.  A finished cascade
    has ``2 * n_frames`` events — one draft and one refine per view —
    and ``next`` continues the cursor without gaps or repeats."""
    events = req.events_since(start)
    done = req.done()
    body = {
        "id": req.id,
        "status": "done" if done and req.error is None else (
            "failed" if done else "running"),
        "n_frames": req.n_frames,
        "n_events": req.n_events,
        "events_committed": req.events_done(),
        "from": start,
        "next": start + len(events),
        "events": [_event_body(e, start + i)
                   for i, e in enumerate(events)],
    }
    if done and req.error is not None:
        body["error"] = str(req.error)
    return body


class ServingService:
    """Wires scheduler + engine + caches + metrics around one Sampler.

    The HTTP layer is optional: tests drive :meth:`submit` in-process.
    """

    def __init__(self, sampler, cfg: Config, params_version: str = "v0",
                 extra_samplers: Optional[dict] = None, cascade=None,
                 ranks=None):
        """``extra_samplers`` maps ``(sampler_kind, steps)`` to extra
        :class:`~diff3d_tpu_torch.sampling.Sampler` instances over the
        default sampler's model — the additional schedules this replica
        serves beyond the default sampler's own.  ``cascade`` is an
        optional :class:`~diff3d_tpu_torch.cascade.CascadeSampler` over
        the same model enabling the progressive-preview surface
        (``POST /cascade``).  ``ranks`` (a
        :class:`~diff3d_tpu_torch.serving.ranks.RankChannel`) serves over
        a mesh of ranks, every sampler built with ``mesh=``: rank 0
        starts the service as usual, every other rank runs
        ``engine.follow()`` instead."""
        cfg.serving.validate()
        self.cfg = cfg
        self.metrics = MetricsRegistry()
        self.scheduler = Scheduler(
            max_queue=cfg.serving.max_queue,
            max_wait_s=cfg.serving.max_wait_ms / 1e3,
            default_timeout_s=cfg.serving.default_timeout_s,
            metrics=self.metrics)
        self.registry = ParamsRegistry(sampler.model,
                                       version=params_version)
        samplers = {(sampler.sampler_kind, sampler.steps): sampler,
                    **(extra_samplers or {})}
        self.engine = Engine(
            sampler, self.scheduler, self.metrics, cfg.serving,
            params_registry=self.registry,
            result_cache=ResultCache(cfg.serving.result_cache_entries,
                                     self.metrics),
            program_cache=ProgramCache(
                samplers if len(samplers) > 1 else sampler, self.metrics),
            extra_samplers=extra_samplers, cascade=cascade, ranks=ranks)
        self.ranks = ranks
        self._requests_lock = threading.Lock()
        self._requests: "OrderedDict[str, ViewRequest]" = OrderedDict()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self, serve_http: bool = True) -> "ServingService":
        self.engine.start()
        if serve_http:
            self._httpd = make_http_server(self, self.cfg.serving.host,
                                           self.cfg.serving.port)
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="diff3d-serving-http", daemon=True)
            self._http_thread.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        """Shut the service down; ``drain_s > 0`` first drains the
        engine (no new admissions, in-flight work finishes) for up to
        that many seconds — the clean-rollout path."""
        if drain_s > 0 and self.engine.alive:
            self.engine.drain(timeout=drain_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.stop()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admissions and wait for queued + in-flight work."""
        return self.engine.drain(timeout=timeout)

    @property
    def port(self) -> Optional[int]:
        """Bound port (useful with ``port=0`` for tests)."""
        return self._httpd.server_address[1] if self._httpd else None

    # -- request surface -------------------------------------------------

    def submit(self, payload: dict) -> ViewRequest:
        """Build + schedule a request from a JSON-shaped payload."""
        req = build_request(payload, self.cfg)
        self.engine.submit(req)
        remember_request(self._requests, self._requests_lock, req,
                         4 * self.cfg.serving.max_queue)
        return req

    def submit_trajectory(self, payload: dict) -> TrajectoryRequest:
        """Build + schedule a camera-path rendering request; frames
        stream through the request's commit buffer as the engine
        commits them (``POST /trajectory``)."""
        req = build_trajectory_request(payload, self.cfg)
        self.engine.submit(req)
        remember_request(self._requests, self._requests_lock, req,
                         4 * self.cfg.serving.max_queue)
        return req

    def submit_cascade(self, payload: dict) -> ViewRequest:
        """Build + schedule a progressive-preview request against the
        replica's cascade plan (``POST /cascade``); phase-tagged frame
        events stream through the request's event buffer as each phase
        commits them.  A ``"plan"`` in the payload is parsed first, so a
        malformed one is a 400 whatever the replica serves."""
        if payload.get("plan") is not None:
            CascadePlan.parse(str(payload["plan"]))
        if self.engine.cascade is None:
            raise UnsupportedSchedule(
                "this replica serves no cascade plan (boot with "
                "--cascade)",
                supported=self.engine.supported_schedules())
        req = build_cascade_request(payload, self.cfg,
                                    self.engine.cascade.plan)
        self.engine.submit_cascade(req)
        remember_request(self._requests, self._requests_lock, req,
                         4 * self.cfg.serving.max_queue)
        return req

    def get_request(self, request_id: str) -> Optional[ViewRequest]:
        with self._requests_lock:
            return self._requests.get(request_id)

    def result_payload(self, req: ViewRequest) -> dict:
        return result_payload(req)

    def health(self) -> dict:
        alive = self.engine.alive
        # Engine health states (ok|degraded|draining); a
        # dead engine thread reports degraded whatever the state says.
        status = self.engine.health if alive else "degraded"
        return {
            "status": status,
            "engine_alive": alive,
            "engine_health": self.engine.health,
            "engine_restarts": self.engine._restarts,
            "queue_depth": self.scheduler.depth(),
            "params_version": self.registry.version,
            "lane_multiple": self.engine.lane_multiple,
            "max_batch": self.engine.max_batch,
            "supported_schedules": self.engine.supported_schedules(),
            "cascade": (self.engine.cascade.plan.spec()
                        if self.engine.cascade is not None else None),
        }

    def metrics_snapshot(self, include_memory: bool = False) -> dict:
        return self.metrics.snapshot(
            extra=self.engine.snapshot_extra(include_memory=include_memory))


def make_http_server(service: ServingService, host: str,
                     port: int) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server bound to ``host:port``."""

    class Handler(BaseHTTPRequestHandler):
        server_version = "diff3d-serve/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route through logging, not
            log.debug("%s " + fmt, self.address_string(), *args)  # stderr

        def _send_json(self, status: int, obj: dict,
                       retry_after: Optional[int] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, status: int, text: str,
                       ctype: str = "text/plain; version=0.0.4") -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                h = service.health()
                self._send_json(200 if h["status"] == "ok" else 503, h)
            elif url.path == "/metrics":
                if "format=json" in (url.query or ""):
                    self._send_json(200, service.metrics_snapshot())
                else:
                    self._send_text(200, service.metrics.exposition())
            elif url.path == "/stats":
                self._send_json(
                    200, service.metrics_snapshot(include_memory=True))
            elif url.path == "/fleet":
                # Served only by the fleet router's front door
                # (serving/router.py FleetService, duck-typed into this
                # handler); the single-replica service has no fleet.
                snap = getattr(service, "fleet_snapshot", None)
                if snap is None:
                    self._send_json(
                        404, {"error": "not a fleet front door"})
                else:
                    self._send_json(200, snap())
            elif url.path.startswith("/result/"):
                req = service.get_request(url.path[len("/result/"):])
                qs = parse_qs(url.query or "")
                cascade = getattr(req, "is_cascade", False)
                if req is None:
                    self._send_json(404, {"error": "unknown request id"})
                elif (req.is_trajectory or cascade) and "from" in qs:
                    # Incremental poll: committed frames/events are
                    # deliverable whether the request is still running,
                    # finished, or even failed mid-path (the body
                    # carries the error).
                    try:
                        start = int(qs["from"][0])
                    except ValueError:
                        self._send_json(
                            400, {"error": "from must be an integer"})
                        return
                    self._send_json(
                        200, cascade_poll_payload(req, start) if cascade
                        else trajectory_poll_payload(req, start))
                elif not req.done():
                    body = {"id": req.id, "status": "pending"}
                    if req.is_trajectory:
                        body["n_frames"] = req.n_frames
                        body["frames_committed"] = req.frames_done()
                    if cascade:
                        body["n_frames"] = req.n_frames
                        body["n_events"] = req.n_events
                        body["events_committed"] = req.events_done()
                    self._send_json(202, body)
                elif req.error is not None:
                    self._send_json(_error_status(req.error),
                                    {"id": req.id,
                                     "error": str(req.error)},
                                    retry_after=_retry_after(req.error))
                else:
                    self._send_json(200, service.result_payload(req))
            else:
                self._send_json(404, {"error": f"no route {url.path}"})

        # -- chunked NDJSON streaming (POST /trajectory stream=true) ----

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(b"%x\r\n" % len(data))
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _stream_line(self, obj: dict) -> None:
            self._write_chunk(json.dumps(obj).encode() + b"\n")

        def _stream_trajectory(self, req: TrajectoryRequest,
                               wait: float) -> None:
            """Stream frames as they commit: HTTP/1.1 chunked transfer,
            one JSON line per event.  The handler thread blocks in
            ``wait_frames`` (never the engine); errors after the header
            has gone out are delivered as a terminal NDJSON line since
            the status line is already on the wire."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._stream_line({"id": req.id, "status": "streaming",
                               "n_frames": req.n_frames,
                               "n_views": req.n_views})
            deadline = time.monotonic() + wait
            sent = 0
            while True:
                try:
                    frames = req.wait_frames(
                        sent, timeout=max(
                            0.05, min(1.0, deadline - time.monotonic())))
                except BaseException as e:
                    self._stream_line({"id": req.id, "status": "error",
                                       "frames_committed": sent,
                                       "http_status": _error_status(e),
                                       "error": str(e)})
                    break
                for f in frames:
                    self._stream_line({"frame": sent,
                                       "view": f.tolist()})
                    sent += 1
                if req.done() and sent >= req.frames_done():
                    err = req.error
                    if err is None:
                        self._stream_line({"id": req.id, "status": "done",
                                           "frames_committed": sent,
                                           "cached": req.cached})
                    else:
                        self._stream_line(
                            {"id": req.id, "status": "error",
                             "frames_committed": sent,
                             "http_status": _error_status(err),
                             "error": str(err)})
                    break
                if time.monotonic() > deadline:
                    req.cancel()
                    self._stream_line({"id": req.id, "status": "timeout",
                                       "frames_committed": sent})
                    break
            self._write_chunk(b"")   # terminal zero-length chunk

        def _stream_cascade(self, req, wait: float) -> None:
            """Progressive-preview streaming: the same chunked-NDJSON
            surface as ``_stream_trajectory``, but the unit is a
            phase-tagged event — draft frames arrive first, then the
            refine event for each frame index replaces it client-side."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._stream_line({"id": req.id, "status": "streaming",
                               "n_frames": req.n_frames,
                               "n_events": req.n_events,
                               "n_views": req.n_views})
            deadline = time.monotonic() + wait
            sent = 0
            while True:
                try:
                    events = req.wait_events(
                        sent, timeout=max(
                            0.05, min(1.0, deadline - time.monotonic())))
                except BaseException as e:
                    self._stream_line({"id": req.id, "status": "error",
                                       "events_committed": sent,
                                       "http_status": _error_status(e),
                                       "error": str(e)})
                    break
                for e in events:
                    self._stream_line(_event_body(e, sent))
                    sent += 1
                if req.done() and sent >= req.events_done():
                    err = req.error
                    if err is None:
                        self._stream_line({"id": req.id, "status": "done",
                                           "events_committed": sent,
                                           "cached": req.cached})
                    else:
                        self._stream_line(
                            {"id": req.id, "status": "error",
                             "events_committed": sent,
                             "http_status": _error_status(err),
                             "error": str(err)})
                    break
                if time.monotonic() > deadline:
                    req.cancel()
                    self._stream_line({"id": req.id, "status": "timeout",
                                       "events_committed": sent})
                    break
            self._write_chunk(b"")   # terminal zero-length chunk

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/synthesize", "/trajectory", "/cascade"):
                self._send_json(404, {"error": f"no route {url.path}"})
                return
            trajectory = url.path == "/trajectory"
            cascade = url.path == "/cascade"
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if trajectory:
                    req = service.submit_trajectory(payload)
                elif cascade:
                    submit = getattr(service, "submit_cascade", None)
                    if submit is None:
                        raise UnsupportedSchedule(
                            "this service has no cascade surface")
                    req = submit(payload)
                else:
                    req = service.submit(payload)
            except Exception as e:
                self._send_json(_error_status(e), {"error": str(e)},
                                retry_after=_retry_after(e))
                return
            wait = float(payload.get(
                "timeout_s", service.cfg.serving.default_timeout_s)) + 5.0
            if trajectory and payload.get("stream", False):
                self._stream_trajectory(req, wait)
                return
            if cascade and payload.get("stream", False):
                self._stream_cascade(req, wait)
                return
            if not payload.get("block", True):
                body = {"id": req.id, "status": "pending"}
                if trajectory:
                    body["n_frames"] = req.n_frames
                if cascade:
                    body["n_frames"] = req.n_frames
                    body["n_events"] = req.n_events
                self._send_json(202, body)
                return
            # Block the handler thread (not the engine) for the result.
            try:
                req.result(timeout=wait)
                self._send_json(200, service.result_payload(req))
            except Exception as e:
                self._send_json(_error_status(e),
                                {"id": req.id, "error": str(e)},
                                retry_after=_retry_after(e))

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd
