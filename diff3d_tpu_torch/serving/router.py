"""Fleet router: one front door over N engine replicas (counterpart:
``diff3d_tpu/serving/router.py``, the same routing decisions).

3DiM's sampler is autoregressive — view N of an object conditions on
the views already committed to that object's record, so a session is
pinned to the replica holding its state.  The router therefore moves
*requests to state*, never state to requests:

* **Session affinity** — a request carrying ``session_id`` pins to an
  owning replica on its first view (rendezvous hash over the replicas
  eligible for its schedule — stable under fleet churn: adding or
  losing an unrelated replica never remaps an existing session) and
  every later view routes to the recorded owner.  Records never
  migrate.  Sessionless requests go to the least-loaded healthy
  replica and may fail over.
* **Admission control & backpressure** — per-replica queue depth and
  health (``ok|degraded|draining|dead``) feed typed rejections
  composing the RetryableError taxonomy:
  :class:`~diff3d_tpu_torch.serving.scheduler.FleetOverloaded` (capacity,
  retry same request),
  :class:`~diff3d_tpu_torch.serving.scheduler.ReplicaDraining` (owner
  mid-rollout, retry same session) and
  :class:`~diff3d_tpu_torch.serving.scheduler.SessionLost` (owner dead,
  record gone — restart the session), each carrying ``retry_after_s``.
* **Rolling rollout** — :meth:`Router.rollout` drains one replica at a
  time, swaps its weights through its ``ParamsRegistry`` (copied in
  place by its engine), re-admits, repeats.  In-flight requests finish
  on the old weights before their replica swaps; a drain that times out
  resumes WITHOUT swapping (reported, never dropped).  ``replicas=``
  rolls out to the named ones only (a canary, or a rollback of one).  A
  replica over a mesh of ranks swaps on every rank of it: its engine
  sends the weights over its own channel at its next view step.
* **Schedule-aware placement** — replicas declare supported
  ``(sampler_kind, steps)`` schedules; the router places each request on
  a replica that serves its schedule or rejects with
  :class:`~diff3d_tpu_torch.serving.scheduler.UnsupportedSchedule`
  carrying the fleet-wide supported union.

The router holds no device state and captures nothing: it composes
engines.  Its lock covers only the session table and rollout flag —
every replica call (submit, drain, health probes) happens with the lock
released, so a slow view step can never serialize routing (see the
``# guarded-by:`` annotations).
"""

from __future__ import annotations

import hashlib
import logging
import re
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.serving.engine import (HEALTH_DEGRADED,
                                            HEALTH_DRAINING, HEALTH_OK)
from diff3d_tpu_torch.serving.fleet import (HEALTH_DEAD, Replica,
                                           build_fleet)
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.scheduler import (EngineDraining,
                                               EngineOverloaded,
                                               FleetOverloaded,
                                               QueueFullError,
                                               ReplicaDraining,
                                               ReplicaOverBudget,
                                               SessionLost,
                                               UnsupportedSchedule,
                                               ViewRequest)
from diff3d_tpu_torch.serving.server import (build_cascade_request,
                                            build_request,
                                            build_trajectory_request,
                                            make_http_server,
                                            remember_request,
                                            result_payload)

log = logging.getLogger(__name__)

_ROUTABLE = (HEALTH_OK, HEALTH_DEGRADED)


def _metric_suffix(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


def _sched_str(kind: Optional[str], steps: Optional[int]) -> str:
    return f"{'default' if kind is None else kind}:" \
           f"{'default' if steps is None else steps}"


class Router:
    """Routing core: session table + placement + rollout state machine.

    Thread contract: ``submit`` runs on many HTTP handler threads
    concurrently; ``rollout`` on an operator thread; replica health
    changes on engine/watchdog threads.  ``self._lock`` guards only the
    session table, the replica map and the rollout flag — never held
    across a replica call.
    """

    def __init__(self, replicas: List[Replica],
                 metrics: Optional[MetricsRegistry] = None,
                 retry_after_s: float = 5.0):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.metrics = metrics or MetricsRegistry()
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._replicas: "OrderedDict[str, Replica]" = (
            OrderedDict())  # guarded-by: self._lock
        for rep in replicas:
            if rep.name in self._replicas:
                raise ValueError(f"duplicate replica name {rep.name!r}")
            self._replicas[rep.name] = rep
        # Affinity table: session_id -> owning replica name.  Entries
        # are removed only when the owner dies (SessionLost tells the
        # client) or the session's replica is removed from the fleet.
        self._sessions: Dict[str, str] = {}  # guarded-by: self._lock
        self._rollout_active = False  # guarded-by: self._lock

        m = self.metrics
        self._requests_ctr = m.counter(
            "router_requests_total", "requests entering the router")
        self._rejected_ctr = m.counter(
            "router_rejected_total",
            "requests rejected by the router (typed retryable)")
        self._failover_ctr = m.counter(
            "router_failover_total",
            "sessionless/new-session requests placed away from their "
            "first-preference replica (attempt failed or a replica is "
            "dead)")
        self._sessions_lost_ctr = m.counter(
            "router_sessions_lost_total",
            "sticky sessions orphaned by a dead replica")
        self._rollouts_ctr = m.counter(
            "router_rollouts_total", "blue/green rollouts started")
        self._sessions_g = m.gauge(
            "router_sessions_active", "sessions in the affinity table")
        # Cross-process fleet supervision (serving/transport.py): these
        # exist (at 0) even on an all-in-process fleet, so dashboards
        # can alert on them before the first remote replica joins.
        self._remote_connected_g = m.gauge(
            "fleet_remote_connected",
            "remote replicas with a live transport connection")
        self._hb_timeouts_ctr = m.counter(
            "fleet_heartbeat_timeouts_total",
            "remote replicas marked dead by heartbeat timeout")
        self._admission_rejects_ctr = m.counter(
            'fleet_admission_rejects_total{reason="hbm"}',
            "requests rejected by worker HBM-budgeted admission")
        # Per-replica last-seen counter values for delta folding (worker
        # counters are cumulative; ours must only ever inc).
        self._remote_seen_lock = threading.Lock()
        self._remote_seen: Dict[str, Dict[str, int]] = (
            {})  # guarded-by: self._remote_seen_lock

    # -- fleet membership -------------------------------------------------

    def replica_list(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def replica(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(name)

    def add_replica(self, replica: Replica) -> None:
        """Fleet churn: admit a new replica.  Existing sessions keep
        their owners (the affinity table, not the hash, is the source
        of truth); only new sessions can land on the newcomer."""
        with self._lock:
            if replica.name in self._replicas:
                raise ValueError(
                    f"replica {replica.name!r} already in the fleet")
            self._replicas[replica.name] = replica

    def remove_replica(self, name: str) -> Optional[Replica]:
        """Fleet churn: forget a replica (caller owns stopping it).
        Its sticky sessions stay in the table and surface
        :class:`SessionLost` on their next request — silent record loss
        is never an option."""
        with self._lock:
            return self._replicas.pop(name, None)

    # -- placement --------------------------------------------------------

    @staticmethod
    def rendezvous_order(session_id: str,
                         replicas: List[Replica]) -> List[Replica]:
        """Highest-random-weight ranking of ``replicas`` for a session:
        each (session, replica) pair hashes independently, so removing
        one replica only remaps the sessions it owned — every other
        session's argmax is untouched.  That minimal-disruption
        property is exactly the affinity-under-churn contract."""
        def weight(rep: Replica) -> str:
            return hashlib.sha256(
                f"{session_id}|{rep.name}".encode()).hexdigest()
        return sorted(replicas, key=weight, reverse=True)

    def _routable(self, kind: Optional[str],
                  steps: Optional[int]) -> List[Replica]:
        return [r for r in self.replica_list()
                if r.health in _ROUTABLE and r.supports(kind, steps)]

    def _reject(self, exc: BaseException) -> BaseException:
        self._rejected_ctr.inc()
        return exc

    @staticmethod
    def _rep_submit(rep: Replica, req: ViewRequest) -> ViewRequest:
        """One dispatch point for both request shapes: a cascade parent
        goes through the replica's cascade surface (which derives and
        chains the phase children), everything else through the plain
        submit path."""
        if getattr(req, "is_cascade", False):
            return rep.submit_cascade(req)
        return rep.submit(req)

    # -- request path -----------------------------------------------------

    def submit(self, req: ViewRequest) -> ViewRequest:
        """Route + submit one request.  Raises typed retryable errors
        (FleetOverloaded / ReplicaDraining / SessionLost /
        UnsupportedSchedule) instead of queueing anywhere the record
        contract would not be honoured."""
        self._requests_ctr.inc()
        sid = req.session_id
        if sid is not None:
            with self._lock:
                owner = self._sessions.get(sid)
            if owner is not None:
                return self._submit_sticky(req, sid, owner)
        return self._submit_placed(req, sid)

    def _submit_sticky(self, req: ViewRequest, sid: str,
                       owner: str) -> ViewRequest:
        rep = self.replica(owner)
        if rep is None or rep.health == HEALTH_DEAD:
            with self._lock:
                if self._sessions.get(sid) == owner:
                    del self._sessions[sid]
                    self._sessions_g.set(len(self._sessions))
            self._sessions_lost_ctr.inc()
            raise self._reject(SessionLost(
                f"{req.id}: session {sid}: owning replica {owner} is "
                "gone and its device-resident record is lost — restart "
                "the session from its committed views",
                replica=owner, retry_after_s=self.retry_after_s))
        if rep.health == HEALTH_DRAINING:
            raise self._reject(ReplicaDraining(
                f"{req.id}: session {sid}: owning replica {owner} is "
                "draining for rollout; the record stays there — retry "
                f"the same session after {self.retry_after_s:g}s",
                replica=owner, retry_after_s=self.retry_after_s))
        try:
            return self._rep_submit(rep, req)
        except (QueueFullError, EngineOverloaded) as e:
            # Sticky requests cannot fail over — the record is here.
            raise self._reject(FleetOverloaded(
                f"{req.id}: session {sid}: owning replica {owner} is at "
                f"capacity; retry after {self.retry_after_s:g}s",
                retry_after_s=self.retry_after_s)) from e
        except EngineDraining as e:
            # Health flipped to draining between the check and the
            # submit; same contract as the pre-check.
            raise self._reject(ReplicaDraining(
                f"{req.id}: session {sid}: owning replica {owner} "
                "started draining; retry the same session",
                replica=owner, retry_after_s=self.retry_after_s)) from e
        except ReplicaOverBudget:
            # The owner's HBM admission gate fired.  Sticky requests
            # cannot fail over (the record is here), but unlike a dead
            # owner the record is intact — the typed rejection carries
            # the budget arithmetic and a Retry-After.
            self._rejected_ctr.inc()
            raise
        except UnsupportedSchedule:
            self._rejected_ctr.inc()
            raise
        except RuntimeError as e:
            if rep.health == HEALTH_DEAD:
                # Killed between the health check and the submit.
                with self._lock:
                    if self._sessions.get(sid) == owner:
                        del self._sessions[sid]
                        self._sessions_g.set(len(self._sessions))
                self._sessions_lost_ctr.inc()
                raise self._reject(SessionLost(
                    f"{req.id}: session {sid}: owning replica {owner} "
                    "died mid-submit; its record is lost — restart the "
                    "session", replica=owner,
                    retry_after_s=self.retry_after_s)) from e
            raise

    def _submit_placed(self, req: ViewRequest,
                       sid: Optional[str]) -> ViewRequest:
        kind, steps = req.sampler_kind, req.steps
        cands = self._routable(kind, steps)
        if getattr(req, "is_cascade", False):
            spec = req.plan.spec()
            cands = [r for r in cands if r.supports_cascade(spec)]
            if not cands:
                raise self._reject(UnsupportedSchedule(
                    f"{req.id}: no live replica serves cascade plan "
                    f"{spec} (boot replicas with --cascade)",
                    retry_after_s=self.retry_after_s))
        if not cands:
            raise self._reject(self._no_candidates_exc(req, kind, steps))
        dead = [r.name for r in self.replica_list()
                if r.health == HEALTH_DEAD]
        if sid is not None:
            return self._place_session(req, sid, cands, bool(dead))
        # Sessionless: least-loaded first, fail over down the order.
        order = sorted(cands, key=lambda r: (r.depth(), r.name))
        last: Optional[BaseException] = None
        for i, rep in enumerate(order):
            try:
                got = self._rep_submit(rep, req)
            except (QueueFullError, EngineOverloaded, EngineDraining,
                    ReplicaOverBudget) as e:
                # ReplicaOverBudget: this replica's slice is out of HBM
                # headroom, but another may admit — keep failing over.
                last = e
                continue
            if i > 0 or dead:
                self._failover_ctr.inc()
            return got
        raise self._reject(FleetOverloaded(
            f"{req.id}: all {len(order)} eligible replicas rejected the "
            f"request ({len(dead)} dead); retry after "
            f"{self.retry_after_s:g}s",
            retry_after_s=self.retry_after_s)) from last

    def _place_session(self, req: ViewRequest, sid: str,
                       cands: List[Replica],
                       any_dead: bool) -> ViewRequest:
        """First view of a session: claim the rendezvous owner in the
        affinity table BEFORE submitting, so a concurrent same-session
        request sees the claim and goes sticky instead of racing to a
        second replica."""
        chosen = self.rendezvous_order(sid, cands)[0]
        with self._lock:
            owner = self._sessions.setdefault(sid, chosen.name)
            self._sessions_g.set(len(self._sessions))
        if owner != chosen.name:
            # Lost the first-view race; the established claim wins.
            return self._submit_sticky(req, sid, owner)
        try:
            got = self._rep_submit(chosen, req)
        except ReplicaOverBudget:
            # No record exists yet; release the claim exactly like the
            # capacity path, but re-raise the typed budget rejection
            # itself — the client (or an upstream balancer) should see
            # the HBM arithmetic, not a generic FleetOverloaded.
            with self._lock:
                release = (self._sessions.get(sid) == chosen.name
                           and chosen.session_count(sid) == 0)
                if release:
                    del self._sessions[sid]
                    self._sessions_g.set(len(self._sessions))
            self._rejected_ctr.inc()
            raise
        except (QueueFullError, EngineOverloaded, EngineDraining) as e:
            # No record exists yet; release the claim (unless a racing
            # request already landed one) and report capacity — a new
            # session does NOT fail over, so its retry re-hashes to the
            # same owner once capacity frees (stable placement beats
            # one-shot greed here).
            with self._lock:
                release = (self._sessions.get(sid) == chosen.name
                           and chosen.session_count(sid) == 0)
                if release:
                    del self._sessions[sid]
                    self._sessions_g.set(len(self._sessions))
            raise self._reject(FleetOverloaded(
                f"{req.id}: session {sid}: rendezvous owner "
                f"{chosen.name} cannot admit ({e}); retry after "
                f"{self.retry_after_s:g}s",
                retry_after_s=self.retry_after_s)) from e
        if any_dead:
            self._failover_ctr.inc()
        return got

    def _no_candidates_exc(self, req: ViewRequest, kind: Optional[str],
                           steps: Optional[int]) -> BaseException:
        reps = self.replica_list()
        supporters = [r for r in reps if r.health != HEALTH_DEAD
                      and r.supports(kind, steps)]
        if not supporters:
            supported = sorted({s for r in reps
                                if r.health != HEALTH_DEAD
                                for s in r.supported_schedules()})
            return UnsupportedSchedule(
                f"{req.id}: no live replica serves schedule "
                f"{_sched_str(kind, steps)} (fleet supports: "
                f"{', '.join(supported) or 'nothing — fleet dead'})",
                supported=supported, retry_after_s=self.retry_after_s)
        if all(r.health == HEALTH_DRAINING for r in supporters):
            return ReplicaDraining(
                f"{req.id}: every replica serving "
                f"{_sched_str(kind, steps)} is draining for rollout; "
                f"retry after {self.retry_after_s:g}s",
                retry_after_s=self.retry_after_s)
        return FleetOverloaded(
            f"{req.id}: no healthy replica for schedule "
            f"{_sched_str(kind, steps)}; retry after "
            f"{self.retry_after_s:g}s",
            retry_after_s=self.retry_after_s)

    # -- blue/green rollout ----------------------------------------------

    def rollout(self, params, version: Optional[str] = None,
                drain_timeout_s: float = 60.0,
                replicas: Optional[List[str]] = None) -> dict:
        """Rolling weights rollout (``params``: a state dict by the
        port's names): for each live replica in turn (those named in
        ``replicas``, default all), drain (in-flight work finishes on
        the old weights) -> swap through its ParamsRegistry -> resume.
        At every instant N-1 replicas serve, so the fleet never goes
        dark; a drain timeout resumes the replica un-swapped and marks
        the rollout failed rather than dropping its in-flight requests.
        Single-flight: concurrent rollouts are rejected."""
        if replicas is not None:
            unknown = sorted(set(replicas) - {r.name for r in
                                              self.replica_list()})
            if unknown:
                raise ValueError(f"rollout: no replica named {unknown}")
        with self._lock:
            if self._rollout_active:
                raise RuntimeError("rollout already in progress")
            self._rollout_active = True
        self._rollouts_ctr.inc()
        steps_log: List[dict] = []
        ok = True
        try:
            for rep in self.replica_list():
                if replicas is not None and rep.name not in replicas:
                    continue
                if rep.health == HEALTH_DEAD:
                    steps_log.append({"replica": rep.name,
                                      "status": "skipped-dead"})
                    continue
                log.info("rollout: draining replica %s", rep.name)
                if not rep.drain(timeout=drain_timeout_s):
                    rep.resume()
                    steps_log.append({"replica": rep.name,
                                      "status": "drain-timeout"})
                    ok = False
                    continue
                new_version = rep.swap_params(params, version)
                rep.resume()
                log.info("rollout: replica %s -> params %s", rep.name,
                         new_version)
                steps_log.append({"replica": rep.name,
                                  "status": "swapped",
                                  "params_version": new_version})
        finally:
            with self._lock:
                self._rollout_active = False
        return {"ok": ok, "steps": steps_log}

    # -- observability ----------------------------------------------------

    def refresh_gauges(self) -> None:
        """Update the per-replica depth gauges (lazy get-or-create, so
        churned-in replicas appear on their first refresh), and fold
        remote replicas' transport counters into the fleet metrics."""
        connected = 0
        deltas: List[tuple] = []
        for rep in self.replica_list():
            self.metrics.gauge(
                f"router_replica_depth_{_metric_suffix(rep.name)}",
                "queued + in-flight requests on this replica").set(
                    rep.depth())
            stats_fn = getattr(rep, "transport_stats", None)
            if stats_fn is None:
                continue        # in-process replica: no transport
            stats = stats_fn()
            if stats.get("connected"):
                connected += 1
            deltas.append((rep.name, stats))
        # Delta-fold cumulative worker counters into our inc-only
        # counters: compute deltas under the last-seen lock, inc after
        # release (Counter has its own lock; never nest them).
        pending: List[tuple] = []
        with self._remote_seen_lock:
            for name, stats in deltas:
                seen = self._remote_seen.setdefault(name, {})
                for key, ctr in (
                        ("heartbeat_timeouts", self._hb_timeouts_ctr),
                        ("admission_rejects_hbm",
                         self._admission_rejects_ctr)):
                    now = int(stats.get(key) or 0)
                    delta = now - seen.get(key, 0)
                    if delta > 0:
                        pending.append((ctr, delta))
                    seen[key] = max(now, seen.get(key, 0))
        for ctr, delta in pending:
            ctr.inc(delta)
        self._remote_connected_g.set(connected)

    def fleet_snapshot(self) -> dict:
        self.refresh_gauges()
        with self._lock:
            sessions = dict(self._sessions)
            rollout_active = self._rollout_active
        per_owner: Dict[str, int] = {}
        for owner in sessions.values():
            per_owner[owner] = per_owner.get(owner, 0) + 1
        return {
            "replicas": {r.name: r.snapshot()
                         for r in self.replica_list()},
            "sessions": {
                "active": len(sessions),
                "per_replica": per_owner,
            },
            "rollout_active": rollout_active,
        }


class FleetService:
    """HTTP-facing front door over a :class:`Router` — duck-types the
    single-replica :class:`~diff3d_tpu_torch.serving.server.ServingService`
    surface (submit / get_request / result_payload / health /
    metrics_snapshot), so :func:`make_http_server` serves either, and
    adds ``GET /fleet`` plus the router counters to ``GET /metrics``.
    """

    def __init__(self, replicas: List[Replica], cfg: Config):
        cfg.serving.validate()
        self.cfg = cfg
        self.replicas = list(replicas)
        self._metrics = MetricsRegistry()
        self.router = Router(self.replicas, metrics=self._metrics,
                             retry_after_s=cfg.serving.retry_after_s)
        self._requests_lock = threading.Lock()
        self._requests: "OrderedDict[str, ViewRequest]" = (
            OrderedDict())  # guarded-by: self._requests_lock
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None

    @classmethod
    def build(cls, sampler, cfg: Config, n: Optional[int] = None,
              extra_samplers: Optional[dict] = None,
              per_replica_extra: Optional[Dict[int, dict]] = None,
              params_version: str = "v0", cascade=None) -> "FleetService":
        """One-call fleet: N replicas, each with its own weights and
        samplers (see :func:`~diff3d_tpu_torch.serving.fleet.build_fleet`)."""
        return cls(build_fleet(sampler, cfg, n,
                               extra_samplers=extra_samplers,
                               per_replica_extra=per_replica_extra,
                               params_version=params_version,
                               cascade=cascade), cfg)

    # -- lifecycle -------------------------------------------------------

    def start(self, serve_http: bool = True) -> "FleetService":
        for rep in self.replicas:
            rep.start()
        if serve_http:
            self._httpd = make_http_server(self, self.cfg.serving.host,
                                           self.cfg.serving.port)
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="diff3d-fleet-http", daemon=True)
            self._http_thread.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        if drain_s > 0:
            for rep in self.replicas:
                if rep.health not in (HEALTH_DEAD,):
                    rep.drain(timeout=drain_s)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for rep in self.replicas:
            rep.stop()

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    # -- request surface -------------------------------------------------

    def submit(self, payload: dict) -> ViewRequest:
        """Build, route and schedule a request from a JSON-shaped
        payload (``session_id`` keys the affinity contract)."""
        req = build_request(payload, self.cfg)
        self.router.submit(req)
        remember_request(self._requests, self._requests_lock, req,  # lockcheck: disable=LC302(reference passed; remember_request locks)
                         4 * self.cfg.serving.max_queue)
        return req

    def submit_trajectory(self, payload: dict) -> ViewRequest:
        """Build + route a camera-path rendering request.  A trajectory
        carrying ``session_id`` is the canonical sticky workload: every
        frame commits to the owning replica's device-resident record,
        and the zero-migration contract keeps it there."""
        req = build_trajectory_request(payload, self.cfg)
        self.router.submit(req)
        remember_request(self._requests, self._requests_lock, req,  # lockcheck: disable=LC302(reference passed; remember_request locks)
                         4 * self.cfg.serving.max_queue)
        return req

    def submit_cascade(self, payload: dict) -> ViewRequest:
        """Build + route a progressive-preview cascade.  The plan comes
        from the fleet (the first cascade-capable replica's — replicas
        built through :meth:`build` share one), never the payload; the
        router then places the parent on a cascade-capable replica,
        honouring session affinity exactly like a plain request."""
        plan = None
        for rep in self.replicas:
            casc = getattr(getattr(rep, "engine", None), "cascade", None)
            if casc is not None:
                plan = casc.plan
                break
        if plan is None:
            raise UnsupportedSchedule(
                "no replica in this fleet serves a cascade plan "
                "(boot with --cascade)")
        req = build_cascade_request(payload, self.cfg, plan)
        self.router.submit(req)
        remember_request(self._requests, self._requests_lock, req,  # lockcheck: disable=LC302(reference passed; remember_request locks)
                         4 * self.cfg.serving.max_queue)
        return req

    def get_request(self, request_id: str) -> Optional[ViewRequest]:
        with self._requests_lock:
            return self._requests.get(request_id)

    def result_payload(self, req: ViewRequest) -> dict:
        return result_payload(req)

    def rollout(self, params, version: Optional[str] = None,
                drain_timeout_s: float = 60.0,
                replicas: Optional[List[str]] = None) -> dict:
        return self.router.rollout(params, version=version,
                                   drain_timeout_s=drain_timeout_s,
                                   replicas=replicas)

    # -- observability ----------------------------------------------------

    @property
    def metrics(self) -> MetricsRegistry:
        # Refresh per-replica depth gauges on the way out so the text
        # exposition (`GET /metrics`) is as current as the JSON path.
        self.router.refresh_gauges()
        return self._metrics

    def health(self) -> dict:
        reps = self.router.replica_list()
        healths = {r.name: r.health for r in reps}
        if any(h == HEALTH_OK for h in healths.values()):
            status = "ok"
        elif any(h in (HEALTH_DEGRADED, HEALTH_DRAINING)
                 for h in healths.values()):
            status = "degraded"
        else:
            status = "dead"
        return {
            "status": status,
            "fleet_size": len(reps),
            "replicas": healths,
            "queue_depth": sum(r.depth() for r in reps),
            "params_versions": {r.name: r.params_version for r in reps},
            "supported_schedules": sorted(
                {s for r in reps if r.health != HEALTH_DEAD
                 for s in r.supported_schedules()}),
            "cascade": sorted(
                {r.engine.cascade.plan.spec() for r in reps
                 if r.health != HEALTH_DEAD
                 and getattr(getattr(r, "engine", None), "cascade",
                             None) is not None}),
        }

    def metrics_snapshot(self, include_memory: bool = False) -> dict:
        self.router.refresh_gauges()
        return self._metrics.snapshot(
            extra={"fleet": self.fleet_snapshot()})

    def fleet_snapshot(self) -> dict:
        return self.router.fleet_snapshot()
