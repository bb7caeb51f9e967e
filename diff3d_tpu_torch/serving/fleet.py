"""Replica lifecycle for the multi-replica serving fleet (counterpart:
``diff3d_tpu/serving/fleet.py``).

A :class:`Replica` is one self-contained serving engine — its own
bounded :class:`~diff3d_tpu_torch.serving.scheduler.Scheduler`,
:class:`~diff3d_tpu_torch.serving.engine.Engine` (device executor),
:class:`~diff3d_tpu_torch.serving.cache.ParamsRegistry`,
:class:`~diff3d_tpu_torch.serving.cache.ProgramCache`,
:class:`~diff3d_tpu_torch.serving.cache.ResultCache` and
:class:`~diff3d_tpu_torch.serving.metrics.MetricsRegistry` — under a stable
name.  The router (``serving/router.py``) owns N of them behind one
HTTP surface and routes *requests to state*: an object session's record
lives on whichever replica served its first view, so every later view of
that session must land there.  The replica therefore keeps the
per-session record ledger (:meth:`Replica.session_records`) that the
affinity contract is asserted against — one session appearing on two
replicas' ledgers IS a record migration, and the tests treat it as a
bug.

Lifecycle::

    start -> (drain -> swap_params -> resume)* -> stop
                     \\-> kill                    (chaos path)

``kill`` is abrupt and non-blocking: the replica reports health
``"dead"`` at once and never serves again, its in-flight and queued
requests are rejected at once, and its engine thread leaves its loop at
the next step boundary (a view step on the card runs to its end, so the
CUDA context stays whole for the survivors).  The router fails
sessionless traffic over to the survivors and rejects the replica's
orphaned sticky sessions with a typed
:class:`~diff3d_tpu_torch.serving.scheduler.SessionLost` naming the lost
owner.

**Nothing is shared between replicas.**  The JAX package shares one
sampler across its replicas to share XLA's jit cache.  Here a sampler
owns captured CUDA graphs that read static input and output buffers, so
two engine threads replaying one graph would race on them; and a rolling
rollout swaps one replica's weights in place while the others keep the
old version.  So :func:`build_fleet` gives every replica its own copy of
the weights, its own samplers (and cascade), and with them its own
graphs and graph memory pool; the engines of one card take turns
(``engine.device_turns``).  :meth:`Replica.snapshot` reports each
replica's weight bytes.

**Over a mesh of ranks** (``ranks``, ``serve_cli --mesh --replicas N``)
every replica spans every rank, as the JAX package's replicas share its
one mesh: each rank builds the same N replicas, and each replica's
engine leads on rank 0 and follows there elsewhere, over a channel of
its own (``serving/ranks.py``; replicas past the first also gather their
views over a group of their own).  Every rank's copies hold rank 0's
weights, checked by digest at boot; a rollout swaps one replica on every
rank of it, through its channel; killing a replica tells its followers
to leave its loop while the others serve on.
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import Dict, List, Optional

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.serving.cache import (ParamsRegistry, ProgramCache,
                                           ResultCache)
from diff3d_tpu_torch.serving.engine import Engine, EngineStopTimeout
from diff3d_tpu_torch.serving.metrics import MetricsRegistry
from diff3d_tpu_torch.serving.scheduler import (EngineStopped, Scheduler,
                                               ViewRequest)

log = logging.getLogger(__name__)

#: Replica-level health state beyond the engine's ok|degraded|draining:
#: a killed replica (or one whose worker thread is gone) is ``dead`` —
#: terminal, never routed to again.
HEALTH_DEAD = "dead"


class Replica:
    """One named engine replica: scheduler + engine + caches + metrics.

    Thin by design — all serving behavior lives in the engine; the
    replica adds the identity, the session record ledger, and the
    drain/swap/resume/kill lifecycle the router composes.
    """

    def __init__(self, name: str, sampler, cfg: Config,
                 extra_samplers: Optional[dict] = None,
                 params_version: str = "v0", cascade=None, ranks=None):
        """``extra_samplers`` maps ``(sampler_kind, steps)`` to extra
        Sampler instances over ``sampler``'s model — the schedules this
        replica serves beyond the default sampler's own (per replica, so
        the router can place few-step DDIM traffic on distilled-student
        replicas and parity traffic on teacher replicas).  ``cascade`` is
        an optional :class:`~diff3d_tpu_torch.cascade.CascadeSampler`
        over the same model enabling the progressive-preview surface on
        this replica.  ``ranks`` serves it over a mesh of ranks (see
        :class:`~diff3d_tpu_torch.serving.ServingService`): this replica's
        channel."""
        cfg.serving.validate()
        self.name = str(name)
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
        self.weights_bytes = sum(
            t.numel() * t.element_size()
            for t in sampler.model.state_dict().values())
        if cascade is not None and cascade.owns_draft_weights:
            self.weights_bytes += sum(
                t.numel() * t.element_size()
                for t in cascade.draft.model.state_dict().values())
        self._lock = threading.Lock()
        # Session record ledger: session_id -> requests served into that
        # session's record on THIS replica.  The router's zero-migration
        # contract is asserted against these counters.
        self._session_records: Dict[str, int] = {}  # guarded-by: self._lock
        self._killed = False  # guarded-by: self._lock
        self._records_ctr = self.metrics.counter(
            "replica_session_records_total",
            "session-carrying requests served into this replica's records")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Replica":
        self.engine.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        try:
            self.engine.stop(timeout=timeout)
        except EngineStopTimeout:
            # The worker thread is leaked (wedged in a device call); the
            # fleet keeps shutting the other replicas down — one wedged
            # replica must not leak its siblings too.
            log.error("replica %s: worker thread leaked on stop",
                      self.name)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admissions, wait for queued + in-flight work (the rolling
        rollout step).  New submissions get EngineDraining; the router
        additionally turns the session-sticky ones into
        :class:`~diff3d_tpu_torch.serving.scheduler.ReplicaDraining`
        before they reach the scheduler."""
        return self.engine.drain(timeout=timeout)

    def resume(self) -> None:
        """Re-admit after a drain (rollout complete for this replica)."""
        self.engine.resume()

    def kill(self, reason: str = "killed") -> None:
        """Simulate replica death: non-blocking, idempotent.  In-flight
        and queued requests resolve with typed retryable errors; the
        replica reports ``dead`` forever after.  Its records die with it
        — the router owns telling sessions so.  On a mesh its engine
        tells the replica's followers to leave their loop as it leaves
        its own (at the next step boundary)."""
        with self._lock:
            if self._killed:
                return
            self._killed = True
        log.warning("replica %s: killed (%s)", self.name, reason)
        self.engine.kill(EngineStopped(
            f"replica {self.name} {reason}: in-flight work lost"))

    # -- state the router reads ------------------------------------------

    @property
    def health(self) -> str:
        """``ok|degraded|draining`` from the engine, or ``dead`` once
        killed / the worker thread is gone for good."""
        with self._lock:
            if self._killed:
                return HEALTH_DEAD
        return self.engine.health if self.engine.alive else HEALTH_DEAD

    def depth(self) -> int:
        """Load proxy for least-loaded placement: queued + in-flight."""
        return self.scheduler.depth() + self.engine.inflight()

    def supports(self, sampler_kind: Optional[str] = None,
                 steps: Optional[int] = None) -> bool:
        return self.engine.supports_schedule(sampler_kind, steps)

    def supported_schedules(self) -> List[str]:
        return self.engine.supported_schedules()

    def supports_cascade(self, plan_spec: Optional[str] = None) -> bool:
        return self.engine.supports_cascade(plan_spec)

    @property
    def params_version(self) -> str:
        return self.registry.version

    # -- request path ----------------------------------------------------

    def submit(self, req: ViewRequest) -> ViewRequest:
        """Engine submit + session-record accounting.  The ledger counts
        only *accepted* requests — a rejected submit leaves no trace, so
        a failed first view does not pin the session here."""
        req = self.engine.submit(req)
        self._note_session(req)
        return req

    def submit_cascade(self, req) -> ViewRequest:
        """Cascade submit + session-record accounting.  The refine phase
        conditions on (and extends) this replica's session record, so a
        session-carrying cascade pins the session here exactly like a
        plain view request."""
        req = self.engine.submit_cascade(req)
        self._note_session(req)
        return req

    def _note_session(self, req: ViewRequest) -> None:
        if req.session_id is not None:
            with self._lock:
                self._session_records[req.session_id] = (
                    self._session_records.get(req.session_id, 0) + 1)
            self._records_ctr.inc()

    def session_records(self) -> Dict[str, int]:
        """Copy of the session -> served-request-count ledger."""
        with self._lock:
            return dict(self._session_records)

    def session_count(self, session_id: str) -> int:
        with self._lock:
            return self._session_records.get(session_id, 0)

    # -- rollout ---------------------------------------------------------

    def swap_params(self, params, version: Optional[str] = None) -> str:
        """Stage new weights for this replica (``params``: a state dict
        of the served model, by the port's names); returns the new
        version string.  The engine copies them in place at the start of
        its next view step, so the swap itself is safe mid-flight;
        callers drain first if no request may straddle two versions (the
        router's rollout does)."""
        return self.registry.swap(params, version)

    def snapshot(self) -> dict:
        """Per-replica block of ``GET /fleet`` (and ``/stats``)."""
        ranks = self.engine.ranks
        return {
            "name": self.name,
            "health": self.health,
            "queue_depth": self.scheduler.depth(),
            "inflight": self.engine.inflight(),
            "params_version": self.registry.version,
            "supported_schedules": self.supported_schedules(),
            "cascade": (self.engine.cascade.plan.spec()
                        if self.engine.cascade is not None else None),
            "sessions": len(self.session_records()),
            "session_records_total": sum(
                self.session_records().values()),
            "engine_restarts": self.engine._restarts,
            "weights_bytes": self.weights_bytes,
            # The ranks this replica spans and its channel's messages.
            "mesh_ranks": 1 if ranks is None else ranks.world,
            "channel": None if ranks is None else ranks.snapshot(),
            # Per-trajectory progress (frames committed / path length)
            # for every camera-path request in flight on this replica.
            "trajectories": self.engine.trajectory_progress(),
        }


def _sampler_over(template, model):
    """A sampler like ``template`` (schedule, chunks, truncation, graph
    mode, device) over ``model``, with no graphs of its own yet."""
    from diff3d_tpu_torch.sampling import Sampler

    return Sampler(model, template.cfg, device=template.device,
                   sampler_kind=template.sampler_kind, steps=template.steps,
                   scan_chunks=template.scan_chunks,
                   start_t=template.start_t,
                   cuda_graphs=template.cuda_graphs, mesh=template.mesh)


def _cascade_over(template, model):
    """A cascade like ``template`` over ``model``; a draft with weights of
    its own gets a copy of them."""
    from diff3d_tpu_torch.cascade import CascadeSampler

    draft = (template.draft.model.state_dict()
             if template.owns_draft_weights else None)
    return CascadeSampler(model, template.cfg, template.plan,
                          device=template.device, draft_params=draft,
                          cuda_graphs=template.refine.cuda_graphs,
                          mesh=template.refine.mesh)


def build_fleet(sampler, cfg: Config, n: Optional[int] = None,
                extra_samplers: Optional[dict] = None,
                per_replica_extra: Optional[Dict[int, dict]] = None,
                params_version: str = "v0",
                name_prefix: str = "r", cascade=None,
                ranks=None) -> List[Replica]:
    """Build ``n`` replicas (default ``cfg.serving.replicas``).

    Replica 0 serves ``sampler`` (and ``extra_samplers``,
    ``per_replica_extra[0]``, ``cascade``) as given; every other replica
    gets a copy of ``sampler.model``'s weights and samplers of the same
    schedules over it (see the module docstring).  ``extra_samplers``
    applies to every replica; ``per_replica_extra[i]`` adds
    replica-``i``-only schedules — the heterogeneous-fleet shape (e.g.
    one distilled-student schedule in a teacher fleet).  A ``cascade``
    enables the progressive-preview surface fleet-wide.

    ``ranks`` (a :class:`~diff3d_tpu_torch.serving.ranks.RankChannel`,
    every sampler built with ``mesh=``) serves every replica over the
    mesh of ranks (see the module docstring): replica 0 over ``ranks``,
    each other over a channel of its own made here, its copy's digest
    checked on every rank.  Call it on every rank with the same
    arguments: the channels' groups are made in one order everywhere."""
    n = cfg.serving.replicas if n is None else int(n)
    if n < 1:
        raise ValueError(f"fleet size {n} must be >= 1")
    per_replica_extra = per_replica_extra or {}
    if ranks is not None and n > 1 and ranks.name is None:
        ranks.name = f"{name_prefix}0"
    replicas = []
    for i in range(n):
        extra = dict(extra_samplers or {})
        extra.update(per_replica_extra.get(i, {}))
        default, casc, chan = sampler, cascade, ranks
        if i > 0:
            model = copy.deepcopy(sampler.model)
            default = _sampler_over(sampler, model)
            extra = {k: _sampler_over(s, model) for k, s in extra.items()}
            casc = None if cascade is None else _cascade_over(cascade,
                                                              model)
            if ranks is not None:
                chan = _channel_over(ranks, f"{name_prefix}{i}", model)
        replicas.append(Replica(f"{name_prefix}{i}", default, cfg,
                                extra_samplers=extra or None,
                                params_version=params_version,
                                cascade=casc, ranks=chan))
    return replicas


def _channel_over(ranks, name: str, model):
    """A replica's own channel on ``ranks``' mesh (with its own views'
    gather group), once every rank holds the same copy ``model`` (a
    rank whose copy differs fails the boot)."""
    from diff3d_tpu_torch.serving.ranks import RankChannel

    chan = RankChannel(ranks.mesh, name=name, own_gather=True)
    digest = chan.check_weights(model)
    log.info("replica %s: rank %d/%d holds rank 0's weights (sha256 %s)",
             name, chan.rank, chan.world, digest[:16])
    return chan
