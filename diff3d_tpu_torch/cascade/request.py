"""The progressive-preview request: one client job, two engine passes
(counterpart: ``diff3d_tpu/cascade/request.py``).

A :class:`CascadeRequest` is what the client submits (full-resolution
views payload, exactly like a plain :class:`ViewRequest`).  It never
queues itself; the engine's ``submit_cascade`` derives two
:class:`_PhaseRequest` children from it — a draft-resolution child first,
then (once every draft view resolved) a refine child carrying the
upsampled drafts — and chains them, so each child co-batches with plain
views through the ordinary scheduler/engine path under its own
``(resolution, phase)`` bucket.

What the parent adds over a trajectory request is the *phase-tagged
event buffer*: every committed frame from either child lands here as
``{"phase", "view", "frame"}`` in commit order, served through the same
``?from=K`` cursor / NDJSON streaming surface as trajectories.  Draft
events for view k arrive first (preview), the refine event for view k
later replaces it in place client-side.  A finished cascade has exactly
``2 * (n_views - 1)`` events.

Random streams across phases mirror
:meth:`CascadeSampler.synthesize_cascade`: each child's engine slot seeds
its generator with :func:`~diff3d_tpu_torch.cascade.sampler.phase_seed`
of the request seed, so the refined output is deterministic under a
pinned seed and independent of the draft phase's draw count.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from diff3d_tpu_torch.cascade.plan import CascadePlan
from diff3d_tpu_torch.cascade.sampler import (downsample_views, phase_seed,
                                              upsample_draft)
from diff3d_tpu_torch.serving.scheduler import ViewRequest


class CascadeRequest(ViewRequest):
    """A progressive-preview synthesis job (see module docstring).

    Constructed at the *refine* (served-model) resolution; the plan's
    refine phase must match the payload's H/W.  The request resolves
    with the refined result ``[n_views-1, B, H, W, 3]``; draft frames
    are preview-only and reachable exclusively through the event
    surface.  ``draws`` (None by default) may map each phase to one draw
    source per generated view, as ``CascadeSampler.synthesize_cascade``
    takes them; each child then replays its phase's.
    """

    def __init__(self, views: dict, plan: CascadePlan, **kwargs):
        kwargs.setdefault("sampler_kind", plan.refine.sampler_kind)
        kwargs.setdefault("steps", plan.refine.steps)
        super().__init__(views, **kwargs)
        H, W = self._HW
        if (H, W) != (plan.refine.resolution,) * 2:
            raise ValueError(
                f"cascade payload is {H}x{W} but the plan refines at "
                f"{plan.refine.resolution}² — submit at the refine "
                "resolution")
        self.plan = plan
        # The full views dict is kept (plain ViewRequest only keeps
        # imgs0): the draft child re-derives its downsampled payload
        # from it.
        self._views = {
            "imgs": np.asarray(views["imgs"], np.float32)[:1],
            "R": self.R, "T": self.T, "K": self.K,
        }
        self._events_lock = threading.Lock()
        self._events_cv = threading.Condition(self._events_lock)
        # Phase-tagged frame events, append-only in commit order.
        self._events: List[dict] = []  # guarded-by: self._events_lock
        self._children: List[ViewRequest] = []  # guarded-by: self._events_lock
        self.first_draft_time: Optional[float] = None
        self.first_refined_time: Optional[float] = None

    @property
    def is_cascade(self) -> bool:
        return True

    @property
    def n_frames(self) -> int:
        """Frames per phase (views past the conditioning one); the event
        buffer holds two of each, one per phase."""
        return self.n_views - 1

    @property
    def n_events(self) -> int:
        return 2 * (self.n_views - 1)

    # -- event surface (the ?from=K cursor) -----------------------------

    def _cascade_event(self, phase: str, view_index: int,
                       frame: np.ndarray) -> None:
        """Child commit hook: append one phase-tagged frame event."""
        with self._events_cv:
            if phase == "draft" and self.first_draft_time is None:
                self.first_draft_time = time.monotonic()
            if phase == "refine" and self.first_refined_time is None:
                self.first_refined_time = time.monotonic()
            self._events.append(
                {"phase": phase, "view": int(view_index), "frame": frame})
            self._events_cv.notify_all()

    def events_done(self) -> int:
        with self._events_lock:
            return len(self._events)

    def events_since(self, start: int = 0) -> List[dict]:
        """Committed events ``start..`` (non-blocking snapshot)."""
        with self._events_lock:
            return list(self._events[max(0, int(start)):])

    def wait_events(self, start: int,
                    timeout: Optional[float] = None) -> List[dict]:
        """Block until at least one event past ``start`` exists (or the
        request resolves), then return events ``start..`` — same
        contract as ``TrajectoryRequest.wait_frames``."""
        start = max(0, int(start))
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._events_cv:
            while len(self._events) <= start and not self._event.is_set():
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self._events_cv.wait(remaining)
            got = list(self._events[start:])
        if not got and self._event.is_set():
            err = self.error
            if err is not None:
                raise err
        return got

    # -- child derivation ------------------------------------------------

    def make_draft_child(self,
                         on_resolve: Callable[[np.ndarray], None]
                         ) -> "_PhaseRequest":
        """The draft-resolution phase request (downsampled payload,
        rescaled intrinsics, ``phase="draft"`` bucket)."""
        views = downsample_views(self._views, self.plan.draft.resolution)
        child = _PhaseRequest(
            self, "draft", views, on_resolve,
            sampler_kind=self.plan.draft.sampler_kind,
            steps=self.plan.draft.steps)
        with self._events_lock:
            self._children.append(child)
        return child

    def make_refine_child(self, draft_result: np.ndarray
                          ) -> "_PhaseRequest":
        """The refine phase request: full-resolution payload plus the
        upsampled drafts the truncated loop renoises from.  Carries the
        parent's session id, so router affinity keeps refinement on the
        replica holding the session's record."""
        child = _PhaseRequest(
            self, "refine", self._views, self._resolve,
            sampler_kind=self.plan.refine.sampler_kind,
            steps=self.plan.refine.steps)
        child.drafts = upsample_draft(draft_result, self._HW)
        with self._events_lock:
            self._children.append(child)
        return child

    # -- terminal-state overrides ----------------------------------------

    def _resolve(self, result: np.ndarray) -> None:
        super()._resolve(result)
        with self._events_cv:
            # Backfill refine events on a short-circuit resolve (result
            # cache / direct resolve) so the cursor surface still
            # terminates at a full event set.
            seen = {e["view"] for e in self._events
                    if e["phase"] == "refine"}
            for k in range(1, result.shape[0] + 1):
                if k not in seen:
                    self._events.append({"phase": "refine", "view": k,
                                         "frame": result[k - 1]})
            self._events_cv.notify_all()

    def _reject(self, exc: BaseException) -> None:
        super()._reject(exc)
        with self._events_cv:
            children = list(self._children)
            self._events_cv.notify_all()
        for c in children:
            c.cancel()

    def cancel(self) -> bool:
        ok = super().cancel()
        if ok:
            with self._events_lock:
                children = list(self._children)
            for c in children:
                c.cancel()
        return ok


class _PhaseRequest(ViewRequest):
    """One phase of a cascade, shaped like an ordinary view request so it
    co-batches with plain views under its ``(resolution, phase)`` bucket.
    Relays frame commits to the parent's event buffer and its terminal
    state to ``on_resolve`` / the parent's reject."""

    def __init__(self, parent: CascadeRequest, phase: str, views: dict,
                 on_resolve: Callable[[np.ndarray], None], **kwargs):
        super().__init__(
            views, seed=parent.seed, n_views=parent.n_views,
            timeout_s=parent.timeout_s,
            request_id=f"{parent.id}:{phase}",
            session_id=parent.session_id, **kwargs)
        self.parent = parent
        self.phase = phase
        self.bucket = self.bucket._replace(phase=phase)
        # The engine's slot seeds its generator with this instead of the
        # request seed: each phase runs its own stream (module docstring).
        self.stream_seed = phase_seed(parent.seed, phase)
        # A parent that brought its own draw sources (``draws``: phase ->
        # one per view, as ``CascadeSampler.synthesize_cascade`` takes
        # them) hands each phase its own.
        if parent.draws is not None:
            self.draws = parent.draws[phase]
        self._on_resolve = on_resolve
        self.drafts: Optional[np.ndarray] = None  # refine phase only

    def content_key(self, params_version: str, extra: str = "") -> str:
        # A phase child must never collide with a plain request on the
        # same inputs — its output depends on the cascade plan (and, for
        # refine, on the draft it renoised from, itself a deterministic
        # function of seed + plan).
        tag = f"cascade:{self.phase}:{self.parent.plan.spec()}"
        return super().content_key(params_version,
                                   extra=f"{extra}|{tag}")

    def _commit_frame(self, view_index: int, frame: np.ndarray) -> None:
        self.parent._cascade_event(self.phase, view_index, frame)

    def _resolve(self, result: np.ndarray) -> None:
        super()._resolve(result)
        try:
            self._on_resolve(result)
        except BaseException as e:  # chain failure -> parent terminal
            self.parent._reject(e)

    def _reject(self, exc: BaseException) -> None:
        super()._reject(exc)
        self.parent._reject(exc)
