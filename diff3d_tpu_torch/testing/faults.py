"""Deterministic, seedable fault injection for chaos testing (counterpart:
``diff3d_tpu/testing/faults.py``: ``FaultInjector``, ``wrap_iter``,
``wrap_sampler`` and the fleet's ``arm_replica``, copied).

A :class:`FaultInjector` owns a set of named *sites* — instrumentation
points such as ``"engine.step"`` or the checkpoint writer's ``"commit"``
— and a list of :class:`FaultSpec` rules per site.  Production code
never imports this module; instead it exposes small hooks (the
checkpoint manager's ``fault_hook``, the sampler proxy returned by
:func:`wrap_sampler`, or a plain :meth:`FaultInjector.wrap` around any
callable) that call :meth:`FaultInjector.fire` with a site name.

Determinism: call counts are tracked per site under a lock, and
probabilistic specs draw from a per-site ``random.Random`` stream seeded
from ``(seed, site)``.  As long as the per-site call *order* is
deterministic (it is in the chaos tests: one engine loop, one writer
thread), the injected fault schedule replays exactly.

Fault kinds:

* ``"error"``   — raise (default :class:`FaultInjected`, a typed
  retryable error, so injected faults flow through the same
  classification as real transient faults).
* ``"slow"``    — sleep ``delay_s`` before proceeding (drives watchdog
  stuck-step detection; a sleep past the watchdog budget is the
  "wedged replica" fault).
* ``"sigterm"`` — deliver a real ``SIGTERM`` to this process's main
  thread (drives the trainer's preemption path end-to-end).
* ``"kill"``    — invoke the kill hook registered for the site
  (:meth:`FaultInjector.set_kill_hook`) and then raise, aborting the
  dispatch that fired it.  This is replica death for the fleet router:
  :func:`arm_replica` instruments a fleet replica so every view-step
  dispatch fires ``replica.<name>.step`` and registers
  ``Replica.kill`` as that site's kill hook — a ``kill`` spec then
  takes the replica down mid-run, in-flight work and all.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from diff3d_tpu_torch.runtime.retry import RetryableError

log = logging.getLogger(__name__)


class FaultInjected(RetryableError):
    """An injected fault.  Retryable by type, like the real transients
    it stands in for."""


@dataclasses.dataclass
class FaultSpec:
    """One rule deciding when a site's calls fault.

    A call triggers the spec if its 1-based per-site call number is
    ``<= first_n``, is listed in ``at_calls``, or wins a Bernoulli draw
    with probability ``prob`` from the site's seeded stream.
    ``max_fires`` caps total firings of this spec.
    """

    kind: str = "error"              # "error" | "slow" | "sigterm" | "kill"
    first_n: int = 0
    at_calls: Tuple[int, ...] = ()
    prob: float = 0.0
    delay_s: float = 0.0
    exc: Optional[Callable[[], BaseException]] = None
    max_fires: Optional[int] = None
    fires: int = 0                            # bookkeeping, not config

    def __post_init__(self):
        if self.kind not in ("error", "slow", "sigterm", "kill"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


class FaultInjector:
    """Registry of fault specs plus the per-site counters that drive them."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._specs: Dict[str, List[FaultSpec]] = collections.defaultdict(list)
        self._rngs: Dict[str, random.Random] = {}
        # Per-site kill hooks ("kill" specs invoke them); see
        # set_kill_hook / arm_replica.
        self._kill_hooks: Dict[str, Callable[[], None]] = (
            {})  # guarded-by: self._lock
        self.calls: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()

    def add(self, site: str, *, kind: str = "error", first_n: int = 0,
            at_calls: Tuple[int, ...] = (), prob: float = 0.0,
            delay_s: float = 0.0,
            exc: Optional[Callable[[], BaseException]] = None,
            max_fires: Optional[int] = None) -> FaultSpec:
        spec = FaultSpec(kind=kind, first_n=first_n, at_calls=tuple(at_calls),
                         prob=prob, delay_s=delay_s, exc=exc,
                         max_fires=max_fires)
        with self._lock:
            self._specs[site].append(spec)
        return spec

    def clear(self, site: Optional[str] = None) -> None:
        """Drop all specs (for ``site``, or everywhere).  Counters survive
        so tests can still assert how many calls happened."""
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    def set_kill_hook(self, site: str,
                      hook: Callable[[], None]) -> None:
        """Register the destructive action a ``"kill"`` spec at ``site``
        performs (e.g. ``Replica.kill``).  The hook runs on the thread
        that fired the site — for a replica that is its own engine
        loop, which is exactly what real mid-dispatch death looks
        like."""
        with self._lock:
            self._kill_hooks[site] = hook

    def _kill_hook_for(self, site: str) -> Optional[Callable[[], None]]:
        with self._lock:
            return self._kill_hooks.get(site)

    def _rng_for(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def fire(self, site: str) -> None:
        """Record one call at ``site`` and apply any triggered faults.

        Raising specs raise; slow specs sleep; sigterm specs deliver the
        signal.  Multiple triggered specs apply in registration order
        (so a ``slow`` + ``error`` pair sleeps, then raises).
        """
        to_apply: List[FaultSpec] = []
        with self._lock:
            self.calls[site] += 1
            n = self.calls[site]
            rng = self._rng_for(site)
            for spec in self._specs.get(site, ()):
                if spec.max_fires is not None and spec.fires >= spec.max_fires:
                    continue
                hit = (n <= spec.first_n or n in spec.at_calls
                       or (spec.prob > 0.0 and rng.random() < spec.prob))
                if hit:
                    spec.fires += 1
                    self.fired[site] += 1
                    to_apply.append(spec)
        for spec in to_apply:
            if spec.kind == "slow":
                log.info("fault[%s]: sleeping %.2fs (call %d)", site, spec.delay_s, n)
                time.sleep(spec.delay_s)
            elif spec.kind == "kill":
                hook = self._kill_hook_for(site)
                if hook is None:
                    raise RuntimeError(
                        f"kill spec fired at {site!r} but no kill hook "
                        "is registered (set_kill_hook / arm_replica)")
                log.info("fault[%s]: invoking kill hook (call %d)",
                         site, n)
                hook()
                # Abort the dispatch that fired us: the killed target's
                # in-flight work is already rejected; letting this call
                # run to completion would resurrect it.
                raise FaultInjected(
                    f"killed at {site} (call {n})")
            elif spec.kind == "sigterm":
                log.info("fault[%s]: delivering SIGTERM (call %d)", site, n)
                # Target the main thread explicitly.  os.kill() lets the
                # kernel pick any thread that doesn't block SIGTERM —
                # including runtime worker threads (the checkpoint
                # writer, data loaders), and interrupting one of those
                # mid-operation can abort the whole process instead of
                # driving the Python-level handler.  pthread_kill still
                # exercises the real installed handler; it only makes the
                # delivery point deterministic.
                signal.pthread_kill(
                    threading.main_thread().ident, signal.SIGTERM)
            else:
                exc = (spec.exc() if spec.exc is not None
                       else FaultInjected(f"injected fault at {site} (call {n})"))
                log.info("fault[%s]: raising %r (call %d)", site, exc, n)
                raise exc

    def wrap(self, site: str, fn: Callable) -> Callable:
        """Return ``fn`` instrumented to :meth:`fire` at ``site`` first."""

        def wrapped(*args, **kwargs):
            self.fire(site)
            return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


def wrap_iter(it, injector: FaultInjector, site: str):
    """Instrument an iterator so every ``__next__`` fires ``site`` first.

    Wrapping a trainer's loader makes each batch fetch a fault site, so a
    ``kind="sigterm"`` spec at call number ``n`` delivers the preemption
    signal at the boundary before step ``n``'s batch (the loop then stops
    after that step).  ``close()`` passes through when the inner iterator
    has one.
    """

    class _FaultyIter:
        def __iter__(self):
            return self

        def __next__(self):
            injector.fire(site)
            return next(it)

        def close(self):
            close = getattr(it, "close", None)
            if close is not None:
                close()

    return _FaultyIter()


class _FaultySampler:
    """Proxy delegating everything to a real sampler, with ``step_many``
    instrumented.  Attribute reads (``w``, ``lane_multiple``, ...) pass
    straight through so the engine and program cache see the real
    sampler's contract."""

    def __init__(self, inner, injector: FaultInjector, site: str):
        self._inner = inner
        self._injector = injector
        self._site = site

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step_many(self, *args, **kwargs):
        self._injector.fire(self._site)
        return self._inner.step_many(*args, **kwargs)


def wrap_sampler(sampler, injector: FaultInjector, site: str = "engine.step"):
    """Wrap a sampler so every ``step_many`` dispatch fires ``site``."""
    return _FaultySampler(sampler, injector, site)


def replica_site(name: str) -> str:
    """The named fault site of one fleet replica's view-step dispatch."""
    return f"replica.{name}.step"


def arm_replica(replica, injector: FaultInjector) -> str:
    """Instrument one fleet replica for chaos and return its site name.

    Every view-step dispatch of ``replica`` (any schedule or cascade
    phase — the hook sits on its ProgramCache, below the samplers) fires
    ``replica.<name>.step``; specs registered there then mean:

    * ``kind="slow", delay_s=...`` — a slow replica (past the watchdog
      budget: a wedged one);
    * ``kind="error"``             — a faulting replica (degrades);
    * ``kind="kill"``              — replica death mid-dispatch:
      ``Replica.kill`` runs, in-flight and queued requests resolve with
      typed retryable errors, and the replica reports ``dead``.

    Post-hoc instrumentation (no build-time sampler wrapping), so each
    replica of a fleet is armed under its own name.
    """
    site = replica_site(replica.name)
    programs = replica.engine.programs
    programs.step_many = injector.wrap(site, programs.step_many)
    injector.set_kill_hook(site, replica.kill)
    return site
