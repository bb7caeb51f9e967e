"""Bounded retry with capped exponential backoff (counterpart:
``diff3d_tpu/runtime/retry.py``, its ``RetryPolicy``, ``RetryBudget``,
``is_transient_io_error`` and ``is_transient_backend_error``).

The checkpoint writer (:mod:`diff3d_tpu_torch.train.checkpoint`) retries
each tensor's device-to-host fetch and each commit of a sliced
checkpoint under a policy; the serving engine retries a view step under
one that classifies with :func:`is_transient_backend_error`.  CUDA's
sticky errors (an illegal memory access, a launch failure, a device-side
assert, a launch timeout) poison the context, so they are never
transient: a retry in the same process can only repeat them.  Of
``torch.distributed``'s faults, a rendezvous or store timeout
(``DistNetworkError``, ``DistStoreError``), a peer that reset or closed
its connection and NCCL's remote and system errors are transient (the
process group can be rebuilt: ``parallel.multihost``); NCCL's internal
and invalid-usage errors are bugs, never retried.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


class RetryableError(RuntimeError):
    """A fault the caller may safely retry: a failed or stuck engine
    step, degraded admission, a draining engine (injected faults in tests
    subclass it).  ``retry_after_s`` is an advisory wait; the HTTP layer
    maps it to a ``Retry-After`` header."""

    def __init__(self, msg: str = "", *,
                 retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


#: Lower-cased substrings that mark an exception as a transient
#: transport or backend fault (the JAX package's list: gRPC status names
#: and the failure strings of its bench rounds).
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "connection reset",
    "connection refused",
    "socket closed",
    "broken pipe",
    "transport closed",
    "failed to connect",
    "temporarily",
    # torch.distributed: the rendezvous and the store, a lost peer.
    "connection closed by peer",
    "connection reset by peer",
    "socket timeout",
    "timed out",
    # NCCL's result codes of a fault outside the program.
    "ncclremoteerror",
    "ncclsystemerror",
    "remote process exited or there was a network error",
    "unhandled system error",
)

#: Lower-cased substrings of CUDA's sticky errors: each leaves the
#: context unusable, so they are never transient whatever else the
#: message says.
_STICKY_CUDA_MARKERS = (
    "an illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "cudaerrorlaunchtimeout",
)

#: NCCL's errors of the program itself: retrying repeats them.
_NCCL_BUG_MARKERS = (
    "ncclinternalerror",
    "ncclinvalidusage",
    "ncclinvalidargument",
    "internal check failed",
    "invalid usage",
)


def _dist_transient_types() -> tuple:
    """``torch.distributed``'s rendezvous and store errors, where this
    build of torch has them."""
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover - torch without distributed
        return ()
    return tuple(t for t in (getattr(dist, "DistNetworkError", None),
                             getattr(dist, "DistStoreError", None))
                 if isinstance(t, type))


def is_transient_backend_error(exc: BaseException) -> bool:
    """True if ``exc`` looks like a transient backend or transport fault:
    a :class:`RetryableError`, a ``ConnectionError``, a
    ``torch.distributed`` rendezvous or store error, or a message with one
    of the transport markers, unless it names a sticky CUDA error or an
    NCCL error of the program itself."""
    msg = str(exc).lower()
    if any(marker in msg for marker in _STICKY_CUDA_MARKERS):
        return False
    if any(marker in msg for marker in _NCCL_BUG_MARKERS):
        return False
    if isinstance(exc, (RetryableError, ConnectionError)
                  + _dist_transient_types()):
        return True
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def is_transient_io_error(exc: BaseException) -> bool:
    """True if ``exc`` is a filesystem fault worth retrying: checkpoint
    commits go to network filesystems, where ``OSError`` is routinely
    transient."""
    return isinstance(exc, (OSError, RetryableError))


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with capped exponential backoff and seeded jitter.

    ``classify`` decides whether an error is retried; a non-retryable
    error (or the last attempt's) is re-raised as it is.  ``sleep`` is
    injectable so tests run at full speed, and the jitter draws from
    ``random.Random(seed)`` per call, so a policy always produces the
    same backoff sequence.
    """

    max_attempts: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 60.0
    growth: float = 2.0         # 1.0 = constant backoff
    jitter: float = 0.25        # +/- fraction of the delay
    seed: int = 0
    classify: Callable[[BaseException], bool] = is_transient_io_error
    sleep: Callable[[float], None] = time.sleep

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Backoff after failed attempt number ``attempt`` (1-based)."""
        delay = min(self.max_delay_s,
                    self.base_delay_s * self.growth ** (attempt - 1))
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, delay)

    def call(self, fn: Callable[[], Any], *, describe: str = "call") -> Any:
        """Run ``fn`` under this policy and return its result; each retry
        is logged, and the last error is raised unchanged."""
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        rng = random.Random(self.seed)
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except Exception as exc:  # noqa: BLE001 - classify decides
                try:
                    retryable = bool(self.classify(exc))
                except Exception:  # a broken classifier must not mask it
                    retryable = False
                if not retryable or attempt >= self.max_attempts:
                    raise
                delay = self.delay_for(attempt, rng)
                log.warning("%s: attempt %d/%d failed (%s); retrying in "
                            "%.2fs", describe, attempt, self.max_attempts,
                            exc, delay)
                self.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


class RetryBudget:
    """A failure budget that progress refills, for supervision loops
    (the elastic supervisor): give up after ``max_failures`` failures in a
    row *without forward progress*, never because a long run was
    preempted many times.  ``spend()`` takes one unit and returns True
    while some remain; ``reset()`` refills it.  One owner, no locking."""

    def __init__(self, max_failures: int):
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {max_failures}")
        self.max_failures = max_failures
        self.spent = 0

    def spend(self) -> bool:
        """Take one failure; True while the budget is not exhausted."""
        self.spent += 1
        return self.spent < self.max_failures

    def reset(self) -> None:
        """Forward progress: the budget is whole again."""
        self.spent = 0

    @property
    def remaining(self) -> int:
        return max(0, self.max_failures - self.spent)
