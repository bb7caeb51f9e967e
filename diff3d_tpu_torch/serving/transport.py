"""Socket replica transport: length-prefixed JSON frames + RemoteReplica
(counterpart: ``diff3d_tpu/serving/transport.py``; the frames are
byte-identical to the JAX package's for the same objects).

The fleet router multiplexes N replicas that all live in one Python
process — one out-of-memory error or crash takes down every replica.
This module puts the deliberately small
:class:`~diff3d_tpu_torch.serving.fleet.Replica` surface (submit /
health / depth / drain / resume / inflight / kill, plus trajectory frame
cursors) behind a socket so replicas become separate *processes*, each
on a card of its own (``serving/worker.py`` is the far end;
``cli/worker_cli.py`` boots it).  The front door holds no device state.

**Frame layout**: every message is one frame —

    +----------------+----------------------------------+
    | length: !I (4B)| body: UTF-8 JSON, `length` bytes |
    +----------------+----------------------------------+

Requests are ``{"op": str, "args": {...}}``; responses are
``{"ok": true, "value": ...}`` or ``{"ok": false, "error": {...}}``.
numpy arrays ride inside the JSON as ``{"__nd__": {dtype, shape,
b64}}`` — raw little-endian bytes, so a round-trip is *bit-exact* (the
fleet's bit-parity contract survives the wire).  Malformed input is a
typed error, never a hung socket: a declared length past the cap is
:class:`FrameTooLarge`, EOF mid-frame is :class:`FrameTruncated`,
a body that isn't a JSON object is :class:`FrameGarbage`, and every
socket op runs under a timeout (:class:`TransportError` on expiry).

**Error taxonomy over the wire**: the server encodes the typed
retryable taxonomy (scheduler.py) by class name + payload fields;
:func:`decode_error` rehydrates the same class client-side, so
``RemoteReplica.submit`` raises exactly what ``Replica.submit`` would
— the router's placement logic needs zero changes.

**RemoteReplica** duck-types :class:`~diff3d_tpu_torch.serving.fleet.Replica`:
short reads (depth/supports/ledger) are live RPCs with a cached
fallback, results stream back on a dedicated poller connection (plain
requests resolve from the terminal poll; trajectory requests commit
frames through the same ``?from=K`` cursor semantics as the HTTP
surface), and a heartbeat thread supervises the connection — a worker
silent past ``heartbeat_timeout_s`` is marked ``dead`` (terminal, like
an in-process kill), its in-flight sticky requests are rejected with a
typed :class:`~diff3d_tpu_torch.serving.scheduler.SessionLost` naming it,
and the router fails sessionless traffic over to the survivors.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from diff3d_tpu_torch.runtime.retry import RetryableError
from diff3d_tpu_torch.serving.fleet import HEALTH_DEAD
from diff3d_tpu_torch.serving.scheduler import (EngineDraining,
                                               EngineOverloaded,
                                               EngineStepError,
                                               EngineStopped,
                                               FleetOverloaded,
                                               QueueFullError,
                                               ReplicaDraining,
                                               ReplicaOverBudget,
                                               RequestCancelled,
                                               RequestTimeout, SessionLost,
                                               TrajectoryRequest,
                                               UnsupportedSchedule,
                                               ViewRequest)

log = logging.getLogger(__name__)

#: Frame-size ceiling.  A frame carries at most one request's views or
#: one result batch; base64 inflates arrays ~4/3, so this bounds a
#: result at ~¾ GiB of raw pixels — far past any served bucket.
DEFAULT_MAX_FRAME_BYTES = 1 << 30

_LEN = struct.Struct("!I")


# ---------------------------------------------------------------------------
# Typed transport faults (all retryable: the *connection*, not the
# request, is the problem — the caller resubmits or fails over).
# ---------------------------------------------------------------------------


class TransportError(RetryableError):
    """Socket-level fault talking to a worker: connect/read/write
    failure or timeout.  Retryable — the heartbeat decides whether the
    worker is dead or just slow."""


class FrameTooLarge(TransportError):
    """Declared frame length exceeds the negotiated cap — refuse to
    buffer it (a garbage header would otherwise demand gigabytes)."""


class FrameTruncated(TransportError):
    """Peer closed the connection mid-frame (after the length prefix
    promised more bytes)."""


class FrameGarbage(TransportError):
    """Frame body is not a JSON object — protocol violation."""


# ---------------------------------------------------------------------------
# Array / payload codec
# ---------------------------------------------------------------------------


def encode_payload(obj: Any) -> Any:
    """JSON-able deep copy of ``obj`` with ndarrays as bit-exact
    ``{"__nd__": ...}`` blocks (little-endian raw bytes + base64)."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        return {"__nd__": {
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        }}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, dict):
        return {k: encode_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_payload(v) for v in obj]
    return obj


def decode_payload(obj: Any) -> Any:
    """Inverse of :func:`encode_payload` (arrays come back bit-equal)."""
    if isinstance(obj, dict):
        nd = obj.get("__nd__")
        if nd is not None and set(obj) == {"__nd__"}:
            raw = base64.b64decode(nd["b64"])
            return np.frombuffer(raw, dtype=np.dtype(nd["dtype"])).reshape(
                nd["shape"]).copy()
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Frame I/O
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, obj: Any,
               max_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> None:
    body = json.dumps(encode_payload(obj)).encode()
    if len(body) > max_bytes:
        raise FrameTooLarge(
            f"outgoing frame {len(body)} bytes exceeds cap {max_bytes}")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes or None on clean EOF at offset 0; EOF mid-read is a
    :class:`FrameTruncated`."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            if got == 0:
                return None
            raise FrameTruncated(
                f"peer closed mid-frame: wanted {n} bytes, got {got}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket,
               max_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> Optional[dict]:
    """One decoded frame, None on clean EOF.  Raises the typed frame
    faults; a socket timeout propagates as ``socket.timeout`` for the
    caller to classify (server: drop connection; client: TransportError).
    """
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > max_bytes:
        raise FrameTooLarge(
            f"declared frame length {length} exceeds cap {max_bytes}")
    body = _recv_exact(sock, length)
    if body is None:
        raise FrameTruncated("peer closed between header and body")
    try:
        obj = json.loads(body)
    except ValueError as e:
        raise FrameGarbage(f"frame body is not JSON: {e}") from e
    if not isinstance(obj, dict):
        raise FrameGarbage(
            f"frame body must be a JSON object, got {type(obj).__name__}")
    return decode_payload(obj)


# ---------------------------------------------------------------------------
# Error codec: typed taxonomy across the wire
# ---------------------------------------------------------------------------

#: Classes that cross the wire by name.  Anything else degrades to a
#: RuntimeError carrying the original type name in its message.
_WIRE_ERRORS = {cls.__name__: cls for cls in (
    QueueFullError, RequestTimeout, RequestCancelled, EngineStepError,
    EngineOverloaded, EngineDraining, EngineStopped, UnsupportedSchedule,
    FleetOverloaded, ReplicaDraining, SessionLost, ReplicaOverBudget,
    TransportError, FrameTooLarge, FrameTruncated, FrameGarbage,
    ValueError, KeyError, TypeError, RuntimeError,
)}

#: Extra constructor/attribute fields carried per class (beyond msg and
#: retry_after_s, which every RetryableError has).
_ERROR_FIELDS = ("replica", "supported", "budget_bytes", "resident_bytes",
                 "program_peak_bytes")


def encode_error(exc: BaseException) -> dict:
    d: Dict[str, Any] = {"type": type(exc).__name__, "msg": str(exc)}
    after = getattr(exc, "retry_after_s", None)
    if after is not None:
        d["retry_after_s"] = float(after)
    for f in _ERROR_FIELDS:
        v = getattr(exc, f, None)
        if v is not None:
            d[f] = v
    return d


def decode_error(d: dict) -> BaseException:
    name = d.get("type", "RuntimeError")
    msg = d.get("msg", "")
    cls = _WIRE_ERRORS.get(name)
    if cls is None:
        return RuntimeError(f"{name}: {msg}")
    if not issubclass(cls, RetryableError):
        # KeyError reprs its arg; keep the message readable either way.
        return cls(msg)
    kwargs: Dict[str, Any] = {}
    if d.get("retry_after_s") is not None:
        kwargs["retry_after_s"] = float(d["retry_after_s"])
    if issubclass(cls, UnsupportedSchedule) and "supported" in d:
        kwargs["supported"] = list(d["supported"])
    if issubclass(cls, (ReplicaDraining, SessionLost, ReplicaOverBudget)) \
            and "replica" in d:
        kwargs["replica"] = d["replica"]
    if issubclass(cls, ReplicaOverBudget):
        for f in ("budget_bytes", "resident_bytes", "program_peak_bytes"):
            if f in d:
                kwargs[f] = int(d[f])
    return cls(msg, **kwargs)


def request_wire(req: ViewRequest) -> dict:
    """Serialize a request for the worker's ``submit`` op.  The worker
    rebuilds the exact ViewRequest/TrajectoryRequest (same id, seed,
    schedule, session), so results and the RNG stream are bit-identical
    to an in-process submit."""
    return {
        "id": req.id,
        "trajectory": req.is_trajectory,
        "seed": req.seed,
        "n_views": req.n_views,
        "timeout_s": req.timeout_s,
        "sampler_kind": req.sampler_kind,
        "steps": req.steps,
        "session_id": req.session_id,
        "views": {
            "imgs": req.imgs0[None],
            "R": req.R,
            "T": req.T,
            "K": req.K,
        },
    }


def request_from_wire(d: dict) -> ViewRequest:
    cls = TrajectoryRequest if d.get("trajectory") else ViewRequest
    return cls(d["views"], seed=int(d.get("seed", 0)),
               n_views=d.get("n_views"),
               timeout_s=d.get("timeout_s"),
               request_id=d.get("id"),
               sampler_kind=d.get("sampler_kind"),
               steps=d.get("steps"),
               session_id=d.get("session_id"))


# ---------------------------------------------------------------------------
# Client connection: one socket, serialized request/response RPCs
# ---------------------------------------------------------------------------


class Connection:
    """One framed RPC connection to a worker.

    ``_io_lock`` is a *leaf* lock serializing the wire (one in-flight
    RPC per connection); no other lock is ever taken while holding it.
    Callers that need concurrency open more connections — RemoteReplica
    keeps one for short control RPCs, one for the poller thread, and
    dials ephemeral ones for long lifecycle calls (drain) so a 30 s
    drain can never stall routing reads.
    """

    def __init__(self, host: str, port: int, *, timeout_s: float = 10.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self.max_frame_bytes = int(max_frame_bytes)
        self._io_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None  # guarded-by: self._io_lock
        #: Last round-trip in ms (benign racy read: a float snapshot for
        #: metrics, monotonic writers only on this connection).
        self.last_rtt_ms: Optional[float] = None

    def _dial(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, op: str, args: Optional[dict] = None,
             timeout_s: Optional[float] = None) -> Any:
        """One RPC; returns the response value or raises the rehydrated
        typed error.  Any socket fault closes the connection (the next
        call redials) and raises :class:`TransportError`."""
        # Dial outside the lock; install under it (losers close theirs).
        with self._io_lock:
            sock = self._sock
        if sock is None:
            try:
                fresh = self._dial()
            except OSError as e:
                raise TransportError(
                    f"{self.host}:{self.port}: connect failed: {e}") from e
            with self._io_lock:
                if self._sock is None:
                    self._sock = fresh
                else:
                    fresh.close()
        t0 = time.monotonic()
        with self._io_lock:
            sock = self._sock
            if sock is None:
                raise TransportError(
                    f"{self.host}:{self.port}: connection closed")
            try:
                sock.settimeout(self.timeout_s if timeout_s is None
                                else float(timeout_s))
                send_frame(sock, {"op": op, "args": args or {}},
                           self.max_frame_bytes)
                resp = recv_frame(sock, self.max_frame_bytes)
            except TransportError:
                self._close_locked()
                raise
            except (OSError, socket.timeout) as e:
                self._close_locked()
                raise TransportError(
                    f"{self.host}:{self.port}: {op} failed: {e}") from e
        self.last_rtt_ms = (time.monotonic() - t0) * 1e3
        if resp is None:
            with self._io_lock:
                self._close_locked()
            raise FrameTruncated(
                f"{self.host}:{self.port}: peer closed before replying "
                f"to {op}")
        if resp.get("ok"):
            return resp.get("value")
        raise decode_error(resp.get("error") or {})

    def _close_locked(self) -> None:  # guarded-by: self._io_lock
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._io_lock:
            self._close_locked()

    @property
    def connected(self) -> bool:
        with self._io_lock:
            return self._sock is not None


# ---------------------------------------------------------------------------
# RemoteReplica: the Replica duck-type over a Connection
# ---------------------------------------------------------------------------


class RemoteReplica:
    """A worker process seen through the replica surface.

    The router reads ``health``/``depth``/``supports`` and calls
    ``submit``/``drain``/``resume``/``swap_params``/``kill`` exactly as
    it would on an in-process :class:`~diff3d_tpu_torch.serving.fleet.Replica`
    — placement logic is unchanged.  Three connections: ``_conn`` for
    short control RPCs, ``_poll_conn`` owned by the poller/heartbeat
    thread, and ephemeral dials for long lifecycle calls.

    Death is terminal, mirroring the in-process contract: once the
    heartbeat goes ``heartbeat_timeout_s`` without a successful probe
    the replica reports ``dead`` forever, in-flight requests are
    rejected with :class:`SessionLost` naming it, and the router tells
    its sticky sessions the record is gone.
    """

    def __init__(self, host: str, port: int, *,
                 name: Optional[str] = None,
                 rpc_timeout_s: float = 10.0,
                 heartbeat_interval_s: float = 0.25,
                 heartbeat_timeout_s: float = 3.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.host, self.port = host, int(port)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._conn = Connection(host, port, timeout_s=rpc_timeout_s,
                                max_frame_bytes=max_frame_bytes)
        self._poll_conn = Connection(host, port, timeout_s=rpc_timeout_s,
                                     max_frame_bytes=max_frame_bytes)
        self._lock = threading.Lock()
        self._state: Dict[str, Any] = {}  # guarded-by: self._lock
        self._inflight: Dict[str, ViewRequest] = {}  # guarded-by: self._lock
        self._cursors: Dict[str, int] = {}  # guarded-by: self._lock
        self._dead = False  # guarded-by: self._lock
        self._dead_reason = ""  # guarded-by: self._lock
        self._hb_timeouts = 0  # guarded-by: self._lock
        self._last_ok = time.monotonic()  # guarded-by: self._lock
        self._stop_evt = threading.Event()
        self._wake_evt = threading.Event()
        self._poller: Optional[threading.Thread] = None
        # Adopt the worker's replica name so SessionLost / the session
        # ledger / GET /fleet all name the same identity fleet-wide.
        state = self._conn.call("state")
        with self._lock:
            self._state = state
        self.name = str(name or state.get("name")
                        or f"w@{host}:{port}")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "RemoteReplica":
        if self._poller is None:
            self._poller = threading.Thread(
                target=self._poll_loop,
                name=f"diff3d-remote-{self.name}", daemon=True)
            self._poller.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Detach from the worker (the worker process keeps running —
        ``worker_cli`` owns its lifecycle).  Local in-flight futures are
        rejected so no client hangs on a connection we no longer poll."""
        self._stop_evt.set()
        self._wake_evt.set()
        if self._poller is not None:
            self._poller.join(timeout)
        self._reject_inflight(EngineStopped(
            f"remote replica {self.name}: front door detached"))
        self._conn.close()
        self._poll_conn.close()

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Worker-side drain over an ephemeral connection (it can block
        for the full timeout without stalling control RPCs)."""
        wait = 30.0 if timeout is None else float(timeout)
        conn = Connection(self.host, self.port, timeout_s=wait + 10.0)
        try:
            return bool(conn.call("drain", {"timeout": timeout},
                                  timeout_s=wait + 10.0))
        except TransportError:
            return False
        finally:
            conn.close()

    def resume(self) -> None:
        try:
            self._conn.call("resume")
        except TransportError as e:
            log.warning("remote %s: resume failed: %s", self.name, e)

    def kill(self, reason: str = "killed") -> None:
        """Kill the *replica on the worker* (chaos parity with the
        in-process path); the worker process survives to report dead."""
        try:
            self._conn.call("kill", {"reason": reason})
        except TransportError:
            # Worker unreachable — the heartbeat will mark us dead.
            pass

    # -- state the router reads ------------------------------------------

    def _cached(self, key: str, default=None):
        with self._lock:
            return self._state.get(key, default)

    @property
    def health(self) -> str:
        with self._lock:
            if self._dead:
                return HEALTH_DEAD
            return str(self._state.get("health", HEALTH_DEAD))

    def depth(self) -> int:
        try:
            return int(self._conn.call("depth"))
        except TransportError:
            return int(self._cached("depth", 1 << 30))

    def supports(self, sampler_kind: Optional[str] = None,
                 steps: Optional[int] = None) -> bool:
        try:
            return bool(self._conn.call(
                "supports", {"sampler_kind": sampler_kind, "steps": steps}))
        except TransportError:
            return False

    def supported_schedules(self) -> List[str]:
        return list(self._cached("supported_schedules", []))

    def supports_cascade(self, plan_spec: Optional[str] = None) -> bool:
        """The wire carries plain and trajectory requests only (as the
        JAX package's does): a cascade is placed on in-process replicas."""
        return False

    @property
    def params_version(self) -> str:
        return str(self._cached("params_version", "unknown"))

    def session_records(self) -> Dict[str, int]:
        """Live ledger; falls back to the last heartbeat's copy so the
        zero-migration audit still sees a SIGKILLed worker's sessions."""
        try:
            got = self._conn.call("session_records")
            return {str(k): int(v) for k, v in got.items()}
        except TransportError:
            return dict(self._cached("session_records", {}))

    def session_count(self, session_id: str) -> int:
        return self.session_records().get(session_id, 0)

    def swap_params(self, params, version: Optional[str] = None) -> str:
        """Ship new weights as a state dict by the port's parameter names
        (numpy on the wire; the worker's registry refuses a missing,
        unexpected or reshaped name — a Flax tree of the JAX package is
        refused) — the rolling rollout path, cross-process."""
        state = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                     else np.asarray(v)) for k, v in params.items()}
        conn = Connection(self.host, self.port,
                          timeout_s=max(60.0, self.rpc_timeout_s),
                          max_frame_bytes=self._conn.max_frame_bytes)
        try:
            return str(conn.call("swap_params",
                                 {"state_dict": state, "version": version}))
        finally:
            conn.close()

    def snapshot(self) -> dict:
        try:
            snap = self._conn.call("snapshot")
        except TransportError:
            snap = {"name": self.name, "health": self.health,
                    "queue_depth": self._cached("depth", 0),
                    "params_version": self.params_version,
                    "supported_schedules": self.supported_schedules(),
                    "sessions": len(self._cached("session_records", {}))}
        snap["transport"] = self.transport_stats()
        return snap

    def transport_stats(self) -> dict:
        """Connection-supervision block: RTT, liveness and the counters
        the router folds into GET /metrics."""
        with self._lock:
            dead, hb = self._dead, self._hb_timeouts
            state = self._state
        rtts = [c.last_rtt_ms for c in (self._conn, self._poll_conn)
                if c.last_rtt_ms is not None]
        return {
            "remote": f"{self.host}:{self.port}",
            "connected": not dead and (self._conn.connected
                                       or self._poll_conn.connected),
            "rtt_ms": round(min(rtts), 3) if rtts else None,
            "heartbeat_timeouts": hb,
            "admission_rejects_hbm": int(
                (state.get("hbm") or {}).get("rejects", 0)),
        }

    # -- request path ----------------------------------------------------

    def submit(self, req: ViewRequest) -> ViewRequest:
        """Wire submit + poller registration.  Raises the same typed
        taxonomy as the in-process submit (rehydrated from the wire);
        the returned request resolves asynchronously when the poller
        streams the worker's result back."""
        with self._lock:
            if self._dead:
                reason = self._dead_reason
                raise EngineStopped(
                    f"{req.id}: remote replica {self.name} is dead"
                    f" ({reason})")
        self._conn.call("submit", request_wire(req))
        with self._lock:
            self._inflight[req.id] = req
            self._cursors[req.id] = 0
        self._wake_evt.set()
        return req

    # -- poller / heartbeat thread ---------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop_evt.is_set():
            had_work = self._heartbeat()
            if self._is_dead():
                self._reject_inflight(SessionLost(
                    f"remote replica {self.name} stopped heartbeating; "
                    "its device-resident records are lost — restart "
                    "sessions from their committed views",
                    replica=self.name))
                return
            had_work = self._poll_inflight() or had_work
            if not had_work:
                self._wake_evt.wait(self.heartbeat_interval_s)
                self._wake_evt.clear()

    def _is_dead(self) -> bool:
        with self._lock:
            return self._dead

    def _heartbeat(self) -> bool:
        """One probe: refresh cached state or advance the death clock.
        Returns True when in-flight work exists (skip the idle sleep)."""
        try:
            state = self._poll_conn.call(
                "state", timeout_s=min(self.rpc_timeout_s,
                                       self.heartbeat_timeout_s))
        except TransportError as e:
            with self._lock:
                expired = (time.monotonic() - self._last_ok
                           > self.heartbeat_timeout_s)
                if expired and not self._dead:
                    self._dead = True
                    self._dead_reason = f"heartbeat timeout: {e}"
                    self._hb_timeouts += 1
            if self._is_dead():
                log.warning("remote %s: marked dead (%s)", self.name, e)
            return False
        with self._lock:
            self._state = state
            self._last_ok = time.monotonic()
            return bool(self._inflight)

    def _poll_inflight(self) -> bool:
        with self._lock:
            pending: List[Tuple[str, ViewRequest, int]] = [
                (rid, req, self._cursors.get(rid, 0))
                for rid, req in self._inflight.items()]
        for rid, req, cursor in pending:
            try:
                got = self._poll_conn.call(
                    "poll", {"id": rid, "from": cursor,
                             "wait_s": 0.2 if req.is_trajectory else 0.2})
            except TransportError:
                return True     # heartbeat owns the death decision
            self._apply_poll(rid, req, got)
        return bool(pending)

    def _apply_poll(self, rid: str, req: ViewRequest, got: dict) -> None:
        frames = got.get("frames") or []
        if frames and req.is_trajectory:
            with self._lock:
                start = self._cursors.get(rid, 0)
            for i, frame in enumerate(frames):
                # frame k (0-based) is synthesised view k+1; the
                # request's commit hook drops out-of-order duplicates.
                req._commit_frame(start + i + 1, np.asarray(frame))
            with self._lock:
                self._cursors[rid] = start + len(frames)
        status = got.get("status")
        if status == "done":
            req.cached = bool(got.get("cached", False))
            req._resolve(np.asarray(got["result"]))
        elif status == "failed":
            req._reject(decode_error(got.get("error") or {}))
        elif status == "unknown":
            req._reject(EngineStepError(
                f"{rid}: remote replica {self.name} no longer knows this "
                "request (worker restarted?)"))
        else:
            return
        with self._lock:
            self._inflight.pop(rid, None)
            self._cursors.pop(rid, None)

    def _reject_inflight(self, exc: BaseException) -> None:
        with self._lock:
            victims = list(self._inflight.values())
            self._inflight.clear()
            self._cursors.clear()
        for req in victims:
            req._reject(exc)
