"""Worker process: one replica behind the socket transport (counterpart:
``diff3d_tpu/serving/worker.py``).

The far end of ``serving/transport.py``: a :class:`Worker` wraps one
:class:`~diff3d_tpu_torch.serving.fleet.Replica` (touching ONLY the
replica duck-type surface, so tests can wrap scripted fakes) and serves
the framed RPC protocol — submit / poll / state / drain / resume / kill /
swap_params / snapshot / depth / supports / session ledger — plus an
optional HTTP front door (the single-replica surface: /healthz,
/metrics, /stats, /synthesize) for direct inspection of a worker.

**Device-memory-budgeted admission.**  The worker rejects *at the door*
— before any device work, before the request even reaches the replica —
when admitting a request would push its card past its budget::

    resident_record_bytes + request_record_bytes + program_peak_bytes
        > hbm_budget_bytes   ->  ReplicaOverBudget (503 + Retry-After)

``resident_record_bytes`` counts the staged records of every request
still in flight on this worker (:meth:`HbmAdmission.record_bytes`: the
port's float32 record, poses and intrinsics of one lane);
``program_peak_bytes`` is the pin of the request's program: the bytes
each captured program added at its peak at first use, which
``ProgramCache`` measures on the card — :func:`boot_worker` captures
every lane count of every schedule at boot (the warm-up) and takes the
largest reading per program.  With ``memcheck_dir`` (``worker_cli
--memcheck_dir``), the pins of the memory manifests there
(``python -m diff3d_tpu_torch.analysis memcheck``: the traced programs'
peak by liveness, :func:`memcheck_pins`) take the place of the measured
ones for their programs, as the JAX package's worker reads its
StableHLO memory manifests.  Budget,
resident and headroom surface on the ``state`` RPC, ``health()`` and
``GET /stats`` so the router and operators see the same arithmetic that
rejected the request.

**A slice of cards per worker.**  :func:`boot_worker` runs the replica
on one CUDA device (``--devices 3`` = ``cuda:3``), or on a slice of N
(``--devices 0-3``) as N ranks of one process group, rank ``r`` on
``cuda:<devices[r]>``: a serving mesh whose lanes split over the ranks
(``serving/ranks.py``).  Rank 0 is the worker: its engine leads, its
socket and admission gate face the router; the other ranks only follow
its view steps.  Every rank warms every lane count before rank 0 returns
(the warm-up goes to every rank at once), and the admission pins are the
largest first-use bytes over the ranks.  XLA's persistent compile cache
has no counterpart: each worker captures its graphs at boot.
"""

from __future__ import annotations

import logging
import socket
import threading
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.serving.scheduler import (ReplicaOverBudget,
                                               RequestTimeout, ViewRequest)
from diff3d_tpu_torch.serving.transport import (DEFAULT_MAX_FRAME_BYTES,
                                               FrameGarbage, FrameTooLarge,
                                               FrameTruncated,
                                               TransportError, encode_error,
                                               recv_frame, request_from_wire,
                                               send_frame)

log = logging.getLogger(__name__)

def program_for_schedule(sampler_kind: Optional[str],
                         phase: Optional[str] = None) -> str:
    """Program name (the JAX package's) for a request's (resolved)
    sampler kind: ``step_many`` for the ancestral sampler, other kinds
    append their name.  A cascade phase child maps to its phase program
    regardless of kind — the phase, not the schedule, names the captured
    step."""
    if phase is not None:
        return f"step_many_cascade_{phase}"
    if sampler_kind in (None, "ancestral"):
        return "step_many"
    return f"step_many_{sampler_kind}"


def memcheck_pins(manifest_dir: str) -> Tuple[Dict[str, int],
                                              Dict[str, dict]]:
    """``(pins, configs)``: each serving program's ``budgets.peak_bytes``
    from the port's memory manifest in ``manifest_dir``
    (``<program>.json``), and the config it was traced at.  A missing
    manifest (or directory) pins nothing; an unreadable one is logged and
    skipped -- the JAX worker's behaviour."""
    import json
    import os

    from diff3d_tpu_torch.analysis import manifests, memcheck

    pins: Dict[str, int] = {}
    configs: Dict[str, dict] = {}
    for program in memcheck.SERVING_PROGRAMS:
        path = manifests.manifest_path(program, manifest_dir)
        if not os.path.exists(path):
            continue
        try:
            data = manifests.load(path, memcheck.TOOL)
            pins[program] = int(data["budgets"]["peak_bytes"])
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            log.warning("hbm admission: unreadable manifest %s: %s", path,
                        e)
            continue
        configs[program] = data.get("observed", {}).get("config", {})
    return pins, configs


def pins_from_stats(stats: dict) -> Dict[str, int]:
    """Per program name, the largest bytes any of its captured graphs
    added at its peak at first use (``ProgramCache.stats(
    include_memory=True)``; graphs without a reading — off the card —
    pin nothing)."""
    pins: Dict[str, int] = {}
    for entry in stats["programs"].values():
        peak = entry.get("peak_bytes")
        if peak:
            name = program_for_schedule(entry["sampler"], entry["phase"])
            pins[name] = max(pins.get(name, 0), int(peak))
    return pins


class HbmAdmission:
    """The admission gate: budget arithmetic over resident records.

    Tracks the record bytes of every in-flight request (reserved at
    admission, released when the request resolves) and the per-program
    peak pins (``program_peaks``, by :func:`program_for_schedule` name).
    ``budget_bytes <= 0`` disables the gate.  ``guidance_B`` is the
    record's guidance-weight axis (8 for w = 0..7).  ``measured_peaks``
    (the warm-up's readings) and ``pin_sources`` (where each pin came
    from) are reported beside the pins (:meth:`pin_report`), not used.
    """

    def __init__(self, budget_bytes: int = 0,
                 program_peaks: Optional[Dict[str, int]] = None,
                 replica_name: str = "?", retry_after_s: float = 5.0,
                 guidance_B: int = 8,
                 measured_peaks: Optional[Dict[str, int]] = None,
                 pin_sources: Optional[Dict[str, str]] = None):
        self.budget_bytes = int(budget_bytes)
        self.replica_name = replica_name
        self.retry_after_s = float(retry_after_s)
        self.guidance_B = int(guidance_B)
        self._lock = threading.Lock()
        self._reserved: Dict[str, int] = {}  # guarded-by: self._lock
        self._rejects = 0  # guarded-by: self._lock
        self._warned_unpinned: set = set()  # guarded-by: self._lock
        self.program_peaks: Dict[str, int] = dict(program_peaks or {})
        self.measured_peaks: Dict[str, int] = dict(measured_peaks or {})
        self.pin_sources: Dict[str, str] = dict(pin_sources or {})

    def record_bytes(self, req: ViewRequest) -> int:
        """Device footprint of one admitted request's lane: the float32
        record the engine stages each view step (``[capacity, B, H, W,
        3]`` images, ``[capacity, 3, 3]`` / ``[capacity, 3]`` poses) and
        its ``[3, 3]`` intrinsics, 4 bytes an element."""
        b = req.bucket
        imgs = b.capacity * self.guidance_B * b.H * b.W * 3
        return 4 * (imgs + b.capacity * (9 + 3) + 9)

    def program_peak(self, sampler_kind: Optional[str],
                     phase: Optional[str] = None) -> int:
        """Pin of the request's program; a program with no pin is
        charged the largest known pin (admission must stay conservative
        for unpinned programs, not free) — and warns once per program
        name, so an unpinned program riding the fallback is visible,
        not silent."""
        program = program_for_schedule(sampler_kind, phase)
        peak = self.program_peaks.get(program)
        if peak is not None:
            return peak
        fallback = max(self.program_peaks.values(), default=0)
        with self._lock:
            warn = program not in self._warned_unpinned
            if warn:
                self._warned_unpinned.add(program)
        if warn:
            log.warning(
                "hbm admission: program %r has no pin (no first use "
                "measured on the card) — charging the largest known pin "
                "(%d bytes)", program, fallback)
        return fallback

    def admit(self, req: ViewRequest,
              default_kind: Optional[str] = None) -> None:
        """Reserve the request's footprint or raise
        :class:`ReplicaOverBudget` — atomic under the gate's lock, so
        two concurrent submits can never both squeeze under the line.

        Cascade work is charged its phase pin: a phase child carries
        ``bucket.phase``, and a cascade parent (whose children have not
        been derived yet) is charged the refine pin — the
        full-resolution phase, the cascade's own peak."""
        if self.budget_bytes <= 0:
            return
        kind = req.sampler_kind if req.sampler_kind is not None \
            else default_kind
        phase = req.bucket.phase
        if phase is None and getattr(req, "is_cascade", False):
            phase = "refine"
        need = self.record_bytes(req)
        peak = self.program_peak(kind, phase=phase)
        with self._lock:
            resident = sum(self._reserved.values())
            if resident + need + peak > self.budget_bytes:
                self._rejects += 1
                raise ReplicaOverBudget(
                    f"{req.id}: admitting {need} record bytes would "
                    f"exceed the card's memory budget: resident {resident} "
                    f"+ record {need} + program peak {peak} > budget "
                    f"{self.budget_bytes}",
                    replica=self.replica_name,
                    retry_after_s=self.retry_after_s,
                    budget_bytes=self.budget_bytes,
                    resident_bytes=resident,
                    program_peak_bytes=peak)
            self._reserved[req.id] = need

    def release(self, request_id: str) -> None:
        with self._lock:
            self._reserved.pop(request_id, None)

    def pin_report(self) -> dict:
        """Where the pins came from: the warm-up's readings beside them
        and each pin's source (the worker's ``snapshot`` RPC,
        ``hbm_pins``)."""
        return {"program_peaks": dict(self.program_peaks),
                "measured_program_peaks": dict(self.measured_peaks),
                "pin_sources": dict(self.pin_sources)}

    def snapshot(self) -> dict:
        """The /stats + state-RPC block: the exact arithmetic admission
        runs, so a rejected client can see why."""
        with self._lock:
            resident = sum(self._reserved.values())
            rejects = self._rejects
        return {
            "budget_bytes": self.budget_bytes,
            "resident_bytes": resident,
            "headroom_bytes": (self.budget_bytes - resident
                               if self.budget_bytes > 0 else None),
            "program_peaks": dict(self.program_peaks),
            "rejects": rejects,
            "enabled": self.budget_bytes > 0,
        }


class Worker:
    """Socket server exposing one replica over the framed protocol.

    One accept loop, one handler thread per connection (RemoteReplica
    holds two long-lived connections — control + poller — and dials
    ephemeral ones for lifecycle calls).  Handler threads do pure host
    work; device calls stay on the replica's engine thread, so ``state``
    probes answer while a long job is on the card.
    """

    def __init__(self, replica, cfg: Config, *,
                 host: str = "127.0.0.1", port: int = 0,
                 admission: Optional[HbmAdmission] = None,
                 default_sampler_kind: Optional[str] = None):
        self.replica = replica
        self.cfg = cfg
        self.host = host
        self._requested_port = int(port)
        self.admission = admission or HbmAdmission(
            0, replica_name=replica.name)
        self._default_kind = default_sampler_kind
        #: A slice's follower processes (``worker_cli`` starts them).
        self.followers: list = []
        #: Graphs each rank captured at boot (:func:`boot_worker`).
        self.rank_programs: List[int] = []
        self.max_frame_bytes = int(getattr(
            cfg.serving, "max_frame_bytes", DEFAULT_MAX_FRAME_BYTES))
        self._lock = threading.Lock()
        self._requests: Dict[str, ViewRequest] = {}  # guarded-by: self._lock
        self._conns: List[socket.socket] = []  # guarded-by: self._lock
        self._stopping = False  # guarded-by: self._lock
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        # Worker-side metrics: reuse the replica's registry when it has
        # one (Replica does) so /metrics shows engine + admission in one
        # exposition; scripted fakes get a private registry.
        metrics = getattr(replica, "metrics", None)
        if metrics is None:
            from diff3d_tpu_torch.serving.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._rejects_ctr = metrics.counter(
            "worker_admission_rejects_hbm_total",
            "requests rejected at the door by the memory admission gate")
        self._resident_gauge = metrics.gauge(
            "worker_hbm_resident_bytes",
            "record bytes of in-flight requests counted by admission")
        self._headroom_gauge = metrics.gauge(
            "worker_hbm_headroom_bytes",
            "bytes left under the memory budget (0 when disabled)")

    # -- lifecycle -------------------------------------------------------

    def start(self, http_port: Optional[int] = None) -> "Worker":
        self.replica.start()
        self._sock = socket.create_server((self.host, self._requested_port))
        self._sock.listen(32)
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"diff3d-worker-{self.replica.name}", daemon=True)
        self._accept_thread.start()
        if http_port is not None:
            from diff3d_tpu_torch.serving.server import make_http_server
            self._httpd = make_http_server(self, self.host, http_port)
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"diff3d-worker-http-{self.replica.name}", daemon=True)
            self._http_thread.start()
        log.info("worker %s: serving on %s:%d", self.replica.name,
                 self.host, self.port)
        return self

    @property
    def port(self) -> int:
        if self._sock is None:
            return self._requested_port
        return self._sock.getsockname()[1]

    @property
    def http_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self, timeout: float = 10.0) -> None:
        """Close the listener and every open connection, then stop the
        replica.  Clients see the close as FrameTruncated and their
        heartbeat marks this worker dead — the abrupt shape a SIGKILL
        would have."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            conns = list(self._conns)
        if self._sock is not None:
            # shutdown() before close(): close() alone leaves a thread
            # blocked in accept() pinned until the join timeout.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout)
        self.replica.stop(timeout=timeout)

    # -- accept / dispatch ----------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return      # listener closed: shutting down
            with self._lock:
                if self._stopping:
                    conn.close()
                    return
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn, addr),
                name=f"diff3d-worker-conn-{addr[1]}", daemon=True).start()

    def _serve_conn(self, conn: socket.socket, addr) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                try:
                    frame = recv_frame(conn, self.max_frame_bytes)
                except (FrameTooLarge, FrameGarbage) as e:
                    # Protocol violation: tell the peer (typed), then
                    # drop the connection — the stream offset is lost.
                    self._reply_error(conn, e)
                    return
                except (FrameTruncated, OSError):
                    return
                if frame is None:
                    return      # clean EOF
                op = str(frame.get("op", ""))
                args = frame.get("args") or {}
                try:
                    value = self._dispatch(op, args)
                except Exception as e:   # typed errors cross the wire
                    self._reply_error(conn, e)
                    continue
                try:
                    send_frame(conn, {"ok": True, "value": value},
                               self.max_frame_bytes)
                except (TransportError, OSError):
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _reply_error(self, conn: socket.socket, exc: BaseException) -> None:
        try:
            send_frame(conn, {"ok": False, "error": encode_error(exc)},
                       self.max_frame_bytes)
        except (TransportError, OSError):
            pass

    def _dispatch(self, op: str, args: dict) -> Any:
        if op == "ping":
            return "pong"
        if op == "state":
            return self._state()
        if op == "submit":
            return self._op_submit(args)
        if op == "poll":
            return self._op_poll(args)
        if op == "depth":
            return self.replica.depth()
        if op == "supports":
            return bool(self.replica.supports(
                args.get("sampler_kind"), args.get("steps")))
        if op == "session_records":
            return self.replica.session_records()
        if op == "session_count":
            return self.replica.session_count(args.get("session_id"))
        if op == "snapshot":
            snap = dict(self.replica.snapshot())
            snap["hbm"] = self.admission.snapshot()
            snap["hbm_pins"] = self.admission.pin_report()
            snap["kernel_launches"] = self._kernel_launches()
            return snap
        if op == "drain":
            return bool(self.replica.drain(timeout=args.get("timeout")))
        if op == "resume":
            self.replica.resume()
            return True
        if op == "kill":
            self.replica.kill(str(args.get("reason", "killed")))
            return True
        if op == "swap_params":
            return self._op_swap(args)
        raise ValueError(f"unknown op {op!r}")

    # -- op implementations ----------------------------------------------

    def _state(self) -> dict:
        """The heartbeat payload: everything the RemoteReplica caches."""
        hbm = self.admission.snapshot()
        self._resident_gauge.set(hbm["resident_bytes"])
        self._headroom_gauge.set(hbm["headroom_bytes"] or 0)
        return {
            "name": self.replica.name,
            "health": self.replica.health,
            "depth": self.replica.depth(),
            "params_version": self.replica.params_version,
            "supported_schedules": self.replica.supported_schedules(),
            "session_records": self.replica.session_records(),
            "hbm": hbm,
        }

    def _op_submit(self, args: dict) -> dict:
        req = self._admit_and_submit(request_from_wire(args))
        return {"id": req.id, "accepted": True}

    def _op_poll(self, args: dict) -> dict:
        """One poll turn for a submitted request: block up to ``wait_s``
        for progress, then report status + any frames past ``from``.
        Terminal polls release the admission reservation and drop the
        request from the table (the client owns the result now)."""
        rid = str(args.get("id", ""))
        start = max(0, int(args.get("from", 0)))
        wait_s = min(5.0, max(0.0, float(args.get("wait_s", 0.2))))
        with self._lock:
            req = self._requests.get(rid)
        if req is None:
            return {"id": rid, "status": "unknown"}
        out: Dict[str, Any] = {"id": rid, "status": "pending"}
        if req.is_trajectory:
            try:
                frames = req.wait_frames(start, timeout=wait_s)
            except BaseException:
                frames = req.frames_since(start)
            if frames:
                out["frames"] = [np.asarray(f) for f in frames]
        else:
            try:
                req.result(timeout=wait_s)
            except RequestTimeout:
                if not req.done():
                    return out      # genuinely still running
            except BaseException:
                pass                # terminal failure: classified below
        if not req.done():
            return out
        self._forget(rid)
        err = req.error
        if err is not None:
            out["status"] = "failed"
            out["error"] = encode_error(err)
            return out
        out["status"] = "done"
        out["cached"] = bool(req.cached)
        out["result"] = np.asarray(req.result(timeout=0))
        return out

    def _kernel_launches(self) -> Optional[Dict[str, int]]:
        """This process's kernel launches: the wrappers' counts plus the
        replays of the replica's captured graphs (each graph's captured
        launches x its replays).  A worker process holds one replica, so
        these are its launches since the process started; None for a
        replica without an engine."""
        eng = getattr(self.replica, "engine", None)
        if eng is None:
            return None
        from diff3d_tpu_torch.graphs import graph_launches
        from diff3d_tpu_torch.ops import launch_counts

        samplers = list(eng.samplers.values())
        if eng.cascade is not None:
            samplers += [eng.cascade.draft, eng.cascade.refine]
        counts = launch_counts()
        for k, n in graph_launches(
                g for s in samplers for g in s.graphs.values()).items():
            counts[k] = counts.get(k, 0) + n
        return counts

    def _forget(self, rid: str) -> None:
        self.admission.release(rid)
        with self._lock:
            self._requests.pop(rid, None)

    def _op_swap(self, args: dict) -> str:
        """Stage new weights from a wire state dict (the port's parameter
        names; the registry's key, shape and dtype guard still runs) —
        the rolling rollout step, cross-process."""
        state = args.get("state_dict")
        if state is None:
            raise ValueError("swap_params needs 'state_dict' (the port's "
                             "parameter names)")
        if getattr(self.replica, "registry", None) is not None:
            import torch

            state = {k: torch.from_numpy(np.asarray(v))
                     for k, v in state.items()}
        return str(self.replica.swap_params(state, args.get("version")))

    # -- ServingService duck-type (optional HTTP front door) -------------

    def submit(self, payload: dict) -> ViewRequest:
        from diff3d_tpu_torch.serving.server import build_request
        return self._admit_and_submit(build_request(payload, self.cfg))

    def submit_trajectory(self, payload: dict) -> ViewRequest:
        from diff3d_tpu_torch.serving.server import build_trajectory_request
        return self._admit_and_submit(
            build_trajectory_request(payload, self.cfg))

    def _admit_and_submit(self, req: ViewRequest) -> ViewRequest:
        # Admission BEFORE the replica sees the request: a rejected
        # request does no device work and leaves no ledger trace.
        try:
            self.admission.admit(req, default_kind=self._default_kind)
        except ReplicaOverBudget:
            self._rejects_ctr.inc()
            raise
        try:
            self.replica.submit(req)
        except BaseException:
            self.admission.release(req.id)
            raise
        with self._lock:
            self._requests[req.id] = req
        return req

    def get_request(self, request_id: str) -> Optional[ViewRequest]:
        with self._lock:
            return self._requests.get(request_id)

    def result_payload(self, req: ViewRequest) -> dict:
        from diff3d_tpu_torch.serving.server import result_payload
        return result_payload(req)

    def health(self) -> dict:
        return {
            "status": self.replica.health,
            "replica": self.replica.name,
            "queue_depth": self.replica.depth(),
            "params_version": self.replica.params_version,
            "supported_schedules": self.replica.supported_schedules(),
            "hbm": self.admission.snapshot(),
        }

    def metrics_snapshot(self, include_memory: bool = False) -> dict:
        extra = {"hbm": self.admission.snapshot(),
                 "replica": self.replica.snapshot()}
        return self.metrics.snapshot(extra=extra)


def device_slice(spec: str) -> List[int]:
    """Parse a ``--devices`` slice: ``"0-3"`` (inclusive range) or
    ``"0,1,2"`` (explicit list) into device indices."""
    spec = spec.strip()
    if "-" in spec and "," not in spec:
        lo, hi = spec.split("-", 1)
        idx = list(range(int(lo), int(hi) + 1))
    else:
        idx = [int(p) for p in spec.split(",") if p.strip()]
    if not idx:
        raise ValueError(f"--devices {spec!r}: empty device slice")
    if len(set(idx)) != len(idx):
        raise ValueError(f"--devices {spec!r}: duplicate device index")
    return idx


def warm_lanes(max_batch: int, multiple: int = 1) -> List[int]:
    """Every lane count the engine launches up to ``max_batch`` (lanes in
    multiples of ``multiple``, a serving mesh's rank count)."""
    from diff3d_tpu_torch.serving.engine import lane_count

    return sorted({lane_count(n, max_batch, multiple)
                   for n in range(1, max_batch + 1)})


def rank_pins(rank_stats: List[dict]) -> Dict[str, int]:
    """Per program name, the largest pin over the ranks' statistics
    (:func:`pins_from_stats` of each)."""
    pins: Dict[str, int] = {}
    for stats in rank_stats:
        for name, b in pins_from_stats(stats).items():
            pins[name] = max(pins.get(name, 0), b)
    return pins


def boot_worker(cfg: Config, *, name: str, devices: List[int],
                device: Optional[str] = None,
                sampler_kind: str = "ancestral", steps: Optional[int] = None,
                extra_schedules: Optional[List[Tuple[str, int]]] = None,
                weights: Optional[str] = None, raw_params: bool = False,
                params_version: str = "v0",
                host: str = "127.0.0.1", port: int = 0,
                hbm_budget_bytes: int = 0, scan_chunks: int = 1,
                rank_devices: Optional[List[str]] = None,
                memcheck_dir: Optional[str] = None
                ) -> Optional[Worker]:
    """Build a worker (not started): model + samplers on its card or
    slice, replica, warm-up, admission gate, socket server.

    ``devices`` names the worker's cards; ``device`` names another torch
    device for every rank instead (the CPU tests).  A slice of several
    runs as the ranks of the default process group, which must be up
    (one rank per card: ``worker_cli`` starts the ranks and makes it);
    ``rank_devices`` maps each rank to its torch device
    (default ``cuda:<devices[rank]>``, or ``device``): a card test puts
    two ranks on ``cuda:0`` over gloo.  ``weights`` is anything
    ``cli/_common.py::load_eval_params`` reads; ``None`` serves the
    seeded random initialisation (rank 0's, on every rank).  The warm-up
    captures every lane count up to ``max_batch`` of every schedule at
    the ``max_views`` record capacity; on the card their first-use bytes
    become the admission pins, except where ``memcheck_dir``'s memory
    manifests pin a program (:func:`memcheck_pins`).  Rank 0 returns the
    worker once every rank warmed up; every other rank follows rank 0's
    engine until it stops and returns None."""
    import torch
    import torch.distributed as dist

    from diff3d_tpu_torch.cli._common import load_eval_params
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler, record_capacity
    from diff3d_tpu_torch.serving.fleet import Replica
    from diff3d_tpu_torch.serving.scheduler import Bucket

    sliced = len(devices) > 1
    if sliced and not dist.is_initialized():
        raise ValueError(
            f"device slice {devices}: a slice of several cards runs one "
            "rank per card in a process group (worker_cli starts them)")
    rank = 0
    if sliced:
        rank = dist.get_rank()
        if dist.get_world_size() != len(devices):
            raise ValueError(
                f"device slice {devices}: {len(devices)} ranks, but the "
                f"process group has {dist.get_world_size()}")
    if rank_devices is None:
        if device is None:
            resolve_device(None)                  # raises without CUDA
            bad = [d for d in devices if d >= torch.cuda.device_count()]
            if bad:
                raise ValueError(
                    f"device indices {bad} out of range: "
                    f"{torch.cuda.device_count()} CUDA devices")
            rank_devices = [f"cuda:{d}" for d in devices]
        else:
            rank_devices = [device] * len(devices)
    dev = torch.device(rank_devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = ranks = None
    if sliced:
        from diff3d_tpu_torch.parallel import make_mesh
        from diff3d_tpu_torch.serving.ranks import RankChannel

        mesh = make_mesh(cfg.mesh)
        ranks = RankChannel(mesh)
    model = build_model(cfg.model, dev)
    if weights is not None:
        load_eval_params(weights, model, raw_params)
    if ranks is not None:
        ranks.sync_weights(model)
    default_steps = steps if steps is not None else cfg.diffusion.timesteps
    sampler = Sampler(model, cfg, device=dev, scan_chunks=scan_chunks,
                      sampler_kind=sampler_kind, steps=default_steps,
                      mesh=mesh)
    extra = {}
    for kind, n_steps in (extra_schedules or []):
        if (kind, n_steps) == (sampler_kind, default_steps):
            continue
        extra[(kind, n_steps)] = Sampler(
            model, cfg, device=dev, scan_chunks=scan_chunks,
            sampler_kind=kind, steps=n_steps, mesh=mesh)

    replica = Replica(name, sampler, cfg, extra_samplers=extra or None,
                      params_version=params_version, ranks=ranks)
    eng = replica.engine
    if ranks is not None and not ranks.leader:
        eng.follow()
        return None
    cap = record_capacity(cfg.serving.max_views)
    for s in eng.samplers.values():
        for lanes in warm_lanes(eng.max_batch, eng.lane_multiple):
            secs = eng.warmup(
                Bucket(cfg.model.H, cfg.model.W, cap, s.steps,
                       s.sampler_kind), lanes)
            log.info("worker %s: warmed %s:%d at %d lanes in %.1fs", name,
                     s.sampler_kind, s.steps, lanes, secs)
    rank_stats = eng.rank_program_stats()
    measured = rank_pins(rank_stats)
    pins = dict(measured)
    sources = {program: "warm-up" for program in measured}
    if memcheck_dir is not None:
        from diff3d_tpu_torch.analysis.manifests import manifest_path

        loaded, configs = memcheck_pins(memcheck_dir)
        for program, peak in sorted(loaded.items()):
            log.info("worker %s: admission pin of %s from %s: %d bytes "
                     "(warm-up: %s), traced at %s (this worker: H %d, ch "
                     "%d, max_batch %d, max_views %d)", name, program,
                     memcheck_dir, peak, measured.get(program),
                     configs.get(program), cfg.model.H, cfg.model.ch,
                     eng.max_batch, cfg.serving.max_views)
            sources[program] = manifest_path(program, memcheck_dir)
        pins.update(loaded)
    admission = HbmAdmission(
        hbm_budget_bytes, program_peaks=pins,
        replica_name=name, retry_after_s=cfg.serving.retry_after_s,
        guidance_B=eng.guidance_B, measured_peaks=measured,
        pin_sources=sources)
    worker = Worker(replica, cfg, host=host, port=port, admission=admission,
                    default_sampler_kind=sampler_kind)
    worker.rank_programs = [st["num_programs"] for st in rank_stats]
    return worker
