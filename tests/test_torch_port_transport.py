"""The port's cross-process fleet (``diff3d_tpu_torch/serving/transport.py``,
``worker.py``, ``cli/worker_cli.py``, ``serve_cli --workers``) on the CPU,
against the JAX package's (``diff3d_tpu/serving/transport.py``,
``worker.py``).

The wire is shared: payloads and frames must be byte-identical to the
JAX package's for the same objects, and the typed error taxonomy must
come back as the same classes with the same fields.  Then a port
``Worker`` serves the tiny model behind a ``RemoteReplica`` in-process
(results bit for bit the worker's own offline sampler), the admission
gate's arithmetic is held against the JAX gate's on the same pins, and
``worker_cli`` runs once as a process fronted by ``serve_cli --workers``.
Every wait has its own timeout.
"""

import dataclasses
import json
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.serving import scheduler as jsched  # noqa: E402
from diff3d_tpu.serving import transport as jtransport  # noqa: E402
from diff3d_tpu.serving import worker as jworker  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.cli import serve_cli, worker_cli  # noqa: E402
from diff3d_tpu_torch.serving import scheduler as psched  # noqa: E402
from diff3d_tpu_torch.serving import transport as ptransport  # noqa: E402
from diff3d_tpu_torch.serving import worker as pworker  # noqa: E402
from diff3d_tpu_torch.serving.router import FleetService  # noqa: E402
from diff3d_tpu_torch.testing import FaultInjector, arm_replica  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 8
WAIT = 60.0
SERVING = dict(port=0, max_batch=2, max_queue=8, max_wait_ms=20.0,
               max_views=3, default_timeout_s=60.0, retry_after_s=0.1,
               result_cache_entries=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _views(i, n_views=3, size=H):
    r = np.random.RandomState(100 + i)
    return {
        "imgs": r.uniform(-1, 1, (n_views, size, size, 3)).astype(
            np.float32),
        "R": np.broadcast_to(np.eye(3, dtype=np.float32),
                             (n_views, 3, 3)).copy(),
        "T": r.randn(n_views, 3).astype(np.float32),
        "K": np.array([[size * 1.2, 0, size / 2],
                       [0, size * 1.2, size / 2], [0, 0, 1]], np.float32),
    }


def _frame_bytes(mod, obj, max_bytes=1 << 30):
    a, b = socket.socketpair()
    try:
        a.settimeout(5.0)
        b.settimeout(5.0)
        mod.send_frame(a, obj, max_bytes)
        (n,) = struct.unpack("!I", b.recv(4))
        body = b""
        while len(body) < n:
            body += b.recv(n - len(body))
        return struct.pack("!I", n) + body
    finally:
        a.close()
        b.close()


# --- the codec and frames -------------------------------------------------------


def _objects():
    r = np.random.RandomState(3)
    return {
        "f32": r.randn(2, 3).astype(np.float32),
        "f64_be": r.randn(4).astype(">f8"),
        "f16": r.randn(3, 1, 2).astype(np.float16),
        "ints": [np.arange(5, dtype=np.int8), np.arange(3, dtype=np.int64),
                 np.array([7], np.uint16)],
        "bool": np.array([[True, False]]),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"i": np.int32(4), "f": np.float32(0.5),
                    "b": np.bool_(True), "py": [1, 2.5, None, "s"]},
        "nested": {"views": {"imgs": r.rand(1, 2, 2, 3).astype(np.float32),
                             "K": np.eye(3, dtype=np.float32)},
                   "tuple": (1, np.arange(2, dtype=np.int32))},
    }


@pytest.mark.parametrize("key", list(_objects()))
def test_payload_and_frames_byte_identical_to_jax(key):
    obj = {"op": "x", "args": {key: _objects()[key]}}
    enc_j = json.dumps(jtransport.encode_payload(obj))
    enc_p = json.dumps(ptransport.encode_payload(obj))
    assert enc_p == enc_j
    assert _frame_bytes(ptransport, obj) == _frame_bytes(jtransport, obj)
    back_p = ptransport.decode_payload(json.loads(enc_p))
    back_j = jtransport.decode_payload(json.loads(enc_j))
    assert json.dumps(ptransport.encode_payload(back_p)) == json.dumps(
        jtransport.encode_payload(back_j))


def _errors(mod, smod):
    return [
        smod.QueueFullError("full"),
        smod.RequestTimeout("late"),
        smod.EngineOverloaded("busy", retry_after_s=2.0),
        smod.UnsupportedSchedule("nope", supported=["ddim:16"],
                                 retry_after_s=1.0),
        smod.ReplicaDraining("drain", replica="r1", retry_after_s=3.0),
        smod.SessionLost("gone", replica="r0", retry_after_s=5.0),
        smod.ReplicaOverBudget("hbm", replica="w0", retry_after_s=1.5,
                               budget_bytes=100, resident_bytes=60,
                               program_peak_bytes=50),
        mod.FrameTooLarge("big"), mod.FrameTruncated("cut"),
        mod.FrameGarbage("junk"), ValueError("bad"), KeyError("k"),
        RuntimeError("boom"), OSError("not on the wire"),
    ]


@pytest.mark.parametrize("i", range(14))
def test_error_round_trip_matches_jax(i):
    exc_p = _errors(ptransport, psched)[i]
    exc_j = _errors(jtransport, jsched)[i]
    wire_p = ptransport.encode_error(exc_p)
    assert json.dumps(wire_p) == json.dumps(jtransport.encode_error(exc_j))
    back_p = ptransport.decode_error(wire_p)
    back_j = jtransport.decode_error(wire_p)
    assert type(back_p).__name__ == type(back_j).__name__
    assert str(back_p) == str(back_j)
    for f in ("retry_after_s", "replica", "supported", "budget_bytes",
              "resident_bytes", "program_peak_bytes"):
        assert getattr(back_p, f, None) == getattr(back_j, f, None)


@pytest.mark.parametrize("fault", ["too_large", "truncated", "garbage"])
def test_frame_faults(fault):
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    try:
        if fault == "too_large":
            a.sendall(struct.pack("!I", 1 << 20))
            with pytest.raises(ptransport.FrameTooLarge):
                ptransport.recv_frame(b, max_bytes=1 << 16)
            with pytest.raises(ptransport.FrameTooLarge):
                ptransport.send_frame(a, {"x": "y" * (1 << 16)},
                                      max_bytes=1 << 16)
        elif fault == "truncated":
            a.sendall(struct.pack("!I", 100) + b'{"op": ')
            a.shutdown(socket.SHUT_WR)
            with pytest.raises(ptransport.FrameTruncated):
                ptransport.recv_frame(b)
        else:
            for body in (b"[1, 2]", b"not json"):
                a.sendall(struct.pack("!I", len(body)) + body)
                with pytest.raises(ptransport.FrameGarbage):
                    ptransport.recv_frame(b)
        assert issubclass(ptransport.FrameTooLarge,
                          ptransport.TransportError)
    finally:
        a.close()
        b.close()


def test_request_wire_matches_jax():
    for traj in (False, True):
        kw = dict(seed=3, n_views=3, session_id="obj-7",
                  sampler_kind="ancestral", steps=4, timeout_s=9.0,
                  request_id="req-x")
        jr = (jsched.TrajectoryRequest if traj else jsched.ViewRequest)(
            _views(1), **kw)
        pr = (psched.TrajectoryRequest if traj else psched.ViewRequest)(
            _views(1), **kw)
        wire = json.dumps(ptransport.encode_payload(
            ptransport.request_wire(pr)))
        assert wire == json.dumps(jtransport.encode_payload(
            jtransport.request_wire(jr)))
        back = ptransport.request_from_wire(ptransport.decode_payload(
            json.loads(wire)))
        assert type(back) is type(pr)
        assert (back.id, back.seed, back.session_id, back.bucket) == (
            pr.id, pr.seed, pr.session_id, pr.bucket)


# --- a port Worker behind a RemoteReplica -----------------------------------------


def _cfg(**over):
    cfg = pconfig.test_config(imgsize=H, ch=8)
    return dataclasses.replace(cfg, serving=pconfig.ServingConfig(
        **dict(SERVING, **over)))


@pytest.fixture(scope="module")
def worker():
    w = pworker.boot_worker(_cfg(), name="w0", devices=[0], device="cpu")
    w.start()
    yield w
    w.stop()


def _remote(w, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("heartbeat_timeout_s", 1.0)
    return ptransport.RemoteReplica("127.0.0.1", w.port, **kw).start()


def test_remote_replica_serves_bit_identical_to_the_worker(worker):
    """A plain request and a trajectory through the wire: the views are
    the worker's offline ``synthesize_many`` bit for bit, the
    trajectory's frames arrive through the cursor; the warm-up captured
    every lane count of the max_views bucket."""
    rr = _remote(worker)
    try:
        assert rr.name == "w0" and rr.health == "ok"
        assert rr.supported_schedules() == ["ancestral:4"]
        assert not rr.supports_cascade()      # the wire carries none
        progs = worker.replica.engine.programs.stats()["programs"]
        assert set(progs) == {"H8xW8xcap4xlanes1", "H8xW8xcap4xlanes2"}
        out = rr.submit(psched.ViewRequest(
            _views(2), seed=2, session_id="s2")).result(timeout=WAIT)
        traj = rr.submit(psched.TrajectoryRequest(_views(3), seed=3))
        frames = traj.result(timeout=WAIT)
        sampler = worker.replica.engine.sampler
        for got, seed in ((out, 2), (frames, 3)):
            (ref,) = sampler.synthesize_many(
                [_views(seed)], [torch.Generator().manual_seed(seed)])
            np.testing.assert_array_equal(got, ref)
        assert len(traj.frames_since(0)) == 2
        assert rr.session_records() == {"s2": 1}
        assert rr.snapshot()["transport"]["connected"]
    finally:
        rr.stop()


def test_wire_swap_takes_state_dict_names_and_refuses_foreign_trees(worker):
    rr = _remote(worker)
    try:
        sd = worker.replica.engine.sampler.model.state_dict()
        version = rr.swap_params({k: t.clone() for k, t in sd.items()},
                                 "same")
        assert version == "same"
        foreign = {"params/" + k.replace(".", "/"): t for k, t in sd.items()}
        with pytest.raises(ValueError, match="key mismatch"):
            rr.swap_params(foreign, "flax")
    finally:
        rr.stop()


def test_admission_rejects_at_the_door_over_the_wire():
    """With a budget of one request's pin plus record, a second request
    in flight is refused ``ReplicaOverBudget`` with the arithmetic."""
    cfg = _cfg()
    w = pworker.boot_worker(cfg, name="w-gate", devices=[0], device="cpu")
    gate = w.admission
    gate.program_peaks = {"step_many": 10_000}
    one = psched.ViewRequest(_views(1), seed=1)
    gate.budget_bytes = 10_000 + gate.record_bytes(one) + 1
    w.start()
    rr = _remote(w)
    try:
        first = rr.submit(one)
        with pytest.raises(psched.ReplicaOverBudget) as ei:
            rr.submit(psched.ViewRequest(_views(2), seed=2))
        e = ei.value
        assert (e.budget_bytes, e.resident_bytes, e.program_peak_bytes) == (
            gate.budget_bytes, gate.record_bytes(one), 10_000)
        assert e.replica == "w-gate" and e.retry_after_s == 0.1
        first.result(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while gate.snapshot()["resident_bytes"]:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rr.submit(psched.ViewRequest(_views(2), seed=2)).result(timeout=WAIT)
        assert gate.snapshot()["rejects"] == 1
    finally:
        rr.stop()
        w.stop()


def test_heartbeat_death_rejects_in_flight_with_session_lost():
    """A worker that goes silent with a request in flight: past the
    heartbeat timeout the remote replica is dead and the request fails
    with ``SessionLost`` naming it."""
    w = pworker.boot_worker(_cfg(), name="w-dies", devices=[0],
                            device="cpu")
    inj = FaultInjector(seed=0)
    inj.add(arm_replica(w.replica, inj), kind="slow", delay_s=0.5,
            prob=1.0)
    w.start()
    rr = _remote(w, heartbeat_timeout_s=0.3)
    req = psched.ViewRequest(_views(4, n_views=3), seed=4,
                             session_id="doomed")
    try:
        rr.submit(req)
        w.stop()
        with pytest.raises(psched.SessionLost) as ei:
            req.result(timeout=WAIT)
        assert ei.value.replica == "w-dies"
        deadline = time.monotonic() + WAIT
        while rr.health != "dead":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert rr.transport_stats()["heartbeat_timeouts"] == 1
    finally:
        rr.stop()


@pytest.mark.parametrize("budget", [0, 25_000, 60_000, 120_000, 300_000])
def test_admission_arithmetic_matches_jax(budget):
    """The same requests, pins and budget through both gates (the JAX
    gate given the port's record bytes): the same admit / refuse
    decisions, charged pins and snapshots."""
    pins = {"step_many": 20_000, "step_many_ddim": 5_000}
    port_gate = pworker.HbmAdmission(budget, program_peaks=pins,
                                     replica_name="w", guidance_B=8)
    jax_gate = jworker.HbmAdmission(budget, manifest_dir="/no-manifests",
                                    replica_name="w")
    jax_gate.program_peaks = dict(pins)
    jax_gate.record_bytes = port_gate.record_bytes
    traces = []
    for gate, smod in ((port_gate, psched), (jax_gate, jsched)):
        trace = []
        reqs = [smod.ViewRequest(_views(i, n_views=n), seed=i,
                                 sampler_kind=kind, request_id=f"r{i}")
                for i, (n, kind) in enumerate(
                    [(3, None), (2, "ddim"), (3, "ancestral"), (2, None),
                     (3, None)])]
        # An unpinned program (a cascade phase) is charged the largest
        # pin, with one warning.
        reqs[3].bucket = reqs[3].bucket._replace(phase="draft")
        for i, r in enumerate(reqs):
            try:
                gate.admit(r, default_kind="ancestral")
                trace.append("ok")
            except Exception as e:
                trace.append((type(e).__name__, e.resident_bytes,
                              e.program_peak_bytes))
            if i == 2:
                gate.release("r0")
        trace.append(gate.snapshot())
        traces.append(trace)
    assert traces[0] == traces[1]


def test_record_bytes_are_the_staged_record(worker):
    """The gate charges what the engine stages for one lane: the float32
    record images, poses and intrinsics."""
    from diff3d_tpu_torch.serving.engine import _Slot

    req = psched.ViewRequest(_views(5), seed=5)
    slot = _Slot(req, 8, torch.device("cpu"))
    staged = sum(a.nbytes for a in (slot.record_imgs, slot.record_R,
                                    slot.record_T, req.K))
    assert slot.record_imgs.dtype == np.float32
    assert worker.admission.record_bytes(req) == staged


# --- worker_cli ------------------------------------------------------------------


def test_worker_cli_process_fronted_by_serve_cli_then_sigterm():
    """``worker_cli --device cpu`` as a process; ``serve_cli --workers``
    fronts it remote-only (no engine of its own); a request through the
    front door; SIGTERM drains the worker and it exits 0."""
    cmd = [sys.executable, "-m", "diff3d_tpu_torch.cli.worker_cli",
           "--device", "cpu", "--devices", "0", "--config", "test",
           "--init", "random", "--imgsize", "8", "--port", "0",
           "--max_views", "3", "--max_batch", "1", "--name", "wp"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    svc = None
    try:
        readable, _, _ = select.select([proc.stdout], [], [], WAIT)
        assert readable, "worker_cli printed no ready line"
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["name"] == "wp"
        args = serve_cli.build_parser().parse_args(
            ["--config", "test", "--imgsize", "8", "--port", "0",
             "--workers", f"127.0.0.1:{ready['port']}"])
        svc = serve_cli.build_service(args)
        assert isinstance(svc, FleetService)
        assert not any(hasattr(r, "engine") for r in svc.replicas)
        svc.start(serve_http=True)
        payload = {"views": {k: v.tolist() for k, v in _views(6).items()},
                   "seed": 6}
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc.port}/synthesize",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            body = json.loads(r.read())
        views = np.asarray(body["views"], np.float32)
        assert views.shape == (2, 8, H, H, 3) and np.isfinite(views).all()
        svc.stop()
        svc = None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if svc is not None:
            svc.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()


def test_worker_cli_without_device_and_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = worker_cli.build_parser().parse_args(
        ["--devices", "0", "--config", "test", "--init", "random"])
    with pytest.raises(RuntimeError, match="CUDA"):
        worker_cli.build_worker(args)


@pytest.mark.parametrize("argv", [
    ["--compile_cache", "/tmp/c"], ["--host_device_count", "8"],
    ["--memcheck_dir", "runs/memcheck"], ["--devices", ""]])
def test_worker_cli_refuses_flags_without_a_counterpart(argv):
    base = ["--device", "cpu", "--config", "test", "--init", "random"]
    if "--devices" not in argv:
        base += ["--devices", "0"]
    with pytest.raises(SystemExit) as ei:
        worker_cli.build_worker(worker_cli.build_parser().parse_args(
            base + argv))
    assert ei.value.code not in (0, None)
