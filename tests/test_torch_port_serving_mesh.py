"""Serving over a mesh of ranks on the CPU: the leader/follower view step
(``serving/ranks.py``, ``Engine.follow``), ``CascadeSampler(mesh=)``,
``serve_cli --mesh`` and ``worker_cli --devices`` slices.

(a) holds the lane arithmetic against the JAX package's engine.  The
multi-rank cases run on 2 gloo ranks spawned by
``diff3d_tpu_torch.testing.distributed.spawn`` (rank bodies in
``tests/_torch_port_serving_mesh_worker.py``, one torch thread each), the
``test`` config at 8x8 (the cascade's refine at 16x16): one group runs
(b) three requests, one admitted mid-job, (d) a weights swap mid-job,
(e) a retried step, (c) the cascade over HTTP and (g) ``serve_cli.main
--mesh``; a second group (f) loses its follower mid-job.  Every rank's
views must be bit-identical, and the served views within 1e-5 of one
process's engine on the same seeds or draws and weights (the tolerance
of ``test_torch_port_parallel_train.py``'s ``Sampler(mesh)`` check: the
ranks run other batch shapes).  (b) and (c) also serve the JAX package's
weights with its ``PRNGKey`` draws replayed (each lane's draw source
travels in the step's plan to the rank that runs it) and are held against
the JAX package's ``ServingService`` on its data=2 virtual CPU mesh.  (h)
runs ``worker_cli --devices 0-1`` as processes.
"""

import copy
import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import jax
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.cascade import CascadePlan as JPlan  # noqa: E402
from diff3d_tpu.cascade import CascadeSampler as JCascade  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from diff3d_tpu.sampling import Sampler as JSampler  # noqa: E402
from diff3d_tpu.serving import ServingService as JService  # noqa: E402
from diff3d_tpu.serving import engine as jengine  # noqa: E402
from diff3d_tpu_torch.cli import serve_cli, worker_cli  # noqa: E402
from diff3d_tpu_torch.convert import load_flax_params  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.serving import ServingService  # noqa: E402
from diff3d_tpu_torch.serving import engine as pengine  # noqa: E402
from diff3d_tpu_torch.serving.metrics import MetricsRegistry  # noqa: E402
from diff3d_tpu_torch.serving.scheduler import Scheduler  # noqa: E402
from diff3d_tpu_torch.serving.worker import boot_worker  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402

import _torch_port_serving_mesh_worker as worker  # noqa: E402
from _torch_port_threads import one_thread  # noqa: E402,F401
from test_torch_port_cascade import _jax_cascade_draws  # noqa: E402
from test_torch_port_sampler import jax_view_draws  # noqa: E402
from test_torch_port_sampler_runtime import (  # noqa: E402
    _assert_close_to_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60.0
JAX_WAIT = 300.0                # the JAX references' compiles included
TOL = 1e-5
#: A follower must be gone this long after its leader's SIGKILL (it sees
#: the closed socket at once, or its parent gone within 0.5 s).
FOLLOWER_EXIT_S = 10.0


# --- (a) lane arithmetic ------------------------------------------------------


def _stub_sampler(multiple, *, jax_side):
    if jax_side:
        return types.SimpleNamespace(params={"w": np.zeros(2, np.float32)},
                                     lane_multiple=multiple,
                                     sampler_kind="ancestral", steps=4,
                                     w=np.zeros(8, np.float32))
    return types.SimpleNamespace(model=torch.nn.Linear(2, 2),
                                 lane_multiple=multiple, cuda_graphs=False,
                                 device=torch.device("cpu"),
                                 sampler_kind="ancestral", steps=4,
                                 w=torch.zeros(8))


@pytest.mark.parametrize("multiple", [1, 2, 4])
@pytest.mark.parametrize("max_batch", range(1, 9))
def test_lane_count_and_max_batch_rounding_match_the_jax_engine(
        max_batch, multiple):
    """The port's ``lane_count`` over n 1-9 and its engine's rounded
    ``max_batch`` (healthy and degraded) equal the JAX package's."""
    from diff3d_tpu import config as jconfig
    from diff3d_tpu.serving.metrics import MetricsRegistry as JMetrics
    from diff3d_tpu.serving.scheduler import Scheduler as JScheduler
    from diff3d_tpu_torch import config as pconfig

    jcfg = jconfig.ServingConfig(max_batch=max_batch)
    pcfg = pconfig.ServingConfig(max_batch=max_batch)
    jm, pm = JMetrics(), MetricsRegistry()
    je = jengine.Engine(_stub_sampler(multiple, jax_side=True),
                        JScheduler(metrics=jm), jm, jcfg)
    pe = pengine.Engine(_stub_sampler(multiple, jax_side=False),
                        Scheduler(metrics=pm), pm, pcfg)
    assert pe.max_batch == je.max_batch
    for n in range(1, 10):
        assert pengine.lane_count(n, pe.max_batch, multiple) == \
            jengine.lane_count(n, je.max_batch, multiple)
    for eng in (je, pe):
        eng._set_health(pengine.HEALTH_DEGRADED)
    assert pe._effective_max_batch() == je._effective_max_batch()


# --- the JAX package's service on its data=2 virtual CPU mesh ----------------


def _both_packages(imgsize):
    """The tiny X-UNet at ``imgsize`` with the same random weights in both
    packages (the recipe of ``test_torch_port_sampler_runtime.py``'s
    ``tiny``): the JAX config, model and params, and the port's state
    dict."""
    jcfg = jconfig.test_config(imgsize=imgsize, ch=8)
    jm = JXUNet(jcfg.model)
    B = len(jcfg.diffusion.guidance_weights)
    batch = {"x": np.zeros((2 * B, imgsize, imgsize, 3), np.float32),
             "z": np.zeros((2 * B, imgsize, imgsize, 3), np.float32),
             "logsnr": np.zeros((2 * B, 2), np.float32),
             "R": np.zeros((2 * B, 2, 3, 3), np.float32),
             "t": np.zeros((2 * B, 2, 3), np.float32),
             "K": np.tile(np.eye(3, dtype=np.float32), (2 * B, 1, 1))}
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch, cond_mask=np.ones(2 * B, bool)))
    rng = np.random.default_rng(8)
    flat = {k: (0.08 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in flatten_dict(shapes["params"], sep="/").items()}
    model = worker.tiny_model(worker.mesh_cfg(imgsize))
    load_flax_params(model, flat)
    return jcfg, jm, unflatten_dict(flat, sep="/"), model.state_dict()


def _jax_service(jcfg, jm, params, plan=None):
    """The JAX package's ``ServingService`` over a data=2 mesh of its
    virtual CPU devices (``tests/test_cascade.py``'s acceptance run), the
    workers' serving config."""
    env = jmake_mesh(jconfig.MeshConfig(data_parallel=2, model_parallel=1),
                     devices=jax.devices()[:2])
    jcfg = dataclasses.replace(jcfg, serving=jconfig.ServingConfig(
        **worker.SERVING))
    cascade = None if plan is None else JCascade(jm, params, jcfg, plan,
                                                 mesh=env)
    return JService(JSampler(jm, params, jcfg, mesh=env), jcfg,
                    cascade=cascade)


def _replay(d):
    """A ``jax_view_draws`` source as the ranks' picklable replay."""
    return worker.Replay(d._init, d._idx, d._x, d._noise)


class _Later:
    """``fn()`` run on a thread of its own from now on; :meth:`get` waits
    for its value (the JAX package's services compile while the ranks
    run)."""

    def __init__(self, fn):
        self._out = {}
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - raised by get()
            self._out["error"] = e

    def get(self):
        self._thread.join(JAX_WAIT)
        assert not self._thread.is_alive(), "the JAX reference hangs"
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def _jax_b(jcfg, jm, params):
    """(b)'s requests on the JAX service, which draws from
    ``PRNGKey(seed)``: each request's served views, and its views from the
    JAX ``synthesize`` alone (the reference's second path)."""
    svc = _jax_service(jcfg, jm, params)
    reqs = [svc.submit(worker.payload(s, n_views=n))
            for s, n in worker.B_REQUESTS]
    svc.start(serve_http=False)
    try:
        served = [np.asarray(r.result(timeout=JAX_WAIT)) for r in reqs]
    finally:
        svc.stop()
    alone = JSampler(jm, params, jcfg)
    seq = [np.asarray(alone.synthesize(
        worker.views(max(n, 3), 100 + s), jax.random.PRNGKey(s),
        max_views=n)) for s, n in worker.B_REQUESTS]
    return {"served": served, "seq": seq}


def _jax_c(jcfg, jm, params, plan):
    """(c)'s cascade (seed 11) on the JAX service: its refined views and
    draft frames, and the offline ``synthesize_cascade``'s."""
    svc = _jax_service(jcfg, jm, params, plan)
    svc.start(serve_http=False)
    try:
        req = svc.submit_cascade(worker.payload(11, size=worker.CASCADE_H))
        refined = np.asarray(req.result(timeout=JAX_WAIT))
        drafts = np.stack([np.asarray(e["frame"])
                           for e in req.events_since(0)
                           if e["phase"] == "draft"])
    finally:
        svc.stop()
    offline = JCascade(jm, params, jcfg, plan).synthesize_cascade(
        worker.views(3, 111, worker.CASCADE_H), jax.random.PRNGKey(11))
    return {"refined": refined, "drafts": drafts,
            "offline_refined": np.asarray(offline["refined"]),
            "offline_drafts": np.asarray(offline["draft"])}


@pytest.fixture(scope="module")
def jax_refs():
    """The weights of (b) (8x8) and (c) (16x16) in both packages, the
    draws the port's requests replay (``PRNGKey(seed)``'s for (b), the
    cascade's phase streams of seed 11 for (c)), and the JAX services'
    results of both, computed on threads while the ranks run."""
    jcfg, jm, params, b_state = _both_packages(worker.H)
    B = len(jcfg.diffusion.guidance_weights)
    b_draws = {}
    for seed, n in worker.B_REQUESTS:
        carry, b_draws[seed] = jax.random.PRNGKey(seed), []
        for view in range(1, n):
            carry, d = jax_view_draws(carry, (B, worker.H, worker.H, 3),
                                      jcfg.diffusion.timesteps, view)
            b_draws[seed].append(_replay(d))
    b = _Later(lambda: _jax_b(jcfg, jm, params))
    ccfg, cm, cparams, c_state = _both_packages(worker.CASCADE_H)
    plan = JPlan.parse(worker.CASCADE_PLAN)
    c_draws = {phase: [_replay(d) for d in ds] for phase, ds in
               _jax_cascade_draws(11, 3, B, ccfg, plan).items()}
    c = _Later(lambda: _jax_c(ccfg, cm, cparams, plan))
    return {"b_state": b_state, "c_state": c_state,
            "draws": {"b": b_draws, "c": c_draws}, "b": b, "c": c}


@pytest.fixture(scope="module")
def jax_b(jax_refs, group):
    return dict(jax_refs["b"].get(), state=jax_refs["b_state"],
                draws=jax_refs["draws"]["b"])


@pytest.fixture(scope="module")
def jax_c(jax_refs, group):
    return dict(jax_refs["c"].get(), state=jax_refs["c_state"])


# --- the 2-rank group: (b), (c), (d), (e), (g) -----------------------------------


@pytest.fixture(scope="module")
def cfg():
    return worker.mesh_cfg()


@pytest.fixture(scope="module")
def swap_state(cfg):
    return worker.tiny_model(cfg, seed=1).state_dict()


@pytest.fixture(scope="module")
def group(swap_state, jax_refs):
    return spawn("_torch_port_serving_mesh_worker:group", 2, swap_state,
                 jax_refs["b_state"], jax_refs["c_state"],
                 jax_refs["draws"], timeout_s=240)


def _one_process(cfg, state=None, **serving):
    """One process's engine (no mesh) on the ranks' weights (``state``:
    those of (b) or (c))."""
    c = worker.mesh_cfg(**serving) if serving else cfg
    model = worker.tiny_model(c)
    if state is not None:
        model.load_state_dict(state)
    svc = ServingService(Sampler(model, c, device="cpu"), c)
    steps = worker.record_steps(svc.engine)
    return svc, steps


def _same_steps(r0, r1, key):
    assert len(r0[key]) == len(r1[key]) > 0
    for a, b in zip(r0[key], r1[key]):
        assert a["lanes"] == b["lanes"]
        assert a["generation"] == b["generation"]
        np.testing.assert_array_equal(a["views"], b["views"])


@pytest.mark.lock_witness
def test_served_on_two_ranks_matches_one_process(group, cfg, jax_b,
                                                 lock_witness):
    """(b) Three requests, the third admitted mid-job (3 live lanes pad to
    4, two a rank), each replaying its ``PRNGKey(seed)`` draws (the plan
    carries each lane's source to the rank that runs it): every rank's
    views of every step bit-identical, the weights' digest the same
    (rank 0 alone loaded them), and each request's views within 1e-5 of
    one process's engine on the same draws."""
    r0, r1 = group
    assert r0["digest"] == r1["digest"]
    assert [s["lanes"] for s in r0["b_steps"]] == [2, 4, 4]
    _same_steps(r0, r1, "b_steps")
    assert r1["b_counts"]["plan"] == r0["b_counts"]["plan"] == len(
        r0["b_steps"])
    svc, _ = _one_process(cfg, jax_b["state"])
    svc.start(serve_http=False)
    try:
        want = worker.serve_requests(svc, copy.deepcopy(jax_b["draws"]))
    finally:
        svc.stop()
    assert len(want) == len(r0["b_results"]) == 3
    for got, ref in zip(r0["b_results"], want):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_served_on_two_ranks_matches_the_jax_service(group, jax_b):
    """(b) The same three requests against the JAX package's service on
    its data=2 virtual CPU mesh, which draws from ``PRNGKey(seed)``: 1e-5
    where the JAX package's own two paths (its served batch and its
    ``synthesize`` alone) agree to 1e-5, within their disagreement
    elsewhere (``test_torch_port_sampler_runtime.py`` gives the
    reason)."""
    got = group[0]["b_results"]
    assert len(got) == len(jax_b["served"]) == 3
    for out, ref, seq in zip(got, jax_b["served"], jax_b["seq"]):
        assert out.shape == ref.shape == seq.shape
        _assert_close_to_reference(out, ref, seq)


@pytest.mark.lock_witness
def test_swap_lands_at_the_same_step_on_every_rank(group, cfg, swap_state,
                                                   lock_witness):
    """(d) A swap staged on the leader during the first view step lands at
    the second on both ranks (the weights generation each rank ran), and
    the views equal one process's under the same swap."""
    r0, r1 = group
    _same_steps(r0, r1, "d_steps")
    assert [s["generation"] for s in r1["d_steps"]] == [0, 1, 1]
    assert r0["d_version"] == "swapped"
    svc, _ = _one_process(cfg)
    svc.engine.programs.step_many = worker._after(
        svc.engine.programs.step_many, worker.swap_after(svc, 1, swap_state))
    svc.start(serve_http=False)
    try:
        want = svc.submit(worker.payload(4, n_views=4)).result(timeout=WAIT)
    finally:
        svc.stop()
    np.testing.assert_allclose(r0["d_results"][0], want, rtol=TOL, atol=TOL)


def test_retried_step_equals_the_clean_run(group):
    """(e) The leader's first attempt at a view step fails before its
    share ran: the follower learns it at the agreement, the leader sends
    the plan again, and the views equal the clean run's bit for bit."""
    r0, r1 = group
    clean, retried = r0["e_results"]
    np.testing.assert_array_equal(retried, clean)
    _same_steps(r0, r1, "e_steps")
    # 2 view steps a run; the failed attempt sent its plan too.
    assert r0["e_counts"]["plan"] == r1["e_counts"]["plan"] == 5
    assert r0["e_faults"] == 0          # retried, never failed a request


def test_cascade_on_the_mesh_previews_then_refines(group):
    """(c) The counterpart of ``tests/test_cascade.py``'s data=2 run: a
    3-view cascade, every draft event before any refine event, a gapless
    ``?from=`` cursor, the result the refine events, and a pinned-seed
    rerun bit-identical; every rank ran the same steps."""
    r0, r1 = group
    _same_steps(r0, r1, "c_steps")
    runs = r0["c_runs"]
    for head, events, cursors, body in runs:
        assert head["n_frames"] == 2 and head["n_events"] == 4
        for frm, nxt, evs in cursors:
            assert evs == list(range(frm, nxt))
        assert [(e["phase"], e["frame"]) for e in events] == [
            ("draft", 0), ("draft", 1), ("refine", 0), ("refine", 1)]
        result = np.asarray(body["views"], np.float32)
        for e in events[2:]:
            np.testing.assert_array_equal(
                np.asarray(e["view"], np.float32), result[e["frame"]])
    np.testing.assert_array_equal(np.asarray(runs[0][3]["views"]),
                                  np.asarray(runs[1][3]["views"]))


def test_cascade_on_the_mesh_matches_one_process(group, jax_c):
    """(c) The cascade's refined views within 1e-5 of one process's
    offline cascade on the same seed and weights."""
    from diff3d_tpu_torch.cascade import CascadePlan, CascadeSampler

    r0, _ = group
    ccfg = worker.mesh_cfg(imgsize=worker.CASCADE_H)
    model = worker.tiny_model(ccfg)
    model.load_state_dict(jax_c["state"])
    casc = CascadeSampler(model, ccfg,
                          CascadePlan.parse(worker.CASCADE_PLAN),
                          device="cpu")
    v = worker.views(3, 111, worker.CASCADE_H)
    want = casc.synthesize_cascade(v, seed=11)["refined"]
    np.testing.assert_allclose(np.asarray(r0["c_runs"][0][3]["views"],
                                          np.float32), want,
                               rtol=TOL, atol=TOL)


def test_cascade_on_the_mesh_matches_the_jax_service(group, jax_c):
    """(c) The cascade again with its phases' ``PRNGKey(11)`` draws
    replayed (each child takes its phase's): the refined views and the
    draft frames against the JAX package's service on its data=2 virtual
    CPU mesh, 1e-5 where its served and offline cascades agree to 1e-5,
    within their disagreement elsewhere."""
    refined, drafts = group[0]["c_replayed"]
    assert refined.shape == jax_c["refined"].shape == (
        2, 8, worker.CASCADE_H, worker.CASCADE_H, 3)
    assert drafts.shape == jax_c["drafts"].shape == (2, 8, 8, 8, 3)
    _assert_close_to_reference(refined, jax_c["refined"],
                               jax_c["offline_refined"])
    _assert_close_to_reference(drafts, jax_c["drafts"],
                               jax_c["offline_drafts"])


def test_serve_cli_mesh_in_a_group_answers_and_both_ranks_return(group):
    """(g) ``serve_cli.main --mesh`` in the 2-rank group: rank 0 answers
    two HTTP requests, SIGTERM stops it, and the follower returns from
    ``main`` when the leader stops (both ranks' bodies ran to their
    end)."""
    r0, r1 = group
    assert len(r0["g_answers"]) == 2 and r1["g_answers"] == []
    for status, body in r0["g_answers"]:
        views = np.asarray(body["views"], np.float32)
        assert status == 200 and views.shape == (2, 8, 8, 8, 3)
        assert np.isfinite(views).all()


# --- (f) a follower that exits mid-job --------------------------------------------


def test_follower_exit_rejects_the_inflight_request():
    """(f) The follower exits during a 4-view request's second view step:
    the leader rejects the request with a typed retryable error well
    inside the wait, refuses later work, and nothing hangs."""
    r0, r1 = spawn("_torch_port_serving_mesh_worker:follower_exits", 2,
                   timeout_s=120, may_exit=(1,))
    assert r1 is None
    name, msg, retryable = r0["error"]
    assert name == "EngineStepError" and retryable
    assert "serving mesh" in msg or "Connection closed" in msg
    assert r0["waited_s"] < 30.0
    assert r0["broken"] is not None
    assert r0["later"] is not None


# --- (h) worker_cli --devices over two ranks ---------------------------------------


def _launch_slice(weights, name):
    cmd = [sys.executable, "-m", "diff3d_tpu_torch.cli.worker_cli",
           "--device", "cpu", "--devices", "0-1", "--config", "test",
           "--imgsize", "8", "--model", weights, "--port", "0",
           "--max_views", "3", "--max_batch", "2", "--name", name]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    readable, _, _ = select.select([proc.stdout], [], [], WAIT)
    assert readable, "worker_cli printed no ready line"
    return proc, json.loads(proc.stdout.readline())


def _gone(pid) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(ln.split()[1:2] == ["Z"] for ln in f
                       if ln.startswith("State:"))
    except FileNotFoundError:
        return True


def _wait_gone(pids, limit):
    deadline = time.monotonic() + limit
    while not all(_gone(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


@pytest.fixture(scope="module")
def slice_weights(cfg, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slice") / "tiny.pt")
    torch.save(worker.tiny_model(cfg).state_dict(), path)
    return path


@pytest.mark.lock_witness
def test_worker_cli_slice_serves_like_one_rank_then_sigterm(
        cfg, slice_weights, lock_witness):
    """(h) ``worker_cli --device cpu --devices 0-1``: the ready line comes
    after both ranks warmed every lane count; fronted by ``serve_cli
    --workers`` it serves a session within 1e-5 of a one-rank worker on
    the same weights; SIGTERM stops the leader and its follower, both
    exit 0."""
    proc, ready = _launch_slice(slice_weights, "ws")
    svc = None
    try:
        assert ready["ready"] and ready["ranks"] == 2
        assert len(ready["followers"]) == 1
        # lanes 2 (max_batch 2 over 2 ranks), one program on each rank
        assert ready["rank_programs"] == [1, 1]
        svc = serve_cli.build_service(serve_cli.build_parser().parse_args(
            ["--config", "test", "--imgsize", "8", "--port", "0",
             "--workers", f"127.0.0.1:{ready['port']}"]))
        svc.start(serve_http=True)
        body = dict(worker.payload(9), session_id="s9")
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc.port}/synthesize",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            got = np.asarray(json.loads(r.read())["views"], np.float32)
        svc.stop()
        svc = None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT) == 0
        assert _wait_gone(ready["followers"], FOLLOWER_EXIT_S)
    finally:
        if svc is not None:
            svc.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()
    one = boot_worker(worker.mesh_cfg(max_batch=2, max_views=3), name="w1",
                      devices=[0], device="cpu", weights=slice_weights)
    one.start()
    try:
        want = one.submit(worker.payload(9)).result(timeout=WAIT)
    finally:
        one.stop()
    assert got.shape == want.shape == (2, 8, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_worker_cli_slice_followers_exit_after_leader_sigkill(
        slice_weights):
    """(h) SIGKILL of a slice's leader: its follower is gone within
    ``FOLLOWER_EXIT_S`` (the counterpart of ``tests/test_transport.py``'s
    killed worker)."""
    proc, ready = _launch_slice(slice_weights, "wk")
    try:
        pids = ready["followers"]
        assert pids and not any(_gone(p) for p in pids)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=WAIT)
        assert _wait_gone(pids, FOLLOWER_EXIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        proc.stdout.close()


def test_admission_pins_are_the_largest_over_the_ranks():
    """A slice's admission pin of each program is the largest first-use
    bytes any rank read (off the card no rank reads any: no pin)."""
    from diff3d_tpu_torch.serving.worker import rank_pins

    def stats(**peaks):
        return {"programs": {f"g{i}": {"peak_bytes": b, "sampler": kind,
                                       "phase": None}
                             for i, (kind, b) in enumerate(peaks.items())}}

    assert rank_pins([stats(ancestral=5, ddim=None),
                      stats(ancestral=3, ddim=7)]) == {
        "step_many": 5, "step_many_ddim": 7}
    assert rank_pins([stats(ancestral=None)] * 2) == {}


@pytest.mark.parametrize("devices", ["0,0", "0,1,0"])
def test_worker_cli_refuses_duplicate_devices(devices):
    with pytest.raises(SystemExit) as ei:
        worker_cli.build_worker(worker_cli.build_parser().parse_args(
            ["--device", "cpu", "--config", "test", "--init", "random",
             "--devices", devices]), [])
    assert ei.value.code not in (0, None)


def test_worker_cli_refuses_devices_out_of_range(monkeypatch):
    """An index past the host's cards is refused before any rank
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as ei:
        worker_cli.build_worker(worker_cli.build_parser().parse_args(
            ["--config", "test", "--init", "random", "--devices", "0-1"]),
            [])
    assert "out of range" in str(ei.value.code)
