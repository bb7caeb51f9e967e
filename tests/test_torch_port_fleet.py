"""The port's serving fleet (``diff3d_tpu_torch/serving/fleet.py``,
``router.py``, ``cli/serve_cli.py --replicas / i@``) on the CPU, against
the JAX package's (``diff3d_tpu/serving/router.py``).

The router is framework-neutral, so both packages' ``Router`` are driven
through the same scripted scenarios over the same stub replicas
(``tests/test_router.py``'s ``FakeReplica``) and must take the same
decisions: placement, failover, typed rejections, the session table and
the rollout's steps.  A real 2-replica fleet then serves the tiny model
over HTTP on the CPU; each replica's views are bit for bit its own
offline ``synthesize_many`` over the same lanes.  Every wait has its
own timeout.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu.serving import router as jrouter  # noqa: E402
from diff3d_tpu.serving import scheduler as jsched  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.cli import serve_cli  # noqa: E402
from diff3d_tpu_torch.models import build_model  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.serving import router as prouter  # noqa: E402
from diff3d_tpu_torch.serving import scheduler as psched  # noqa: E402
from diff3d_tpu_torch.serving.fleet import build_fleet  # noqa: E402
from diff3d_tpu_torch.testing import FaultInjector, arm_replica  # noqa: E402
from test_router import FakeReplica  # noqa: E402

H = 8
WAIT = 60.0
SERVING = dict(port=0, max_batch=2, max_queue=8, max_wait_ms=20.0,
               max_views=6, default_timeout_s=60.0, retry_after_s=0.1,
               result_cache_entries=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the tiny model (the engine threads
    inherit it)."""
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


# --- the routing core against the JAX package's ----------------------------


def test_rendezvous_order_matches_jax():
    """200 session ids over 2-4 named replicas, and again after removing
    one: the same ranking in both packages."""
    sids = [f"sess-{i}" for i in range(200)]
    for n in (2, 3, 4):
        reps = [FakeReplica(f"r{i}") for i in range(n)]
        for pool in (reps, reps[:1] + reps[2:]):
            for sid in sids:
                want = [r.name for r in jrouter.Router.rendezvous_order(
                    sid, pool)]
                got = [r.name for r in prouter.Router.rendezvous_order(
                    sid, pool)]
                assert got == want


def _outcome(fn):
    """``fn()``'s replica, or the typed rejection's class and fields."""
    try:
        return ("placed", fn())
    except Exception as e:
        return (type(e).__name__, getattr(e, "replica", None),
                getattr(e, "retry_after_s", None),
                sorted(getattr(e, "supported", None) or []))


def _scenario(name, rmod, smod):
    """Drive one scripted scenario through ``rmod.Router`` with
    ``smod``'s request and error classes; returns its trace."""
    def req(i, sid=None, **kw):
        return smod.ViewRequest(_views(i, n_views=2, size=4), seed=i,
                                n_views=2, session_id=sid, **kw)

    def owner_of(router, r):
        router.submit(r)
        return next(rep.name for rep in router.replica_list()
                    if r in rep.submitted)

    trace = []
    if name == "least_loaded":
        reps = [FakeReplica("r0", depth=5), FakeReplica("r1", depth=0),
                FakeReplica("r2", depth=2), FakeReplica("r3", depth=0)]
        router = rmod.Router(reps)
        trace.append(owner_of(router, req(7)))
    elif name == "failover":
        full = smod.QueueFullError("full")
        reps = [FakeReplica("r0", depth=0, submit_exc=full),
                FakeReplica("r1", depth=1, submit_exc=full),
                FakeReplica("r2", depth=2)]
        router = rmod.Router(reps, retry_after_s=0.3)
        trace.append(owner_of(router, req(8)))
        reps[2].submit_exc = smod.EngineDraining("draining",
                                                 retry_after_s=0.1)
        trace.append(_outcome(lambda: router.submit(req(9))))
        reps[1].submit_exc = smod.ReplicaOverBudget("hbm", replica="r1")
        reps[2].submit_exc = None
        trace.append(owner_of(router, req(10)))
    elif name == "sticky":
        reps = [FakeReplica("r0"), FakeReplica("r1"), FakeReplica("r2")]
        router = rmod.Router(reps, retry_after_s=0.25)
        owner = owner_of(router, req(1, "s"))
        trace.append(owner)
        rep = router.replica(owner)
        rep.submit_exc = smod.QueueFullError("full")
        trace.append(_outcome(lambda: router.submit(req(2, "s"))))
        rep.submit_exc = smod.ReplicaOverBudget("hbm", replica=owner,
                                                retry_after_s=0.5)
        trace.append(_outcome(lambda: router.submit(req(3, "s"))))
        rep.submit_exc = None
        trace.append(owner_of(router, req(4, "s")))
        rep.health = "draining"
        trace.append(_outcome(lambda: router.submit(req(5, "s"))))
        rep.health = "dead"
        trace.append(_outcome(lambda: router.submit(req(6, "s"))))
        trace.append(owner_of(router, req(7, "s")))   # re-placed, fresh
    elif name == "claim_release":
        reps = [FakeReplica("r0"), FakeReplica("r1"), FakeReplica("r2")]
        chosen = rmod.Router.rendezvous_order("sess-N", reps)[0]
        chosen.submit_exc = smod.QueueFullError("full")
        router = rmod.Router(reps)
        trace.append(_outcome(lambda: router.submit(req(1, "sess-N"))))
        trace.append(router.fleet_snapshot()["sessions"])
        chosen.submit_exc = None
        trace.append(owner_of(router, req(1, "sess-N")))
    elif name == "churn":
        reps = [FakeReplica("r0"), FakeReplica("r1"), FakeReplica("r2")]
        router = rmod.Router(reps)
        owners = [owner_of(router, req(i, f"s{i}")) for i in range(12)]
        router.add_replica(FakeReplica("r9"))
        reps[1].health = "dead"
        for i in range(12):
            trace.append(_outcome(lambda i=i: owner_of(router,
                                                       req(i, f"s{i}"))))
        for i in range(12, 20):
            trace.append(owner_of(router, req(i, f"s{i}")))
        trace.append(owners)
    elif name == "schedules":
        reps = [FakeReplica("r0", schedules={("ancestral", 4)}, depth=0),
                FakeReplica("r1", schedules={("ancestral", 4),
                                             ("ddim", 2)}, depth=9)]
        router = rmod.Router(reps)
        trace.append(owner_of(router, req(1, sampler_kind="ddim",
                                          steps=2)))
        trace.append(_outcome(lambda: router.submit(
            req(2, sampler_kind="ddim", steps=7))))
        reps[1].health = "draining"
        trace.append(_outcome(lambda: router.submit(
            req(3, sampler_kind="ddim", steps=2))))
    elif name == "rollout":
        good, stuck = FakeReplica("r0"), FakeReplica("r1")
        stuck.drain_ok = False
        dead = FakeReplica("r2", health="dead")
        router = rmod.Router([good, stuck, dead])
        trace.append(router.rollout(params=None, version="v1",
                                    drain_timeout_s=0.1))
        trace.append([good.events, stuck.events, dead.events,
                      good.params_version, stuck.params_version])
        with router._lock:
            router._rollout_active = True
        trace.append(_outcome(lambda: router.rollout(params=None)))
    m = router.metrics.snapshot()["counters"]
    trace.append({k: v for k, v in sorted(m.items())})
    trace.append(router.fleet_snapshot()["sessions"])
    return trace


@pytest.mark.parametrize("name", ["least_loaded", "failover", "sticky",
                                  "claim_release", "churn", "schedules",
                                  "rollout"])
def test_router_decisions_match_jax(name):
    want = _scenario(name, jrouter, jsched)
    got = _scenario(name, prouter, psched)
    assert got == want


# --- a real fleet on the CPU ----------------------------------------------------


def _cfg(**over):
    cfg = pconfig.test_config(imgsize=H, ch=8)
    return dataclasses.replace(cfg, serving=pconfig.ServingConfig(
        **dict(SERVING, **over)))


@pytest.fixture(scope="module")
def model():
    return build_model(_cfg().model, device="cpu", seed=4,
                       randomize_zero_init=True)


def _payload(i, **kw):
    return {"views": {k: v.tolist() for k, v in _views(i).items()},
            "seed": i, "n_views": 3, **kw}


def _post(port, payload, path="/synthesize"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _offline(rep, seeds):
    """``synthesize_many`` on ``rep``'s own sampler over ``seeds``'
    objects (one lane each)."""
    s = rep.engine.sampler
    return s.synthesize_many([_views(i) for i in seeds],
                             [torch.Generator().manual_seed(i)
                              for i in seeds])


def test_fleet_serves_sessions_bit_identical_per_replica(model):
    """Two replicas behind the router over HTTP: every replica owns its
    weights and samplers; sticky sessions land on their rendezvous
    owner, a replica-only schedule lands on that replica, and each
    request's views are its replica's offline views bit for bit."""
    cfg = _cfg(replicas=2)
    sampler = Sampler(model, cfg, device="cpu")
    extra = {("ddim", 2): Sampler(model, cfg, device="cpu",
                                  sampler_kind="ddim", steps=2)}
    svc = prouter.FleetService(build_fleet(
        sampler, cfg, per_replica_extra={1: extra}), cfg).start(
        serve_http=True)
    try:
        r0, r1 = svc.replicas
        assert r0.engine.sampler is sampler
        assert r1.engine.sampler.model is not model
        p0 = dict(model.named_parameters())
        p1 = dict(r1.engine.sampler.model.named_parameters())
        assert all(p1[k].data_ptr() != p0[k].data_ptr() for k in p0)
        assert r0.snapshot()["weights_bytes"] == r1.snapshot()[
            "weights_bytes"] > 0
        sids = {f"obj-{i}": prouter.Router.rendezvous_order(
            f"obj-{i}", svc.replicas)[0].name for i in range(4)}
        out, errs = {}, []

        def post(i):
            try:
                out[i] = _post(svc.port, _payload(
                    i, session_id=f"obj-{i}"))[1]
            except Exception as e:               # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not errs and len(out) == 4
        for i in range(4):
            rep = svc.router.replica(sids[f"obj-{i}"])
            assert rep.session_count(f"obj-{i}") == 1
            (ref,) = _offline(rep, [i])
            np.testing.assert_array_equal(
                np.asarray(out[i]["views"], np.float32), ref)
        _, d = _post(svc.port, _payload(9, sampler_kind="ddim", steps=2))
        assert d["shape"][0] == 2
        assert r1.engine.programs.stats()["programs"].keys() >= {
            "H8xW8xcap4xddim2xlanes1"}
        assert not any("ddim" in k for k in r0.engine.programs.stats()[
            "programs"])
        status, fleet = _get(svc.port, "/fleet")
        assert status == 200 and set(fleet["replicas"]) == {"r0", "r1"}
        assert fleet["sessions"]["active"] == 4
    finally:
        svc.stop()


def test_fleet_rollout_kill_and_failover(model):
    """A rolling rollout changes every replica's views and rolling back
    restores them bit for bit with every parameter at its address; then
    replica r0 dies mid-dispatch: its session gets ``SessionLost`` (503,
    naming r0), sessionless traffic fails over to r1."""
    cfg = _cfg(replicas=2)
    own = build_model(cfg.model, device="cpu")
    own.load_state_dict(model.state_dict())
    svc = prouter.FleetService.build(Sampler(own, cfg, device="cpu"), cfg,
                                     n=2).start(serve_http=True)
    try:
        r0, r1 = svc.replicas
        base = {rep.name: _offline(rep, [5])[0] for rep in svc.replicas}
        ptrs = [{k: p.data_ptr() for k, p in
                 rep.engine.sampler.model.named_parameters()}
                for rep in svc.replicas]
        orig = {k: t.clone() for k, t in own.state_dict().items()}
        report = svc.rollout({k: t + 0.05 for k, t in orig.items()}, "v1")
        assert report["ok"] and [s["status"] for s in report["steps"]] == [
            "swapped", "swapped"]
        rolled = {rep.name: rep.submit(psched.ViewRequest(
            _views(5), seed=5, n_views=3)).result(timeout=WAIT)
            for rep in svc.replicas}
        svc.rollout(orig, "v2")
        back = {rep.name: rep.submit(psched.ViewRequest(
            _views(5), seed=5, n_views=3)).result(timeout=WAIT)
            for rep in svc.replicas}
        for name in base:
            assert not np.array_equal(rolled[name], base[name])
            np.testing.assert_array_equal(back[name], base[name])
        assert ptrs == [{k: p.data_ptr() for k, p in
                         rep.engine.sampler.model.named_parameters()}
                        for rep in svc.replicas]
        assert svc.health()["params_versions"] == {"r0": "v2", "r1": "v2"}

        sid = next(f"s{i}" for i in range(50) if prouter.Router
                   .rendezvous_order(f"s{i}", svc.replicas)[0] is r0)
        _post(svc.port, _payload(6, session_id=sid))
        inj = FaultInjector(seed=0)
        site = arm_replica(r0, inj)
        inj.add(site, kind="kill", first_n=1 << 30, max_fires=1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(svc.port, _payload(7, session_id=sid))
        assert ei.value.code == 503
        deadline = time.monotonic() + WAIT
        while r0.health != "dead":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(svc.port, _payload(8, session_id=sid))
        body = json.loads(ei.value.read())
        assert ei.value.code == 503 and ei.value.headers["Retry-After"]
        assert "r0" in body["error"] and "lost" in body["error"]
        _, ok = _post(svc.port, _payload(9))
        (ref,) = _offline(r1, [9])
        np.testing.assert_array_equal(np.asarray(ok["views"], np.float32),
                                      ref)
        counters = svc.metrics_snapshot()["counters"]
        assert counters["router_sessions_lost_total"] == 1
        assert counters["router_failover_total"] >= 1
        assert svc.health()["replicas"] == {"r0": "dead", "r1": "ok"}
    finally:
        svc.stop()


# --- serve_cli ----------------------------------------------------------------


BASE = ["--init", "random", "--config", "test", "--device", "cpu",
        "--imgsize", "8", "--port", "0", "--max_wait_ms", "0"]


def test_serve_cli_replicas_and_per_replica_schedules():
    args = serve_cli.build_parser().parse_args(
        BASE + ["--replicas", "2", "--schedules", "ddim:2,1@ancestral:2",
                "--warmup"])
    svc = serve_cli.build_service(args)
    try:
        assert isinstance(svc, prouter.FleetService)
        r0, r1 = svc.replicas
        assert r0.supported_schedules() == ["ancestral:4", "ddim:2"]
        assert r1.supported_schedules() == ["ancestral:2", "ancestral:4",
                                            "ddim:2"]
        assert r0.engine.programs.stats()["num_programs"] == 2  # warmed
        assert r1.engine.programs.stats()["num_programs"] == 3
        svc.start(serve_http=True)
        status, body = _post(svc.port, _payload(0, sampler_kind="ancestral",
                                                steps=2))
        assert status == 200 and body["shape"] == [2, 8, H, H, 3]
        assert r1.engine.programs.stats()["programs"][
            "H8xW8xcap4xancestral2xlanes1"]["uses"] == 2    # 2 views
        _, health = _get(svc.port, "/healthz")
        assert health["fleet_size"] == 2 and health["status"] == "ok"
    finally:
        svc.stop(drain_s=1.0)


@pytest.mark.parametrize("argv", [
    ["--mesh"], ["--replicas", "0"],
    ["--schedules", "0@ddim:2"], ["--replicas", "2", "--schedules",
                                  "2@ddim:2"],
    ["--replicas", "2", "--schedules", "x@ddim:2"],
    ["--workers", "127.0.0.1:notaport"], ["--workers", "127.0.0.1:1"],
    ["--cascade", "draft=8:ddim:2,refine=16:ancestral:4@t0.5"],
    ["--imgsize", "16", "--cascade",
     "draft=8:ddim:2,refine=16:ancestral:4@t0.3"]])
def test_serve_cli_flags_that_stay_refused_exit_non_zero(argv):
    with pytest.raises(SystemExit) as ei:
        serve_cli.build_service(serve_cli.build_parser().parse_args(
            BASE + argv))
    assert ei.value.code not in (0, None)


@pytest.mark.parametrize("argv,fleet", [([], False),
                                        (["--replicas", "2"], True)])
def test_serve_cli_accepts_pallas_and_logs_it(argv, fleet, caplog):
    """``--pallas`` names the kernels the port runs on the card anyway:
    accepted and logged, for the single engine and for ``--replicas 2``,
    and the service serves a request."""
    import logging

    caplog.set_level(logging.INFO)
    svc = serve_cli.build_service(serve_cli.build_parser().parse_args(
        BASE + ["--pallas", "--sampler_steps", "2"] + argv))
    assert isinstance(svc, prouter.FleetService) == fleet
    assert any(r.getMessage().startswith("--pallas: the hand-written CUDA")
               for r in caplog.records)
    try:
        svc.start(serve_http=True)
        status, body = _post(svc.port, _payload(0))
        assert status == 200 and body["shape"] == [2, 8, H, H, 3]
        assert np.isfinite(np.asarray(body["views"])).all()
    finally:
        svc.stop(drain_s=1.0)
