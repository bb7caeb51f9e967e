"""The port's single-engine serving path (``diff3d_tpu_torch/serving``,
``cascade/plan.py``, ``testing/faults.py``, ``cli/serve_cli.py``) on the
CPU, against the JAX package's (``diff3d_tpu/serving``).

The jax-free copies (scheduler, metrics, result cache, lane counts, the
HTTP statuses, the cascade plan grammar, ``ServingConfig``) are driven
with the same inputs on both sides and must agree exactly.  The port's
service is held against the JAX ``ServingService`` on the same tiny
weights and payloads, with the JAX per-view draws replayed into the
port's requests: 1e-5 where the JAX package's own two paths (the served
batch and ``synthesize`` per object) agree to 1e-5, within their
disagreement elsewhere (``test_torch_port_sampler_runtime.py`` gives the
reason).  The engine's own contracts are held bit for bit against the
port's ``Sampler.synthesize_many`` over the same lanes.

Every wait has its own timeout (``urlopen(timeout=)``, ``result(timeout=)``,
polling deadlines).
"""

import builtins
import dataclasses
import json
import re
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.cascade import plan as jplan  # noqa: E402
from diff3d_tpu.serving import cache as jcache  # noqa: E402
from diff3d_tpu.serving import engine as jengine  # noqa: E402
from diff3d_tpu.serving import metrics as jmetrics  # noqa: E402
from diff3d_tpu.serving import scheduler as jsched  # noqa: E402
from diff3d_tpu.serving import server as jserver  # noqa: E402
from diff3d_tpu.sampling import Sampler as JSampler  # noqa: E402
from diff3d_tpu_torch import config as pconfig  # noqa: E402
from diff3d_tpu_torch.cascade import plan as pplan  # noqa: E402
from diff3d_tpu_torch.cli import serve_cli  # noqa: E402
from diff3d_tpu_torch.runtime.retry import (  # noqa: E402
    RetryableError, is_transient_backend_error)
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.serving import cache as pcache  # noqa: E402
from diff3d_tpu_torch.serving import engine as pengine  # noqa: E402
from diff3d_tpu_torch.serving import metrics as pmetrics  # noqa: E402
from diff3d_tpu_torch.serving import scheduler as psched  # noqa: E402
from diff3d_tpu_torch.serving import server as pserver  # noqa: E402
from diff3d_tpu_torch.testing import (FaultInjected,  # noqa: E402
                                      FaultInjector, wrap_sampler)
from test_torch_port_sampler import _views, jax_view_draws  # noqa: E402
from test_torch_port_sampler_runtime import (  # noqa: E402,F401
    _assert_close_to_reference, tiny)

H = 8
WAIT = 60.0                    # every blocking wait's limit, in seconds
SERVING = dict(port=0, max_batch=4, max_queue=8, max_wait_ms=200.0,
               max_views=8, default_timeout_s=60.0)


def _payload(seed, n_views=3, **kw):
    v = _views(max(n_views, 3), H, seed=100 + seed)
    return {"views": {k: np.asarray(a).tolist() for k, a in v.items()},
            "seed": seed, "n_views": n_views, **kw}


def _views_of(payload):
    return {k: np.asarray(a, np.float32)
            for k, a in payload["views"].items()}


def _post(port, payload, path="/synthesize"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, r.read()


def _post_json(port, payload, path="/synthesize"):
    status, body = _post(port, payload, path)
    return status, json.loads(body)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=WAIT) as r:
        return r.status, r.read()


def _http_error(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*args)
    return ei.value.code, ei.value.headers, json.loads(ei.value.read())


def _port_cfg(**serving):
    cfg = pconfig.test_config(imgsize=H, ch=8)
    return dataclasses.replace(cfg, serving=pconfig.ServingConfig(
        **dict(SERVING, **serving)))


def _counter(service, name):
    return service.metrics_snapshot()["counters"].get(name, 0.0)


def _wait_until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the tiny model (the engine thread inherits
    it): at 8x8 the thread pool costs more than it saves, and the file
    shares the machine's cores with other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def service(tiny):
    """The port's service on the tiny converted weights, HTTP on an
    ephemeral port."""
    _, _, _, _, model, _ = tiny
    cfg = _port_cfg()
    svc = pserver.ServingService(Sampler(model, cfg, device="cpu"),
                                 cfg).start(serve_http=True)
    yield svc
    svc.stop()


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


# --- the jax-free copies against the JAX package ---------------------------


def test_bucket_and_cache_key_match_jax():
    cfg_j = dataclasses.replace(jconfig.test_config(imgsize=H, ch=8),
                                serving=jconfig.ServingConfig(**SERVING))
    cfg_p = _port_cfg()
    for n_views in (2, 3, 5):
        p = _payload(3, n_views=n_views, sampler_kind="ddim", steps=2)
        rj = jserver.build_request(p, cfg_j)
        rp = pserver.build_request(p, cfg_p)
        assert tuple(rj.bucket) == tuple(rp.bucket)
        assert rj.content_key("v0") == rp.content_key("v0")
        rj.resolve_schedule("ancestral", 4)
        rp.resolve_schedule("ancestral", 4)
        assert tuple(rj.bucket) == tuple(rp.bucket)
        assert rj.content_key("v7", "x") == rp.content_key("v7", "x")
    for bad in ({"seed": 1}, _payload(0, n_views=9)):
        for build, cfg in ((jserver.build_request, cfg_j),
                           (pserver.build_request, cfg_p)):
            with pytest.raises(ValueError):
                build(bad, cfg)


def _drive_scheduler(mod):
    """One event sequence through a Scheduler: bucket grouping, the
    bounded queue, the max-wait flush, a full batch skipping the wait,
    and the timeout sweep.  Returns the trace."""
    trace = []
    s = mod.Scheduler(max_queue=3, max_wait_s=0.5, default_timeout_s=30.0)
    reqs = [mod.ViewRequest(_views_of(_payload(i, n_views=n)), seed=i,
                            n_views=n, request_id=f"r{i}")
            for i, n in enumerate((3, 5, 3, 3))]
    for r in reqs[:3]:
        s.submit(r)
    try:
        s.submit(reqs[3])
    except mod.QueueFullError as e:
        trace.append(("full", type(e).__name__))
    trace.append(("depth", s.depth()))
    got = s.acquire(reqs[0].bucket, max_n=8, block=False)
    trace.append(("grouped", [r.id for r in got]))
    got = s.acquire(None, max_n=4, block=True, poll_s=1.0)
    # An underfull batch leaves no earlier than its head's flush time.
    trace.append(("flushed", [r.id for r in got],
                  time.monotonic() >= reqs[1].submit_time + 0.5))
    s.submit(reqs[3])
    s.submit(mod.ViewRequest(_views_of(_payload(9)), seed=9, n_views=3,
                             request_id="r9"))
    got = s.acquire(None, max_n=2, block=True, poll_s=1.0)
    # A full batch leaves before it: the wait is skipped.
    trace.append(("full_batch", [r.id for r in got],
                  time.monotonic() < reqs[3].submit_time + 0.5))
    late = s.submit(mod.ViewRequest(_views_of(_payload(8)), seed=8,
                                    n_views=3, request_id="r8",
                                    timeout_s=0.0))
    time.sleep(0.01)
    trace.append(("swept",
                  [r.id for r in s.acquire(None, max_n=4, block=False)],
                  type(late.error).__name__, s.depth()))
    return trace


def test_scheduler_matches_jax():
    tj, tp = _drive_scheduler(jsched), _drive_scheduler(psched)
    assert tj == tp
    assert ("grouped", ["r0", "r2"]) in tp
    assert tp[3][:2] == ("flushed", ["r1"]) and tp[3][2]
    assert ("full_batch", ["r3", "r9"], True) in tp


def _drive_metrics(mod):
    m = mod.MetricsRegistry()
    c = m.counter("serving_a_total", "a counter")
    c.inc()
    c.inc(2.5)
    g = m.gauge("serving_depth", "a gauge")
    g.set(3)
    g.add(-1)
    h = m.histogram("serving_lat_seconds", "a histogram", window=4)
    for v in (0.5, 0.25, 2.0, 1.0, 4.0):
        h.observe(v)
    m.histogram("serving_empty_seconds")
    return m.snapshot(extra={"engine": {"x": 1}}), m.exposition()


def test_metrics_registry_matches_jax():
    assert _drive_metrics(jmetrics) == _drive_metrics(pmetrics)


def _drive_result_cache(mod, metrics_mod):
    c = mod.ResultCache(capacity=2, metrics=metrics_mod.MetricsRegistry())
    trace = []
    c.put("a", np.zeros(1))
    c.put("b", np.ones(1))
    trace.append(c.get("a") is not None)
    c.put("c", np.ones(1))
    trace += [c.get(k) is not None for k in ("a", "b", "c")]
    trace.append(len(c))
    off = mod.ResultCache(capacity=0)
    off.put("a", np.zeros(1))
    trace.append(len(off))
    return trace


def test_result_cache_lru_matches_jax():
    assert (_drive_result_cache(jcache, jmetrics)
            == _drive_result_cache(pcache, pmetrics)
            == [True, True, False, True, 2, 0])


def test_lane_count_matches_jax():
    for n in range(0, 10):
        for max_batch in (1, 2, 4, 8, 16):
            for multiple in (1, 2, 3):
                assert (pengine.lane_count(n, max_batch, multiple)
                        == jengine.lane_count(n, max_batch, multiple))


ERRORS = ["QueueFullError", "RequestTimeout", "RequestCancelled",
          "EngineStepError", "EngineOverloaded", "EngineDraining",
          "EngineStopped", "UnsupportedSchedule", "FleetOverloaded",
          "ReplicaDraining", "SessionLost", "ReplicaOverBudget"]


@pytest.mark.parametrize("name", ERRORS + ["ValueError", "KeyError",
                                           "TypeError", "RuntimeError"])
def test_error_status_and_retry_after_match_jax(name):
    for after in (None, 0.4, 2.5):
        got = []
        for sched, server in ((jsched, jserver), (psched, pserver)):
            cls = getattr(sched, name, None) or getattr(builtins, name)
            if issubclass(cls, sched.RetryableError):
                exc = cls("boom", retry_after_s=after)
            else:
                exc = cls("boom")
            got.append((server._error_status(exc),
                        server._retry_after(exc)))
        assert got[0] == got[1], (name, after, got)


@pytest.mark.parametrize("spec", [
    "draft=64:ddim:8,refine=128:ancestral:64@t0.4",
    "refine=128:ancestral:64@t0.25,draft=32:ancestral:4",
    "draft=64:ddim:8", "draft=64:ddim:8,refine=64:ddim:8@t0.5",
    "draft=64:ddim:8@t0.5,refine=128:ddim:8@t0.5",
    "draft=64:ddim:8,refine=128:ddim:8", "draft=64:euler:8,refine=128:ddim:8@t0.5",
    "draft=64:ddim,refine=128:ddim:8@t0.5", "draft=x:ddim:8,refine=128:ddim:8@t0.5",
    "draft=64:ddim:8,refine=128:ddim:8@0.5", "plan=64:ddim:8",
    "draft=64:ddim:8,draft=64:ddim:8"])
def test_cascade_plan_parse_matches_jax(spec):
    out = []
    for mod in (jplan, pplan):
        try:
            out.append(mod.CascadePlan.parse(spec).spec())
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


def test_serving_config_defaults_match_jax():
    ref = jconfig.ServingConfig()
    port = pconfig.ServingConfig()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert pconfig.srn64_config().serving == port
    for bad in (dict(max_batch=0), dict(max_views=1), dict(replicas=0),
                dict(step_retry_attempts=0), dict(watchdog_timeout_s=-1)):
        for cls in (jconfig.ServingConfig, pconfig.ServingConfig):
            with pytest.raises(ValueError):
                dataclasses.replace(cls(), **bad).validate()


# --- the port's service against the JAX service ---------------------------


def test_served_views_match_the_jax_service(tiny):
    """Three concurrent requests (lanes 4, one of them padding) on the
    same weights and payloads: the JAX service draws from PRNGKey(seed),
    the port's requests replay those draws."""
    jcfg, pcfg, jm, params, model, B = tiny
    seeds = (31, 32, 33)
    payloads = [_payload(s) for s in seeds]
    jcfg = dataclasses.replace(jcfg, serving=jconfig.ServingConfig(
        **SERVING))
    jsampler = JSampler(jm, params, jcfg)
    jsvc = jserver.ServingService(jsampler, jcfg)
    jreqs = [jsvc.submit(p) for p in payloads]   # queued, then one batch
    jsvc.start(serve_http=False)
    try:
        ref = np.stack([r.result(timeout=WAIT) for r in jreqs])
    finally:
        jsvc.stop()
    ref_seq = np.stack([np.asarray(jsampler.synthesize(
        _views_of(p), jax.random.PRNGKey(s), max_views=3))
        for p, s in zip(payloads, seeds)])

    cfg = _port_cfg()
    psvc = pserver.ServingService(Sampler(model, cfg, device="cpu"), cfg)
    preqs = []
    for p, s in zip(payloads, seeds):
        req = pserver.build_request(p, cfg)
        carry, req.draws = jax.random.PRNGKey(s), []
        for view in (1, 2):
            carry, d = jax_view_draws(carry, (B, H, H, 3),
                                      jcfg.diffusion.timesteps, view)
            req.draws.append(d)
        preqs.append(psvc.engine.submit(req))
    psvc.start(serve_http=False)
    try:
        out = np.stack([r.result(timeout=WAIT) for r in preqs])
    finally:
        psvc.stop()
    occ = psvc.metrics_snapshot()["histograms"]["serving_batch_occupancy"]
    assert occ["max"] == 3
    assert out.shape == ref.shape == (3, 2, B, H, H, 3)
    _assert_close_to_reference(out, ref, ref_seq)


# --- the engine's contracts -------------------------------------------------


def test_concurrent_requests_are_synthesize_many_over_the_same_lanes(
        service):
    """Three concurrent HTTP requests run as 4 lanes (one padding lane
    repeating lane 0's record with a throwaway generator): each is
    bit-identical to ``synthesize_many`` over the three objects plus a
    fourth that repeats object 0 under another seed."""
    port = service.port
    seeds = (0, 1, 2)
    results, errs = {}, []

    def worker(s):
        try:
            results[s] = _post_json(port, _payload(s))[1]
        except Exception as e:                   # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for t in threads:
        t.start()
    status, body = _get(port, "/healthz")
    assert status == 200 and json.loads(body)["engine_alive"]
    for t in threads:
        t.join(WAIT)
    assert not errs and len(results) == 3
    snap = service.metrics_snapshot()
    assert snap["histograms"]["serving_batch_occupancy"]["max"] == 3
    assert snap["histograms"]["serving_batch_padding_fraction"]["max"] \
        == 0.25
    views = [_views_of(_payload(s)) for s in seeds]
    ref = service.engine.sampler.synthesize_many(
        views + [views[0]], _gens(list(seeds) + [77]), max_views=3)
    for s in seeds:
        np.testing.assert_array_equal(
            np.asarray(results[s]["views"], np.float32), ref[s])


def test_padding_lane_leaves_lane_zero_stream_intact(service):
    """Lane 0's views do not depend on what the padding lane draws: a
    padding lane that took lane 0's generator would advance its stream
    twice and change them."""
    eng = service.engine
    seeds = (5, 6, 7)
    reqs = []
    for s in seeds:
        reqs.append(eng.submit(pserver.build_request(_payload(s),
                                                     service.cfg)))
    outs = [r.result(timeout=WAIT) for r in reqs]
    views = [_views_of(_payload(s)) for s in seeds]
    for pad_seed in (8, 9):
        ref = eng.sampler.synthesize_many(
            views + [views[0]], _gens(list(seeds) + [pad_seed]),
            max_views=3)
        for n in range(3):
            np.testing.assert_array_equal(outs[n], ref[n])
    # ...and lane 0 drawing twice per view would not match:
    gen = torch.Generator().manual_seed(seeds[0])
    from diff3d_tpu_torch.diffusion import Draws
    d = Draws(gen)
    twice = eng.sampler.synthesize_many(
        views + [views[0]], None, max_views=3,
        draws=[[d, d]] + [[Draws(g)] * 2 for g in _gens(seeds[1:])]
        + [[d, d]])
    assert not np.array_equal(twice[0], outs[0])


def test_request_admitted_mid_job(tiny):
    """A 5-view request posted after an 8-view one (same bucket, record
    capacity 8) has committed its first view joins at a view boundary
    and finishes first.  Each view step is slowed to 0.5 s, so the
    second request arrives within a step or two."""
    _, _, _, _, model, _ = tiny
    inj = FaultInjector(seed=0)
    inj.add("engine.step", kind="slow", delay_s=0.5, prob=1.0)
    service, _ = _faulty_service(model, lambda s: wrap_sampler(s, inj))
    service.start(serve_http=True)
    port = service.port
    before = _counter(service, "serving_views_completed_total")
    done, order = {}, []

    def worker(name, payload):
        done[name] = _post_json(port, payload)[1]
        order.append(name)

    long_t = threading.Thread(target=worker,
                              args=("long", _payload(11, n_views=8)))
    long_t.start()
    _wait_until(lambda: _counter(service, "serving_views_completed_total")
                > before, "the long request's first view")
    short_t = threading.Thread(target=worker,
                               args=("short", _payload(12, n_views=5)))
    short_t.start()
    short_t.join(WAIT)
    long_t.join(WAIT)
    try:
        assert order == ["short", "long"]
        for name, n in (("long", 7), ("short", 4)):
            v = np.asarray(done[name]["views"], np.float32)
            assert v.shape[0] == n and np.isfinite(v).all()
        occ = service.metrics_snapshot()["histograms"][
            "serving_batch_occupancy"]
        assert occ["max"] == 2
    finally:
        service.stop()


def test_replay_comes_from_the_result_cache(service):
    port = service.port
    p = _payload(42)
    _, first = _post_json(port, p)
    views_before = _counter(service, "serving_views_completed_total")
    _, again = _post_json(port, p)
    assert not first["cached"] and again["cached"]
    assert again["views"] == first["views"]
    assert _counter(service, "serving_views_completed_total") \
        == views_before
    assert _counter(service, "serving_result_cache_hits_total") >= 1


def test_params_swap_copies_in_place_without_a_new_loop(service):
    port = service.port
    model = service.engine.sampler.model
    params = dict(model.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    orig = {k: t.clone() for k, t in model.state_dict().items()}
    p = _payload(13)
    _, base = _post_json(port, p)
    loops = dict(service.engine.sampler._loops)
    try:
        service.registry.swap({k: t + 0.05 for k, t in orig.items()},
                              version="ckpt-2")
        assert json.loads(_get(port, "/healthz")[1])["params_version"] \
            == "ckpt-2"
        _, swapped = _post_json(port, p)
        assert not swapped["cached"]
        assert swapped["views"] != base["views"]
        assert {k: q.data_ptr() for k, q in params.items()} == ptrs
        assert service.engine.sampler._loops == loops
        for k, t in model.state_dict().items():
            torch.testing.assert_close(t, orig[k] + 0.05, rtol=0, atol=0)
    finally:
        service.registry.swap(orig, version="v0-restored")
    _, restored = _post_json(port, p)
    assert not restored["cached"] and restored["views"] == base["views"]


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape",
                                   "dtype"])
def test_params_swap_refuses_a_mismatch_and_names_it(tiny, fault):
    _, _, _, _, model, _ = tiny
    reg = pcache.ParamsRegistry(model, version="v0")
    sd = {k: t.clone() for k, t in model.state_dict().items()}
    key = sorted(sd)[3]
    if fault == "missing":
        del sd[key]
    elif fault == "unexpected":
        key = "not.a.weight"
        sd[key] = torch.zeros(1)
    elif fault == "shape":
        sd[key] = torch.zeros(sd[key].shape + (1,))
    else:
        sd[key] = sd[key].double()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    with pytest.raises(ValueError, match=re.escape(key)):
        reg.swap({k: t + 1.0 for k, t in sd.items()})
    assert reg.apply() == "v0" and reg.version == "v0"
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_queue_full_429_and_degraded_health(tiny):
    """With the engine not started and a 1-deep queue, the second
    submission gets 429 and ``/healthz`` reports degraded."""
    _, _, _, _, model, _ = tiny
    cfg = _port_cfg(max_queue=1)
    stalled = pserver.ServingService(Sampler(model, cfg, device="cpu"), cfg)
    httpd = pserver.make_http_server(stalled, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        status, _ = _post_json(port, _payload(0, block=False))
        assert status == 202
        code, _, body = _http_error(_post_json, port,
                                    _payload(1, block=False))
        assert code == 429 and "queue full" in body["error"]
        code, _, body = _http_error(_get, port, "/healthz")
        assert code == 503 and body["status"] == "degraded"
    finally:
        httpd.shutdown()
        httpd.server_close()
        stalled.scheduler.close()


def test_timeout_is_explicit(service):
    code, _, body = _http_error(_post_json, service.port,
                                _payload(14, timeout_s=0.0))
    assert code == 504 and "deadline" in body["error"]


def test_validation_errors_and_routes(service):
    port = service.port
    assert _http_error(_post_json, port, {"seed": 1})[0] == 400
    assert _http_error(_post_json, port, _payload(0, n_views=60))[0] == 400
    bad = _payload(0)
    bad["views"]["K"] = [[1.0, 0.0], [0.0, 1.0]]
    assert _http_error(_post_json, port, bad)[0] == 400
    code, headers, body = _http_error(
        _post_json, port, _payload(0, sampler_kind="ddim", steps=2))
    assert code == 503 and headers["Retry-After"] == "5"
    assert "ancestral:4" in body["error"]
    assert _http_error(_get, port, "/result/nope")[0] == 404
    assert _http_error(_get, port, "/fleet")[0] == 404
    assert _http_error(_get, port, "/nowhere")[0] == 404
    assert _http_error(_post_json, port, _payload(0), "/cascade")[0] == 503
    assert _http_error(_post_json, port, dict(_payload(0), plan="draft=x"),
                       "/cascade")[0] == 400
    status, body = _get(port, "/metrics")
    assert status == 200 and b"serving_queue_depth" in body
    status, body = _get(port, "/stats")
    eng = json.loads(body)["engine"]
    assert status == 200 and eng["num_devices"] == 1
    assert eng["program_cache"]["num_programs"] >= 1
    assert all(p["peak_bytes"] is None        # the CPU: no device bytes
               for p in eng["program_cache"]["programs"].values())


def test_poll_path(service):
    port = service.port
    status, body = _post_json(port, _payload(15, block=False))
    assert status == 202 and body["status"] == "pending"
    rid = body["id"]
    _wait_until(lambda: _get(port, f"/result/{rid}")[0] == 200,
                "the polled result")
    out = json.loads(_get(port, f"/result/{rid}")[1])
    ref = service.engine.sampler.synthesize_many(
        [_views_of(_payload(15))], _gens([15]), max_views=3)[0]
    np.testing.assert_array_equal(np.asarray(out["views"], np.float32), ref)


def _trajectory_payload(seed, frames=3, **kw):
    v = _views_of(_payload(seed))
    return {"cond": {"img": v["imgs"][0].tolist(), "R": v["R"][0].tolist(),
                     "T": v["T"][0].tolist(), "K": v["K"].tolist()},
            "path": {"kind": "orbit", "frames": frames, "radius": 1.5},
            "seed": seed, **kw}


def test_trajectory_polled_and_streamed(service):
    port = service.port
    status, body = _post_json(port, _trajectory_payload(16, block=False),
                              "/trajectory")
    assert status == 202 and body["n_frames"] == 3
    rid, frames, start = body["id"], [], 0
    deadline = time.monotonic() + WAIT
    while True:
        poll = json.loads(_get(port, f"/result/{rid}?from={start}")[1])
        frames += poll["frames"]
        start = poll["next"]
        if poll["status"] == "done" and start == 3:
            break
        assert poll["status"] == "running" and time.monotonic() < deadline
        time.sleep(0.01)
    final = json.loads(_get(port, f"/result/{rid}")[1])
    assert final["n_frames"] == 3 and final["frames_committed"] == 3
    np.testing.assert_array_equal(np.asarray(frames, np.float32),
                                  np.asarray(final["views"], np.float32))

    status, raw = _post(port, _trajectory_payload(17, stream=True),
                        "/trajectory")
    lines = [json.loads(x) for x in raw.decode().splitlines() if x]
    assert status == 200 and lines[0]["status"] == "streaming"
    assert [x["frame"] for x in lines[1:-1]] == [0, 1, 2]
    assert lines[-1]["status"] == "done"
    streamed = np.asarray([x["view"] for x in lines[1:-1]], np.float32)
    assert streamed.shape == (3, 8, H, H, 3) and np.isfinite(streamed).all()


# --- faults: retry, watchdog, sticky CUDA errors ---------------------------


class _FailsAfterTheStep:
    """A sampler whose first ``step_many`` runs (taking its draws) and
    then raises a transient fault, so a retry must put the generators
    back to redraw the same."""

    def __init__(self, inner):
        self._inner, self.calls = inner, 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step_many(self, *args, **kwargs):
        self.calls += 1
        out = self._inner.step_many(*args, **kwargs)
        if self.calls == 1:
            raise FaultInjected("transient fault after the step ran")
        return out


def _faulty_service(model, wrap, **serving):
    cfg = _port_cfg(step_retry_backoff_s=0.0, **serving)
    sampler = Sampler(model, cfg, device="cpu")
    return pserver.ServingService(wrap(sampler), cfg), sampler


@pytest.mark.parametrize("where", ["before", "after"])
def test_transient_fault_retries_bit_exactly(tiny, where):
    _, _, _, _, model, _ = tiny
    inj = FaultInjector(seed=0)
    inj.add("engine.step", first_n=1)
    wrap = ((lambda s: wrap_sampler(s, inj)) if where == "before"
            else _FailsAfterTheStep)
    svc, sampler = _faulty_service(model, wrap)
    svc.start(serve_http=False)
    try:
        out = svc.submit(_payload(21)).result(timeout=WAIT)
    finally:
        svc.stop()
    ref = sampler.synthesize_many([_views_of(_payload(21))], _gens([21]),
                                  max_views=3)[0]
    np.testing.assert_array_equal(out, ref)
    assert _counter(svc, "serving_engine_step_faults_total") == 0
    assert svc.engine.health == "ok"


def test_stuck_step_trips_the_watchdog(tiny):
    _, _, _, _, model, _ = tiny
    inj = FaultInjector(seed=0)
    inj.add("engine.step", kind="slow", delay_s=1.0, first_n=1)
    svc, _ = _faulty_service(model, lambda s: wrap_sampler(s, inj),
                             watchdog_timeout_s=0.2)
    svc.start(serve_http=False)
    try:
        req = svc.submit(_payload(22))
        with pytest.raises(psched.EngineStepError, match="watchdog") as ei:
            req.result(timeout=WAIT)
        assert isinstance(ei.value, RetryableError)
        assert _counter(svc, "serving_engine_watchdog_trips_total") == 1
        assert svc.engine.health == "degraded"
    finally:
        svc.stop()


STICKY = ["CUDA error: an illegal memory access was encountered",
          "CUDA error: unspecified launch failure",
          "CUDA error: device-side assert triggered",
          "cudaErrorLaunchTimeout: the launch timed out and was terminated"]


@pytest.mark.parametrize("msg", STICKY)
def test_sticky_cuda_error_is_not_transient(msg):
    assert not is_transient_backend_error(RuntimeError(msg))
    assert not is_transient_backend_error(RetryableError(msg))
    assert is_transient_backend_error(RetryableError("injected"))
    assert is_transient_backend_error(ConnectionResetError("reset"))
    assert is_transient_backend_error(RuntimeError("UNAVAILABLE: socket"))
    assert not is_transient_backend_error(ValueError("bad shape"))


def test_sticky_cuda_error_fails_the_step_without_a_retry(tiny):
    _, _, _, _, model, _ = tiny
    inj = FaultInjector(seed=0)
    inj.add("engine.step", first_n=1, exc=lambda: RuntimeError(STICKY[0]))
    svc, _ = _faulty_service(model, lambda s: wrap_sampler(s, inj))
    svc.start(serve_http=False)
    try:
        req = svc.submit(_payload(23))
        with pytest.raises(psched.EngineStepError, match="illegal memory"):
            req.result(timeout=WAIT)
        assert inj.calls["engine.step"] == 1
        assert _counter(svc, "serving_engine_step_faults_total") == 1
    finally:
        svc.stop()


# --- serve_cli ----------------------------------------------------------------


def test_serve_cli_serves_on_the_cpu():
    args = serve_cli.build_parser().parse_args(
        ["--init", "random", "--config", "test", "--device", "cpu",
         "--imgsize", "8", "--port", "0", "--max_wait_ms", "0",
         "--schedules", "ddim:2", "--warmup"])
    svc = serve_cli.build_service(args)
    assert svc.engine.supported_schedules() == ["ancestral:4", "ddim:2"]
    assert svc.engine.programs.stats()["num_programs"] == 2   # warmed
    svc.start(serve_http=True)
    try:
        status, body = _post_json(svc.port, _payload(0))
        assert status == 200 and body["shape"] == [2, 8, H, H, 3]
        status, body = _post_json(svc.port, _trajectory_payload(
            1, frames=2, sampler_kind="ddim", steps=2), "/trajectory")
        assert status == 200 and body["n_frames"] == 2
        assert np.isfinite(np.asarray(body["views"])).all()
    finally:
        svc.stop(drain_s=1.0)


@pytest.mark.parametrize("argv", [
    ["--replicas", "0"], ["--schedules", "0@ddim:2"],
    ["--schedules", "ddim"], ["--workers", "127.0.0.1:1"], ["--mesh"],
    ["--cascade", "draft=8:ddim:2,refine=16:ddim:4@t0.5"],
    ["--sampler_steps", "3"], ["--max_batch", "0"]])
def test_serve_cli_refuses(argv):
    base = ["--init", "random", "--config", "test", "--device", "cpu",
            "--imgsize", "8", "--port", "0"]
    with pytest.raises(SystemExit) as ei:
        serve_cli.build_service(serve_cli.build_parser().parse_args(
            base + argv))
    assert ei.value.code not in (0, None)
    why = {"--replicas": "needs --workers", "--schedules": "--replicas > 1",
           "--workers": "unreachable", "--cascade": "refine resolution"}
    if argv[0] in why and argv != ["--schedules", "ddim"]:
        assert why[argv[0]] in str(ei.value.code)


def test_serve_cli_refuses_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve_cli.build_parser().parse_args(
        ["--init", "random", "--config", "test", "--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.build_service(args)
