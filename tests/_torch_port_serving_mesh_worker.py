"""Rank bodies of the mesh-serving CPU tests
(``tests/test_torch_port_serving_mesh.py``), run on spawned gloo ranks by
:func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports no JAX (the
``ast`` test checks it): the tiny model's weights and the views are made
here from seeds, so the test process builds the same ones for its
one-process references.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import threading
import time
import urllib.request

import numpy as np
import torch

H = 8
CASCADE_H = 16
CASCADE_PLAN = "draft=8:ddim:2,refine=16:ancestral:2@t0.5"
WAIT = 60.0
SERVING = dict(port=0, max_batch=4, max_queue=8, max_wait_ms=300.0,
               max_views=8, default_timeout_s=60.0, step_retry_attempts=3,
               step_retry_backoff_s=0.01, watchdog_timeout_s=0.0)


def mesh_cfg(imgsize: int = H, **serving):
    from diff3d_tpu_torch import config as pconfig

    cfg = pconfig.test_config(imgsize=imgsize, ch=8)
    return dataclasses.replace(cfg, serving=pconfig.ServingConfig(
        **dict(SERVING, **serving)))


def tiny_model(cfg, seed: int = 0):
    """The tiny X-UNet with every leaf drawn from ``seed`` (zero-init
    leaves too), on the CPU."""
    from diff3d_tpu_torch.models import build_model

    model = build_model(cfg.model, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            p.copy_(0.08 * torch.randn(p.shape, generator=gen))
    return model


def views(n: int, seed: int, size: int = H) -> dict:
    """``n`` seeded views (images in [-1, 1], rotations, translations, an
    SRN-like K) of one object."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    K = np.array([[size, 0, size / 2], [0, size, size / 2], [0, 0, 1]],
                 np.float32)
    return {"imgs": rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            "R": q.astype(np.float32),
            "T": (2.0 * rng.standard_normal((n, 3))).astype(np.float32),
            "K": K}


def payload(seed: int, n_views: int = 3, size: int = H, **kw) -> dict:
    v = views(max(n_views, 3), 100 + seed, size)
    return {"views": {k: a.tolist() for k, a in v.items()}, "seed": seed,
            "n_views": n_views, **kw}


class Replay:
    """One view's draws answered from arrays made elsewhere (the test
    process replays the JAX package's key streams): the interface of
    ``diffusion.Draws``, and picklable, so a step's plan carries it to
    the rank that runs its lane."""

    def __init__(self, init_noise, cond_idx, x_uncond, step_noise):
        self._init, self._idx = init_noise, cond_idx
        self._x, self._noise = list(x_uncond), list(step_noise)

    def init_noise(self, shape, device):
        assert tuple(shape) == self._init.shape
        return torch.tensor(self._init, device=device)

    def cond_idx(self, n_steps, record_len, device):
        assert n_steps == len(self._idx)
        return torch.tensor(self._idx, dtype=torch.long, device=device)

    def x_uncond(self, shape, device):
        return torch.tensor(self._x.pop(0), device=device)

    def step_noise(self, shape, device):
        return torch.tensor(self._noise.pop(0), device=device)


def record_steps(engine, after=None) -> list:
    """Wrap ``engine``'s program cache so every view step it runs is
    recorded (lanes, this rank's returned views, the weights generation);
    ``after(k)`` runs after the k-th (1-based) step."""
    steps = []
    inner = engine.programs.step_many

    def step_many(bucket, lanes, *args, **kw):
        out = inner(bucket, lanes, *args, **kw)
        steps.append({"lanes": int(lanes),
                      "generation": kw.get("generation", 0),
                      "views": out[0].detach().cpu().numpy().copy()})
        if after is not None:
            after(len(steps))
        return out

    engine.programs.step_many = step_many
    return steps


def _serving(rank, cfg, model, *, cascade_plan=None, after=None):
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import ServingService
    from diff3d_tpu_torch.serving.ranks import RankChannel

    env = make_mesh(cfg.mesh)
    ranks = RankChannel(env)
    digest = ranks.sync_weights(model)
    cascade = None
    if cascade_plan is not None:
        from diff3d_tpu_torch.cascade import CascadePlan, CascadeSampler

        cascade = CascadeSampler(model, cfg, CascadePlan.parse(cascade_plan),
                                 device="cpu", mesh=env)
    svc = ServingService(Sampler(model, cfg, device="cpu", mesh=env), cfg,
                         cascade=cascade, ranks=ranks)
    steps = record_steps(svc.engine, after)
    return svc, ranks, steps, digest


def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


#: (b)'s requests: (seed, n_views); the last is admitted mid-job.
B_REQUESTS = ((1, 4), (2, 4), (3, 3))


def serve_requests(svc, draws=None):
    """(b)'s traffic on a started service: two requests, then a third
    submitted on the engine thread as the first view step ends, so it is
    admitted at the second (3 live lanes pad to 4).  ``draws`` (seed ->
    one draw source per view) replaces each request's generator."""
    from diff3d_tpu_torch.serving.server import build_request

    def submit(seed, n_views):
        if draws is None:
            return svc.submit(payload(seed, n_views=n_views))
        req = build_request(payload(seed, n_views=n_views), svc.cfg)
        req.draws = draws[seed]
        return svc.engine.submit(req)

    late = []
    svc.engine.programs.step_many = _after(
        svc.engine.programs.step_many,
        lambda n: late.append(submit(*B_REQUESTS[2])) if n == 1 else None)
    reqs = [submit(*r) for r in B_REQUESTS[:2]]
    _wait(lambda: late, "the first view step")
    return [r.result(timeout=WAIT) for r in reqs + late]


def serve_cascade(svc, draws):
    """One cascade of seed 11 submitted with its phases' draws (``draws``:
    phase -> one draw source per view) on a started service: its refined
    views and its draft frames."""
    from diff3d_tpu_torch.serving.server import build_cascade_request

    req = build_cascade_request(payload(11, size=CASCADE_H), svc.cfg,
                                svc.engine.cascade.plan)
    req.draws = draws
    svc.engine.submit_cascade(req)
    refined = req.result(timeout=WAIT)
    drafts = [e["frame"] for e in req.events_since(0)
              if e["phase"] == "draft"]
    return refined, np.stack(drafts)


def swap_after(svc, k: int, state):
    """A hook for :func:`record_steps`: stage ``state`` as the weights
    once the k-th view step has run (on the engine thread, so the swap
    lands at step k + 1)."""
    def after(n):
        if n == k:
            svc.engine.registry.swap(state, version="swapped")
    return after


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def poll_cascade(port, payload_):
    """POST one cascade (``block=false``) and walk ``?from=K`` to its end:
    ``(head, events, cursors, final body)``."""
    status, head = _http(port, "/cascade", dict(payload_, block=False))
    assert status == 202, status
    events, nxt, cursors = [], 0, []
    deadline = time.monotonic() + WAIT
    while True:
        assert time.monotonic() < deadline, "cascade did not finish"
        _, poll = _http(port, f"/result/{head['id']}?from={nxt}")
        cursors.append((poll["from"], poll["next"],
                        [e["event"] for e in poll["events"]]))
        events += poll["events"]
        nxt = poll["next"]
        if poll["status"] == "done":
            break
        time.sleep(0.02)
    _, body = _http(port, f"/result/{head['id']}")
    return head, events, cursors, body


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group(rank: int, world: int, swap_state: dict, b_state: dict,
          c_state: dict, draws: dict) -> dict:
    """Every scenario of one 2-rank group, in order: (b) plain requests,
    (d) a swap mid-job, (e) a retried step, (c) the cascade over HTTP,
    (g) ``serve_cli.main --mesh``.  Each follower returns what its engine
    ran; the leader also returns what it served.  (b) and (c) serve
    ``b_state`` / ``c_state`` (given to rank 0 only: the boot's weight
    sync brings them to the others) with the requests' draws
    ``draws["b"]`` / ``draws["c"]``."""
    from diff3d_tpu_torch.runtime.retry import RetryableError

    out = {}
    cfg = mesh_cfg()
    model = tiny_model(cfg)

    # (b) Three requests, one admitted mid-job.
    bmodel = tiny_model(cfg)
    if rank == 0:
        bmodel.load_state_dict(b_state)
    svc, ranks, steps, digest = _serving(rank, cfg, bmodel)
    out["digest"] = digest
    if rank:
        svc.engine.follow()
    else:
        svc.start(serve_http=False)
        out["b_results"] = serve_requests(svc, draws["b"])
        svc.stop()
    out["b_steps"] = steps
    out["b_counts"] = dict(ranks.counts)

    # (d) A swap staged on the leader after the first view step.
    svc, ranks, steps, _ = _serving(rank, cfg, model)
    if rank:
        svc.engine.follow()
    else:
        svc.engine.programs.step_many = _after(
            svc.engine.programs.step_many, swap_after(svc, 1, swap_state))
        svc.start(serve_http=False)
        out["d_results"] = [svc.submit(payload(4, n_views=4)).result(
            timeout=WAIT)]
        out["d_version"] = svc.engine.registry.version
        svc.stop()
    out["d_steps"] = steps
    with torch.no_grad():       # the swap wrote into the shared model
        model.load_state_dict(tiny_model(cfg).state_dict())

    # (e) One request twice: clean, then with the leader's first attempt
    # at its second view step failing.
    cfg_e = mesh_cfg(result_cache_entries=0)
    svc, ranks, steps, _ = _serving(rank, cfg_e, model)
    if rank:
        svc.engine.follow()
    else:
        svc.start(serve_http=False)
        clean = svc.submit(payload(5, n_views=3)).result(timeout=WAIT)
        fired = []

        def fault(n):
            if n == 2 and not fired:
                fired.append(n)
                raise RetryableError("injected: the leader's attempt fails")

        svc.engine.programs.step_many = _before(
            svc.engine.programs.step_many, fault)
        retried = svc.submit(payload(5, n_views=3)).result(timeout=WAIT)
        out["e_results"] = [clean, retried]
        out["e_faults"] = svc.metrics_snapshot()["counters"].get(
            "serving_engine_step_faults_total", 0.0)
        svc.stop()
    out["e_steps"] = steps
    out["e_counts"] = dict(ranks.counts)

    # (c) The cascade over HTTP at 16x16 (draft 8x8), twice with one seed,
    # then once with the phases' draws.
    ccfg = mesh_cfg(imgsize=CASCADE_H)
    cmodel = tiny_model(ccfg)
    if rank == 0:
        cmodel.load_state_dict(c_state)
    svc, ranks, steps, _ = _serving(rank, ccfg, cmodel,
                                    cascade_plan=CASCADE_PLAN)
    if rank:
        svc.engine.follow()
    else:
        svc.start(serve_http=True)
        out["c_runs"] = [poll_cascade(svc.port, payload(
            11, size=CASCADE_H)) for _ in range(2)]
        out["c_replayed"] = serve_cascade(svc, draws["c"])
        svc.stop()
    out["c_steps"] = steps

    # (g) serve_cli.main --mesh in this group: two HTTP requests, then
    # SIGTERM to the leader; both ranks return from main.
    from diff3d_tpu_torch.cli import serve_cli

    port = _free_port() if rank == 0 else 0
    argv = ["--mesh", "--init", "random", "--config", "test", "--device",
            "cpu", "--imgsize", str(H), "--port", str(port),
            "--max_wait_ms", "0", "--sampler_steps", "2", "--drain_s", "2"]
    answers = []
    if rank == 0:
        def client():
            _wait(lambda: _up(port), "serve_cli's front door")
            for seed in (21, 22):
                answers.append(_http(port, "/synthesize", payload(seed)))
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=client, daemon=True).start()
    serve_cli.main(argv)
    out["g_answers"] = answers
    return out


def _up(port) -> bool:
    try:
        _http(port, "/healthz")
        return True
    except OSError:
        return False


def _after(fn, hook):
    n = [0]

    def wrapped(*args, **kw):
        got = fn(*args, **kw)
        n[0] += 1
        hook(n[0])
        return got
    return wrapped


def _before(fn, hook):
    n = [0]

    def wrapped(*args, **kw):
        n[0] += 1
        hook(n[0])
        return fn(*args, **kw)
    return wrapped


def follower_exits(rank: int, world: int) -> dict:
    """(f): rank 1 exits during the second view step of a 4-view request;
    the leader must reject the request with a typed error."""
    cfg = mesh_cfg()
    model = tiny_model(cfg)
    svc, ranks, steps, _ = _serving(rank, cfg, model)
    if rank:
        svc.engine.programs.step_many = _before(
            svc.engine.programs.step_many,
            lambda n: os._exit(0) if n == 2 else None)
        svc.engine.follow()
        return {}
    svc.start(serve_http=False)
    req = svc.submit(payload(7, n_views=4))
    t0 = time.monotonic()
    try:
        req.result(timeout=WAIT)
        err = None
    except Exception as e:  # noqa: BLE001 - returned to the test
        from diff3d_tpu_torch.runtime.retry import RetryableError

        err = (type(e).__name__, str(e), isinstance(e, RetryableError))
    waited = time.monotonic() - t0
    health = svc.health()
    later = None
    try:
        svc.submit(payload(8))
    except Exception as e:  # noqa: BLE001 - returned to the test
        later = type(e).__name__
    svc.stop()
    return {"error": err, "waited_s": waited, "health": health,
            "later": later, "broken": ranks.broken, "steps": len(steps)}
