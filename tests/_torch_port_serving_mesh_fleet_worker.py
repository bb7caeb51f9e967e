"""Rank bodies of ``tests/test_torch_port_serving_mesh_fleet.py``: two
in-process replicas over one 2-rank serving mesh, run on spawned gloo
ranks by :func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports no
JAX (the ``ast`` test checks it); the tiny model, the views and the
payloads come from ``tests/_torch_port_serving_mesh_worker.py``.
"""

from __future__ import annotations

import copy
import os
import signal
import threading
import time
import types

import _torch_port_serving_mesh_worker as mw

#: Each replica's requests of (a)-(c), submitted at once (2 lanes, one a
#: rank): replica 0 serves the first pair, replica 1 the second.
SEEDS = ((11, 12), (13, 14))
#: (d): rounds of one request a replica, the two replicas' first plans
#: held at a barrier until both are ready.
ROUNDS = 5
#: (g): the flags of ``serve_cli --mesh --replicas 2`` beyond the port.
CLI_ARGV = ["--mesh", "--replicas", "2", "--init", "random", "--config",
            "test", "--device", "cpu", "--imgsize", str(mw.H),
            "--sampler_steps", "4", "--schedules", "ancestral:4,1@ddim:4",
            "--max_wait_ms", "0", "--drain_s", "2", "--max_views", "3"]


def owned_session(names, owner: str, prefix: str = "s") -> str:
    """A session id that the router's rendezvous hash pins to ``owner``
    among replicas named ``names`` (every one serving its schedule)."""
    from diff3d_tpu_torch.serving.router import Router

    reps = [types.SimpleNamespace(name=n) for n in names]
    for i in range(1000):
        sid = f"{prefix}{i}"
        if Router.rendezvous_order(sid, reps)[0].name == owner:
            return sid
    raise AssertionError(f"no session id lands on {owner}")


def _fleet(cfg, model):
    """Two replicas over the group's serving mesh (rank 0's weights,
    checked by digest on every rank)."""
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import FleetService
    from diff3d_tpu_torch.serving.fleet import build_fleet
    from diff3d_tpu_torch.serving.ranks import RankChannel

    env = make_mesh(cfg.mesh)
    ranks = RankChannel(env)
    digest = ranks.sync_weights(model)
    fleet = FleetService(build_fleet(
        Sampler(model, cfg, device="cpu", mesh=env), cfg, 2, ranks=ranks),
        cfg)
    return fleet, digest


def _submit(rep, cfg, seed, draws, **kw):
    """One 3-view request of ``seed`` on replica ``rep``, replaying
    ``draws[seed]`` (a copy: a replay is consumed)."""
    from diff3d_tpu_torch.serving.server import build_request

    req = build_request(mw.payload(seed, **kw), cfg)
    req.draws = copy.deepcopy(draws[seed])
    return rep.submit(req)


def _barrier_plans(engines):
    """Each engine's first plan after :func:`arm` waits at one barrier
    until every engine has one: the replicas' steps then race for the
    card."""
    box = {}

    for i, eng in enumerate(engines):
        inner = eng._plan

        def plan(active, i=i, inner=inner):
            bar = box.pop(i, None)
            if bar is not None:
                bar.wait()
            return inner(active)

        eng._plan = plan

    def arm():
        bar = threading.Barrier(len(engines), timeout=mw.WAIT)
        for i in range(len(engines)):
            box[i] = bar

    return arm


def _follow_timed(engines):
    """Run every engine's follower loop (``follow_all``), recording when
    each one ended (``time.time()``, comparable across the ranks)."""
    from diff3d_tpu_torch.serving.engine import follow_all

    ended = {}
    for i, eng in enumerate(engines):
        inner = eng.follow

        def follow(i=i, inner=inner):
            try:
                inner()
            finally:
                ended[i] = time.time()

        eng.follow = follow
    follow_all(engines)
    return ended


def fleet_group(rank: int, world: int, state: dict, draws: dict) -> dict:
    """Every scenario of one 2-rank group, in order: (c) a one-replica
    mesh service's reference, then one fleet of two replicas for (a)-(f),
    then (g) ``serve_cli.main --mesh --replicas 2`` and (h) the mixed
    fleet.  ``state`` (rank 0 loads it; the boot's sync brings it to the
    other rank) and ``draws`` (seed -> one replay a view) are the JAX
    package's weights and draws."""
    from diff3d_tpu_torch.serving.scheduler import SessionLost

    out = {}
    cfg = mw.mesh_cfg()
    model = mw.tiny_model(cfg)
    if rank == 0:
        model.load_state_dict(state)

    # (c)'s reference: one replica over the mesh serving each pair.
    svc, ranks, steps, _ = mw._serving(rank, cfg, model)
    if rank:
        svc.engine.follow()
    else:
        svc.start(serve_http=False)
        ref = {}
        for pair in SEEDS:
            reqs = [_submit(svc.engine, cfg, s, draws) for s in pair]
            ref.update({s: r.result(timeout=mw.WAIT)
                        for s, r in zip(pair, reqs)})
        out["ref"] = ref
        svc.stop()
    out["ref_steps"] = steps

    # (a)-(c): both replicas at once, each on its pair.
    fleet, digest = _fleet(cfg, model)
    out["digest"] = digest
    engines = [rep.engine for rep in fleet.replicas]
    out["rep_steps"] = [mw.record_steps(eng) for eng in engines]
    out["channels"] = [eng.ranks.name for eng in engines]
    out["gather_groups"] = [eng.ranks.gather_group is None
                            for eng in engines]
    if rank:
        out["ended"] = _follow_timed(engines)
        out["counts"] = [dict(eng.ranks.counts) for eng in engines]
        return _cli(rank, out)
    arm = _barrier_plans(engines)
    fleet.start(serve_http=False)
    reqs = [[_submit(rep, cfg, s, draws) for s in pair]
            for rep, pair in zip(fleet.replicas, SEEDS)]
    out["fleet"] = [{s: r.result(timeout=mw.WAIT) for s, r in zip(pair, rs)}
                    for pair, rs in zip(SEEDS, reqs)]
    out["steps_before_d"] = [len(s) for s in out["rep_steps"]]

    # (d) Rounds of one request a replica, their first plans held until
    # both replicas have one.
    rounds = []
    for k in range(ROUNDS):
        arm()
        got = [_submit(rep, cfg, pair[k % 2], draws)
               for rep, pair in zip(fleet.replicas, SEEDS)]
        rounds.append([(pair[k % 2], r.result(timeout=mw.WAIT))
                       for pair, r in zip(SEEDS, got)])
    out["rounds"] = rounds
    out["steps_before_e"] = [len(s) for s in out["rep_steps"]]

    # (e) A rollout (x 1.01) on replica 1 alone, then its rollback.
    r1 = fleet.replicas[1]
    orig = {k: v.clone() for k, v in r1.engine.sampler.model.state_dict()
            .items()}
    up = {k: v * 1.01 if v.is_floating_point() else v.clone()
          for k, v in orig.items()}
    out["rollout"] = fleet.rollout(up, version="up", replicas=["r1"])
    got = [_submit(rep, cfg, pair[0], draws)
           for rep, pair in zip(fleet.replicas, SEEDS)]
    out["after_rollout"] = [r.result(timeout=mw.WAIT) for r in got]
    out["rollback"] = fleet.rollout(orig, version="back", replicas=["r1"])
    out["after_rollback"] = _submit(r1, cfg, SEEDS[1][0], draws).result(
        timeout=mw.WAIT)
    out["versions"] = [rep.params_version for rep in fleet.replicas]

    # (f) Kill replica 1 with a session on it: its follower leaves its
    # loop, the session is lost, replica 0 answers on.
    sid = owned_session(["r0", "r1"], "r1")
    sticky = fleet.submit(dict(mw.payload(15), session_id=sid))
    sticky.result(timeout=mw.WAIT)
    out["fleet_snapshot"] = fleet.fleet_snapshot()
    out["killed_at"] = time.time()
    r1.kill()
    try:
        fleet.submit(dict(mw.payload(16), session_id=sid))
        out["lost"] = None
    except SessionLost as e:
        out["lost"] = (type(e).__name__, str(e))
    out["survivor"] = _submit(fleet.replicas[0], cfg, SEEDS[0][1],
                              draws).result(timeout=mw.WAIT)
    out["health"] = fleet.health()
    fleet.stop()
    out["counts"] = [dict(eng.ranks.counts) for eng in engines]
    return _cli(rank, out)


def _cli(rank: int, out: dict) -> dict:
    """(g) ``serve_cli.main --mesh --replicas 2`` in the group, then (h)
    ``build_service`` with ``--workers`` (a stubbed remote)."""
    from diff3d_tpu_torch.cli import serve_cli

    port = mw._free_port() if rank == 0 else 0
    answers = {}
    if rank == 0:
        def client():
            try:
                mw._wait(lambda: mw._up(port), "serve_cli's front door")
                for name in ("r0", "r1"):
                    sid = owned_session(["r0", "r1"], name, prefix="g")
                    answers[name] = mw._http(port, "/synthesize", dict(
                        mw.payload(30 + len(answers)), session_id=sid))
                # ddim:4 is replica 1's alone: the router must place it
                # there, whatever its session hashes to.
                sid = owned_session(["r0", "r1"], "r0", prefix="d")
                answers["ddim"] = mw._http(port, "/synthesize", dict(
                    mw.payload(40), session_id=sid, sampler_kind="ddim",
                    steps=4))
                answers["fleet"] = mw._http(port, "/fleet")
                answers["stats"] = mw._http(port, "/stats")
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=client, daemon=True).start()
    serve_cli.main(CLI_ARGV + ["--port", str(port), "--warmup"])
    out["g_answers"] = answers

    # (h) --workers beside --mesh --replicas 2: the leader's fleet holds
    # both mesh replicas and the remote; a follower builds the replicas
    # alone and follows them until the leader stops them.
    asked = []

    class Remote:
        name = "remote"
        health = "ok"

        def start(self):
            return self

        def stop(self, *a, **kw):
            pass

    def remotes(addrs, cfg):
        asked.append(list(addrs))
        return [Remote()]

    serve_cli._remotes = remotes
    svc = serve_cli.build_service(serve_cli.build_parser().parse_args(
        CLI_ARGV + ["--workers", "127.0.0.1:9"]))
    out["h_replicas"] = [type(r).__name__ for r in svc.replicas]
    out["h_names"] = [r.name for r in svc.replicas]
    out["h_remotes_asked"] = asked
    local = serve_cli._local_engines(svc)
    out["h_mesh_ranks"] = [eng.ranks.world for eng in local]
    if rank:
        _follow_timed(local)
    else:
        for rep in svc.replicas:
            rep.stop()
    return out
