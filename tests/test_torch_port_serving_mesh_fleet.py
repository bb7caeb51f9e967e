"""Several in-process replicas on one serving mesh on the CPU
(``serve_cli --mesh --replicas N``, ``build_fleet(..., ranks=...)``):
each replica spans both ranks of a 2-rank gloo mesh, over a channel of
its own (its plans and messages, its views' gathers), and the replicas'
engines take turns on each rank in the leader's order
(``engine._Turns.ordered``).

One spawned group (rank bodies in
``tests/_torch_port_serving_mesh_fleet_worker.py``, one torch thread
each), the ``test`` config at 8x8, serving the JAX package's weights with
its ``PRNGKey`` draws replayed: (c) a one-replica mesh service serves
each replica's pair of requests (2 lanes, one a rank); then one fleet of
two replicas serves both pairs at once, held (a) within 1e-5 of the JAX
package's ``FleetService.build(sampler, cfg, n=2)`` on its data=2 virtual
CPU mesh (1e-5 where the JAX package's own two programs agree to 1e-5),
(b) bit-identical across the ranks and (c) step for step to
the one-replica service; (d) five rounds whose two first plans wait for
each other at a barrier; (e) a rollout on replica 1 and its rollback;
(f) replica 1 killed with a session on it; (g) ``serve_cli.main --mesh
--replicas 2 --schedules ancestral:4,1@ddim:4``; (h) the same with
``--workers`` (a stubbed remote).
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from diff3d_tpu.sampling import Sampler as JSampler  # noqa: E402
from diff3d_tpu.serving import FleetService as JFleet  # noqa: E402
from diff3d_tpu.serving.server import build_request as jbuild  # noqa: E402
from diff3d_tpu_torch.serving import engine as pengine  # noqa: E402
from diff3d_tpu_torch.serving.ranks import MeshBroken  # noqa: E402
from diff3d_tpu_torch.serving.router import Router  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402

import _torch_port_serving_mesh_fleet_worker as fw  # noqa: E402
import _torch_port_serving_mesh_worker as mw  # noqa: E402
from _torch_port_threads import one_thread  # noqa: E402,F401
from test_torch_port_sampler import jax_view_draws  # noqa: E402
from test_torch_port_serving_mesh import (JAX_WAIT, _both_packages,  # noqa
                                          _Later, _replay)

#: A killed replica's followers must have left its loop within this.
KILL_EXIT_S = 5.0
#: (a): an element that the first step's 1/alpha amplifies (see
#: ``_assert_close_to_jax``) is held to this many times the JAX package's
#: own disagreement there.
AMPLIFIED = 10.0


def _jax_fleet(jcfg, jm, params):
    """Each replica's requests on the JAX package's two-replica fleet over
    a data=2 mesh of its virtual CPU devices (the replicas share one
    sampler), drawing from ``PRNGKey(seed)``: the served views by seed,
    and each request's views from a second program, the JAX
    ``synthesize_many`` of its pair on one device."""
    env = jmake_mesh(jconfig.MeshConfig(data_parallel=2, model_parallel=1),
                     devices=jax.devices()[:2])
    jcfg = dataclasses.replace(jcfg, serving=jconfig.ServingConfig(
        **mw.SERVING))
    svc = JFleet.build(JSampler(jm, params, jcfg, mesh=env), jcfg, n=2)
    reqs = {s: rep.submit(jbuild(mw.payload(s), jcfg))
            for rep, pair in zip(svc.replicas, fw.SEEDS) for s in pair}
    svc.start(serve_http=False)
    try:
        served = {s: np.asarray(r.result(timeout=JAX_WAIT))
                  for s, r in reqs.items()}
    finally:
        svc.stop()
    alone, many = JSampler(jm, params, jcfg), {}
    for pair in fw.SEEDS:
        got = np.asarray(alone.synthesize_many(
            [mw.views(3, 100 + s) for s in pair],
            [jax.random.PRNGKey(s) for s in pair], max_views=3))
        many.update(zip(pair, got))
    return {"served": served, "many": many}


def _assert_close_to_jax(out, ref, other):
    """``out`` within 1e-5 of the JAX fleet's ``ref`` wherever the JAX
    package's own second program (``other``: the pair as two objects of
    one program on one device; its fleet runs one object a device) agrees
    with it to 1e-5, at least 99% of the elements.  Elsewhere the first
    reverse step divides eps's rounding by alpha ~ 4.5e-5 at a pixel
    whose x0 is not clipped (``test_torch_port_sampler.py``'s module
    docstring): seed 12's first view has one, where the JAX package's two
    programs differ by 3.3e-4 and the port (bit-identical across its own
    batch shapes there) by 2.0e-3 from the fleet's, the ~3x of its
    differences elsewhere (6e-6 against 2e-6); such elements are held to
    ``AMPLIFIED`` times the JAX package's own difference."""
    spread = np.abs(ref - other)
    tol = 1e-5 + 1e-5 * np.abs(ref)
    sound = spread <= tol
    assert sound.mean() >= 0.99
    np.testing.assert_allclose(out[sound], ref[sound], atol=1e-5, rtol=1e-5)
    assert (np.abs(out - ref) <= np.maximum(AMPLIFIED * spread, tol)).all()


@pytest.fixture(scope="module")
def refs():
    """The tiny model's weights in both packages, the ``PRNGKey(seed)``
    draws the port's requests replay, and the JAX fleet's results
    (computed on a thread while the ranks run)."""
    jcfg, jm, params, state = _both_packages(mw.H)
    B = len(jcfg.diffusion.guidance_weights)
    draws = {}
    for seed in [s for pair in fw.SEEDS for s in pair]:
        carry, draws[seed] = jax.random.PRNGKey(seed), []
        for view in range(1, 3):
            carry, d = jax_view_draws(carry, (B, mw.H, mw.H, 3),
                                      jcfg.diffusion.timesteps, view)
            draws[seed].append(_replay(d))
    return {"state": state, "draws": draws,
            "jax": _Later(lambda: _jax_fleet(jcfg, jm, params))}


@pytest.fixture(scope="module")
def group(refs):
    return spawn("_torch_port_serving_mesh_fleet_worker:fleet_group", 2,
                 refs["state"], refs["draws"], timeout_s=240)


@pytest.fixture(scope="module")
def jax_fleet(refs, group):
    return refs["jax"].get()


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def test_each_replica_matches_the_jax_fleet(group, jax_fleet):
    """(a) Each replica's two requests against the JAX package's
    two-replica fleet on its data=2 virtual CPU mesh (its draws
    replayed): 1e-5 where the JAX package's own two programs agree to
    1e-5 (``_assert_close_to_jax``)."""
    r0, _ = group
    for pair, got in zip(fw.SEEDS, r0["fleet"]):
        for s in pair:
            assert got[s].shape == jax_fleet["served"][s].shape == (
                2, 8, mw.H, mw.H, 3)
            _assert_close_to_jax(got[s], jax_fleet["served"][s],
                                 jax_fleet["many"][s])


def test_each_replica_is_bit_identical_across_ranks(group):
    """(b) Every view step of each replica, (a) to (f), the same bits on
    both ranks (the leader's and its follower's gathered views), at the
    same lanes and weights generation; the weights' digest the same."""
    r0, r1 = group
    assert r0["digest"] == r1["digest"]
    for a_steps, b_steps in zip(r0["rep_steps"], r1["rep_steps"]):
        assert len(a_steps) == len(b_steps) > 0
        for a, b in zip(a_steps, b_steps):
            assert (a["lanes"], a["generation"]) == (b["lanes"],
                                                     b["generation"])
            assert _bits(a["views"], b["views"])


def test_each_replica_has_its_own_channel_and_gather_group(group):
    """Replica 0 keeps the channel it was given (named after it, the
    mesh's gather group); replica 1 has its own channel and group; each
    channel carried its replica's plans alone, on both ranks."""
    r0, r1 = group
    for r in (r0, r1):
        assert r["channels"] == ["r0", "r1"]
        assert r["gather_groups"] == [True, False]
    for lead, follow, steps in zip(r0["counts"], r1["counts"],
                                   r0["rep_steps"]):
        assert lead["plan"] == follow["plan"] == len(steps)
        assert lead["stop"] == follow["stop"] == 1


def test_each_replica_equals_a_one_replica_mesh_service(group):
    """(c) Each replica's two view steps of its pair bit-identical to the
    one-replica mesh service's on the same lanes, weights and draws (that
    service served replica 0's pair, then replica 1's)."""
    r0, r1 = group
    for r in (r0, r1):
        ref = r["ref_steps"]
        assert [s["lanes"] for s in ref] == [2, 2, 2, 2]
        for i, steps in enumerate(r["rep_steps"]):
            for a, b in zip(steps[:2], ref[2 * i:2 * i + 2]):
                assert a["lanes"] == b["lanes"] == 2
                assert _bits(a["views"], b["views"])
    for pair, got in zip(fw.SEEDS, r0["fleet"]):
        for s in pair:
            assert _bits(got[s], r0["ref"][s])


def test_overlapping_replica_steps_neither_hang_nor_cross(group):
    """(d) Five rounds of one request a replica, both replicas' first
    plans released together by a barrier on the leader: every round ends,
    each request's views equal (c)'s bit for bit (a lane's view at 2
    lanes is its rank's alone), and both ranks ran the rounds' steps in
    the same order."""
    r0, _ = group
    assert len(r0["rounds"]) == fw.ROUNDS
    for rnd in r0["rounds"]:
        for seed, views in rnd:
            assert _bits(views, r0["ref"][seed])
    for i, steps in enumerate(r0["rep_steps"]):
        assert r0["steps_before_e"][i] - r0["steps_before_d"][i] == \
            2 * fw.ROUNDS


def test_rollout_on_one_replica_lands_on_both_its_ranks(group):
    """(e) A rollout (x 1.01) named for replica 1 swaps it alone: its
    next view step runs the new weights on both ranks (generation 1 on
    each), replica 0's views stay bit for bit, and the rollback restores
    replica 1's views bit for bit (generation 2)."""
    r0, r1 = group
    assert r0["rollout"]["ok"] and [s["replica"] for s in
                                     r0["rollout"]["steps"]] == ["r1"]
    assert r0["rollback"]["ok"]
    rep0, rep1 = r0["after_rollout"]
    assert _bits(rep0, r0["ref"][fw.SEEDS[0][0]])
    assert not _bits(rep1, r0["ref"][fw.SEEDS[1][0]])
    assert np.isfinite(rep1).all()
    assert _bits(r0["after_rollback"], r0["ref"][fw.SEEDS[1][0]])
    at = r0["steps_before_e"][1]
    for r in (r0, r1):
        gens0 = [s["generation"] for s in r["rep_steps"][0]]
        gens1 = [s["generation"] for s in r["rep_steps"][1][at:at + 4]]
        assert set(gens0) == {0}
        assert gens1 == [1, 1, 2, 2]
    assert r0["versions"] == ["v0", "back"]


def test_killed_replica_releases_its_followers(group):
    """(f) Replica 1 killed with a session on it: its follower loop ends
    within ``KILL_EXIT_S``, before replica 0's; the session's next
    request gets ``SessionLost`` naming replica 1; replica 0 answers on
    both ranks, its views (c)'s bit for bit."""
    r0, r1 = group
    snap = r0["fleet_snapshot"]
    assert snap["sessions"]["per_replica"] == {"r1": 1}
    for name in ("r0", "r1"):
        rep = snap["replicas"][name]
        assert rep["mesh_ranks"] == 2 and rep["channel"]["name"] == name
        assert rep["channel"]["messages"]["plan"] > 0
    ended = r1["ended"]
    assert 0 <= ended[1] - r0["killed_at"] < KILL_EXIT_S
    assert ended[0] > ended[1]
    assert r0["lost"] is not None and r0["lost"][0] == "SessionLost"
    assert "r1" in r0["lost"][1]
    assert _bits(r0["survivor"], r0["ref"][fw.SEEDS[0][1]])
    assert r0["health"]["replicas"] == {"r0": "ok", "r1": "dead"}


def test_serve_cli_mesh_replicas_answers_on_both_replicas(group):
    """(g) ``serve_cli.main --mesh --replicas 2 --schedules
    ancestral:4,1@ddim:4 --warmup`` in the group (each replica's
    warm-ups captured on both ranks in rank 0's order): a session on each
    replica
    answered, the ``ddim:4`` request placed on replica 1 (the only one
    serving it), ``/fleet`` and ``/stats`` reporting each replica's
    ranks and channel; both ranks returned from ``main`` after the
    leader's SIGTERM."""
    r0, r1 = group
    got = r0["g_answers"]
    for key in ("r0", "r1", "ddim"):
        status, body = got[key]
        views = np.asarray(body["views"], np.float32)
        assert status == 200 and views.shape == (2, 8, 8, 8, 3)
        assert np.isfinite(views).all()
    _, fleet = got["fleet"]
    reps = fleet["replicas"]
    assert "ddim:4" in reps["r1"]["supported_schedules"]
    assert "ddim:4" not in reps["r0"]["supported_schedules"]
    assert fleet["sessions"]["per_replica"] == {"r0": 1, "r1": 2}
    for name in ("r0", "r1"):
        assert reps[name]["mesh_ranks"] == 2
        assert reps[name]["channel"]["messages"]["plan"] > 0
    assert reps["r0"]["channel"]["messages"]["warmup"] == 1
    assert reps["r1"]["channel"]["messages"]["warmup"] == 2
    _, stats = got["stats"]
    assert set(stats["fleet"]["replicas"]) == {"r0", "r1"}
    assert r1["g_answers"] == {}


def test_serve_cli_mesh_replicas_with_workers_builds_the_mixed_fleet(
        group):
    """(h) ``--mesh --replicas 2 --workers``: rank 0's fleet holds both
    mesh replicas and the remote; the follower builds the two replicas
    alone (it asks for no remote) and follows them until rank 0 stops
    them."""
    r0, r1 = group
    assert r0["h_names"] == ["r0", "r1", "remote"]
    assert r0["h_replicas"] == ["Replica", "Replica", "Remote"]
    assert r0["h_remotes_asked"] == [[("127.0.0.1", 9)]]
    assert r1["h_names"] == ["r0", "r1"] and r1["h_remotes_asked"] == []
    assert r0["h_mesh_ranks"] == r1["h_mesh_ranks"] == [2, 2]


# --- the turn lock's tickets, alone ----------------------------------------


def test_ordered_turns_admit_tickets_in_order():
    """A follower's turns run the leader's tickets in their order, however
    the threads asking for them arrive, and never two at once."""
    turns = pengine._Turns()
    ran, inside = [], []

    def take(ticket, delay):
        time.sleep(delay)
        with turns.ordered(ticket):
            inside.append(ticket)
            assert len(inside) == 1
            ran.append(ticket)
            time.sleep(0.005)
            inside.pop()

    threads = [threading.Thread(target=take, args=(t, d))
               for t, d in ((3, 0.0), (1, 0.01), (0, 0.03), (2, 0.0),
                            (4, 0.02))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert ran == [0, 1, 2, 3, 4]


def test_leader_tickets_count_from_zero_under_the_turn():
    turns = pengine._Turns()
    with turns:
        assert [turns.ticket() for _ in range(3)] == [0, 1, 2]


def test_failed_turns_release_every_waiter():
    """A follower's broken channel fails its turns: a thread waiting for a
    ticket that will never come raises ``MeshBroken`` instead of
    hanging."""
    turns = pengine._Turns()
    errors = []

    def wait_for(ticket):
        try:
            with turns.ordered(ticket):
                pass
        except MeshBroken as e:
            errors.append(str(e))

    t = threading.Thread(target=wait_for, args=(1,))
    t.start()
    time.sleep(0.05)
    turns.fail("channel r1 broke")
    t.join(5)
    assert not t.is_alive() and errors and "channel r1 broke" in errors[0]
    assert turns.failed == "channel r1 broke"


def test_rollout_names_only_known_replicas():
    """``Router.rollout(replicas=...)`` refuses a name the fleet does not
    hold, before any replica drains."""

    class Rep:
        health = "ok"

        def __init__(self, name):
            self.name = name
            self.events = []

        def drain(self, timeout=None):
            self.events.append("drain")
            return True

        def swap_params(self, params, version=None):
            self.events.append("swap")
            return version

        def resume(self):
            self.events.append("resume")

    reps = [Rep("r0"), Rep("r1")]
    router = Router(reps)
    with pytest.raises(ValueError, match="r7"):
        router.rollout({}, replicas=["r1", "r7"])
    assert reps[0].events == reps[1].events == []
    got = router.rollout({}, version="v1", replicas=["r1"])
    assert got["ok"] and reps[0].events == []
    assert reps[1].events == ["drain", "swap", "resume"]
