"""The port's progressive distillation under the mesh's placements
(``fsdp``, ``tp``, ``fsdp+tp``, ``context_parallel``) on the CPU over gloo,
held against one process and against the JAX package.

  * Two distill steps under ``fsdp`` (dp 2), ``tp`` (mp 2), ``fsdp+tp``
    (dp2 x mp2), cp (mp 2) and cp at dp2 x mp2, from one mid-round state
    (Adam's moments non-zero: from fresh ones the first update is ``lr *
    sign(g)``, and the sign of the smallest distill gradients is
    summation-order noise), against one process from the same state: the
    loss, gradient norm and lr within 1e-5 relative, every leaf of the
    parameters, the EMA and Adam's moments within 1e-4 relative L2 or 2
    float32 spacings + 1e-8.
  * One step at cp mp 2 and at tp mp 2 against the JAX package's sharded
    ``make_distill_step`` on the virtual CPU mesh (cp through
    ``activation_constraint``), the JAX draws replayed through
    ``DistillDraws``' interface, at ``test_one_distill_step_matches_jax``'s
    tolerances.
  * ``distill()`` for two rounds at tp 2 and cp 2: the returned tensors
    whole and equal to one process's; each round's ``full_sliced``
    checkpoint (gathered, written by rank 0) restored bit for bit at world
    1; a world-1 round restored at tp 2, bit for bit.
  * The refusals: a sharded placement with context parallelism, and CUDA
    graphs under a placement that runs eagerly.

Two spawned groups (2 and 4 ranks) run ``tests/_torch_port_distill_worker
.py`` once each; the tests below assert on what they returned and wrote.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

torch = pytest.importorskip("torch")

import _torch_port_distill_worker as worker  # noqa: E402
from diff3d_tpu import config as jconfig  # noqa: E402
from diff3d_tpu.config import test_config as jax_tiny_config  # noqa: E402
from diff3d_tpu.models import XUNet as JXUNet  # noqa: E402
from diff3d_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from diff3d_tpu.train import make_distill_step as j_make_distill_step  # noqa: E402
from diff3d_tpu.train import state as jstate  # noqa: E402
from diff3d_tpu_torch.config import MeshConfig  # noqa: E402
from diff3d_tpu_torch.convert import (convert_params,  # noqa: E402
                                      load_flax_train_state)
from diff3d_tpu_torch.models import XUNet  # noqa: E402
from diff3d_tpu_torch.parallel import make_mesh  # noqa: E402
from diff3d_tpu_torch.testing.distributed import spawn  # noqa: E402
from diff3d_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                    create_train_state, distill)
from diff3d_tpu_torch.train.distill import DistillStep  # noqa: E402

from _torch_port_threads import one_thread  # noqa: E402,F401

H, B, K = worker.H, worker.B, worker.K
STEP = 9                        # the mid-round state's step
KEY = 11                        # the JAX step's PRNG key
#: The JAX package's mesh of each placement held against it.
JAX_MESHES = {"cp": dict(model_parallel=2, context_parallel=True),
              "tp": dict(model_parallel=2, param_sharding="tp")}


def _np_batch(seed):
    r = np.random.RandomState(seed)
    Km = np.array([[H * 1.2, 0, H / 2], [0, H * 1.2, H / 2], [0, 0, 1]],
                  np.float32)
    q, _ = np.linalg.qr(r.normal(size=(B, 2, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    return {"imgs": r.randint(0, 256, (B, 2, H, H, 3)).astype(np.uint8),
            "R": R, "T": r.randn(B, 2, 3).astype(np.float32),
            "K": np.broadcast_to(Km, (B, 3, 3)).copy()}


def _jax_cfg(mesh=None):
    j = jax_tiny_config(imgsize=H, ch=8, shallow=True)
    p = worker.config().train
    j = dataclasses.replace(j, train=dataclasses.replace(
        j.train, global_batch=B, lr=p.lr, warmup_examples=p.warmup_examples,
        ema_halflife_examples=p.ema_halflife_examples,
        grad_clip=p.grad_clip))
    if mesh is not None:
        j = dataclasses.replace(j, mesh=jconfig.MeshConfig(**mesh))
    return j


@pytest.fixture(scope="module")
def start():
    """The mid-round state as Flax leaves (as
    ``test_one_distill_step_matches_jax`` builds it: a random teacher, a
    student and an EMA near it, Adam's moments of 7 updates, the schedule
    at 8, the step at 9), its JAX ``TrainState``, and the port's teacher
    weights."""
    jcfg = _jax_cfg()
    model = JXUNet(jcfg.model)
    dummy = {"x": np.zeros((1, H, H, 3), np.float32),
             "z": np.zeros((1, H, H, 3), np.float32),
             "logsnr": np.zeros((1, 2), np.float32),
             "R": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 2, 3, 3)),
             "t": np.zeros((1, 2, 3), np.float32),
             "K": np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))}
    shapes = flatten_dict(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), dummy, cond_mask=np.ones(1, bool)))["params"],
        sep="/")
    rng = np.random.default_rng(5)

    def rand(scale):
        return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in shapes.items()}

    teacher = rand(0.08)
    student = {k: v + d for (k, v), d in zip(teacher.items(),
                                             rand(0.01).values())}
    ema = {k: v + d for (k, v), d in zip(student.items(),
                                         rand(0.01).values())}
    mu = rand(0.01)
    nu = {k: (v * v + 1e-6).astype(np.float32) for k, v in rand(0.01).items()}
    tree = lambda d: unflatten_dict(  # noqa: E731
        {k: jnp.asarray(v) for k, v in d.items()}, sep="/")
    st = jstate.create_train_state(tree(student), jcfg.train)
    opt_state = jax.tree.map(
        lambda s: (s._replace(count=jnp.int32(7), mu=tree(mu), nu=tree(nu))
                   if isinstance(s, optax.ScaleByAdamState) else
                   s._replace(count=jnp.int32(8))
                   if isinstance(s, optax.ScaleByScheduleState) else s),
        st.opt_state, is_leaf=lambda s: isinstance(
            s, (optax.ScaleByAdamState, optax.ScaleByScheduleState)))
    st = st.replace(step=jnp.int32(STEP), opt_state=opt_state,
                    ema_params=tree(ema))
    pm = XUNet(worker.config().model)
    flax = dict(params=student, ema_params=ema, mu=mu, nu=nu)
    return {"flax": flax, "jax_state": st, "tree": tree(teacher),
            "teacher": {k: v.numpy() for k, v in
                        convert_params(teacher, pm).items()}}


def _write_start(start, workdir):
    """The mid-round state as the port's one-process ``full`` checkpoint
    in ``<workdir>/start``."""
    cfg = worker.config()
    state = create_train_state(XUNet(cfg.model), cfg.train)
    load_flax_train_state(state, **start["flax"], adam_count=7,
                          schedule_count=8, step=STEP)
    CheckpointManager(os.path.join(workdir, "start")).save(state)


def _replays():
    """The JAX step's draws (``diff3d_tpu/train/distill.py:89-109``): the
    step folded into the key, then split."""
    k_i, k_noise = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(KEY), STEP))
    i = np.asarray(jax.random.randint(k_i, (B,), 1, K + 1))
    noise = np.array(jax.random.normal(k_noise, (B, H, H, 3)))
    assert (i == K).any() and (i < K).any()   # alpha_t ~ 4.5e-5 included
    return {name: (i, noise) for name in JAX_MESHES}


def _one_loop(teacher, batches, workdir):
    """``distill()`` in one process (the whole loop's reference; its last
    round's checkpoint is the one the ranks restore at tp 2)."""
    env = make_mesh(MeshConfig())
    return worker.loop(env, os.path.join(workdir, "loop_one"), teacher,
                       batches)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, start):
    """Both spawned groups, and in this process meanwhile one process's
    references and the JAX package's sharded steps."""
    from concurrent.futures import ThreadPoolExecutor

    workdir = str(tmp_path_factory.mktemp("distill_mesh"))
    _write_start(start, workdir)
    batches = [_np_batch(s) for s in range(4)]
    one_loop = _one_loop(start["teacher"], batches, workdir)
    replays = _replays()
    with ThreadPoolExecutor(2) as pool:
        groups = {n: pool.submit(spawn, "_torch_port_distill_worker:group",
                                 n, workdir, start["teacher"], batches,
                                 replays, timeout_s=600) for n in (2, 4)}
        one = worker.steps(make_mesh(MeshConfig()),
                           os.path.join(workdir, "start"), start["teacher"],
                           batches[:worker.STEPS])
        jax_runs = {name: _jax_step(start, name, batches[0])
                    for name in JAX_MESHES}
        ranks = {n: f.result() for n, f in groups.items()}
    cfg = worker.config()
    state = create_train_state(XUNet(cfg.model), cfg.train)
    CheckpointManager(os.path.join(workdir, "start")).restore(state)
    return {"workdir": workdir, "one": one, "one_loop": one_loop,
            "jax": jax_runs, "ranks": ranks,
            "start_state": worker.whole_state(make_mesh(MeshConfig()),
                                              state)}


def _jax_step(start, name, batch):
    """One step of the JAX package's sharded ``make_distill_step`` on 2
    virtual CPU devices: its metrics and state in the port's names and
    layout."""
    jcfg = _jax_cfg(JAX_MESHES[name])
    env = j_make_mesh(jcfg.mesh, devices=jax.devices()[:2])
    model = JXUNet(jcfg.model)
    new, jm = j_make_distill_step(model, jcfg, env=env, donate=False)(
        start["jax_state"], start["tree"],
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(KEY), jnp.asarray(K, jnp.int32))
    pm = XUNet(worker.config().model)
    adam = [s for s in jax.tree.leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    out = {"metrics": {k: float(v) for k, v in jax.device_get(jm).items()},
           "step": int(new.step)}
    for prefix, t in (("model.", new.params), ("ema.", new.ema_params),
                      ("adam_mu.", adam.mu)):
        for k, v in convert_params(flatten_dict(jax.device_get(t), sep="/"),
                                   pm).items():
            out[prefix + k] = v.numpy()
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _leaf_ok(got, want) -> bool:
    """Within 1e-4 relative L2, or every element within 2 float32
    spacings of the reference + 1e-8."""
    if _rel(got, want) <= 1e-4:
        return True
    d = np.abs(got.astype(np.float64) - want)
    return bool((d <= 2 * np.spacing(np.abs(want).astype(np.float32))
                 + 1e-8).all())


def _by_rank(runs, name):
    """The ranks' results of placement ``name``."""
    n = 2 if name in worker.GROUPS[2] else 4
    return runs["ranks"][n]


# ---- two steps under each placement against one process ----------------

@pytest.mark.parametrize("name", list(worker.MESHES))
def test_two_distill_steps_match_one_process(runs, name):
    """Every rank ends with the same whole state, each leaf of the
    parameters, the EMA and both Adam moments held against one process's
    two steps from the same mid-round state; the loss, the gradient norm
    and the lr within 1e-5 relative at each step."""
    one = runs["one"]
    ranks = [r[name] for r in _by_rank(runs, name)]
    for r in ranks:
        assert r["step"] == one["step"] == STEP + worker.STEPS
        assert r["graphs"] is False
        for got, want in zip(r["metrics"], one["metrics"]):
            for k, v in want.items():
                assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        assert sorted(r["state"]) == sorted(one["state"])
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k])
    bad = [(k, _rel(v, one["state"][k])) for k, v in ranks[0]["state"].items()
           if not _leaf_ok(v, one["state"][k])]
    assert not bad, bad[:5]
    # The steps moved every kind of leaf far beyond the tolerance.
    for kind in ("model.", "ema.", "adam."):
        moved = [_rel(v, runs["start_state"][k]) for k, v in
                 one["state"].items() if k.startswith(kind)]
        assert moved and float(np.median(moved)) > 1e-2, kind


def test_placements_split_and_shard_what_they_name(runs):
    """fsdp shards (and splits nothing), tp splits (and shards nothing),
    fsdp+tp does both, with the row split too; cp does neither; the ranks'
    (data, model) ranks."""
    r2, r4 = runs["ranks"][2], runs["ranks"][4]
    assert [r["fsdp"]["sharded"] for r in r2] == [True, True]
    assert r2[0]["fsdp"]["split"] == 0
    assert r2[0]["tp"]["split"] > 0 and not r2[0]["tp"]["sharded"]
    for name in ("fsdp+tp", "cp_fsdp_tp"):
        assert r4[0][name]["split"] > 0 and r4[0][name]["sharded"]
        assert r4[0][name]["split"] == r4[0]["fsdp+tp"]["split"]
    for r in r2 + r4:
        for name in ("cp", "cp_dp2"):
            if name in r:
                assert not r[name]["sharded"] and r[name]["split"] == 0
    assert sorted(r["ranks"]["fsdp"] for r in r2) == [(0, 0), (1, 0)]
    assert sorted(r["ranks"]["tp"] for r in r2) == [(0, 0), (0, 1)]
    assert sorted(r["ranks"]["cp_dp2"] for r in r4) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name,data", [("cp", 1), ("cp_dp2", 2),
                                       ("cp_fsdp_tp", 2)])
def test_cp_bucket_spans_the_world_divided_by_the_data_size(runs, name,
                                                            data):
    """Under the row split the bucket is all-reduced over every rank and
    divided by the data size, model rank 0's loss alone in it; under the
    placements the bucket is the data group's."""
    for r in _by_rank(runs, name):
        model_rank = r["ranks"][name][1]
        assert r[name]["bucket"] == (data, model_rank == 0)
    for r in runs["ranks"][2]:
        assert r["fsdp"]["bucket"] == (2, True)
        assert r["tp"]["bucket"] == (1, True)


def test_cp_fsdp_tp_distill_steps_match_one_process_at_1e_5(runs):
    """Under the row split with ``fsdp+tp`` at dp2 x mp2 (the teacher's
    two forwards and the student's gathering their split leaves per
    layer; the bucket's blocks over the data axis, FSDP2's shards over the
    model axis): every leaf of the state within 1e-5 relative L2 of one
    process's two steps, and of the row split's own run with every leaf
    whole (``cp_dp2``)."""
    one = runs["one"]
    ranks = sorted(runs["ranks"][4], key=lambda r: r["ranks"]["cp_fsdp_tp"])
    got = ranks[0]["cp_fsdp_tp"]["state"]
    whole = ranks[0]["cp_dp2"]["state"]
    bad = [(k, _rel(v, one["state"][k])) for k, v in got.items()
           if _rel(v, one["state"][k]) > 1e-5]
    assert not bad, bad[:5]
    bad = [(k, _rel(v, whole[k])) for k, v in got.items()
           if _rel(v, whole[k]) > 1e-5]
    assert not bad, bad[:5]


# ---- against the JAX package --------------------------------------------

@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_one_step_matches_the_jax_packages_sharded_step(runs, start, name):
    """The port's step at mp 2 (cp: each rank its rows; tp: each rank its
    blocks) against the JAX package's ``make_distill_step(env=...)`` on
    the same virtual mesh, the JAX draws replayed: loss, gradient norm and
    lr within 1e-5 relative; the parameters, the EMA and Adam's first
    moments within 1e-4 relative L2 over all of them; the step moved the
    parameters."""
    want = runs["jax"][name]
    for r in runs["ranks"][2]:
        got = r[f"jax_{name}"]
        assert got["step"] == want["step"] == STEP + 1
        for k in ("distill_loss", "grad_norm", "lr"):
            ref = want["metrics"][k]
            assert abs(got["metrics"][0][k] - ref) <= 1e-5 * abs(ref), (
                k, got["metrics"][0][k], ref)
        assert want["metrics"]["grad_norm"] > worker.config().train.grad_clip
        for prefix, port in (("model.", "model."), ("ema.", "ema."),
                             ("adam_mu.", "adam.")):
            keys = [k[len(prefix):] for k in want if k.startswith(prefix)]
            g = [got["state"][port + k + (".exp_avg" if port == "adam."
                                          else "")] for k in keys]
            w = [want[prefix + k] for k in keys]
            num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g, w))
            den = sum(float((b ** 2).sum()) for b in w)
            assert (num / den) ** 0.5 <= 1e-4, (prefix, (num / den) ** 0.5)
    start_p = convert_params(start["flax"]["params"],
                             XUNet(worker.config().model))
    moved = [_rel(want["model." + k], v.numpy()) for k, v in start_p.items()]
    assert max(moved) > 1e-3


# ---- the whole loop -----------------------------------------------------

LOOPS = [n for g in (2, 4) for n in worker.LOOPS[g]]


def _loop_ranks(runs, name):
    n = 2 if name in worker.LOOPS[2] else 4
    return [r[f"loop_{name}"] for r in runs["ranks"][n]]


@pytest.mark.parametrize("name", LOOPS)
def test_distill_loop_returns_whole_tensors_equal_to_one_process(runs,
                                                                 start,
                                                                 name):
    """``distill()`` at mp 2 (tp, cp), dp 2 (fsdp) and dp2 x mp2
    (fsdp+tp) returns every parameter's EMA whole on every rank, the same
    on all, within 1e-4 relative L2 (over all of them) of one process's
    ``distill()``; the rounds' losses within 1e-5; the weights moved from
    the teacher far more than they differ."""
    one = runs["one_loop"]
    ranks = _loop_ranks(runs, name)
    shapes = {n: tuple(p.shape) for n, p in
              XUNet(worker.loop_config().model).named_parameters()}
    for r in ranks:
        assert {k: v.shape for k, v in r["final"].items()} == shapes
        for k, v in r["final"].items():
            np.testing.assert_array_equal(v, ranks[0]["final"][k])
        assert [h["student_steps"] for h in r["history"]] == [2, 1]
        for a, b in zip(r["history"], one["history"]):
            assert abs(a["final_loss"] - b["final_loss"]) \
                <= 1e-5 * abs(b["final_loss"])
    keys = sorted(shapes)
    got = [ranks[0]["final"][k] for k in keys]
    want = [one["final"][k] for k in keys]
    diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want)) ** 0.5
    norm = sum(float((b ** 2).sum()) for b in want) ** 0.5
    moved = sum(float(((b - start["teacher"][k]) ** 2).sum())
                for k, b in zip(keys, want)) ** 0.5
    assert diff <= 1e-4 * norm, diff / norm
    assert moved >= 10 * diff, (moved, diff)


@pytest.mark.parametrize("name", LOOPS)
def test_each_round_checkpoint_restores_bit_for_bit_at_world_one(runs,
                                                                  name):
    """Each round's ``full_sliced`` checkpoint of the run under the mesh
    (gathered, written by rank 0, the mesh stamped) restored at world 1:
    bit for bit the ranks' whole state at that round's end; the last
    round's EMA is the returned tensors."""
    workdir = runs["workdir"]
    ranks = _loop_ranks(runs, name)
    axes = {"tp": (1, 2), "cp": (1, 2), "fsdp": (2, 1),
            "fsdp+tp": (2, 2)}[name]
    cfg = worker.loop_config()
    for i, k in enumerate((2, 1)):
        state = create_train_state(XUNet(cfg.model), cfg.train)
        mgr = CheckpointManager(os.path.join(workdir, f"loop_{name}",
                                             f"steps_{k}"))
        mgr.mesh_info = make_mesh(MeshConfig()).topology_summary()
        assert mgr.mode == "full_sliced"
        assert mgr.restore(state) == worker.ROUND_STEPS
        assert mgr.last_restore_reshard["from"]["axes"] == dict(
            zip(("data", "model"), axes))
        got = worker.whole_state(make_mesh(MeshConfig()), state)
        for r in ranks:
            assert sorted(got) == sorted(r["ends"][i])
            for key, v in r["ends"][i].items():
                np.testing.assert_array_equal(got[key], v, err_msg=key)
    for key, v in ranks[0]["final"].items():
        np.testing.assert_array_equal(got[f"ema.{key}"], v)


def test_world_one_round_restores_at_tp2(runs):
    """One process's last round checkpoint restored into a state placed at
    tp 2: every tensor gathered back is the file's, bit for bit."""
    cfg = worker.loop_config()
    state = create_train_state(XUNet(cfg.model), cfg.train)
    path = os.path.join(runs["workdir"], "loop_one", "steps_1")
    assert CheckpointManager(path).restore(state) == worker.ROUND_STEPS
    want = worker.whole_state(make_mesh(MeshConfig()), state)
    for r in runs["ranks"][2]:
        got = r["world1_round_at_tp"]
        assert got["step"] == worker.ROUND_STEPS
        assert got["reshard"]["to"]["param_sharding"] == "tp"
        assert sorted(got["state"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


# ---- refusals -------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fsdp", "tp", "fsdp+tp"])
def test_sharded_placement_with_cp_is_refused(policy):
    """Refused until context parallelism took the split placements (the
    name is kept): the config validates, a mesh of one process is refused
    only for lacking ranks, and a step takes such a mesh, with the row
    split's bucket (``cp_fsdp_tp`` runs it on ranks)."""
    import torch.distributed as dist

    cfg = MeshConfig(model_parallel=2, context_parallel=True,
                     param_sharding=policy)
    cfg.validate()
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(cfg)
    env = SimpleNamespace(cfg=cfg, context_parallel=True, eager_only=True,
                          group=None, data_size=1, data_rank=0,
                          model_rank=1, model_axis=None)
    step = DistillStep(worker.config(), env=env)
    assert step.rows == (dist.group.WORLD, 1, False)
    assert not step.cuda_graphs


@pytest.mark.parametrize("mesh", [dict(param_sharding="fsdp"),
                                  dict(model_parallel=2,
                                       param_sharding="tp"),
                                  dict(model_parallel=2,
                                       context_parallel=True)])
def test_graphs_are_refused_under_an_eager_only_placement(mesh):
    env = SimpleNamespace(cfg=MeshConfig(**mesh), group=None, data_size=1,
                          data_rank=0, model_rank=0, model_axis=None,
                          context_parallel=mesh.get("context_parallel",
                                                    False),
                          eager_only=True)
    with pytest.raises(ValueError, match="eagerly.*cuda_graphs=True"):
        DistillStep(worker.config(), cuda_graphs=True, env=env)
    assert DistillStep(worker.config(), env=env).cuda_graphs is False


def test_distill_picks_the_eager_step_and_a_plain_adam(monkeypatch):
    """Under an eager-only placement ``distill()`` builds its step without
    graphs and a non-capturable Adam, whatever the device."""
    import importlib

    dmod = importlib.import_module("diff3d_tpu_torch.train.distill")
    seen = {}
    real = dmod.create_train_state

    def spy(model, cfg, capturable=None):
        seen["capturable"] = capturable
        return real(model, cfg, capturable=capturable)

    monkeypatch.setattr(dmod, "create_train_state", spy)
    monkeypatch.setattr(dmod, "use_cuda_graphs",
                        lambda g, device: seen.setdefault("graphs", g) or
                        False)
    env = make_mesh(MeshConfig())
    env.cfg = MeshConfig(param_sharding="fsdp")
    cfg = worker.loop_config()
    batches = iter([worker.rows(_np_batch(s), env) for s in range(2)])
    teacher = {k: v.detach().clone()
               for k, v in XUNet(cfg.model).named_parameters()}
    distill(XUNet(cfg.model), cfg, teacher, batches, start_steps=2,
            final_steps=1, round_steps=2, log_every=0, env=env)
    assert seen == {"capturable": False, "graphs": False}
