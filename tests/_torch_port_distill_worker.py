"""Rank bodies of the distillation tests under the mesh's placements
(``test_torch_port_distill_parallel.py``), run on spawned gloo ranks by
:func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports torch and the
port only (no JAX: every rank is a fresh interpreter).

Every rank starts from the same mid-round state, a one-process ``full``
checkpoint the parent wrote (restored into the placed state: each rank its
blocks and chunks), with the teacher's whole weights placed like the
student.  Results come back whole (``MeshEnv.full_of``), so the parent
holds them against one process's run of the same functions.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import _torch_port_parallel_worker as dp_worker

H = 8
B = 8                           # the global batch
K = 2                           # the student's steps of the two-step runs
STEPS = 2
#: ``MeshConfig`` keywords of each placement held against one process.
MESHES = {
    "fsdp": dict(data_parallel=2, param_sharding="fsdp"),
    "tp": dict(model_parallel=2, param_sharding="tp"),
    "cp": dict(model_parallel=2, context_parallel=True),
    "fsdp+tp": dict(data_parallel=2, model_parallel=2,
                    param_sharding="fsdp+tp"),
    "cp_dp2": dict(data_parallel=2, model_parallel=2, context_parallel=True),
    "cp_fsdp_tp": dict(data_parallel=2, model_parallel=2,
                       context_parallel=True, param_sharding="fsdp+tp"),
}
GROUPS = {2: ("fsdp", "tp", "cp"), 4: ("fsdp+tp", "cp_dp2", "cp_fsdp_tp")}
#: The placements the whole loop runs under, by group size.
LOOPS = {2: ("tp", "cp", "fsdp"), 4: ("fsdp+tp",)}
#: The whole loop: ``distill(start_steps=4, final_steps=1)``, rounds k = 2
#: and 1 of ``ROUND_STEPS`` steps each.
LOOP = dict(start_steps=4, final_steps=1)
ROUND_STEPS = 2


def config(mesh=None):
    """The shallow tiny X-UNet at global batch 8; the train settings of
    ``test_one_distill_step_matches_jax`` (lr 0.1, clipping that acts, an
    EMA that follows the parameters)."""
    from diff3d_tpu_torch.config import MeshConfig

    cfg = dp_worker.tiny_config(global_batch=B, lr=0.1,
                                warmup_examples=128,
                                ema_halflife_examples=16, grad_clip=1.0)
    return dataclasses.replace(cfg, mesh=MeshConfig(**(mesh or {})))


def loop_config(mesh=None):
    """The whole loop's: fresh Adam at each round, so a small lr (its
    first update is ``lr * sign(g)``, and the sign of the smallest distill
    gradients is summation-order noise)."""
    cfg = config(mesh)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=1e-5, warmup_examples=8))


class Replay:
    """The JAX package's draws of one distill step: ``i`` as ``u = (i -
    0.5) / k``, and the noise (global batch)."""

    generator = None

    def __init__(self, i, noise, k):
        self._u = ((np.asarray(i, np.float32) - 0.5) / k).astype(np.float32)
        self._noise = np.asarray(noise, np.float32)

    def u(self, n, device):
        assert n == len(self._u)
        return torch.from_numpy(self._u)

    def noise(self, shape, device):
        assert tuple(shape) == self._noise.shape
        return torch.from_numpy(self._noise)


def rows(batch, env):
    """This data rank's rows of a whole numpy batch, as tensors."""
    n = B // env.data_size
    r = env.data_rank
    return {k: torch.from_numpy(np.ascontiguousarray(v[r * n:(r + 1) * n]))
            for k, v in batch.items()}


def whole_state(env, state) -> dict:
    """Every tensor of ``state`` whole, as numpy: ``model.*``, ``ema.*``,
    ``adam.<param>.exp_avg`` / ``exp_avg_sq`` (a collective: every rank
    calls it)."""
    from diff3d_tpu_torch.train.checkpoint import _param_name, state_leaves

    return {n: env.full_of(_param_name(n), t.detach()).numpy().copy()
            for n, t in state_leaves(state) if not n.endswith(".step")}


def placed(cfg, env, start_dir, teacher):
    """``(state, teacher module)`` at ``env``: the student restored from
    the one-process checkpoint in ``start_dir`` (each rank its blocks and
    chunks), the teacher's whole weights ``teacher`` placed like it."""
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import CheckpointManager, create_train_state
    from diff3d_tpu_torch.train.distill import _load_teacher

    model = env.params(XUNet(cfg.model))
    state = create_train_state(model.eval(), cfg.train, capturable=False)
    mgr = CheckpointManager(start_dir)
    mgr.mesh_info = env.topology_summary()
    if env.tensor_parallel:
        mgr.placement = env
    mgr.restore(state)
    t_model = env.params(XUNet(cfg.model).eval().requires_grad_(False))
    _load_teacher(t_model, {k: torch.from_numpy(v)
                            for k, v in teacher.items()}, env)
    return state, t_model


def steps(env, start_dir, teacher, batches, draws=None) -> dict:
    """``len(batches)`` distill steps at ``K`` student steps from the
    mid-round state, each rank on its rows: the metrics, the state after
    them (whole) and the step's bucket and graph setting.  ``draws``: one
    :class:`Replay` per step (default: the step's own generator)."""
    from diff3d_tpu_torch.train import make_distill_step

    cfg = config(dataclasses.asdict(env.cfg))
    state, t_model = placed(cfg, env, start_dir, teacher)
    step = make_distill_step(cfg, env=env if env.group is not None
                             else None)
    metrics = []
    for i, batch in enumerate(batches):
        m = step(state, t_model, rows(batch, env), K,
                 draws=None if draws is None else draws[i])
        metrics.append({k: float(m[k]) for k in ("distill_loss",
                                                 "grad_norm", "lr")})
    return {"metrics": metrics, "state": whole_state(env, state),
            "step": state.step, "graphs": step.cuda_graphs,
            "bucket": (step._sync.world, step._sync.with_loss),
            "sharded": env.sharded(state.model),
            "split": sum(map(env.is_split, state.ema))}


def loop(env, workdir, teacher, batches) -> dict:
    """``distill()`` over ``env``: two rounds with ``workdir``; the
    returned tensors, the history, and the whole state at each round's
    end (read by a wrapper around the step)."""
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import distill, make_distill_step

    cfg = loop_config(dataclasses.asdict(env.cfg))
    inner = make_distill_step(cfg, env=env if env.group is not None
                              else None)
    ends = []

    def step_fn(state, t_model, batch, k):
        m = inner(state, t_model, batch, k)
        if state.step == ROUND_STEPS:
            ends.append(whole_state(env, state))
        return m

    final, history = distill(
        XUNet(cfg.model), cfg, {k: torch.from_numpy(v)
                                for k, v in teacher.items()},
        (rows(b, env) for b in batches), round_steps=ROUND_STEPS,
        workdir=workdir, log_every=0, step_fn=step_fn, env=env, **LOOP)
    return {"final": {k: v.numpy().copy() for k, v in final.items()},
            "history": history, "ends": ends}


def restore_round(env, ckpt_dir) -> dict:
    """A round's ``full_sliced`` checkpoint restored into a state placed
    at ``env``, gathered whole."""
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import CheckpointManager, create_train_state

    cfg = loop_config(dataclasses.asdict(env.cfg))
    state = create_train_state(env.params(XUNet(cfg.model)).eval(),
                               cfg.train, capturable=False)
    mgr = CheckpointManager(ckpt_dir)
    mgr.mesh_info = env.topology_summary()
    if env.tensor_parallel:
        mgr.placement = env
    step = mgr.restore(state)
    return {"step": step, "state": whole_state(env, state),
            "reshard": mgr.last_restore_reshard}


def group(rank: int, world: int, workdir: str, teacher, batches,
          replays) -> dict:
    """Everything at ``world`` ranks: two distill steps under each of the
    group's placements, and the whole loop under its ``LOOPS``; at 2
    ranks also one step with the JAX package's draws replayed
    (``replays``: ``{mesh: (i, noise)}``) and a world-1 round restored at
    tp."""
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.parallel import make_mesh

    start = os.path.join(workdir, "start")
    out = {}

    def mesh(name):
        env = make_mesh(MeshConfig(**MESHES[name]), model=config().model)
        out.setdefault("ranks", {})[name] = (env.data_rank, env.model_rank)
        return env

    for name in GROUPS[world]:
        out[name] = steps(mesh(name), start, teacher, batches[:STEPS])
    for name in LOOPS[world]:
        out[f"loop_{name}"] = loop(mesh(name),
                                   os.path.join(workdir, f"loop_{name}"),
                                   teacher, batches)
    if world != 2:
        return out
    for name, (i, noise) in replays.items():
        out[f"jax_{name}"] = steps(mesh(name), start, teacher, batches[:1],
                                   draws=[Replay(i, noise, K)])
    out["world1_round_at_tp"] = restore_round(
        mesh("tp"), os.path.join(workdir, "loop_one", "steps_1"))
    return out
