"""Rank bodies of the parallel layer's CPU tests, run on spawned gloo
ranks by :func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports
torch and the port only (no JAX: every rank is a fresh interpreter).

Every input is made from a numpy seed, so the parent test rebuilds the
same global tensors and holds each rank's shard against its reference.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

ATTN_SHAPE = (2, 16, 4, 8)          # B, L, H, D (global)
LAYER_SHAPE = (2, 16, 32)           # B, L, C


def attention_inputs(seed: int = 0, shape=ATTN_SHAPE):
    """Global ``q, k, v`` and the output cotangent ``w``, f32 numpy."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def _shard(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(
        x[:, rank * n:(rank + 1) * n]))


def attention(rank: int, world: int) -> dict:
    """Ring (both engines) and Ulysses on this rank's shards: outputs and
    the gradients of ``sum(out * w)``; the indivisible-heads error; the
    ``AttnLayer`` with ``ring:`` / ``ulysses:`` cores."""
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.models.layers import AttnLayer
    from diff3d_tpu_torch.parallel import make_mesh, ring_sdpa, ulysses_sdpa

    q, k, v, w = attention_inputs()
    group = dist.group.WORLD
    out = {}
    for name, fn, kw in (("ring_einsum", ring_sdpa, {"impl": "einsum"}),
                         ("ring_cuda", ring_sdpa, {}),
                         ("ulysses", ulysses_sdpa, {})):
        ql, kl, vl = (_shard(t, rank, world).requires_grad_()
                      for t in (q, k, v))
        o = fn(ql, kl, vl, group, **kw)
        (o * _shard(w, rank, world)).sum().backward()
        out[name] = [t.detach().numpy() for t in
                     (o, ql.grad, kl.grad, vl.grad)]
    try:
        three = torch.zeros(2, 4, 3, 8)
        ulysses_sdpa(three, three, three, group)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    # The ranks listed in any order make the default mesh; a mesh that
    # leaves a rank out is refused.
    out["data_ranks"] = make_mesh(MeshConfig(), devices=[1, 0]).data_rank
    try:
        make_mesh(MeshConfig(data_parallel=1))
        out["partial_mesh"] = None
    except ValueError as e:
        out["partial_mesh"] = str(e)
    make_mesh(MeshConfig())
    layer = AttnLayer(LAYER_SHAPE[2], num_heads=4)
    rng = np.random.RandomState(2)
    with torch.no_grad():               # seeded weights, the same on each rank
        for p in layer.parameters():
            p.copy_(torch.from_numpy(
                0.2 * rng.randn(*p.shape).astype(np.float32)))
    x = np.random.RandomState(1).randn(*LAYER_SHAPE).astype(np.float32)
    xl = _shard(x, rank, world)
    out["layer_state"] = {k: t.numpy() for k, t in
                          layer.state_dict().items()}
    for impl in ("ring:data", "ulysses:data"):
        layer.kernels = impl
        with torch.no_grad():
            out[f"layer_{impl}"] = layer(xl, xl).numpy()
    return out


# ---- training ---------------------------------------------------------

def tiny_config(**train_kw):
    """The tiny X-UNet of the parallel tests, dropout on (the draws'
    global-batch slicing reaches the model's masks too)."""
    from diff3d_tpu_torch.config import test_config

    cfg = test_config(imgsize=8, ch=8, shallow=True)
    train = dict(global_batch=8, max_steps=3, ckpt_every=2, log_every=1,
                 warmup_examples=64)
    train.update(train_kw)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.1),
        train=dataclasses.replace(cfg.train, **train))


def dataset():
    from diff3d_tpu_torch.data import SyntheticDataset

    return SyntheticDataset(num_objects=6, num_views=4, imgsize=8)


def loader(cfg, env, seed=None, start_step=0, sample_mode="iid"):
    from diff3d_tpu_torch.cli.train_cli import rank_loader

    return rank_loader(dataset(), cfg, env,
                       seed=cfg.train.seed if seed is None else seed,
                       start_step=start_step, sample_mode=sample_mode)


class _Batches:
    """numpy batches -> tensors (``prefetch_to_device`` without its
    thread); ``on_fetch(n)`` runs before the n-th batch (1-based)."""

    def __init__(self, it, on_fetch=None):
        self.it, self.on_fetch, self.n = it, on_fetch, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.on_fetch is not None:
            self.on_fetch(self.n)
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in next(self.it).items()}


def write_warm_start(workdir: str, seed: int = 0) -> None:
    """A mid-training state of :func:`tiny_config`'s model as a ``full``
    checkpoint of step 0 in ``<workdir>/checkpoints``: seeded parameters
    (the zero-initialised ones too), the EMA equal to them, and Adam
    moments of 100 updates.  From fresh moments Adam's first update is
    ``lr * sign(g)``, so gradients at the noise floor (behind the
    zero-initialised convolutions) would flip whole steps between two
    summation orders; from this state the update is smooth."""
    from diff3d_tpu_torch.train import Trainer

    tr = Trainer(tiny_config(), workdir=workdir, device="cpu")
    rng = np.random.RandomState(seed)
    opt = tr.state.optimizer
    with torch.no_grad():
        for name, p in tr.state.model.named_parameters():
            p.copy_(torch.from_numpy(
                0.1 * rng.randn(*p.shape).astype(np.float32)))
            tr.state.ema[name].copy_(p)
            opt.state[p] = {
                "step": torch.tensor(100.0),
                "exp_avg": torch.from_numpy(
                    1e-3 * rng.randn(*p.shape).astype(np.float32)),
                "exp_avg_sq": torch.from_numpy(
                    1e-4 * (1.0 + rng.rand(*p.shape)).astype(np.float32))}
    tr.ckpt.save(tr.state, force=True)


def state_arrays(state) -> dict:
    """Every tensor of a train state, whole (FSDP shards gathered: every
    rank must call this), as numpy: ``model.*``, ``ema.*``, ``adam.*``."""
    from diff3d_tpu_torch.train.checkpoint import _full, state_leaves

    return {n: _full(t).detach().cpu().numpy().copy()
            for n, t in state_leaves(state)}


def train(rank: int, world: int, workdir: str) -> dict:
    """The data-parallel trainer at ``world`` ranks: 3 replicated steps, 3
    ``fsdp`` steps, the stop agreement, the val loss of one global batch,
    ``Sampler(mesh)``, and ``train_cli.main`` under the group."""
    from diff3d_tpu_torch.cli import eval_cli, train_cli
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.train import Trainer

    out = {}
    for policy in ("replicated", "fsdp"):
        cfg = tiny_config()
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(
            param_sharding=policy))
        env = make_mesh(cfg.mesh)
        tr = Trainer(cfg, workdir=os.path.join(workdir, policy),
                     device="cpu", env=env, transfer=True)
        out[f"{policy}_start"] = tr.state.step
        tr.loader = _Batches(loader(cfg, env))
        tr.train()
        out[policy] = state_arrays(tr.state)
        out[f"{policy}_sharded"] = sum(
            hasattr(p, "full_tensor") for p in tr.state.model.parameters())
        out[f"{policy}_spec"] = env.param_spec_table(tr.state.model)
        val = _Batches(loader(cfg, env, seed=7, sample_mode="permute"))
        out[f"{policy}_val"] = float(tr._eval_step(tr.state, next(val),
                                                   tr.eval_draws(3)))
        out["topology"] = env.topology_summary()
        if policy == "fsdp":
            # The last checkpoint back into a sharded state (each rank
            # its chunks), gathered again.
            again = Trainer(cfg, workdir=os.path.join(workdir, policy),
                            device="cpu", env=env, transfer=True)
            out["fsdp_restored_step"] = again.state.step
            out["fsdp_restored"] = state_arrays(again.state)

    # The stop agreement: only rank 1 sees the signal, while it fetches
    # the batch of step 2; every rank must stop and save at step 2.
    cfg = tiny_config(max_steps=6, ckpt_every=100)
    env = make_mesh(cfg.mesh)
    tr = Trainer(cfg, workdir=os.path.join(workdir, "stop"), device="cpu",
                 env=env)

    def on_fetch(n):
        if rank == 1 and n == 2:
            tr._preempted.set()

    tr.loader = _Batches(loader(cfg, env), on_fetch)
    tr.train()
    out["stop"] = {"step": tr.state.step,
                   "observed": tr.preempt_observed_step,
                   "saved": tr.ckpt.steps()}

    out["distill"] = distill_run(env)

    # Sampler(mesh): 3 objects padded to 4 over the ranks.
    mcfg = tiny_config()
    torch.manual_seed(0)
    model = build_model(mcfg.model, "cpu")
    sampler = Sampler(model, mcfg, device="cpu", mesh=env,
                      cuda_graphs=False)
    views = sampler_views()
    out["lane_multiple"] = sampler.lane_multiple
    out["views"] = sampler.synthesize_many(
        views, [torch.Generator().manual_seed(10 + i) for i in range(3)],
        max_views=3)
    try:
        z = torch.zeros((3, 4, 8, 8, 8, 3))
        sampler.step_many(z, torch.zeros((3, 4, 3, 3)),
                          torch.zeros((3, 4, 3)), [1, 1, 1],
                          torch.zeros((3, 3, 3)), [None] * 3)
        out["step_many_3"] = None
    except ValueError as e:
        out["step_many_3"] = str(e)

    # The real entry points under this group: fsdp training, then
    # evaluation of its checkpoint with the objects split over the ranks.
    cli = os.path.join(workdir, "cli")
    train_cli.main(["--device", "cpu", "--config", "test", "--imgsize",
                    "8", "--synthetic", "--steps", "2", "--num_workers",
                    "0", "--param_sharding", "fsdp", "--workdir", cli])
    eval_cli.main(["--device", "cpu", "--config", "test", "--imgsize", "8",
                   "--model", os.path.join(cli, "checkpoints"),
                   "--synthetic_scenes", "--objects", "3", "--max_views",
                   "3", "--steps", "4", "--mesh", "--out",
                   os.path.join(cli, "eval.jsonl")])
    return out


def distill_run(env=None) -> dict:
    """One distill step (2 student steps) of the tiny model from a
    teacher with every leaf random, on this rank's rows of a global batch
    of 8: the loss and the gradients the update reads (after the
    all-reduce).  From fresh Adam moments the update is ``lr * sign(g)``,
    and this loss's gradients carry f32 cancellation noise of the size of
    the smallest ones (``x^`` is ``eps^`` scaled by ``1 / alpha_t``), so
    the step's inputs are compared, not the state it leaves."""
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.train import create_train_state
    from diff3d_tpu_torch.train.distill import make_distill_step, start_round

    cfg = tiny_config()
    env = env if env is not None else _one_process_env(cfg)
    teacher = build_model(cfg.model, "cpu", seed=3, randomize_zero_init=True)
    student = build_model(cfg.model, "cpu", seed=4)
    state = create_train_state(student, cfg.train)
    start_round(state, teacher)
    step = make_distill_step(cfg, env=env if env.group is not None
                             else None)
    m = step(state, teacher, next(_Batches(loader(cfg, env))), 2)
    return {"loss": float(m["distill_loss"]),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in student.named_parameters()}}


def _one_process_env(cfg):
    from diff3d_tpu_torch.parallel import make_mesh

    return make_mesh(cfg.mesh)


def sampler_views():
    """Three synthetic objects' views (numpy), the same in every rank."""
    from diff3d_tpu_torch.data import SyntheticDataset

    ds = SyntheticDataset(num_objects=3, num_views=3, imgsize=8)
    return [ds.all_views(i) for i in ds.ids]
