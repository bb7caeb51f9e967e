"""Rank bodies of the tensor-parallel CPU tests (``test_torch_port_tp.py``),
run on spawned gloo ranks by
:func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports torch and the
port only (no JAX: every rank is a fresh interpreter).

Every input and weight is made from a numpy seed, so the parent test
rebuilds the same whole tensors and holds each rank's results against the
unsharded layer.  Results come back whole: split gradients are gathered
over the model axis (``MeshEnv.full_of``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import _torch_port_parallel_worker as dp_worker

#: ``(N, H, W)`` of the layer tests' activations (N = 2 examples x 2
#: frames).
ACT = (4, 4, 4)
EMB = 16


def seed_params(module: torch.nn.Module, seed: int,
                scale: float = 0.3) -> torch.nn.Module:
    """Every parameter of ``module`` from a seeded normal (the
    zero-initialised ones too), the same in every process."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            p.copy_(torch.from_numpy(
                (scale * rng.randn(*p.shape)).astype(np.float32)))
    return module


def array(shape, seed: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def layer_cases():
    """``{name: (make_layer, make_inputs, channels out)}`` of the layer
    tests; ``make_inputs()`` returns whole input tensors (leaves)."""
    from diff3d_tpu_torch.models.layers import AttnBlock, ResnetBlock

    N, H, W = ACT

    def resnet(cin, f, dropout):
        return lambda: seed_params(ResnetBlock(cin, f, EMB, dropout=dropout),
                                   seed=cin + f)

    return {
        # FiLM, dropout and the skip projection (16 -> 8 channels).
        "resnet_film_dropout": (
            resnet(16, 8, 0.3),
            lambda: [array((N, H, W, 16), 1), array((N, H, W, EMB), 2)], 8),
        # Whole heads on each rank (4 heads over 2 or 4 ranks).
        "attn_self_heads_split": (
            lambda: seed_params(AttnBlock("self", 16, num_heads=4), 3),
            lambda: [array((N, H, W, 16), 4)], 16),
        # 3 heads do not split over 2 ranks: q/k/v gathered to whole heads.
        "attn_cross_heads_whole": (
            lambda: seed_params(AttnBlock("cross", 12, num_heads=3), 5),
            lambda: [array((N, H, W, 12), 6)], 12),
        # 3 groups do not split over 2 ranks: the statistics of the
        # gathered activation.
        "groupnorm_gathered": (
            lambda: seed_params(_Norm(), 7),
            lambda: [array((N, H, W, 12), 8)], 12),
    }


class _Norm(torch.nn.Module):
    """A GroupNorm of 12 channels in 3 groups, under its X-UNet name."""

    def __init__(self):
        super().__init__()
        from diff3d_tpu_torch.models.layers import FrameGroupNorm

        self.FrameGroupNorm_0 = FrameGroupNorm(12, num_groups=3)

    def forward(self, h):
        return self.FrameGroupNorm_0(h)


def _run_layer(name, layer, inputs, channels, env, generator_seed):
    """Output (whole) and the gradients of ``sum(out * w)`` (whole) of one
    layer; ``env`` None runs it unsharded."""
    xs = [x.clone().requires_grad_() for x in inputs]
    gen = torch.Generator().manual_seed(generator_seed)
    if name.startswith("resnet"):
        layer.train()
        out = layer(xs[0], xs[1], gen)
    elif name.startswith("attn"):
        out = layer(xs[0], 2)
    else:
        out = layer(xs[0])
    if env is not None:
        out = env.model_axis.whole(out, channels)
    w = array(out.shape, 99)
    (out * w).sum().backward()
    grads = {n: (p.grad if env is None else env.full_of(n, p.grad))
             for n, p in layer.named_parameters()}
    return {"out": out.detach().numpy(),
            "grads": {n: g.numpy() for n, g in grads.items()},
            "input_grads": [x.grad.numpy() for x in xs]}


def unsharded_layers() -> dict:
    """The layer cases on one process (the reference)."""
    return {name: _run_layer(name, make(), ins(), c, None, 11)
            for name, (make, ins, c) in layer_cases().items()}


def concat_case(env=None) -> dict:
    """The up path's concatenation: two blocks (8 and 8 channels) joined
    ``[h, skip]`` (``models/xunet.py::concat_channels``) into a
    ResnetBlock 16 -> 8 with its skip projection.  Whole inputs, whole
    output; the gradients of the inputs and of every parameter."""
    from diff3d_tpu_torch.models.layers import ResnetBlock
    from diff3d_tpu_torch.models.xunet import concat_channels

    N, H, W = ACT
    block = seed_params(ResnetBlock(16, 8, EMB), seed=21)
    h, skip = (array((N, H, W, 8), s).requires_grad_() for s in (22, 23))
    emb = array((N, H, W, EMB), 24)
    axis = None
    if env is not None:
        env.place_model_axis(block)
        axis = env.model_axis
    hh, ss = (h, skip) if axis is None else (axis.to_block(h, 8),
                                            axis.to_block(skip, 8))
    out = block(concat_channels(axis, hh, ss, 8, 8), emb)
    if axis is not None:
        out = axis.whole(out, 8)
    (out * array(out.shape, 25)).sum().backward()
    grads = {n: (p.grad if env is None else env.full_of(n, p.grad))
             for n, p in block.named_parameters()}
    return {"out": out.detach().numpy(), "dh": h.grad.numpy(),
            "dskip": skip.grad.numpy(),
            "grads": {n: g.numpy() for n, g in grads.items()}}


def film_case(env=None) -> dict:
    """A FiLM layer 16 -> 8 features: each rank's ``(scale, shift)``."""
    from diff3d_tpu_torch.models.layers import FiLM

    film = seed_params(FiLM(EMB, 8), seed=31)
    if env is not None:
        env.place_model_axis(film)
    emb = array(ACT + (EMB,), 32)
    with torch.no_grad():
        scale, shift = film(emb)
    return {"scale": scale.numpy(), "shift": shift.numpy(),
            "halves": film.halves}


# ---- the whole model ---------------------------------------------------

def model_config():
    """The shallow tiny X-UNet of the whole-model tests, float32."""
    from diff3d_tpu_torch.config import test_config

    return test_config(imgsize=8, ch=8, shallow=True)


def forward(env, flat, batch, mask) -> np.ndarray:
    """The X-UNet forward of this rank's data rows of ``batch`` under
    ``env``, with the Flax weights ``flat`` carried in whole and then
    placed."""
    from diff3d_tpu_torch.convert import load_flax_params
    from diff3d_tpu_torch.models import build_model

    model = build_model(model_config().model, "cpu")
    load_flax_params(model, flat)
    env.params(model)
    n = mask.shape[0] // env.data_size
    rows = slice(env.data_rank * n, (env.data_rank + 1) * n)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v[rows]) for k, v in
                     batch.items()}, torch.from_numpy(mask[rows]))
    return out.numpy()


def tp_state_arrays(trainer) -> dict:
    """Every tensor of a trainer's state, whole (a collective), as
    numpy: ``model.*``, ``ema.*``, ``adam.*``."""
    from diff3d_tpu_torch.train.checkpoint import state_leaves

    env = trainer.env
    out = {}
    for n, t in state_leaves(trainer.state):
        name = n.split(".", 1)[1]
        if n.startswith("adam."):
            name = name.rsplit(".", 1)[0]
        out[n] = env.full_of(name, t).detach().cpu().numpy().copy()
    return out


def group_of_two(rank: int, world: int, workdir: str, flat, batch,
                 mask) -> dict:
    """Everything at ``mp == 2`` (dp 1): the layer cases, the
    concatenation, FiLM's halves, the spec table, the whole forward, 3
    train steps from the warm start, the checkpoint, ``Sampler(mesh)``,
    ``eval_cli --mesh`` and ``train_cli``."""
    from diff3d_tpu_torch.cli import eval_cli, train_cli
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.train import Trainer

    tp = MeshConfig(model_parallel=2, param_sharding="tp")
    env = make_mesh(tp)
    out = {"model_rank": env.model_rank, "data_rank": env.data_rank,
           "topology": env.topology_summary()}
    out["layers"] = {}
    for name, (make, ins, c) in layer_cases().items():
        layer = make()
        env.place_model_axis(layer)
        out["layers"][name] = _run_layer(name, layer, ins(), c, env, 11)
    out["concat"] = concat_case(env)
    out["film"] = film_case(env)

    model = build_model(model_config().model, "cpu")
    env.params(model)
    out["spec"] = env.param_spec_table(model)

    # The converter: the whole Flax tree carried, then placed; and a
    # whole JAX train state carried into a split Trainer's state.
    from diff3d_tpu_torch.convert import (load_flax_params,
                                          load_flax_train_state)

    carried = build_model(model_config().model, "cpu")
    load_flax_params(carried, flat, placement=env)
    out["carried"] = {n: p.detach().numpy().copy()
                      for n, p in carried.named_parameters()}
    out["halved"] = sorted(env._halved)
    cfg = dataclasses.replace(dp_worker.tiny_config(), mesh=tp)
    tr = Trainer(cfg, workdir=os.path.join(workdir, "carry"), device="cpu",
                 env=env)
    scaled = {k: {n: f * v for n, v in flat.items()}
              for k, f in (("ema", 0.5), ("mu", 1e-3), ("nu", 1e-4))}
    load_flax_train_state(tr.state, params=flat, ema_params=scaled["ema"],
                          mu=scaled["mu"], nu=scaled["nu"], adam_count=5,
                          schedule_count=5, step=5, placement=env)
    out["carried_state"] = tp_state_arrays(tr)
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in model.named_parameters()}
    out["forward"] = forward(env, flat, batch, mask)

    # Training from the warm start (a world-1 checkpoint of step 0).
    cfg = dataclasses.replace(dp_worker.tiny_config(), mesh=tp)
    tr = Trainer(cfg, workdir=os.path.join(workdir, "train"), device="cpu",
                 env=env, transfer=True)
    out["restored_step"] = tr.state.step
    out["restored"] = tp_state_arrays(tr)
    out["graphs"] = tr.step_fn.cuda_graphs
    tr.loader = dp_worker._Batches(dp_worker.loader(cfg, env))
    tr.train()
    out["trained"] = tp_state_arrays(tr)
    out["losses"] = _losses(os.path.join(workdir, "train"))
    out["ckpt_steps"] = tr.ckpt.steps()
    again = Trainer(cfg, workdir=os.path.join(workdir, "train"),
                    device="cpu", env=env, transfer=True)
    out["again_step"] = again.state.step
    out["again"] = tp_state_arrays(again)
    out["again_lr"] = float(again.state.optimizer.param_groups[0]["lr"])

    # The stop agreement spans the model axis: only rank 1 sees the
    # signal, while it fetches the batch of step 2.
    stop_cfg = dataclasses.replace(
        dp_worker.tiny_config(max_steps=6, ckpt_every=100), mesh=tp)
    stop = Trainer(stop_cfg, workdir=os.path.join(workdir, "stop"),
                   device="cpu", env=env)

    def on_fetch(n):
        if rank == 1 and n == 2:
            stop._preempted.set()

    stop.loader = dp_worker._Batches(dp_worker.loader(stop_cfg, env),
                                     on_fetch)
    stop.train()
    out["stop"] = {"step": stop.state.step, "saved": stop.ckpt.steps()}

    # Sampler(mesh): both ranks run the same 3 objects.
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      mesh=env)
    out["sampler_graphs"] = sampler.cuda_graphs
    out["lane_multiple"] = sampler.lane_multiple
    out["views"] = sampler.synthesize_many(
        dp_worker.sampler_views(),
        [torch.Generator().manual_seed(10 + i) for i in range(3)],
        max_views=3)

    # The entry points under this group.
    cli = os.path.join(workdir, "cli")
    train_cli.main(["--device", "cpu", "--config", "test", "--imgsize",
                    "8", "--synthetic", "--steps", "2", "--num_workers",
                    "0", "--param_sharding", "tp", "--model_parallel", "2",
                    "--workdir", cli])
    eval_cli.main(["--device", "cpu", "--config", "test", "--imgsize", "8",
                   "--model", os.path.join(cli, "checkpoints"),
                   "--synthetic_scenes", "--objects", "3", "--max_views",
                   "3", "--steps", "4", "--mesh", "--model_parallel", "2",
                   "--param_sharding", "tp", "--out",
                   os.path.join(cli, "eval.jsonl")])
    return out


def _losses(workdir: str):
    import json

    path = os.path.join(workdir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [json.loads(x)["loss"] for x in f if '"loss"' in x]


def group_of_four(rank: int, world: int, workdir: str, flat, batch,
                  mask) -> dict:
    """At 4 ranks: FiLM's halves and the spec table at ``mp == 4``, then
    the whole forward, the spec table and 3 train steps from the warm
    start under ``fsdp+tp`` at dp2 x mp2."""
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.train import Trainer

    out = {}
    env = make_mesh(MeshConfig(model_parallel=4, param_sharding="tp"))
    out["film"] = film_case(env)
    model = build_model(model_config().model, "cpu")
    env.params(model)
    out["spec_tp4"] = env.param_spec_table(model)
    out["forward_tp4"] = forward(env, flat, batch, mask)

    env = make_mesh(MeshConfig(data_parallel=2, model_parallel=2,
                               param_sharding="fsdp+tp"))
    out["ranks"] = (env.data_rank, env.model_rank)
    model = build_model(model_config().model, "cpu")
    env.params(model)
    out["spec_fsdp_tp"] = env.param_spec_table(model)
    out["dtensors"] = sum(hasattr(p, "full_tensor")
                          for p in model.parameters())
    out["forward_fsdp_tp"] = forward(env, flat, batch, mask)

    # Training: each data rank its rows and its draws' rows, both model
    # ranks of a data rank alike.
    cfg = dataclasses.replace(dp_worker.tiny_config(), mesh=env.cfg)
    tr = Trainer(cfg, workdir=workdir, device="cpu", env=env, transfer=True)
    out["fsdp_tp_restored_step"] = tr.state.step
    out["step_group_size"] = tr.step_fn.shard
    tr.loader = dp_worker._Batches(dp_worker.loader(cfg, env))
    tr.train()
    out["fsdp_tp_trained"] = tp_state_arrays(tr)
    out["fsdp_tp_losses"] = _losses(workdir)
    return out
