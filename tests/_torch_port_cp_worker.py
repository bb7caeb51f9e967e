"""Rank bodies of the context-parallel CPU tests (``test_torch_port_cp.py``),
run on spawned gloo ranks by
:func:`diff3d_tpu_torch.testing.distributed.spawn`.  Imports torch and the
port only (no JAX: every rank is a fresh interpreter).

Every input and weight is made from a numpy seed, so the parent test
rebuilds the same whole tensors and holds each rank's results against the
unsplit layer.  A rank's outputs are its rows, gathered whole over the
model axis (``RowAxis.gather_rows``, whose backward takes the rank's rows
of the whole gradient); its parameters' and inputs' gradients cover its
rows only, and the parent sums them over the ranks.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

import _torch_port_parallel_worker as dp_worker
from _torch_port_tp_worker import array, forward, model_config, seed_params

#: ``(N, H, W)`` of the layer tests' activations (N = 2 examples x 2
#: frames); 8 rows split over 2 or 4 ranks.
ACT = (4, 8, 4)
EMB = 16
#: The split GroupNorm's cases: ``(silu, film)``.
GN_VARIANTS = {"gn": (False, False), "gn_silu": (True, False),
               "gn_film": (False, True), "gn_film_silu": (True, True)}


def layer_cases():
    """``{name: (make_layer, make_inputs)}``; ``make_inputs()`` returns
    whole input tensors, the activations ``[N, H, W, C]`` first."""
    from diff3d_tpu_torch.models.layers import AttnBlock, Conv, ResnetBlock

    N, H, W = ACT
    cases = {
        "conv3": (lambda: seed_params(Conv(6, 5, 3), 1),
                  lambda: [array((N, H, W, 6), 2)]),
        # The level convs: explicit padding 1 at stride 2^i.
        "level_conv_s2": (
            lambda: seed_params(Conv(6, 5, 3, stride=2, padding=1), 3),
            lambda: [array((N, H, W, 6), 4)]),
        "level_conv_s4": (
            lambda: seed_params(Conv(6, 5, 3, stride=4, padding=1), 5),
            lambda: [array((N, H, W, 6), 6)]),
        "attn_self": (
            lambda: seed_params(AttnBlock("self", 8, num_heads=2), 7),
            lambda: [array((N, H, W, 8), 8)]),
        "attn_cross": (
            lambda: seed_params(AttnBlock("cross", 8, num_heads=2), 9),
            lambda: [array((N, H, W, 8), 10)]),
        # FiLM, the skip projection and a downsample.
        "resnet_down": (
            lambda: seed_params(ResnetBlock(8, 6, EMB, resample="down"), 11),
            lambda: [array((N, H, W, 8), 12), array((N, H, W, EMB), 13)]),
    }
    for name, (silu, film) in GN_VARIANTS.items():
        cases[name] = (_norm_maker(silu), _norm_inputs(film))
    return cases


def _norm_maker(silu):
    def make():
        from diff3d_tpu_torch.models.layers import FrameGroupNorm

        return seed_params(FrameGroupNorm(8, silu=silu, num_groups=4), 14)
    return make


def _norm_inputs(film):
    N, H, W = ACT

    def make():
        xs = [array((N, H, W, 8), 15).add_(0.5)]
        if film:
            xs += [array((N, H * W, 8), 16).mul_(0.3),
                   array((N, H * W, 8), 17).mul_(0.3)]
        return xs
    return make


def _rank_rows(name, xs, rows):
    """This rank's rows of each whole input (a level conv's with its row
    above; the FiLM tensors ``[N, H*W, C]`` by their rows of tokens)."""
    H, W = xs[0].shape[1:3]
    r0, r1 = rows.rows(H)
    if name.startswith("level_conv"):
        from diff3d_tpu_torch.parallel.context import with_halo

        return [with_halo(xs[0], r0, r1, above=1, below=0)]
    return [x[:, r0:r1] if x.dim() == 4 else x[:, r0 * W:r1 * W]
            for x in xs]


def run_layer(name, layer, inputs, rows=None, generator_seed=11):
    """The output (whole) of one layer and the gradients of ``sum(out *
    w)``: every parameter's and every input's (on a rank: its rows'
    share).  ``rows`` None runs it unsplit."""
    from diff3d_tpu_torch.parallel.context import place_rows

    if rows is not None:
        place_rows(layer, rows)
    xs = [x.clone().requires_grad_() for x in inputs]
    ins = xs if rows is None else _rank_rows(name, xs, rows)
    if name.startswith("attn"):
        out = layer(ins[0], 2)
    elif name.startswith("resnet"):
        layer.train()
        out = layer(ins[0], ins[1], torch.Generator().manual_seed(
            generator_seed))
    elif name.startswith("level_conv"):
        out = layer(ins[0], rows_padded=rows is not None)
    else:
        out = layer(*ins)
    if rows is not None:
        out = rows.gather_rows(out)
    (out * array(out.shape, 99)).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": {n: p.grad.numpy() for n, p in layer.named_parameters()},
            "input_grads": [x.grad.numpy() for x in xs]}


def unsplit_layers() -> dict:
    """The layer cases in one process (the reference)."""
    return {name: run_layer(name, make(), ins())
            for name, (make, ins) in layer_cases().items()}


def gn_stats(rows=None) -> dict:
    """Each GroupNorm variant's ``[2, N, G]`` statistics on this rank's
    rows (the split forward: (a), the sum over the ranks, (b)), or on the
    whole rows in one process."""
    from diff3d_tpu_torch.ops import cuda_film

    out = {}
    for name, (silu, film) in GN_VARIANTS.items():
        norm = _norm_maker(silu)()
        xs = _norm_inputs(film)()
        if rows is not None:
            xs = _rank_rows(name, xs, rows)
        N, H, W, C = xs[0].shape
        x = xs[0].reshape(N, H * W, C)
        scale, shift = (xs[1], xs[2]) if film else (None, None)
        with torch.no_grad():
            if rows is None:
                stats = cuda_film.groupnorm_stats_reference(x, 4)
            else:
                _, stats = cuda_film._split_forward(
                    x, norm.weight, norm.bias, scale, shift, 4, silu, rows)
        out[name] = stats.numpy()
    return out


def block_rows(env, flat, batch, mask) -> dict:
    """``{block: rows of its output}`` over this rank's forward."""
    from diff3d_tpu_torch.convert import load_flax_params
    from diff3d_tpu_torch.models import build_model

    model = build_model(model_config().model, "cpu")
    load_flax_params(model, flat)
    env.params(model)
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            seen[name] = (int(out.shape[1]), int(args[0].shape[1]))
        return fn

    for name, child in model.named_children():
        if name.startswith(("down_", "up_", "middle", "stem_conv",
                            "last_")):
            child.register_forward_hook(hook(name))
    n = mask.shape[0] // env.data_size
    with torch.no_grad():
        model({k: torch.from_numpy(v[:n]) for k, v in batch.items()},
              torch.from_numpy(mask[:n]))
    return seen


def _cp(mp, dp=None):
    from diff3d_tpu_torch.config import MeshConfig

    kw = {} if dp is None else {"data_parallel": dp}
    return MeshConfig(model_parallel=mp, context_parallel=True, **kw)


def _train(env, workdir, steps=None, **model_kw):
    """The Trainer at ``env`` from the warm start in ``workdir``: its
    state (whole), losses, graphs flag and checkpoint steps."""
    from diff3d_tpu_torch.train import Trainer

    cfg = dp_worker.tiny_config(**({} if steps is None
                                   else {"max_steps": steps}))
    cfg = dataclasses.replace(
        cfg, mesh=env.cfg,
        model=dataclasses.replace(cfg.model, **model_kw))
    tr = Trainer(cfg, workdir=workdir, device="cpu", env=env, transfer=True)
    start = tr.state.step
    tr.loader = dp_worker._Batches(dp_worker.loader(cfg, env))
    tr.train()
    return {"start": start, "state": dp_worker.state_arrays(tr.state),
            "losses": _losses(workdir), "graphs": tr.step_fn.cuda_graphs,
            "ckpt_steps": tr.ckpt.steps(),
            "bucket": (tr.step_fn._sync.world, tr.step_fn._sync.with_loss)}


def _losses(workdir):
    import json

    path = os.path.join(workdir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [json.loads(x)["loss"] for x in f if '"loss"' in x]


def group_of_two(rank: int, world: int, workdir: str, flat, batch,
                 mask) -> dict:
    """Everything at ``mp == 2`` (dp 1): the layer cases, the statistics,
    the rows of every block, the whole forward, 3 train steps from the
    warm start (and 2 under each remat policy), the checkpoints both ways,
    ``Sampler(mesh)``'s single-object view and ``train_cli``."""
    from diff3d_tpu_torch.cli import train_cli
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.train import Trainer

    env = make_mesh(_cp(2))
    rows = env.context_axis
    out = {"model_rank": env.model_rank, "topology": env.topology_summary(),
           "eager_only": env.eager_only,
           "tensor_parallel": env.tensor_parallel}
    out["layers"] = {name: run_layer(name, make(), ins(), rows)
                     for name, (make, ins) in layer_cases().items()}
    out["stats"] = gn_stats(rows)
    out["block_rows"] = block_rows(env, flat, batch, mask)
    out["forward"] = forward(env, flat, batch, mask)

    # Training from the warm start (a world-1 checkpoint of step 0).
    tr = Trainer(dataclasses.replace(dp_worker.tiny_config(), mesh=env.cfg),
                 workdir=os.path.join(workdir, "train"), device="cpu",
                 env=env, transfer=True)
    out["restored_step"] = tr.state.step
    out["restored"] = dp_worker.state_arrays(tr.state)
    del tr
    out["train"] = _train(env, os.path.join(workdir, "train"))
    for policy in ("nothing", "dots"):
        out[f"remat_{policy}"] = _train(
            env, os.path.join(workdir, f"remat_{policy}"), steps=2,
            remat=True, remat_policy=policy)
    again = Trainer(dataclasses.replace(dp_worker.tiny_config(),
                                        mesh=env.cfg),
                    workdir=os.path.join(workdir, "train"), device="cpu",
                    env=env, transfer=True)
    out["again_step"] = again.state.step
    out["again"] = dp_worker.state_arrays(again.state)
    out["again_lr"] = float(again.state.optimizer.param_groups[0]["lr"])

    # Sampler(mesh): one object through the single-object path, split by
    # rows; the same generator seed on both ranks.
    cfg = dp_worker.tiny_config()
    torch.manual_seed(0)
    sampler = Sampler(build_model(cfg.model, "cpu"), cfg, device="cpu",
                      mesh=env)
    out["sampler_graphs"] = sampler.cuda_graphs
    calls = {"n": 0}
    gather = rows.gather_rows

    def counted(x):
        calls["n"] += 1
        return gather(x)

    rows.gather_rows = counted
    out["views"] = sampler.synthesize(dp_worker.sampler_views()[0],
                                      torch.Generator().manual_seed(10),
                                      max_views=3)
    out["split_calls"] = calls["n"]
    rows.gather_rows = gather

    cli = os.path.join(workdir, "cli")
    # The deep test config at 16 x 16 (at 8 x 8 a rank's rows are odd at
    # its third level).
    train_cli.main(["--device", "cpu", "--config", "test", "--imgsize",
                    "16", "--synthetic", "--steps", "2", "--num_workers",
                    "0", "--context_parallel", "--model_parallel", "2",
                    "--workdir", cli])
    return out


def group_of_four(rank: int, world: int, workdir: str, flat, batch,
                  mask) -> dict:
    """At 4 ranks: the statistics, the attention cases and the whole
    forward at ``mp == 4``; then at dp2 x mp2 the attention cases (the
    model-rank token order), the whole forward and 3 train steps from the
    warm start."""
    from diff3d_tpu_torch.parallel import make_mesh

    out = {}
    env = make_mesh(_cp(4))
    rows = env.context_axis
    out["stats_mp4"] = gn_stats(rows)
    cases = layer_cases()
    out["layers_mp4"] = {name: run_layer(name, make(), ins(), rows)
                         for name, (make, ins) in cases.items()
                         if name.startswith(("attn", "gn", "conv3"))}
    out["forward_mp4"] = forward(env, flat, batch, mask)

    env = make_mesh(_cp(2, dp=2))
    rows = env.context_axis
    out["ranks"] = (env.data_rank, env.model_rank)
    out["model_ranks"] = rows.axis.ranks
    out["layers_dp2"] = {name: run_layer(name, make(), ins(), rows)
                         for name, (make, ins) in cases.items()
                         if name.startswith("attn")}
    out["forward_dp2"] = forward(env, flat, batch, mask)
    out["train_dp2"] = _train(env, workdir)
    return out
