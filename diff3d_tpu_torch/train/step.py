"""The train step (counterpart: ``diff3d_tpu/train/step.py:31-112``).

``loss -> backward`` over ``accum_steps`` microbatches (gradients and
loss averaged), optional global-norm clipping, Adam, then the EMA
``e = d e + (1 - d) p`` of the updated parameters, in place on the
:class:`~diff3d_tpu_torch.train.state.TrainState`.  The step is two
bodies, the JAX package's one jitted program cut where the microbatch
loop ends:

  * **micro** — dequantize -> ``p_losses`` -> the gradients, added into
    the parameters' ``.grad`` buffers, and the loss into a running sum;
  * **update** — average -> global norm -> clip -> Adam -> EMA.

On a CUDA device (``cuda_graphs=True``) each body is captured once as a
CUDA graph (:class:`~diff3d_tpu_torch.graphs.StepGraph`) and replayed:
micro ``accum_steps`` times over static input buffers, then update.  The
first step of a state runs both bodies eagerly and captures them after
it; a step whose state no longer sits at the captured addresses (a
checkpoint restore replaces Adam's tensors) does the same again.
Elsewhere, or with ``cuda_graphs=False``, the bodies run eagerly.
With ``cfg.model.remat`` the micro body's backward recomputes every
block's forward (:mod:`diff3d_tpu_torch.models.xunet`); on the graph path
that recompute is part of the captured backward.

The step's random draws (diffusion times, noise, CFG mask, unconditional
frames, dropout) come from one generator seeded by ``(seed, step)``, so a
resumed run replays the same draws -- the property of the JAX package's
``jax.random.fold_in(rng, state.step)``.  On the graph path it is one
generator registered with the micro graph and reseeded before each step,
which gives the eager step's draws bit for bit.  Tests pass their own
draws instead (:class:`~diff3d_tpu_torch.diffusion.TrainDraws`); such a
step runs eagerly.

**Data parallelism** (``env``, a :class:`~diff3d_tpu_torch.parallel.
MeshEnv` with a process group): each rank runs its ``global_batch /
world`` rows.  The parameters' gradients and the loss sum live in one flat
bucket (each ``.grad`` a view of it; so too without a group), which is
all-reduced over the data group once per step, after the microbatch sums
and before the update, and divided by ``world``: the update then sees the
global-batch mean the JAX package's sharded step computes.  On the graph
path the all-reduce is captured inside the update graph (NCCL takes part
in CUDA graph capture; a failed capture raises).  Every rank draws the
*global* batch's draws from the one generator and keeps its own rows
(:class:`RankDraws`, and :class:`~diff3d_tpu_torch.models.layers.RowShard`
as the model's dropout source), so with ``accum_steps == 1`` ``n`` ranks
give the one-rank trajectory up to the order of the reduction, as
``jax.random`` gives the same draws under any sharding (with
``accum_steps > 1`` a rank's microbatch ``i`` keeps its rows of global
microbatch ``i``'s draws: the same law, another pairing of draws and
examples than one rank's).  Every rank draws the whole global batch's
uniforms at each dropout site and the whole global batch's noise, so its
RNG work and transient memory for them grow with the world size.  Under
``param_sharding="fsdp"`` the sharded parameters' gradients are FSDP2's
(reduce-scattered in each microbatch's backward), the replicated ones go
through the bucket, and the step runs **eagerly**: FSDP2 all-gathers on
side streams, which a CUDA graph cannot capture, so ``cuda_graphs=True``
raises there.

**Tensor parallelism** (``tp`` / ``fsdp+tp``, a model axis of more than
one rank): the ranks of one model group run the same data rows (the data
rank keys the draws and the rows, never the global rank), each on its
blocks of the split parameters; the gradients the backward leaves are
exact for every leaf (``parallel/tensor.py``), and the data-axis mean
comes on top, as above.  The global norm counts each split leaf's blocks
once per model group (their squares summed over the model axis) and each
whole leaf once.  The step runs eagerly (the model axis's collectives are
not captured; over gloo they wait for the host).

**Context parallelism** (``MeshConfig.context_parallel``, the
``replicated`` placement): the ranks of one model group run the same data
rows and draws, each on its image rows (``parallel/context.py``); every
parameter is whole on every rank, and each rank's gradient covers its
rows only.  So the bucket is all-reduced over every rank of the mesh (the
world) and divided by the data size, not the world: the sum over the
model axis makes each data rank's gradient whole, the division the mean
over the data axis.  Every model rank takes the same loss (the output is
gathered whole), so only model rank 0 puts its loss sum into the bucket.
The global norm is taken on the reduced, whole gradients.  The step runs
eagerly.  With ``tp`` / ``fsdp+tp`` a split leaf's gradient is this rank's
block, already summed over the model axis by the leaf's gather
(``parallel/tensor.py``): it sits in a second part of the bucket,
all-reduced over the data axis only and divided by the data size, and the
global norm sums its blocks' squares over the model axis.  With ``fsdp`` /
``fsdp+tp`` FSDP2 averages a sharded leaf's gradient over the data axis,
and the bucket's reduction then sums its local shard over the model axis
(not a split leaf's: its gather summed it); the norm counts each shard
once per model group.

``retry`` (a :class:`~diff3d_tpu_torch.runtime.retry.RetryPolicy`, the
``Trainer``'s ``_STEP_RETRY``) wraps the microbatch phase only: it zeroes
the gradient sums, reseeds the draws and refills the static inputs before
anything else, so running it again gives the same bits, while the update
writes the state in place and is never retried (the JAX package retries
its step at dispatch, before the donated buffers are consumed).
"""

from __future__ import annotations

import gc
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.data.images import dequantize
from diff3d_tpu_torch.diffusion import TrainDraws, p_losses
from diff3d_tpu_torch.graphs import StepGraph
from diff3d_tpu_torch.models.layers import RowShard
from diff3d_tpu_torch.train.state import (TrainState, ema_decay_per_step,
                                          warmup_schedule)

INPUTS = ("imgs", "R", "T", "K")


#: The eval stream's tag: the JAX package folds it into the step's key
#: (``fold_in(fold_in(rng, step), 0xE7A1)``) so that the val draws are
#: not the train step's.
EVAL_TAG = 0xE7A1


def step_seed(seed: int, step: int, *tags: int) -> int:
    """The 63-bit seed of step ``step``'s generator (with ``tags``: of
    another stream of that step, e.g. ``EVAL_TAG``)."""
    hi, lo = np.random.SeedSequence([seed, step, *tags]).generate_state(
        2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


class RankDraws:
    """Rank ``rank`` of ``world``'s rows of a :class:`TrainDraws`-like
    source's draws: each draw is taken at the global batch's size
    (``world`` times the rank's, rank-major) and this rank keeps its rows,
    so the generator advances as one process's would over the global
    batch."""

    def __init__(self, inner, rank: int, world: int):
        self.inner, self.rank, self.world = inner, rank, world
        self.generator = getattr(inner, "generator", None)

    def _rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        return t[self.rank * n:(self.rank + 1) * n]

    def t(self, n, device):
        return self._rows(self.inner.t(n * self.world, device), n)

    def cond_u(self, n, device):
        return self._rows(self.inner.cond_u(n * self.world, device), n)

    def noise(self, shape, device):
        n = shape[0]
        return self._rows(self.inner.noise(
            (n * self.world,) + tuple(shape[1:]), device), n)

    def x_noise(self, shape, device):
        n = shape[0]
        return self._rows(self.inner.x_noise(
            (n * self.world,) + tuple(shape[1:]), device), n)


class GradSync:
    """The gradient bucket: one flat f32 tensor holding the gradients of
    ``params`` (each ``.grad`` a view of it) and, last, the loss sum.
    With a data ``group``, :meth:`reduce` all-reduces it over the group and
    divides by the group's size: one collective per step; without one it
    does nothing.  ``divisor`` overrides that size (context parallelism:
    the group is the world, the divisor the data size); ``with_loss``
    False leaves this rank's loss sum out of the all-reduce (a rank whose
    model-axis peer adds the same loss).

    Context parallelism with a split placement adds two kinds of leaves:
    ``blocks`` (model-axis blocks, their gradients summed over the axis
    already) sit after the loss and are all-reduced over ``block_group``
    (the data axis) and divided by the same divisor; ``shards`` (FSDP2's
    sharded parameters, averaged over the data axis by FSDP2) have their
    local gradients summed over ``axis`` (the model axis's
    :class:`~diff3d_tpu_torch.parallel.tensor.ModelAxis`)."""

    #: Each gradient starts on a multiple of this many elements (256
    #: bytes), so the foreach kernels see aligned views.
    ALIGN = 64

    def __init__(self, params: Sequence[torch.Tensor], group=None,
                 divisor: Optional[int] = None, with_loss: bool = True, *,
                 blocks: Sequence[torch.Tensor] = (), block_group=None,
                 shards: Sequence[torch.Tensor] = (), axis=None):
        self.group = group
        self.world = (divisor if divisor is not None else
                      1 if group is None else dist.get_world_size(group))
        self.with_loss = with_loss
        self.block_group, self.shards, self.axis = (block_group,
                                                    list(shards), axis)

        def place(ts, n):
            offsets = []
            for p in ts:
                offsets.append(n)
                n += -(-p.numel() // self.ALIGN) * self.ALIGN
            return offsets, n

        offsets, n = place(params, 0)
        #: Where the blocks' part starts (after the loss).
        self.split_at = n + 1
        more, end = place(blocks, -(-(n + 1) // self.ALIGN) * self.ALIGN)
        if blocks:
            self.split_at = more[0]
        every = list(params) + list(blocks)
        device = every[0].device if every else torch.device("cpu")
        self.flat = torch.zeros((max(end, n + 1),), dtype=torch.float32,
                                device=device)
        self.params = every
        self.grads = [self.flat[off:off + p.numel()].view_as(p)
                      for p, off in zip(every, offsets + more)]
        self.total = self.flat[n]
        self.key = tuple(id(p) for p in every + self.shards)
        self.zero()

    def zero(self) -> None:
        """Zero the bucket and make it the parameters' ``.grad`` again
        (a caller may have set or dropped them)."""
        self.flat.zero_()
        for p, g in zip(self.params, self.grads):
            p.grad = g

    def reduce(self) -> None:
        """Sum over the ranks, then the mean (every rank's gradients are
        the mean over its rows: the mean of the means is the global
        batch's)."""
        if self.group is None:
            return
        if not self.with_loss:
            self.total.zero_()
        if self.split_at >= self.flat.numel():
            dist.all_reduce(self.flat, group=self.group)
        else:
            dist.all_reduce(self.flat[:self.split_at], group=self.group)
            dist.all_reduce(self.flat[self.split_at:],
                            group=self.block_group)
        self.flat.div_(float(self.world))
        for p in self.shards:
            if p.grad is not None:
                g = _local(p.grad)
                g.copy_(self.axis.all_reduce(g))


def make_bucket(names: Sequence[str], params: Sequence[torch.Tensor],
                group=None, rows=None, env=None,
                old: Optional[GradSync] = None) -> GradSync:
    """The gradient bucket of a step's parameters (FSDP2's sharded ones
    left out): over the data ``group``, or under context parallelism
    (``rows``: ``(group, divisor, with_loss)``) over the world with, where
    the model axis splits leaves (``env.model_axis``), their blocks over
    the data ``group`` and FSDP2's shards summed over the model axis
    (:class:`GradSync`).  ``old`` is returned where it holds the same
    parameters."""
    axis = None if rows is None else getattr(env, "model_axis", None)
    split = [axis is not None and env.is_split(n) for n in names]
    sharded = [_local(p) is not p for p in params]
    whole = [p for p, s, f in zip(params, split, sharded) if not (s or f)]
    blocks = [p for p, s, f in zip(params, split, sharded) if s and not f]
    shards = ([] if rows is None else
              [p for p, s, f in zip(params, split, sharded) if f and not s])
    if old is not None and old.key == tuple(
            id(p) for p in whole + blocks + shards):
        return old
    if rows is None:
        return GradSync(whole, group)
    return GradSync(whole, *rows, blocks=blocks, block_group=group,
                    shards=shards,
                    axis=env.context_axis.axis if shards else None)


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of an FSDP-sharded tensor (a DTensor), else ``t``."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def micro_step(cfg: Config, model: torch.nn.Module,
               params: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
               draws, grads: Sequence[torch.Tensor],
               total: torch.Tensor, *, shard=None,
               backward: bool = False) -> None:
    """One microbatch: the loss of ``batch`` (``imgs`` uint8, dequantized
    here), its gradients added into ``grads`` (one per parameter; a
    parameter the loss does not reach adds nothing) and the loss into
    ``total``.  ``shard``: ``(rank, world)`` of a data-parallel step (the
    draws are then :class:`RankDraws`, and dropout keeps this rank's rows
    of the global draw).  ``backward``: accumulate with ``loss.backward()``
    into the parameters' ``.grad`` instead (FSDP2 takes the sharded
    parameters' gradients from the backward).  Reads no host value."""
    dcfg = cfg.diffusion
    gen = getattr(draws, "generator", None)
    if shard and gen is not None:
        gen = RowShard(gen, *shard)

    def denoise(model_batch, cond_mask):
        return model(model_batch, cond_mask, generator=gen)

    loss = p_losses(denoise, dequantize(batch["imgs"]), batch["R"],
                    batch["T"], batch["K"], draws,
                    cond_prob=dcfg.cond_prob, loss_type=dcfg.loss_type,
                    logsnr_min=dcfg.logsnr_min, logsnr_max=dcfg.logsnr_max)
    if backward:
        loss.backward()
    else:
        got = torch.autograd.grad(loss, params, allow_unused=True)
        used = [(a, g) for a, g in zip(grads, got) if g is not None]
        torch._foreach_add_([a for a, _ in used], [g for _, g in used])
    total.add_(loss.detach())


def _global_norm(grads: Sequence[torch.Tensor], group, axis=None,
                 split: Sequence[bool] = ()) -> torch.Tensor:
    """The global 2-norm of ``grads``; with ``group`` (FSDP), sharded
    gradients contribute their local shards' squares, summed over the
    group; with ``axis`` (a model axis), the gradients ``split`` marks are
    blocks, their squares summed over the axis (the whole ones counted
    once)."""
    if group is None and axis is None:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads))))

    def squares(ts):
        if not ts:
            return torch.zeros((), device=grads[0].device)
        return torch.stack([n * n for n in torch._foreach_norm(ts)]).sum()

    if axis is None:
        sq = squares([_local(g) for g in grads if _local(g) is not g])
        dist.all_reduce(sq, group=group)
        return torch.sqrt(sq + squares([g for g in grads
                                        if _local(g) is g]))
    total = torch.zeros((), device=grads[0].device)
    for sharded in (True, False):
        for blocks in (True, False):
            ts = [_local(g) for g, s in zip(grads, split)
                  if (_local(g) is not g) == sharded and s == blocks]
            if not ts:
                continue
            sq = squares(ts)
            if sharded:
                dist.all_reduce(sq, group=group)
            if blocks:
                sq = axis.all_reduce(sq)
            total = total + sq
    return torch.sqrt(total)


def update_step(cfg: Config, state: TrainState, names: Sequence[str],
                params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], total: torch.Tensor,
                shard_group=None, axis=None, split: Sequence[bool] = ()):
    """Average the summed gradients and loss over the microbatches, take
    their global norm (before clipping), clip, step Adam (which reads the
    parameters' ``.grad``, i.e. ``grads``) and the EMA.  ``shard_group``:
    the data group of an FSDP state (its sharded gradients' norm sums
    over it); ``axis`` / ``split``: the model axis and which gradients are
    its blocks (:func:`_global_norm`).  Returns ``(loss, grad_norm)``;
    reads no host value."""
    tcfg = cfg.train
    accum = tcfg.accum_steps
    local = [_local(g) for g in grads]
    if accum > 1:
        torch._foreach_div_(local, float(accum))
        total = total / accum
    grad_norm = _global_norm(grads, shard_group, axis, split)
    if tcfg.grad_clip > 0:
        # optax.clip_by_global_norm: g * clip / norm when norm >= clip.
        torch._foreach_mul_(local, torch.where(
            grad_norm < tcfg.grad_clip, 1.0, tcfg.grad_clip / grad_norm))
    state.optimizer.step()
    decay = ema_decay_per_step(tcfg)
    with torch.no_grad():
        ema = [_local(state.ema[n]) for n in names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [_local(p.detach()) for p in params],
                            alpha=1.0 - decay)
    return total, grad_norm


class TrainStep:
    """``step(state, batch, draws=None) -> metrics`` (see the module
    docstring).

    ``batch``: ``imgs [B, 2, H, W, 3]`` (uint8), ``R [B, 2, 3, 3]``,
    ``T [B, 2, 3]``, ``K [B, 3, 3]`` on the model's device, ``B =
    global_batch`` (``global_batch / world`` with a data-parallel
    ``env``).  ``draws``: one :class:`TrainDraws`-like object per
    microbatch, or None for the step's own generator (under data
    parallelism they draw at the global batch's size, see
    :class:`RankDraws`).  Returns ``{'loss': tensor, 'lr': float,
    'grad_norm': tensor}`` -- the mean loss, the lr of this update (the
    schedule at the pre-update step) and the global norm of the averaged
    gradients (before clipping); the tensors stay on the device,
    unsynchronised, and are the step's own (on the graph path, copies of
    the graph's outputs).  ``graphs`` holds the captured micro and update
    graphs (None before the first graph step)."""

    def __init__(self, cfg: Config, cuda_graphs: bool = False,
                 retry=None, env=None):
        self.cfg = cfg
        self.retry = retry
        self.sched = warmup_schedule(cfg.train)
        self.group = None if env is None else env.group
        self.env = env
        self.fsdp = env is not None and env.cfg.param_sharding in (
            "fsdp", "fsdp+tp")
        self.axis = None if env is None else env.model_axis
        #: Context parallelism: the bucket's group (the world), divisor
        #: (the data size) and whether this rank's loss enters it.
        self.rows = None
        if env is not None and env.context_parallel:
            self.rows = (dist.group.WORLD, env.data_size,
                         env.model_rank == 0)
        if env is not None and env.eager_only and cuda_graphs:
            raise ValueError(
                f"param_sharding={env.cfg.param_sharding!r}"
                f"{' with context_parallel' if self.rows else ''} runs the "
                "train step eagerly: FSDP2 all-gathers on side streams and "
                "the model axis's collectives are not captured "
                "(cuda_graphs=True refused)")
        self.cuda_graphs = cuda_graphs
        world = 1 if self.group is None else dist.get_world_size(self.group)
        self.shard = (None if world == 1
                      else (dist.get_rank(self.group), world))
        self._gen: Optional[torch.Generator] = None
        self._captured = None
        self._sync: Optional[GradSync] = None

    def _accumulate(self, fn, step: int):
        """Run the microbatch phase ``fn`` under ``self.retry``."""
        if self.retry is None:
            return fn()
        return self.retry.call(fn, describe=f"train step {step + 1}")

    @property
    def graphs(self):
        c = self._captured
        return None if c is None else (c["micro"], c["update"])

    def release(self) -> None:
        """Drop the captured graphs (their memory pool goes with them)."""
        self._captured = None

    def _bucket(self, names, params) -> GradSync:
        """The gradient bucket of ``params`` (:func:`make_bucket`), made
        again when they change."""
        self._sync = make_bucket(names, params, self.group, self.rows,
                                 self.env, self._sync)
        return self._sync

    def _draws(self, d):
        return d if self.shard is None else RankDraws(d, *self.shard)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 draws: Optional[Sequence] = None) -> Dict[str, object]:
        accum = self.cfg.train.accum_steps
        B = batch["imgs"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not divisible by accum_steps "
                             f"{accum}")
        if draws is not None and len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")
        state.model.train()
        if draws is None and self.cuda_graphs:
            return self._graphed(state, batch)
        return self._eager(state, batch, draws)

    def _eager(self, state, batch, draws, gen=None):
        cfg, accum = self.cfg, self.cfg.train.accum_steps
        names, params = zip(*state.model.named_parameters())
        device = batch["imgs"].device
        if draws is None:
            gen = torch.Generator(device) if gen is None else gen
            draws = [TrainDraws(gen)] * accum
        draws = [self._draws(d) for d in draws]
        mb = batch["imgs"].shape[0] // accum
        sync = self._bucket(names, params)

        def accumulate():
            if gen is not None:
                gen.manual_seed(step_seed(cfg.train.seed, state.step))
            sync.zero()
            for p in params:
                if _local(p) is not p:
                    p.grad = None            # FSDP accumulates into it
            grads = [p.grad for p in params]
            for i, d in enumerate(draws):
                micro_step(cfg, state.model, params,
                           {k: batch[k][i * mb:(i + 1) * mb]
                            for k in INPUTS}, d, grads, sync.total,
                           shard=self.shard, backward=self.fsdp)
                if cfg.model.remat:
                    # torch.utils.checkpoint's frames leave reference
                    # cycles that hold the microbatch's activations until
                    # collected.
                    gc.collect()
            sync.reduce()
            for p in params:
                if p.grad is None:           # a sharded leaf the loss misses
                    p.grad = torch.zeros_like(p)
            return [p.grad for p in params], sync.total

        grads, total = self._accumulate(accumulate, state.step)
        lr = self.sched(state.step)
        split = ([self.env.is_split(n) for n in names]
                 if self.axis is not None else ())
        loss, grad_norm = update_step(
            cfg, state, names, params, grads, total,
            shard_group=self.group if self.fsdp else None, axis=self.axis,
            split=split)
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.clone(), "lr": lr, "grad_norm": grad_norm}

    @staticmethod
    def _key(state, batch, params) -> tuple:
        """What a capture depends on: the batch's shapes and the addresses
        of every tensor the graphs read or write."""
        opt = state.optimizer
        ptrs = [id(state)]
        for p in params:
            ptrs += [p.data_ptr(), -1 if p.grad is None else
                     p.grad.data_ptr()]
            ptrs += [t.data_ptr() for t in opt.state.get(p, {}).values()
                     if torch.is_tensor(t)]
        ptrs += [g["lr"].data_ptr() if torch.is_tensor(g["lr"]) else -1
                 for g in opt.param_groups]
        ptrs += [t.data_ptr() for t in state.ema.values()]
        shapes = [(k, tuple(batch[k].shape), batch[k].dtype)
                  for k in INPUTS]
        return tuple(shapes), tuple(ptrs)

    def _graphed(self, state, batch):
        cfg, accum = self.cfg, self.cfg.train.accum_steps
        names, params = zip(*state.model.named_parameters())
        c = self._captured
        if c is None or c["key"] != self._key(state, batch, params):
            # This step runs eagerly (the warm-up: kernel attributes,
            # library plans, Adam's state, the process group's
            # communicator), then both bodies are captured.
            self.release()
            if self._gen is None:
                self._gen = torch.Generator(batch["imgs"].device)
            metrics = self._eager(state, batch, None, gen=self._gen)
            self._capture(state, batch, names, params)
            return metrics
        mb = batch["imgs"].shape[0] // accum

        def accumulate():
            self._gen.manual_seed(step_seed(cfg.train.seed, state.step))
            torch._foreach_zero_(c["grads"])
            c["total"].zero_()
            for i in range(accum):
                for k, buf in c["inputs"].items():
                    buf.copy_(batch[k][i * mb:(i + 1) * mb])
                c["micro"].replay()

        self._accumulate(accumulate, state.step)
        lr = self.sched(state.step)
        c["update"].replay()
        state.scheduler.step()
        state.step += 1
        loss, grad_norm = c["update"].output
        return {"loss": loss.clone(), "lr": lr,
                "grad_norm": grad_norm.clone()}

    def _capture(self, state, batch, names, params) -> None:
        cfg, accum = self.cfg, self.cfg.train.accum_steps
        mb = batch["imgs"].shape[0] // accum
        inputs = {k: batch[k][:mb].clone() for k in INPUTS}
        grads = [p.grad for p in params]
        sync = self._bucket(names, params)
        total = sync.total
        draws = self._draws(TrainDraws(self._gen))
        model = state.model
        shard = self.shard

        def update():
            sync.reduce()                # captured: NCCL in the graph
            return update_step(cfg, state, names, params, grads, total)

        micro = StepGraph(
            lambda: micro_step(cfg, model, params, inputs, draws, grads,
                               total, shard=shard),
            generators=[self._gen])
        update = StepGraph(update, pool=micro.pool())
        self._captured = {"key": self._key(state, batch, params),
                          "micro": micro, "update": update,
                          "inputs": inputs, "grads": grads, "total": total}


def make_train_step(cfg: Config, cuda_graphs: bool = False,
                    retry=None, env=None) -> TrainStep:
    """The train step of ``cfg`` (:class:`TrainStep`); ``cuda_graphs``
    captures it as CUDA graphs (a CUDA device only); ``retry`` retries
    its microbatch phase; ``env`` (a ``MeshEnv``) makes it data-parallel
    over the mesh's data axis (and tensor-parallel over its model axis
    under ``tp`` / ``fsdp+tp``)."""
    return TrainStep(cfg, cuda_graphs=cuda_graphs, retry=retry, env=env)
