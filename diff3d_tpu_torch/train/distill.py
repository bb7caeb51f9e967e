"""Progressive distillation of the few-step DDIM sampler (counterpart:
``diff3d_tpu/train/distill.py``).

Salimans & Ho (2022) on the pose-conditional X-UNet: a student with a
``k``-step deterministic schedule is trained so that ONE student DDIM
step matches TWO consecutive teacher DDIM steps (each of size
``1/(2k)``) from the same ``z_t``.  Halving rounds ``256 -> 128 -> ... ->
16`` compound into a 16x cheaper sampler whose steps stay on the dense
grid, so a distilled checkpoint drops into ``Sampler(sampler_kind="ddim",
steps=k)``.

The loss is conditional only (``cond_mask`` all true, guidance ``w =
0``: the teacher's CFG combine takes its ``eps`` twice), both networks
run deterministic (no dropout: the student runs in ``eval()`` mode with
autograd recording), and it is the truncated-SNR x-space loss
``mean(max(exp(logsnr_t), 1) * ||x~ - x^||^2)``.  ``x^`` and the loss are
float32, the model's output dtype: at ``i = k`` alpha_t is ~4.5e-5, so
``x^`` amplifies ``eps^``'s error ~2e4 times.

On the card one CUDA graph serves every round (the JAX package compiles
one step for all rounds, ``student_steps`` traced): ``k`` is a device
scalar filled before each replay, the teacher is a second ``XUNet``
whose parameters are refilled with ``copy_`` at each round, and a new
round resets the student's state in place (:func:`start_round`), which
is bit-identical to a fresh state and keeps every address the graph
reads.  The step's draws are taken before the replay, never inside it,
and can be passed in (:class:`DistillDraws`), so a test replays the JAX
package's ``randint`` and ``normal`` draws.

With a data-parallel ``env`` (a ``MeshEnv`` with a process group, the
replicated policy) each rank distils its ``batch / world`` rows: the draws
are taken at the global batch's size and the rank keeps its rows, and the
gradients and the loss are all-reduced over the data group before the
update (inside the captured graph on the card), as in
:mod:`~diff3d_tpu_torch.train.step`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import torch

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.data.images import dequantize
from diff3d_tpu_torch.diffusion import (alpha_sigma, ddim_step,
                                        logsnr_schedule_cosine,
                                        make_model_batch, q_sample)
from diff3d_tpu_torch.graphs import StepGraph, use_cuda_graphs
from diff3d_tpu_torch.train.checkpoint import CheckpointManager
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          set_schedule_step,
                                          warmup_schedule)
from diff3d_tpu_torch.train.step import (INPUTS, GradSync, step_seed,
                                         update_step)

log = logging.getLogger(__name__)


def distill_schedule(timesteps: int, start_steps: int,
                     final_steps: int) -> List[int]:
    """The per-round student step counts ``[start/2, start/4, ...,
    final]``; validates that the halving chain stays on divisors of the
    dense grid."""
    start_steps, final_steps = int(start_steps), int(final_steps)
    if start_steps < 2 or timesteps % start_steps:
        raise ValueError(
            f"start_steps={start_steps} must divide timesteps={timesteps}")
    if final_steps < 1 or start_steps % final_steps:
        raise ValueError(
            f"final_steps={final_steps} must divide "
            f"start_steps={start_steps}")
    rounds = []
    k = start_steps // 2
    while k >= final_steps:
        rounds.append(k)
        k //= 2
    if not rounds or rounds[-1] != final_steps:
        raise ValueError(
            f"start_steps={start_steps} cannot halve down to "
            f"final_steps={final_steps} (need a power-of-two ratio)")
    return rounds


class DistillDraws:
    """The draws of one distill step from one ``torch.Generator``, in this
    order: ``u [B]`` uniform in ``[0, 1)`` (the student's signal time
    index is ``i = floor(u k) + 1``, formed on the device, so ``k`` never
    leaves it), then the noise ``[B, H, W, 3]``.  A test replays the JAX
    package's ``randint`` draw ``i`` with ``u = (i - 0.5) / k``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def u(self, n: int, device: torch.device) -> torch.Tensor:
        return torch.rand((n,), generator=self.generator, device=device)

    def noise(self, shape: Sequence[int],
              device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=device)


def distill_loss(cfg: Config, student: torch.nn.Module,
                 teacher: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 u: torch.Tensor, noise: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """The distillation loss of ``batch`` (``diff3d_tpu/train/distill.py``
    :81-139): ``k`` is the student's step count as a float32 device
    scalar.  The teacher runs without autograd; the target ``x~`` carries
    no gradient.  Reads no host value."""
    dcfg = cfg.diffusion
    imgs = dequantize(batch["imgs"])
    x, z = imgs[:, 0], imgs[:, 1]
    B = z.shape[0]
    cond_mask = torch.ones((B,), dtype=torch.bool, device=z.device)
    w0 = torch.zeros((B,), dtype=z.dtype, device=z.device)

    def logsnr_of(t):
        return logsnr_schedule_cosine(t, logsnr_min=dcfg.logsnr_min,
                                      logsnr_max=dcfg.logsnr_max)

    # Student signal times t = i/k, i ~ U{1..k}; the teacher crosses the
    # same interval in two half-steps t -> t - 1/(2k) -> t - 1/k.  (u * k
    # can round up to k when u is within an ulp of 1: clamp.)
    i = torch.minimum(torch.floor(u * k) + 1.0, k)
    t = i / k
    logsnr_t = logsnr_of(t)
    logsnr_mid = logsnr_of(t - 0.5 / k)
    logsnr_next = logsnr_of(t - 1.0 / k)
    lt, lm, ln = (v[:, None, None, None]
                  for v in (logsnr_t, logsnr_mid, logsnr_next))
    z_t = q_sample(z, logsnr_t, noise)

    def denoise(model, z_in, logsnr):
        mb = make_model_batch(x, z_in, logsnr, batch["R"], batch["T"],
                              batch["K"], logsnr_max=dcfg.logsnr_max)
        return model(mb, cond_mask)

    alpha_t, sigma_t = alpha_sigma(lt)
    with torch.no_grad():
        # Two teacher DDIM steps; eps twice makes the CFG combine at w=0
        # the plain conditional prediction.
        eps1 = denoise(teacher, z_t, logsnr_t)
        z_mid = ddim_step(eps1, eps1, z_t, lt, lm, w0)
        eps2 = denoise(teacher, z_mid, logsnr_mid)
        z_next = ddim_step(eps2, eps2, z_mid, lm, ln, w0)
        # The x0 the student must predict so that ITS one DDIM step lands
        # on z_next: x~ = (z_next - (s_n/s_t) z_t) / (a_n - (s_n/s_t) a_t).
        alpha_n, sigma_n = alpha_sigma(ln)
        ratio = sigma_n / sigma_t
        x_target = (z_next - ratio * z_t) / (alpha_n - ratio * alpha_t)

    eps_hat = denoise(student, z_t, logsnr_t)
    x_hat = (z_t - sigma_t * eps_hat) / alpha_t
    d = x_target - x_hat
    per = (d * d).mean(dim=(1, 2, 3))
    wgt = torch.clamp(torch.exp(logsnr_t), min=1.0)       # truncated SNR
    return (wgt * per).mean()


def _step_body(cfg: Config, state: TrainState, teacher: torch.nn.Module,
               names: Sequence[str], params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], batch: Dict[str, torch.Tensor],
               u: torch.Tensor, noise: torch.Tensor, k: torch.Tensor,
               sync: GradSync):
    """Loss, its gradients into ``grads`` (the parameters' ``.grad``, views
    of ``sync``'s bucket), the bucket with the loss all-reduced over the
    data group (a no-op without one), then the train step's update (global
    norm, clipping, Adam, EMA).  Returns ``(loss, grad_norm)``; reads no
    host value."""
    torch._foreach_zero_(list(grads))
    loss = distill_loss(cfg, state.model, teacher, batch, u, noise, k)
    got = torch.autograd.grad(loss, params, allow_unused=True)
    used = [(a, g) for a, g in zip(grads, got) if g is not None]
    torch._foreach_add_([a for a, _ in used], [g for _, g in used])
    sync.total.copy_(loss.detach())
    sync.reduce()
    return update_step(cfg, state, names, params, grads, sync.total)


class DistillStep:
    """``step(state, teacher, batch, student_steps, draws=None) ->
    metrics``: one update of the student ``state`` against the teacher
    module at ``student_steps`` (see the module docstring).

    ``batch`` has the trainer's contract (``imgs [B, 2, H, W, 3]`` uint8,
    ``R``, ``T``, ``K``) on the model's device; the whole batch is one
    microbatch (the reference distils without accumulation).  ``draws``:
    a :class:`DistillDraws`-like object, or None for a generator seeded by
    ``(cfg.train.seed, state.step)`` (the JAX package's ``fold_in(rng,
    state.step)``; each round restarts the step at 0, so each round sees
    the same draws, as there).  Returns ``{'distill_loss': tensor, 'lr':
    float, 'grad_norm': tensor}`` (the tensors on the device, the step's
    own).  With ``cuda_graphs`` the first step of a state runs eagerly and
    the step is captured after it; later steps, of any round, replay it
    while the state, the teacher and the batch shapes keep their
    addresses (:attr:`graph`)."""

    def __init__(self, cfg: Config, cuda_graphs: bool = False, env=None):
        # One microbatch: update_step divides by accum_steps.
        self.cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, accum_steps=1))
        self.cuda_graphs = cuda_graphs
        self.sched = warmup_schedule(cfg.train)
        self._gen: Optional[torch.Generator] = None
        self._captured: Optional[dict] = None
        if env is not None and env.cfg.param_sharding != "replicated":
            raise ValueError("distillation is data-parallel under the "
                             "replicated policy only")
        if env is not None and env.context_parallel:
            raise ValueError("distillation under context_parallel waits "
                             "for ROADMAP A10c")
        self.group = None if env is None else env.group
        self.world = 1 if env is None else env.data_size
        self.rank = 0 if env is None else env.data_rank
        self._sync: Optional[GradSync] = None

    @property
    def graph(self) -> Optional[StepGraph]:
        return None if self._captured is None else self._captured["graph"]

    def release(self) -> None:
        """Drop the captured graph (its memory pool goes with it)."""
        self._captured = None

    def __call__(self, state: TrainState, teacher: torch.nn.Module,
                 batch: Dict[str, torch.Tensor], student_steps: int,
                 draws=None) -> Dict[str, object]:
        state.model.eval()                 # deterministic: no dropout
        imgs = batch["imgs"]
        device = imgs.device
        if draws is None:
            if self._gen is None or self._gen.device != device:
                self._gen = torch.Generator(device)
            self._gen.manual_seed(step_seed(self.cfg.train.seed,
                                            state.step))
            draws = DistillDraws(self._gen)
        B = imgs.shape[0]
        rows = slice(self.rank * B, (self.rank + 1) * B)
        # The global batch's draws; this rank keeps its rows.
        u = draws.u(B * self.world, device)[rows]
        noise = draws.noise((B * self.world,) + tuple(imgs.shape[2:]),
                            device)[rows]
        names, params = zip(*state.model.named_parameters())
        sync = self._bucket(params)
        lr = self.sched(state.step)
        c = self._captured
        if self.cuda_graphs and c is not None \
                and c["key"] == self._key(state, teacher, batch, params):
            for key, buf in c["inputs"].items():
                buf.copy_(batch[key])
            c["u"].copy_(u)
            c["noise"].copy_(noise)
            c["k"].fill_(float(student_steps))
            c["graph"].replay()
            loss, grad_norm = (t.clone() for t in c["graph"].output)
        else:
            # The eager step; on the graph path also the warm-up (kernel
            # attributes, library plans, Adam's state) before a capture.
            self.release()
            sync.zero()
            grads = sync.grads
            k = torch.full((), float(student_steps), dtype=torch.float32,
                           device=device)
            loss, grad_norm = _step_body(self.cfg, state, teacher, names,
                                         params, grads, batch, u, noise, k,
                                         sync)
            loss = loss.clone()
            if self.cuda_graphs:
                self._capture(state, teacher, batch, names, params, u,
                              noise)
        state.scheduler.step()
        state.step += 1
        return {"distill_loss": loss, "lr": lr, "grad_norm": grad_norm}

    def _bucket(self, params) -> GradSync:
        if self._sync is None or self._sync.key != tuple(map(id, params)):
            self._sync = GradSync(params, self.group)
        return self._sync

    @staticmethod
    def _key(state, teacher, batch, params) -> tuple:
        """What the capture depends on: the batch's shapes and the
        addresses of every tensor the graph reads or writes."""
        opt = state.optimizer
        ptrs = [id(state), id(teacher)]
        for p in params:
            ptrs += [p.data_ptr(), -1 if p.grad is None else
                     p.grad.data_ptr()]
            ptrs += [t.data_ptr() for t in opt.state.get(p, {}).values()
                     if torch.is_tensor(t)]
        ptrs += [g["lr"].data_ptr() if torch.is_tensor(g["lr"]) else -1
                 for g in opt.param_groups]
        ptrs += [t.data_ptr() for t in state.ema.values()]
        ptrs += [p.data_ptr() for p in teacher.parameters()]
        shapes = [(k, tuple(batch[k].shape), batch[k].dtype)
                  for k in INPUTS]
        return tuple(shapes), tuple(ptrs)

    def _capture(self, state, teacher, batch, names, params, u,
                 noise) -> None:
        cfg = self.cfg
        inputs = {k: batch[k].clone() for k in INPUTS}
        u_buf, noise_buf = u.clone(), noise.clone()
        k_buf = torch.zeros((), dtype=torch.float32, device=u.device)
        grads = [p.grad for p in params]
        graph = StepGraph(lambda: _step_body(
            cfg, state, teacher, names, params, grads, inputs, u_buf,
            noise_buf, k_buf, self._sync))
        self._captured = {"key": self._key(state, teacher, batch, params),
                          "graph": graph, "inputs": inputs, "u": u_buf,
                          "noise": noise_buf, "k": k_buf}


def make_distill_step(cfg: Config, cuda_graphs: bool = False,
                      env=None) -> DistillStep:
    """The distill step of ``cfg`` (:class:`DistillStep`); ``cuda_graphs``
    captures it as one CUDA graph (a CUDA device only); ``env`` (a
    ``MeshEnv`` with a process group) makes it data-parallel."""
    return DistillStep(cfg, cuda_graphs=cuda_graphs, env=env)


def start_round(state: TrainState, teacher: torch.nn.Module) -> None:
    """Reset ``state`` in place to a new round's start: the student's
    parameters and EMA copied from ``teacher``'s, Adam's moments and step
    counters zero, the schedule and the step at 0 -- bit for bit
    ``create_train_state`` of a copy of the teacher, with every tensor at
    its address (the JAX package builds a fresh state, ``distill.py:247``,
    which re-zeroes Adam and restarts the warmup)."""
    with torch.no_grad():
        for (name, p), tp in zip(state.model.named_parameters(),
                                 teacher.parameters()):
            p.copy_(tp)
            state.ema[name].copy_(tp)
        for st in state.optimizer.state.values():
            for t in st.values():
                if torch.is_tensor(t):
                    t.zero_()
    set_schedule_step(state, 0)
    state.step = 0


def distill(model: torch.nn.Module, cfg: Config,
            teacher_params: Mapping[str, torch.Tensor],
            batches: Iterator[Dict[str, torch.Tensor]], *,
            start_steps: Optional[int] = None, final_steps: int = 16,
            round_steps: int = 2000, workdir: Optional[str] = None,
            log_every: int = 100,
            step_fn: Optional[DistillStep] = None, env=None):
    """Run the halving rounds; returns ``(params, history)``: the last
    round's EMA (parameter name -> tensor) and one record per round.

    ``model`` is the student ``XUNet`` on its device (its weights are
    overwritten), ``teacher_params`` the first teacher's weights by
    parameter name (e.g. a ``Trainer`` checkpoint's EMA), ``batches`` any
    iterator of trainer-contract batches on that device (drained across
    rounds: ``rounds * round_steps`` batches).  Per round ``k``: the
    student starts from the teacher (:func:`start_round`), trains
    ``round_steps`` steps at ``k`` student steps, and its EMA becomes the
    next round's teacher.  With ``workdir`` each round lands in
    ``<workdir>/steps_<k>/`` through the asynchronous ``full_sliced``
    checkpoint path, saved and awaited before the next round starts, so a
    run cut short restarts from the last finished round.  ``step_fn``: the
    step to run (default :func:`make_distill_step` on the graph path on a
    CUDA device, eager elsewhere, data-parallel over ``env``'s group, whose
    ranks each pass their rows of every batch); its draws come from
    ``cfg.train.seed``."""
    from diff3d_tpu_torch.models.xunet import XUNet

    rounds = distill_schedule(cfg.diffusion.timesteps,
                              cfg.diffusion.timesteps
                              if start_steps is None else start_steps,
                              final_steps)
    device = next(model.parameters()).device
    if step_fn is None:
        step_fn = make_distill_step(
            cfg, cuda_graphs=use_cuda_graphs(None, device), env=env)
    teacher = XUNet(model.cfg).to(device).eval().requires_grad_(False)
    state = create_train_state(model.eval(), cfg.train)
    history = []
    for r, k in enumerate(rounds):
        src = teacher_params if r == 0 else state.ema
        with torch.no_grad():
            for name, p in teacher.named_parameters():
                p.copy_(src[name])
        start_round(state, teacher)
        metrics: Dict[str, object] = {}
        for n in range(round_steps):
            metrics = step_fn(state, teacher, next(batches), k)
            if log_every and (n + 1) % log_every == 0:
                log.info("distill %d-step round: %d/%d loss=%.5f", k, n + 1,
                         round_steps, float(metrics["distill_loss"]))
        entry = {"student_steps": k, "round_steps": round_steps,
                 "final_loss": float(metrics["distill_loss"])}
        if workdir is not None:
            ckpt_dir = os.path.join(workdir, f"steps_{k}")
            mgr = CheckpointManager(ckpt_dir, keep=1, mode="full_sliced",
                                    async_writes=True)
            mgr.save(state, force=True)
            mgr.wait_until_finished()
            mgr.close()
            entry["checkpoint"] = ckpt_dir
        history.append(entry)
    return {k: v.clone() for k, v in state.ema.items()}, history
