"""Autoregressive novel-view synthesis with stochastic conditioning
(counterpart: ``diff3d_tpu/sampling/runtime.py``).

Seed the record with the first view, then for every remaining pose run
the reverse diffusion, drawing a fresh conditioning view from the record
at each step, with the guidance weights ``w = [0..7]`` as the batch axis;
each generated view is appended to the record, so later views condition
on earlier generations.  The record buffers live on the device for the
whole object; the only device-to-host copy is one fetch at the end.

A view runs as prepare (its draws, taken up front, and the loop's static
buffers) -> ``scan_chunks`` segments of reverse steps -> commit (the view
written into the record), the JAX package's ``prepare_view`` /
``chunk_view`` / ``sample_view_commit``.  The reverse step is
:class:`~diff3d_tpu_torch.diffusion.ReverseLoop`'s body: on a CUDA device
it is captured once per shape as a CUDA graph
(:class:`~diff3d_tpu_torch.graphs.StepGraph`, the counterpart of the
compiled ``lax.scan``) and replayed; elsewhere, or with
``cuda_graphs=False``, it runs eagerly.  :meth:`Sampler.step_many` and
:meth:`Sampler.synthesize_many` batch N objects into every model call.

The serving engine gives all its samplers one CUDA-graph memory pool
(:attr:`Sampler.graph_pool`), so its graphs (one per lane count, record
capacity and schedule) share their intermediates instead of each
holding its own.  That is safe because one thread replays one graph at a
time on one stream, and a step writes its results only into buffers
allocated outside the capture.  The per-call ``params=`` swap of the JAX
package becomes an in-place copy into the model's parameters
(:class:`~diff3d_tpu_torch.serving.ParamsRegistry`), which the captured
graphs read at fixed addresses.

With a mesh (``Sampler(mesh=env)``, a :class:`~diff3d_tpu_torch.parallel.
MeshEnv` whose data axis spans ``n`` ranks) the object axis of
:meth:`Sampler.step_many` and :meth:`Sampler.synthesize_many` is split
over the ranks: rank ``r`` runs objects ``[r N/n, (r+1) N/n)`` in its own
loop (its own CUDA graph), and the views are all-gathered, so every rank
returns all ``N`` objects' views and keeps the same records (over gloo,
ranks sharing one card, the gather is staged through pinned host memory).
:attr:`Sampler.lane_multiple` becomes ``n``: ``step_many`` refuses an
object count that is not a multiple of it, ``synthesize_many`` pads.
Under ``tp`` / ``fsdp+tp`` the model is split over the mesh's model axis
(``MeshEnv.place_model_axis``; the data axis keeps whole copies for
sampling): the ranks of one model group run the same objects with the same
draws, each on its blocks, and the step runs eagerly (the model axis's
collectives are not captured).  Under ``context_parallel`` the
single-object path (:meth:`Sampler.step`, :meth:`Sampler.synthesize`)
runs the model split by image rows over the model axis
(``parallel/context.py``), eagerly, every rank of a model group on the
same object with the same draws; the object-batched path
(:meth:`Sampler.step_many`, :meth:`Sampler.synthesize_many`) leaves the
row split out, as the JAX package does (``diff3d_tpu/sampling/
runtime.py:312-317``), and the model ranks then compute the same thing.
Under context parallelism with ``tp`` / ``fsdp+tp`` the single-object
path runs by rows with each layer's split leaves gathered whole, and the
batched path runs ``tp``'s column and row modes on the same placed model:
the mode is set on every call (``MeshEnv.split_rows``).
``lower_step_many`` (the JAX package's StableHLO hook) waits for ROADMAP
A11.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from diff3d_tpu_torch.config import Config
from diff3d_tpu_torch.device import resolve_device
from diff3d_tpu_torch.diffusion import (SAMPLER_KINDS, Draws, ReverseLoop,
                                       draw_steps, sample_loop_prepare,
                                       schedule_start_index)
from diff3d_tpu_torch.graphs import StepGraph, use_cuda_graphs


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 255] uint8."""
    return np.clip((np.asarray(img) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    """Save one ``[H, W, 3]`` image in [-1, 1]; parent dirs created."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def save_frame_sequence(out_dir: str, frames: np.ndarray,
                        prefix: str = "frame") -> dict:
    """Write ``frames`` (``[n, H, W, 3]`` in [-1, 1], or ``[n, B, H, W,
    3]``, of which lane 0 is written) as ``<out_dir>/<prefix>_%03d.png``
    plus a one-row ``contact_sheet.png`` (counterpart:
    ``diff3d_tpu/utils/frames.py``).  Returns ``{"dir", "frames",
    "contact_sheet"}``, the paths written."""
    from PIL import Image

    frames = np.asarray(frames, np.float32)
    if frames.ndim == 5:
        frames = frames[:, 0]
    if frames.ndim != 4 or frames.shape[-1] != 3 or not len(frames):
        raise ValueError(f"frames must be [n>0, H, W, 3] (or [n, B, H, W, "
                         f"3]), got {frames.shape}")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, frame in enumerate(frames):
        paths.append(os.path.join(out_dir, f"{prefix}_{k:03d}.png"))
        save_image(paths[-1], frame)
    sheet = os.path.join(out_dir, "contact_sheet.png")
    Image.fromarray(np.concatenate([to_uint8(f) for f in frames],
                                   axis=1)).save(sheet)
    return {"dir": out_dir, "frames": paths, "contact_sheet": sheet}


def record_capacity(n_views: int) -> int:
    """Record-buffer capacity for an object synthesised to ``n_views``
    views, rounded up to a power of two (the serving layer buckets by
    it).  The conditioning draw reads only the first ``record_len``
    entries, so the padding never reaches sampling."""
    if n_views < 2:
        raise ValueError(f"n_views={n_views}: need at least 2 views "
                         "(one conditioning + one target)")
    return 1 << (n_views - 1).bit_length()


def _agreed(agree, run):
    """``run()``; with ``agree``, this rank's outcome is agreed with the
    other ranks' before anyone goes on (a failure anywhere raises
    everywhere)."""
    if agree is None:
        return run()
    try:
        result = run()
    except Exception as e:  # noqa: BLE001 - reported to the other ranks
        agree(e)            # raises e
        raise
    agree(None)
    return result


class Sampler:
    """Runs the autoregressive view loop for one object, or for N objects
    batched into every model call.

    Args:
      model: the X-UNet (:func:`diff3d_tpu_torch.models.build_model`),
        moved to ``device`` and put in eval mode.
      cfg: full config (``diffusion.timesteps``, ``guidance_weights`` ...).
      device: where it runs — the card unless the caller names another;
        raises without CUDA when none is named.
      sampler_kind: ``"ancestral"`` (the paper's stochastic sampler) or
        ``"ddim"`` (deterministic, eta = 0).
      steps: reverse steps per view; must divide ``timesteps``.
      scan_chunks: run each view's reverse steps as this many segments
        (must divide ``steps``); the result is bit-identical to 1.
      start_t: truncated refinement (cascade): a grid point of the
        ``steps``-step schedule.  Every view step then takes a ``[B, H,
        W, 3]`` draft, renoised to ``start_t``, and runs only the
        remaining steps; ``start_t=1.0`` ignores the draft and reproduces
        the untruncated sampler bit for bit.  Requires ``scan_chunks ==
        1``; the ``synthesize*`` loops have no draft source and refuse a
        truncated sampler.
      cuda_graphs: None (the default) captures the reverse step as a CUDA
        graph on a CUDA device and runs it eagerly elsewhere; False runs
        it eagerly (the comparison path); True off a CUDA device raises.
        The first view of a shape runs its first step eagerly, then
        captures the step; a failed capture raises.

      mesh: a :class:`~diff3d_tpu_torch.parallel.MeshEnv` to split the
        object axis of the batched entry points over (its data axis);
        :attr:`lane_multiple` is then its data size.  Every data rank
        holds the whole model; under ``tp`` / ``fsdp+tp`` it is split over
        the model axis (in place: pass the whole model, as every other
        caller does), and the caller's draws must agree across the ranks
        of a model group (seed them alike).

    :attr:`graph_pool` (None: each graph gets a pool of its own) may be
    set to a CUDA-graph memory pool handle
    (``torch.cuda.graph_pool_handle()``) that every later capture goes
    into; only one graph of a shared pool may run at a time.
    """

    def __init__(self, model: torch.nn.Module, cfg: Config, *,
                 device: Optional[Union[str, torch.device]] = None,
                 sampler_kind: str = "ancestral",
                 steps: Optional[int] = None, scan_chunks: int = 1,
                 start_t: Optional[float] = None,
                 cuda_graphs: Optional[bool] = None, mesh=None):
        cfg.validate()
        self.mesh = mesh
        #: The object axis's quantum: the mesh's data size (1 without).
        self.lane_multiple = 1 if mesh is None else mesh.data_size
        self.device = resolve_device(device)
        split = mesh is not None and (mesh.tensor_parallel
                                      or mesh.context_parallel)
        if split and cuda_graphs:
            raise ValueError("a model split over the mesh's model axis "
                             "samples eagerly (cuda_graphs=True refused)")
        self.cuda_graphs = use_cuda_graphs(
            False if split else cuda_graphs, self.device)
        self.model = model.to(self.device).eval()
        #: The row split of the single-object path (None: not split).
        self._rows = None if mesh is None else mesh.context_axis
        if split:
            mesh.place_model_axis(self.model)
            mesh.place_context_axis(self.model)
        self.cfg = cfg
        self.w = torch.tensor(cfg.diffusion.guidance_weights,
                              dtype=torch.float32, device=self.device)
        d = cfg.diffusion
        if sampler_kind not in SAMPLER_KINDS:
            raise ValueError(
                f"sampler_kind={sampler_kind!r} not in {SAMPLER_KINDS}")
        self.sampler_kind = sampler_kind
        steps = d.timesteps if steps is None else int(steps)
        if steps < 1 or d.timesteps % steps:
            raise ValueError(
                f"steps={steps} must be a positive divisor of "
                f"timesteps={d.timesteps}")
        self.steps = steps
        if scan_chunks < 1 or steps % scan_chunks:
            raise ValueError(
                f"scan_chunks={scan_chunks} must divide the effective "
                f"step count steps={steps}")
        self.scan_chunks = scan_chunks
        self.start_t = None if start_t is None else float(start_t)
        self.start_index = 0
        if self.start_t is not None:
            # Raises ScheduleError for an off-grid start_t.
            self.start_index = schedule_start_index(
                steps, self.start_t, timesteps=d.timesteps)
            if scan_chunks != 1:
                raise ValueError(
                    f"start_t={self.start_t} (truncated refinement) "
                    f"requires scan_chunks=1, got {scan_chunks} — the "
                    "chunk split assumes the full step count")
        # One loop (static buffers) and, on the graph path, one captured
        # step per (objects, capacity, H, W, record dtype).
        self._loops: Dict[tuple, ReverseLoop] = {}
        self.graphs: Dict[tuple, StepGraph] = {}
        self.graph_pool = None
        #: The views' gathers staged through host memory on a gloo mesh:
        #: calls, bytes this rank put in, host seconds.
        self.gather_stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        #: The group the views are gathered over: None is the mesh's data
        #: axis; a serving replica on a mesh shared with other replicas
        #: gives its samplers a group of its own
        #: (``RankChannel.gather_group``), so two replicas' gathers never
        #: pair.
        self.gather_group = None

    @property
    def model_calls_per_view(self) -> int:
        """Denoiser calls per view: one 2B-batched CFG call per step; a
        truncated (``start_t``) sampler runs only the grid's tail."""
        return self.steps - self.start_index

    def _check_draft(self, draft, batched: bool) -> None:
        """The draft is exactly as optional as ``start_t``."""
        if self.start_t is not None and draft is None:
            raise ValueError(
                f"this sampler was built with start_t={self.start_t}: "
                "every view step needs the "
                + ("[N, B, H, W, 3] drafts" if batched
                   else "[B, H, W, 3] draft")
                + " operand to renoise from")
        if self.start_t is None and draft is not None:
            raise ValueError(
                "draft passed to an untruncated sampler — build the "
                "Sampler with start_t to enable cascade refinement")

    def _check_no_truncation(self, entry: str) -> None:
        if self.start_t is not None:
            raise ValueError(
                f"{entry}: this sampler was built with start_t="
                f"{self.start_t} (truncated refinement) and needs a draft "
                "per view; the offline loops have no draft source — use "
                "the step API")

    @torch.inference_mode()
    def step(self, record_imgs: torch.Tensor, record_R: torch.Tensor,
             record_T: torch.Tensor, step: int, K: torch.Tensor, draws, *,
             draft: Optional[torch.Tensor] = None) -> tuple:
        """One view's reverse diffusion for one object.

        ``record_imgs [capacity, B, H, W, 3]`` and the pose buffers
        ``[capacity, 3, 3]`` / ``[capacity, 3]`` are device tensors; the
        pose buffers hold every view's pose (entry ``step`` is the target).
        ``draws`` supplies the view's random draws (:class:`Draws`);
        ``draft`` (``[B, H, W, 3]``) is required exactly when the sampler
        was built with ``start_t``.  Returns ``(out [B, H, W, 3],
        record_imgs, step + 1)``; the record is updated in place.
        """
        self._check_draft(draft, batched=False)
        self._split_rows(True)
        out, _, _ = self._view(
            record_imgs[None], record_R[None], record_T[None], [int(step)],
            K[None], [draws], None if draft is None else draft[None])
        return out[0], record_imgs, int(step) + 1

    @torch.inference_mode()
    def step_many(self, record_imgs: torch.Tensor, record_R: torch.Tensor,
                  record_T: torch.Tensor, steps: Sequence[int],
                  K: torch.Tensor, draws: Sequence, *,
                  drafts: Optional[torch.Tensor] = None,
                  agree=None) -> tuple:
        """One view step for N objects in one batched loop: every model
        call holds ``N * 2B`` examples.

        Everything gains a leading object axis: ``record_imgs [N,
        capacity, B, H, W, 3]``, ``record_R [N, capacity, 3, 3]``,
        ``record_T [N, capacity, 3]``, ``K [N, 3, 3]``.  ``steps`` holds
        the N record lengths (host ints), so objects may sit at different
        autoregressive depths; each object's conditioning draw reads its
        own first ``steps[n]`` entries and its target pose is its entry
        ``steps[n]``.  ``draws`` holds one draw source per object.
        Returns ``(out [N, B, H, W, 3], record_imgs, steps + 1)`` with the
        records updated in place.  On a mesh N must be a multiple of
        :attr:`lane_multiple`; each rank runs its share of the objects and
        the views are all-gathered.  ``agree`` (a serving mesh's
        agreement, ``serving/ranks.py``) is called with this rank's
        error, or None, once its share has run and before the views are
        gathered; it raises on every rank when any rank's share failed.
        """
        self._check_draft(drafts, batched=True)
        self._split_rows(False)
        lens = [int(s) for s in steps]
        n = int(record_imgs.shape[0])
        if n % self.lane_multiple:
            raise ValueError(
                f"step_many: {n} objects is not a multiple of the mesh's "
                f"data-axis size {self.lane_multiple} — pad the batch "
                "(repeat a live lane; padded outputs are discarded) or "
                "use synthesize_many, which pads internally")
        if len(lens) != n or len(draws) != n:
            raise ValueError(f"step_many: {n} objects need {n} steps and "
                             f"{n} draw sources, got {len(lens)} and "
                             f"{len(draws)}")
        if self.lane_multiple == 1:
            return _agreed(agree, lambda: self._view(
                record_imgs, record_R, record_T, lens, K, draws, drafts))
        return self._view_split(record_imgs, record_R, record_T, lens, K,
                                draws, drafts, agree)

    def _split_rows(self, on: bool) -> None:
        """Under context parallelism, the model split by rows (``on``:
        the single-object path) or whole on every rank (the batched path;
        under ``tp`` / ``fsdp+tp`` it then runs ``tp``'s column and row
        modes, :meth:`MeshEnv.split_rows`)."""
        if self._rows is not None:
            self.mesh.split_rows(self.model, on)

    def _view_split(self, record_imgs, record_R, record_T, lens, K, draws,
                    drafts, agree=None) -> tuple:
        """:meth:`_view` of this rank's objects, then the views of all
        ranks all-gathered and written into every rank's records."""
        world, rank = self.lane_multiple, self.mesh.data_rank
        m = int(record_imgs.shape[0]) // world
        mine = slice(rank * m, (rank + 1) * m)
        rec = record_imgs[mine].clone()
        out, _, _ = _agreed(agree, lambda: self._view(
            rec, record_R[mine], record_T[mine], lens[mine], K[mine],
            draws[mine], None if drafts is None else drafts[mine]))
        full = self._gather_views(out.contiguous(), world)
        at = torch.arange(world * m, device=record_imgs.device)
        record_imgs[at, torch.tensor(lens, device=record_imgs.device)] = \
            full.to(record_imgs.dtype)
        return full, record_imgs, [s + 1 for s in lens]

    def _gather_views(self, out: torch.Tensor, world: int) -> torch.Tensor:
        """Every rank's views, rank-major, over :attr:`gather_group` (the
        mesh's data axis by default).  Over NCCL the card's tensors go
        as they are; over gloo (ranks sharing one card) a CUDA tensor is
        staged through pinned host memory, as the model axis stages its
        collectives (``parallel/tensor.py``), and :attr:`gather_stats`
        counts the staged calls, bytes and host seconds."""
        group = (self.mesh.group if self.gather_group is None
                 else self.gather_group)
        if not (out.is_cuda and dist.get_backend(group) == "gloo"):
            full = torch.empty((world * out.shape[0],) + tuple(out.shape[1:]),
                               dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(full, out, group=group)
            return full
        t0 = time.perf_counter()
        host = torch.empty((world,) + tuple(out.shape), dtype=out.dtype,
                           pin_memory=True)
        host[self.mesh.data_rank].copy_(out)
        for r, src in enumerate(dist.get_process_group_ranks(group)):
            dist.broadcast(host[r], src=src, group=group)
        full = host.to(out.device).flatten(0, 1)
        self.gather_stats["calls"] += 1
        self.gather_stats["bytes"] += out.numel() * out.element_size()
        self.gather_stats["seconds"] += time.perf_counter() - t0
        return full

    def _loop(self, N: int, capacity: int, H: int, W: int,
              dtype: torch.dtype) -> tuple:
        key = (N, capacity, H, W, dtype)
        if key not in self._loops:
            d = self.cfg.diffusion
            model = self.model

            def denoise(batch, cond_mask):
                return model(batch, cond_mask)

            self._loops[key] = ReverseLoop(
                denoise, n_objects=N, capacity=capacity,
                n_steps=self.model_calls_per_view, w=self.w, H=H, W=W,
                record_dtype=dtype, logsnr_max=d.logsnr_max,
                clip_x0=d.clip_x0,
                deterministic=(self.sampler_kind == "ddim"))
        return key, self._loops[key]

    def _prepare(self, loop: ReverseLoop, record_imgs, record_R, record_T,
                 lens: List[int], K, draws, drafts) -> None:
        """Take every object's draws for one view (init noise, conditioning
        indices, then the steps' draws, as an eager loop takes them) and
        load the loop's buffers."""
        d = self.cfg.diffusion
        N = len(lens)
        shape = tuple(loop.shape[1:])
        inits, idxs, xus, noises = [], [], [], []
        for n in range(N):
            init, (logsnrs, logsnr_nexts, idx) = sample_loop_prepare(
                record_len=lens[n], draws=draws[n], timesteps=d.timesteps,
                shape=shape, logsnr_min=d.logsnr_min,
                logsnr_max=d.logsnr_max, device=self.device,
                steps=self.steps, start_t=self.start_t,
                draft=None if drafts is None else drafts[n])
            xu, noise = draw_steps(draws[n], self.model_calls_per_view,
                                   shape, self.device, loop.deterministic)
            inits.append(init)
            idxs.append(idx)
            xus.append(xu)
            noises.append(noise)
        at = torch.arange(N, device=self.device)
        lens_d = torch.tensor(lens, device=self.device)
        loop.load(torch.stack(inits), logsnrs, logsnr_nexts,
                  torch.stack(idxs), torch.stack(xus),
                  None if loop.deterministic else torch.stack(noises),
                  record_imgs, record_R, record_T, record_R[at, lens_d],
                  record_T[at, lens_d], K)

    def _segment(self, key: tuple, loop: ReverseLoop, n: int) -> None:
        """``n`` reverse steps: eager, or replays of the captured step
        (captured after one eager step the first time)."""
        if not self.cuda_graphs:
            for _ in range(n):
                loop.step()
            return
        graph = self.graphs.get(key)
        if graph is None:
            loop.step()
            n -= 1
            graph = self.graphs[key] = StepGraph(loop.step,
                                                 pool=self.graph_pool)
        for _ in range(n):
            graph.replay()

    def _view(self, record_imgs, record_R, record_T, lens: List[int], K,
              draws, drafts) -> tuple:
        """prepare -> ``scan_chunks`` segments -> commit, for N objects."""
        N, capacity = record_imgs.shape[:2]
        H, W = record_imgs.shape[-3:-1]
        key, loop = self._loop(N, capacity, H, W, record_imgs.dtype)
        self._prepare(loop, record_imgs, record_R, record_T, lens, K, draws,
                      drafts)
        per = self.model_calls_per_view // self.scan_chunks
        for _ in range(self.scan_chunks):
            self._segment(key, loop, per)
        out = loop.img.clone()
        at = torch.arange(N, device=record_imgs.device)
        record_imgs[at, torch.tensor(lens, device=record_imgs.device)] = \
            out.to(record_imgs.dtype)
        return out, record_imgs, [s + 1 for s in lens]

    def _record_init(self, imgs0, R, T, n_views):
        """Record buffers on the host: view 0 seeded, all poses
        pre-filled."""
        B = int(self.w.shape[0])
        H, W = imgs0.shape[-3:-1]
        capacity = record_capacity(n_views)
        record_imgs = np.zeros((capacity, B, H, W, 3), np.float32)
        record_R = np.zeros((capacity, 3, 3), np.float32)
        record_T = np.zeros((capacity, 3), np.float32)
        record_imgs[0] = imgs0[None]
        record_R[:n_views] = R[:n_views]
        record_T[:n_views] = T[:n_views]
        return record_imgs, record_R, record_T

    def _view_draws(self, n_gen: int, generator, draws, what: str):
        """One draw source per generated view: ``draws`` as given, or
        :class:`Draws` on ``generator`` (seed 0 when omitted)."""
        if draws is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            return [Draws(generator)] * n_gen
        if len(draws) != n_gen:
            raise ValueError(f"{what}: need {n_gen} (one per generated "
                             f"view), got {len(draws)}")
        return list(draws)

    def synthesize(self, views: Dict[str, np.ndarray],
                   generator: Optional[torch.Generator] = None,
                   out_dir: Optional[str] = None,
                   max_views: Optional[int] = None,
                   draws: Optional[Sequence] = None) -> np.ndarray:
        """Autoregressively synthesise every view of ``views`` (``imgs
        [V, H, W, 3]`` in [-1, 1], ``R [V, 3, 3]``, ``T [V, 3]``,
        ``K [3, 3]``) from view 0.

        Random draws come from ``generator`` (a generator on the sampler's
        device; seed 0 when omitted), or from ``draws``, one object per
        generated view, to replay another stream.  Returns
        ``[n_views-1, B, H, W, 3]`` float32.  With ``out_dir``, writes
        ``{out_dir}/{step}/gt.png`` and ``{out_dir}/{step}/{i}.png``.
        """
        self._check_no_truncation("synthesize")
        imgs = np.asarray(views["imgs"], np.float32)
        n_views = imgs.shape[0] if max_views is None else min(
            imgs.shape[0], max_views)
        B = int(self.w.shape[0])
        H, W = imgs.shape[1:3]
        if n_views < 2:
            return np.zeros((0, B, H, W, 3), np.float32)
        per_view = self._view_draws(n_views - 1, generator, draws, "draws")
        if self._rows is not None:
            outs = self._synthesize_steps(views, n_views, per_view)
        else:
            outs = self.synthesize_many([views], None, max_views=n_views,
                                        draws=[per_view])[0]
        if out_dir is not None:
            for s in range(1, n_views):
                save_image(os.path.join(out_dir, str(s), "gt.png"), imgs[s])
                for i in range(B):
                    save_image(os.path.join(out_dir, str(s), f"{i}.png"),
                               outs[s - 1, i])
        return outs

    def _synthesize_steps(self, views, n_views: int, per_view) -> np.ndarray:
        """:meth:`synthesize` through :meth:`step`, one view at a time (the
        single-object path, split by rows under context parallelism)."""
        rec = self._record_init(
            np.asarray(views["imgs"][0], np.float32),
            np.asarray(views["R"], np.float32),
            np.asarray(views["T"], np.float32), n_views)
        rec_i, rec_R, rec_T = (torch.from_numpy(a).to(self.device)
                               for a in rec)
        K = torch.from_numpy(np.asarray(views["K"], np.float32)).to(
            self.device)
        for s in range(1, n_views):
            _, rec_i, _ = self.step(rec_i, rec_R, rec_T, s, K,
                                    per_view[s - 1])
        return rec_i[1:n_views].cpu().numpy()

    def synthesize_many(self, views_list: Sequence[Dict[str, np.ndarray]],
                        generators: Optional[Sequence[torch.Generator]],
                        max_views: Optional[int] = None,
                        draws: Optional[Sequence[Sequence]] = None
                        ) -> np.ndarray:
        """Autoregressively synthesise N objects' views with the objects
        batched into every model call (:meth:`step_many`).

        ``generators`` holds one generator per object, or ``draws`` one
        list of per-view draw sources per object.  Given the same
        per-object draws, each object's views equal :meth:`synthesize` on
        that object to float tolerance (the larger batch may take other
        convolution and matmul algorithms).  Every object contributes
        ``n_views = min(min_i views_i, max_views)`` views.  The records
        stay on the device; one fetch at the end.  Returns ``[N,
        n_views-1, B, H, W, 3]``.  On a mesh N is padded to a multiple of
        :attr:`lane_multiple` by repeating object 0's views (live data),
        with draws of their own; the padded outputs are discarded.
        """
        self._check_no_truncation("synthesize_many")
        N = len(views_list)
        n_views = min(int(np.shape(v["imgs"])[0]) for v in views_list)
        if max_views is not None:
            n_views = min(n_views, max_views)
        B = int(self.w.shape[0])
        H, W = np.shape(views_list[0]["imgs"])[1:3]
        if n_views < 2:
            return np.zeros((N, 0, B, H, W, 3), np.float32)
        if draws is None:
            if generators is None or len(generators) != N:
                raise ValueError(f"synthesize_many: need one generator per "
                                 f"object ({N})")
            draws = [None] * N
        elif len(draws) != N:
            raise ValueError(f"synthesize_many: need one draw list per "
                             f"object ({N}), got {len(draws)}")
        per_object = [self._view_draws(
            n_views - 1, None if generators is None else generators[n],
            draws[n], f"draws[{n}]") for n in range(N)]
        n_pad = -N % self.lane_multiple
        per_object += [self._view_draws(n_views - 1, None, None, "")
                       for _ in range(n_pad)]
        views_list = list(views_list) + [views_list[0]] * n_pad
        recs = [self._record_init(
            np.asarray(v["imgs"][0], np.float32),
            np.asarray(v["R"], np.float32), np.asarray(v["T"], np.float32),
            n_views) for v in views_list]
        rec_i, rec_R, rec_T = (
            torch.from_numpy(np.stack([r[j] for r in recs])).to(self.device)
            for j in range(3))
        K = torch.from_numpy(np.stack([np.asarray(v["K"], np.float32)
                                       for v in views_list])).to(self.device)
        steps = [1] * len(views_list)
        for v in range(n_views - 1):
            _, rec_i, steps = self.step_many(
                rec_i, rec_R, rec_T, steps, K,
                [per_object[n][v] for n in range(len(views_list))])
        return rec_i[:N, 1:n_views].cpu().numpy()
