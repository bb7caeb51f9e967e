"""Checkpoints of the train state (counterpart:
``diff3d_tpu/train/checkpoint.py``).

Save modes:

  * ``"full"`` (the default) -- one ``torch.save`` per checkpoint,
    ``<dir>/ckpt_<step>.pt``, holding ``{'model', 'ema', 'optim', 'sched',
    'step'}``: the reference's ``{'model', 'optim', 'step'}`` plus the EMA
    and the warmup schedule's position.  Exact resume.
  * ``"ema_bf16"`` -- ``<dir>/ckpt_<step>.pt`` holding ``{'ema', 'step'}``
    with the EMA cast to bfloat16: eval-grade weights
    (:meth:`CheckpointManager.restore_ema`) and a warm restart (the
    ``Trainer`` takes the EMA as its parameters and its EMA, Adam's
    moments start at zero, the schedule at the step).
  * ``"full_sliced"`` -- the whole state as one ``.npy`` file per tensor
    plus ``sliced_manifest.json`` under ``<dir>/<step>/``: written to
    ``<step>.tmp`` and committed by a rename, each tensor's device-to-host
    fetch retried on its own, the commit retried over filesystem faults.
    Exact resume, as ``full``.  With ``async_writes`` the snapshot is
    taken on the caller's thread (after a synchronisation of the stream
    that wrote the state) and the files are written by a writer thread;
    :meth:`CheckpointManager.wait_until_finished` is the durability
    barrier, and a write that failed is raised at the next call.

Every file is written under a temporary name and renamed, so a crash
never leaves a half-written checkpoint under a final name; the newest
``keep`` are kept.  The directory carries a ``ckpt_format.json`` marker
naming a mode other than ``full``; an unmarked directory is ``full`` (so
every checkpoint written before the marker existed stays readable), and a
mode that disagrees with the marker is refused.

Under a process group (:mod:`diff3d_tpu_torch.parallel`) only rank 0
writes ``full`` and ``ema_bf16`` files and the marker; every rank calls
:meth:`CheckpointManager.save` at the same steps (the directory must be
one every rank sees), and under ``fsdp`` the full state is gathered first
(``torch.distributed.checkpoint.state_dict.get_state_dict`` with full
state dicts), so the files keep the one-process format.  ``full_sliced``
does the same leaf by leaf: every rank takes part in each tensor's gather
(the snapshot is a collective) and rank 0 writes the whole tensors; a
restore copies this rank's block and chunk of each.  Under ``tp`` /
``fsdp+tp`` (:attr:`CheckpointManager.placement`, the trainer's
``MeshEnv``) every split tensor is gathered whole over the model
axis too (after FSDP's gather over the data axis), in the JAX package's
order, and a restore takes each rank's block of the whole tensors: a
checkpoint of any topology restores into any other.
:attr:`CheckpointManager.mesh_info` (the trainer's
``MeshEnv.topology_summary()``) is stamped into every checkpoint; a
restore into another topology records ``{"step", "from", "to"}`` in
:attr:`CheckpointManager.last_restore_reshard` (a reshard, the elastic
loop's normal resume, not an error).

A restore first compares every tensor's name, shape and dtype on disk
with the target's and raises :class:`CheckpointMismatchError` naming the
first that differs, before anything is copied.  ``full`` replaces Adam's
state tensors (``load_state_dict``); ``full_sliced`` copies into the
state's tensors in place where they exist.  A train step captured as CUDA
graphs compares the addresses it captured with the state's before every
replay and captures again where they moved
(:class:`~diff3d_tpu_torch.train.step.TrainStep`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import re
import shutil
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from diff3d_tpu_torch.parallel.multihost import is_primary, world_size
from diff3d_tpu_torch.runtime.retry import RetryPolicy, is_transient_io_error
from diff3d_tpu_torch.train.state import (TrainState, set_schedule_step,
                                          settle_lr)

log = logging.getLogger(__name__)

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
_MARKER = "ckpt_format.json"
_SLICED_MANIFEST = "sliced_manifest.json"
MODES = ("full", "ema_bf16", "full_sliced")

#: Per-tensor device-to-host fetch retry of a sliced save: any exception
#: is retried (a transient fault costs one tensor's retry, not the save).
_FETCH_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=5.0, max_delay_s=10.0, growth=2.0,
    jitter=0.0, classify=lambda exc: True)

#: Snapshots an asynchronous manager holds for its writer at most.
_MAX_INFLIGHT = 2

#: Commit retry of a sliced save over filesystem faults; every attempt
#: rebuilds the temporary directory from the host snapshot.
_DEFAULT_WRITE_RETRY = RetryPolicy(
    max_attempts=4, base_delay_s=0.5, max_delay_s=8.0, growth=2.0,
    jitter=0.25, classify=is_transient_io_error)


class CheckpointMismatchError(ValueError):
    """A checkpoint and its target disagree on a tensor's presence, shape
    or dtype; raised before anything is copied, naming the tensor
    (``leaf``), what the target expects and what was found, and the
    checkpoint's step."""

    def __init__(self, msg: str, *, leaf: Optional[str] = None,
                 expected=None, found=None, step: Optional[int] = None):
        super().__init__(msg)
        self.leaf = leaf
        self.expected = expected
        self.found = found
        self.step = step


def _meta(t: torch.Tensor) -> Tuple[tuple, str]:
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _sharded(t) -> bool:
    """Whether ``t`` is an FSDP-sharded tensor (a DTensor)."""
    return hasattr(t, "full_tensor")


def _copy_into(target: torch.Tensor, src: torch.Tensor) -> None:
    """``target.copy_(src)`` for a whole ``src``; a sharded ``target``
    takes its own chunk (FSDP2's ``torch.chunk`` layout)."""
    if not _sharded(target):
        target.copy_(src)
        return
    (place,) = target.placements
    mesh = target.device_mesh
    chunks = src.chunk(mesh.size(), dim=place.dim)
    rank = mesh.get_local_rank()
    local = target.to_local()
    if rank < len(chunks):
        local.copy_(chunks[rank])


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded ``t`` (a collective: every rank
    calls it), on the host; ``t`` itself otherwise."""
    return t.full_tensor().cpu() if _sharded(t) else t


def _placed_payload(state, placement) -> Tuple[dict, dict]:
    """``(model, optim)`` state dicts of a state split over a model axis
    (and maybe sharded by FSDP), whole, in the one-process format: every
    rank calls it (the gathers are collectives)."""
    names = [n for n, _ in state.model.named_parameters()]
    model = {k: placement.full_of(k, v.detach())
             for k, v in state.model.state_dict().items()}
    osd = state.optimizer.state_dict()
    optim = {"state": {i: {k: (placement.full_of(names[i], v)
                               if torch.is_tensor(v) and v.dim() else v)
                           for k, v in st.items()}
                       for i, st in osd["state"].items()},
             "param_groups": osd["param_groups"]}
    return model, optim


def _gathered_payload(state) -> Tuple[dict, dict]:
    """``(model, optim)`` state dicts of an FSDP state, whole, in the
    one-process format (Adam's state keyed by parameter index): every
    rank calls it, rank 0 gets the tensors (the others empty dicts)."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         get_state_dict)

    msd, osd = get_state_dict(state.model, state.optimizer,
                              options=StateDictOptions(
                                  full_state_dict=True, cpu_offload=True))
    index = {n: i for i, (n, _) in
             enumerate(state.model.named_parameters())}
    optim = {"state": {index[k]: v for k, v in
                       osd.get("state", {}).items()},
             "param_groups": [dict(g, params=[index[k] for k in
                                              g["params"]])
                              for g in osd.get("param_groups", [])]}
    return msd, optim


def _adam_leaves(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    opt = state.optimizer
    return [(f"adam.{name}.{key}", st[key])
            for name, p in state.model.named_parameters()
            for st in [opt.state.get(p, {})] for key in sorted(st)
            if torch.is_tensor(st[key])]


def state_leaves(state: TrainState) -> List[Tuple[str, torch.Tensor]]:
    """Every tensor of ``state`` by name, in a fixed order: ``model.*``
    (the state dict), ``ema.*``, ``adam.<param>.<key>`` (where Adam has
    made its state)."""
    return ([(f"model.{k}", v) for k, v in state.model.state_dict().items()]
            + [(f"ema.{k}", v) for k, v in state.ema.items()]
            + _adam_leaves(state))


def _param_name(leaf: str) -> str:
    """The parameter a leaf of :func:`state_leaves` is placed like:
    ``model.<p>`` / ``ema.<p>`` / ``adam.<p>.<key>`` -> ``<p>``."""
    kind, rest = leaf.split(".", 1)
    return rest.rsplit(".", 1)[0] if kind == "adam" else rest


def _expected(state: TrainState, with_adam: bool, placement=None
              ) -> List[Tuple[str, tuple, str]]:
    """(name, shape, dtype) of every tensor a checkpoint of ``state`` holds
    (Adam's for every parameter when ``with_adam``: the step counter and
    both moments in float32); ``placement``: the shapes are the whole
    ones of a state split over a model axis."""
    def whole(name, shape):
        return (tuple(shape) if placement is None
                else placement.whole_shape(name, shape))

    out = [(n, whole(n.split(".", 1)[1], t.shape), _meta(t)[1])
           for n, t in state_leaves(state) if not n.startswith("adam.")]
    if with_adam:
        for name, p in state.model.named_parameters():
            shape = whole(name, p.shape)
            out += [(f"adam.{name}.exp_avg", shape, "float32"),
                    (f"adam.{name}.exp_avg_sq", shape, "float32"),
                    (f"adam.{name}.step", (), "float32")]
    return sorted(out)


def _preflight(found: Sequence[Tuple[str, tuple, str]],
               expected: Sequence[Tuple[str, tuple, str]], where: str,
               step: int) -> None:
    """Raise :class:`CheckpointMismatchError` at the first tensor that is
    missing, extra, or of another shape or dtype."""
    got = {n: (s, d) for n, s, d in found}
    want = {n: (s, d) for n, s, d in expected}
    for name in sorted(want.keys() - got.keys()):
        raise CheckpointMismatchError(
            f"{where} (step {step}) has no tensor {name!r}, which the "
            f"target expects as {want[name]} -- model/optimizer config "
            "mismatch", leaf=name, expected=want[name], found=None,
            step=step)
    for name in sorted(got.keys() - want.keys()):
        raise CheckpointMismatchError(
            f"{where} (step {step}) holds tensor {name!r} {got[name]}, "
            "which the target does not have -- model/optimizer config "
            "mismatch", leaf=name, expected=None, found=got[name],
            step=step)
    for name in sorted(want):
        (ws, wd), (gs, gd) = want[name], got[name]
        if gs != ws:
            raise CheckpointMismatchError(
                f"{where} (step {step}): tensor {name!r} has shape {gs}, "
                f"the target expects {ws} -- model/optimizer config "
                "mismatch", leaf=name, expected=ws, found=gs, step=step)
        if gd != wd:
            raise CheckpointMismatchError(
                f"{where} (step {step}): tensor {name!r} was saved as {gd}, "
                f"the target expects {wd} -- model/optimizer config "
                "mismatch", leaf=name, expected=wd, found=gd, step=step)


def _full_leaves(ckpt: Mapping, names: Sequence[str]
                 ) -> List[Tuple[str, tuple, str]]:
    """(name, shape, dtype) of every tensor of a ``full`` checkpoint;
    Adam's state is keyed by parameter index there."""
    out = [(f"model.{k}", *_meta(v)) for k, v in ckpt["model"].items()]
    out += [(f"ema.{k}", *_meta(v)) for k, v in ckpt["ema"].items()]
    for i, st in ckpt["optim"]["state"].items():
        name = names[i] if 0 <= int(i) < len(names) else f"#{i}"
        out += [(f"adam.{name}.{key}", *_meta(v))
                for key, v in st.items() if torch.is_tensor(v)]
    return sorted(out)


@dataclasses.dataclass
class _Snapshot:
    """A host copy of one train state, ready to write: taken on the
    caller's thread, written by any thread."""

    step: int
    arrays: List[np.ndarray]          # bfloat16 viewed as int16
    manifest: dict


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 mode: Optional[str] = None, async_writes: bool = False,
                 write_retry: Optional[RetryPolicy] = None):
        """``mode=None`` follows the directory's marker (``full`` when it
        has none); an explicit mode must agree with an existing marker.
        ``async_writes`` applies to ``full_sliced`` only: at most
        ``_MAX_INFLIGHT`` snapshots wait for the writer (host memory),
        beyond that :meth:`save` blocks.  ``write_retry`` replaces the
        commit's retry policy (tests pass one that does not sleep)."""
        if mode is not None and mode not in MODES:
            raise ValueError(f"mode={mode!r} not in {MODES}")
        self.directory = directory
        self.keep = keep
        #: ``MeshEnv.topology_summary()`` of the state's mesh (set by the
        #: trainer before any restore); stamped into each checkpoint.
        self.mesh_info: Optional[dict] = None
        #: After a restore whose saved mesh differs from ``mesh_info``:
        #: ``{"step", "from", "to"}``; None otherwise.
        self.last_restore_reshard: Optional[dict] = None
        #: The ``MeshEnv`` of a state split over a model axis (set by the
        #: trainer before any restore): saves gather its tensors whole,
        #: restores take its blocks.
        self.placement = None
        marker = os.path.join(directory, _MARKER)
        if os.path.exists(marker):
            with open(marker) as f:
                marked = json.load(f)["mode"]
            if marked not in MODES:
                raise ValueError(f"{marker} declares unknown mode "
                                 f"{marked!r}")
            if mode is not None and mode != marked:
                raise ValueError(
                    f"{directory} is marked mode={marked!r} but "
                    f"mode={mode!r} was requested -- use a fresh "
                    "checkpoint directory to change modes")
            self.mode = marked
        else:
            self.mode = mode or "full"
            if self.mode != "full" and is_primary():
                # An unmarked directory that holds checkpoints holds full
                # ones: stamping it with another mode would wedge them.
                if self._files() or self._sliced_steps():
                    raise ValueError(
                        f"{directory} already contains full checkpoints; "
                        f"refusing to relabel it mode={self.mode!r} -- use "
                        "a fresh checkpoint directory")
                os.makedirs(directory, exist_ok=True)
                # Renamed into place: another rank's manager may read it.
                tmp = f"{marker}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"mode": self.mode}, f)
                os.replace(tmp, marker)
        self._write_retry = write_retry or _DEFAULT_WRITE_RETRY
        self._async = bool(async_writes) and self.mode == "full_sliced"
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None   # guarded by _lock
        self._pending: set = set()                    # guarded by _lock
        self._queue: queue.Queue = queue.Queue()
        self._inflight = threading.Semaphore(_MAX_INFLIGHT)
        self._writer: Optional[threading.Thread] = None
        #: Under a process group: the steps this manager snapshotted, so
        #: every rank takes the same decision (only rank 0 writes).
        self._taken: set = set()

    # ---- listing ------------------------------------------------------

    def _files(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def _sliced_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(
                          self.directory, d, _SLICED_MANIFEST)))

    def steps(self) -> List[int]:
        """Steps of the checkpoints on disk, ascending."""
        return (self._sliced_steps() if self.mode == "full_sliced"
                else self._files())

    def path(self, step: int) -> str:
        """The checkpoint of ``step``: a file (``full``, ``ema_bf16``) or a
        directory (``full_sliced``)."""
        if self.mode == "full_sliced":
            return os.path.join(self.directory, str(step))
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        if self.keep <= 0:
            return
        for old in self.steps()[:-self.keep]:
            path = self.path(old)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)

    # ---- saving -------------------------------------------------------

    def save(self, state: TrainState, *, force: bool = False) -> bool:
        """Write ``state``; returns whether it wrote.  An existing
        checkpoint of the same step is kept unless ``force`` (a committed
        ``full_sliced`` step is always kept: it is the state of that
        step).  A deferred write failure is raised here first."""
        self._raise_deferred_error()
        if self.mode == "full_sliced":
            return self._save_sliced(state)
        path = self.path(state.step)
        if os.path.exists(path) and not force:
            return False
        ema = {k: self._whole(k, v) for k, v in state.ema.items()}
        if self.mode == "ema_bf16":
            payload = {"ema": {k: v.detach().to("cpu", torch.bfloat16)
                               for k, v in ema.items()},
                       "step": state.step}
        else:
            if self.placement is not None:
                model, optim = _placed_payload(state, self.placement)
            elif any(_sharded(p) for p in state.model.parameters()):
                model, optim = _gathered_payload(state)
            else:
                model = state.model.state_dict()
                optim = state.optimizer.state_dict()
            payload = {"model": model, "ema": ema, "optim": optim,
                       "sched": state.scheduler.state_dict(),
                       "step": state.step}
        if self.mesh_info is not None and self.mode == "full":
            payload["mesh"] = self.mesh_info
        if not is_primary():
            return True
        os.makedirs(self.directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._prune()
        return True

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Tensor ``t`` (placed like parameter ``name``) whole: a
        collective where the state is split or sharded."""
        if self.placement is not None:
            return self.placement.full_of(name, t)
        return _full(t)

    def _local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor placed like ``name`` (the
        data axis's chunk is taken by :func:`_copy_into`)."""
        if self.placement is None:
            return whole
        return self.placement.local_of(name, whole)

    def _snapshot(self, state: TrainState) -> _Snapshot:
        """Host copies of every tensor of ``state``, on the caller's
        thread: the step that wrote them runs on this thread's stream, and
        the next step overwrites them in place."""
        leaves = state_leaves(state)
        devices = {t.device for _, t in leaves if t.is_cuda}
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        arrays, meta = [], []
        for i, (name, t) in enumerate(leaves):
            if world_size() > 1:
                # A collective where the state is split or sharded: every
                # rank gathers, rank 0 keeps the whole tensor.
                t = self._whole(_param_name(name), t.detach())
                if not is_primary():
                    continue
            host = _FETCH_RETRY.call(
                lambda t=t: t.detach().to("cpu", copy=True),
                describe=f"sliced save: tensor {i} ({name}) fetch")
            shape, dtype = _meta(host)
            if host.dtype == torch.bfloat16:     # numpy has no bfloat16
                host = host.view(torch.int16)
            arrays.append(host.numpy())
            meta.append({"name": name, "shape": list(shape),
                         "dtype": dtype})
        manifest = {"step": state.step,
                    "schedule_step": int(state.scheduler.last_epoch),
                    "leaves": meta}
        if self.mesh_info is not None:
            manifest["mesh"] = self.mesh_info
        return _Snapshot(step=state.step, arrays=arrays, manifest=manifest)

    def _commit(self, snap: _Snapshot) -> None:
        """Write one snapshot and publish it by a rename; safe to retry
        (each attempt starts the temporary directory afresh)."""
        final = self.path(snap.step)
        if os.path.exists(final):
            return
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for i, arr in enumerate(snap.arrays):
            np.save(os.path.join(tmp, f"t_{i:05d}.npy"), arr)
        with open(os.path.join(tmp, _SLICED_MANIFEST), "w") as f:
            json.dump(snap.manifest, f)
        os.replace(tmp, final)           # readers never see a partial one
        self._prune()

    def _save_sliced(self, state: TrainState) -> bool:
        step = state.step
        with self._lock:
            pending = step in self._pending
        if pending or step in self._taken or os.path.exists(self.path(step)):
            return False
        snap = self._snapshot(state)
        if world_size() > 1:
            self._taken.add(step)
            if not is_primary():
                return True
        if not self._async:
            self._write_retry.call(lambda: self._commit(snap),
                                   describe=f"ckpt commit (step {step})")
            return True
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()
        with self._lock:
            self._pending.add(step)
        self._inflight.acquire()          # backpressure: bounded host RAM
        self._queue.put(snap)
        return True

    def _writer_loop(self) -> None:
        while True:
            snap = self._queue.get()
            if snap is None:
                self._queue.task_done()
                return
            try:
                self._write_retry.call(
                    lambda: self._commit(snap),
                    describe=f"async ckpt commit (step {snap.step})")
            except BaseException as e:  # noqa: BLE001 - raised later
                # Raised at the next save() or wait_until_finished(): a
                # checkpoint that did not land must reach the caller.
                log.exception("async checkpoint commit failed (step %d)",
                              snap.step)
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    self._pending.discard(snap.step)
                self._inflight.release()
                self._queue.task_done()

    def _raise_deferred_error(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def wait_until_finished(self) -> None:
        """Durability barrier: returns once every accepted save is on
        disk, raising a deferred write failure."""
        if self._writer is not None:
            self._queue.join()
        self._raise_deferred_error()

    def close(self) -> None:
        """Finish the queued writes and stop the writer thread."""
        if self._writer is not None:
            self._queue.put(None)
            self._writer.join(timeout=60.0)
            if self._writer.is_alive():  # pragma: no cover - stuck disk
                log.error("checkpoint writer did not exit within 60 s")
            self._writer = None

    # ---- restoring ----------------------------------------------------

    def _pick(self, step: Optional[int]) -> Optional[int]:
        steps = self.steps()
        if step is None:
            return steps[-1] if steps else None
        if step not in steps:
            raise ValueError(f"checkpoint step {step} not found in "
                             f"{self.directory}; available: "
                             f"{steps or 'none'}")
        return step

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self.path(step), _SLICED_MANIFEST)) as f:
            return json.load(f)

    def _load_leaf(self, step: int, index: int, meta: dict) -> torch.Tensor:
        arr = np.load(os.path.join(self.path(step), f"t_{index:05d}.npy"))
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t

    def _note_reshard(self, step: int, saved: Optional[dict]) -> None:
        self.last_restore_reshard = None
        if saved is not None and self.mesh_info is not None \
                and saved != self.mesh_info:
            self.last_restore_reshard = {"step": step, "from": saved,
                                         "to": self.mesh_info}
            log.info("resharding checkpoint step %d: saved on %s -> "
                     "restoring into %s", step, saved, self.mesh_info)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint ``step`` (the latest when None) into ``state``
        in place and return its step, or None when there is none.  Only
        the exact-resume modes: an ``ema_bf16`` directory raises
        ``ValueError`` (:meth:`restore_ema` reads it)."""
        if self.mode == "ema_bf16":
            raise ValueError(
                f"restore() on a mode='ema_bf16' checkpoint directory "
                f"({self.directory}); use restore_ema() -- it holds no "
                "optimizer state")
        step = self._pick(step)
        if step is None:
            return None
        if self.mode == "full_sliced":
            return self._restore_sliced(state, step)
        # Loaded on the host: the loaders below move each tensor to its
        # parameter's device, and Adam's step counters stay on the host
        # where a fresh Adam keeps them.
        ckpt = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        names = [n for n, _ in state.model.named_parameters()]
        found = _full_leaves(ckpt, names)
        _preflight(found, _expected(state, any(
            n.startswith("adam.") for n, _, _ in found), self.placement),
            self.path(step), step)
        self._note_reshard(step, ckpt.get("mesh"))
        if self.placement is not None or any(
                _sharded(p) for p in state.model.parameters()):
            return self._restore_sharded(state, ckpt, step)
        state.model.load_state_dict(ckpt["model"])
        # The optimizer keeps its own kind (``capturable`` on the card):
        # a loaded state dict brings the saving optimizer's flags.
        opt = state.optimizer
        kinds = [{k: g[k] for k in ("capturable", "foreach") if k in g}
                 for g in opt.param_groups]
        opt.load_state_dict(ckpt["optim"])
        for group, kind in zip(opt.param_groups, kinds):
            group.update(kind)
            for p in group["params"]:
                st = opt.state.get(p, {})
                if kind.get("capturable") and "step" in st:
                    st["step"] = st["step"].to(p.device, torch.float32)
        settle_lr(opt)
        state.scheduler.load_state_dict(ckpt["sched"])
        with torch.no_grad():
            for name, t in ckpt["ema"].items():
                state.ema[name].copy_(t)
        state.step = int(ckpt["step"])
        return state.step

    def _restore_sharded(self, state: TrainState, ckpt: dict,
                         step: int) -> int:
        """``full`` into an FSDP state or a state split over a model axis:
        every tensor copied into this rank's block and chunk, Adam's state
        made as Adam makes it."""
        opt = state.optimizer
        with torch.no_grad():
            for name, t in state.model.state_dict().items():
                _copy_into(t, self._local(name, ckpt["model"][name]))
            for name, t in ckpt["ema"].items():
                _copy_into(state.ema[name], self._local(name, t))
            saved = ckpt["optim"]["state"]
            for i, (name, p) in enumerate(state.model.named_parameters()):
                st = saved.get(i, saved.get(str(i)))
                if not st:
                    continue
                opt.state[p] = {"step": st["step"].detach().clone().float()}
                for key in ("exp_avg", "exp_avg_sq"):
                    buf = torch.zeros_like(p)
                    _copy_into(buf, self._local(name, st[key]))
                    opt.state[p][key] = buf
        # The saved lr, as ``load_state_dict`` restores it on one process:
        # the next update takes it (the schedule moves it after).
        for group, saved in zip(opt.param_groups,
                                ckpt["optim"].get("param_groups", [])):
            if "lr" in saved:
                group["lr"] = saved["lr"]
        settle_lr(opt)
        state.scheduler.load_state_dict(ckpt["sched"])
        state.step = int(ckpt["step"])
        return state.step

    def _restore_sliced(self, state: TrainState, step: int) -> int:
        manifest = self._manifest(step)
        found = [(m["name"], tuple(m["shape"]), m["dtype"])
                 for m in manifest["leaves"]]
        with_adam = any(n.startswith("adam.") for n, _, _ in found)
        _preflight(found, _expected(state, with_adam, self.placement),
                   self.path(step), step)
        self._note_reshard(step, manifest.get("mesh"))
        targets = dict(state_leaves(state))
        opt = state.optimizer
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for i, meta in enumerate(manifest["leaves"]):
                name, src = meta["name"], self._load_leaf(step, i, meta)
                mine = (src if src.dim() == 0       # Adam's step count
                        else self._local(_param_name(name), src))
                if name in targets:
                    _copy_into(targets[name], mine)      # in place
                    continue
                # Adam has made no state yet: make it as Adam would.
                pname, key = name[len("adam."):].rsplit(".", 1)
                p = params[pname]
                if key == "step":
                    capturable = opt.param_groups[0].get("capturable",
                                                         False)
                    opt.state[p][key] = src.to(
                        p.device if capturable else "cpu", copy=True)
                else:
                    buf = torch.zeros_like(p)
                    _copy_into(buf, mine)
                    opt.state[p][key] = buf
            if not with_adam:
                # A checkpoint taken before the first update: Adam's
                # moments are zero, in place where they exist.
                for _, t in _adam_leaves(state):
                    t.zero_()
        set_schedule_step(state, int(manifest["schedule_step"]))
        state.step = int(manifest["step"])
        return state.step

    def restore_ema(self, params: Mapping[str, torch.Tensor],
                    step: Optional[int] = None, *,
                    raw: bool = False) -> Optional[int]:
        """Copy the EMA weights of checkpoint ``step`` (the latest when
        None) into ``params`` (parameter name -> tensor, e.g.
        ``dict(model.named_parameters())`` or a state's ``ema``) in place,
        upcast to their dtype; returns the step, or None when there is no
        checkpoint.  ``raw`` copies the trained (non-EMA) weights instead,
        which only the exact-resume modes hold."""
        if raw and self.mode == "ema_bf16":
            raise ValueError(
                f"{self.directory} is an ema_bf16 checkpoint: it has no raw "
                "parameters (--raw_params unavailable)")
        step = self._pick(step)
        if step is None:
            return None
        prefix = "model." if raw else "ema."
        stored = "bfloat16" if self.mode == "ema_bf16" else None
        place = self.placement
        want = sorted((prefix + k, tuple(v.shape) if place is None
                       else place.whole_shape(k, v.shape),
                       stored or _meta(v)[1]) for k, v in params.items())
        if self.mode == "full_sliced":
            manifest = self._manifest(step)
            picked = [(i, m) for i, m in enumerate(manifest["leaves"])
                      if m["name"].startswith(prefix)]
            _preflight([(m["name"], tuple(m["shape"]), m["dtype"])
                        for _, m in picked], want, self.path(step), step)
            tensors = {m["name"][len(prefix):]: self._load_leaf(step, i, m)
                       for i, m in picked}
        else:
            ckpt = torch.load(self.path(step), map_location="cpu",
                              weights_only=True)
            tensors = ckpt["model" if raw else "ema"]
            _preflight([(prefix + k, *_meta(v)) for k, v in tensors.items()],
                       want, self.path(step), step)
        with torch.no_grad():
            for name, t in tensors.items():
                _copy_into(params[name], self._local(name, t))
        return step
