"""Serving over a mesh of ranks: the leader/follower view-step loop.

In the JAX package one process drives every device of the serving mesh
(``serve_cli --mesh``, a ``worker_cli --devices 0-3`` slice).  Here each
rank is a process of its own, and a rank may run only in lock step with
the others: every rank enters the same collectives in the same order on
the same inputs.  The engine's decisions depend on time and traffic
(admission, the max-wait flush, retries, the watchdog, weight swaps), so
they are taken on rank 0 alone, the *leader*, and reach the others, the
*followers*, as messages of one ordered stream:

  * ``("plan", StepPlan, ticket)`` -- one attempt at one view step: the
    bucket, the lane count, the padded records, poses, intrinsics and
    record lengths, the refine phase's drafts, each live lane's generator
    state (or the draw source its request brought), the padding lanes'
    seed and the weights generation; the ticket of the leader's turn
    (``engine._Turns``) that runs it.  Every rank runs
    its share of the lanes through the same ``ProgramCache.step_many``
    (``Sampler._view_split``: rank ``r`` takes lanes ``[r m, (r+1) m)`` of
    ``m = lanes / world``) and the views are all-gathered there.  A retry
    restores the saved generator states and sends the plan again, so the
    plan goes out once per *attempt* and every rank redraws the same
    noise.
  * ``("warmup", bucket, lanes, ticket)`` -- capture a graph ahead of
    traffic, on every rank at once (a follower that captured on first
    traffic would put its capture inside the leader's watchdog budget).
  * ``("swap", version, layout)`` then the state dict's bytes -- the
    leader's pending weights, sent as it applies them at the start of a
    view step, so the swap lands between the same two view steps on every
    rank.
  * ``("stats",)`` -- every rank's program statistics gathered (the
    worker's admission pins are the largest first-use bytes over the
    ranks).
  * ``("tick",)`` -- the leader is idle and alive.  ``("stop",)``.

Between computing its share and the views' gather every rank reports to
the others (:meth:`RankChannel.agree`): whether its share failed (and
whether the failure is transient), and the generator states its lanes
reached.  A failure on any rank fails the attempt on every rank before
anyone enters the gather, so the leader's retry finds every follower
waiting for the next message; the states let the leader's slots follow
lanes that another rank ran.

Several in-process replicas serve over one mesh (``serve_cli --mesh
--replicas N``, :func:`~diff3d_tpu_torch.serving.fleet.build_fleet`),
each over every rank: each replica has a channel of its own (its own gloo
group, its own message counts, its name in its log lines and
:class:`MeshBroken` messages) and, past the first, a group of its own for
its views' gathers (``gather_group``, which its engine gives its
samplers), so two replicas' messages and gathers never pair with each
other's.  Every group is built on every rank in the same order, at boot,
before any engine thread starts (``dist.new_group`` is collective).  The
engines of one card take turns (``engine.device_turns``); the plans and
warm-ups carry the leader's ticket of its turn, and a follower's turn
admits them in that order (``engine._Turns.ordered``), so every rank
runs the replicas' steps in one order and no rank waits in one
replica's collective while holding the card another replica's peer
needs.

The messages travel over a gloo group of their own (host-side, like
``MeshEnv.cpu_world_group``, but with the serving timeout on every
collective: a rank that stops answering fails the collective within
``TIMEOUT_S`` instead of the process group's default of 30 minutes).  A
rank that dies closes its sockets, and gloo fails the peers' pending
collective at once ("Connection closed by peer"); the channel then
raises :class:`MeshBroken` and refuses every later message.  The leader
sends a tick every ``TICK_S`` while idle, so a follower's receive never
waits on a live but silent leader.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diff3d_tpu_torch.runtime.retry import is_transient_backend_error

log = logging.getLogger(__name__)

#: Every collective of the serving group fails after this many seconds
#: (a view step's first use, which captures its graph, included).
TIMEOUT_S = 120.0
#: The idle leader's heartbeat period.
TICK_S = 1.0


class MeshBroken(RuntimeError):
    """A collective of the serving group failed: a rank died, or stopped
    answering within the timeout.  The mesh cannot serve again."""


class RankStepFailed(RuntimeError):
    """Another rank's share of a view step failed (raised on every rank
    that did not fail itself).  ``transient``: every failing rank judged
    its error retryable."""

    def __init__(self, msg: str, transient: bool):
        super().__init__(msg)
        self.transient = bool(transient)


@dataclasses.dataclass
class StepPlan:
    """One attempt at one view step, as the leader built it (host data
    only: it is pickled to the followers)."""

    bucket: Any
    lanes: int
    n: int                      # live lanes; the rest pad
    record_imgs: np.ndarray     # [lanes, capacity, B, H, W, 3]
    record_R: np.ndarray
    record_T: np.ndarray
    K: np.ndarray
    steps: List[int]
    drafts: Optional[np.ndarray]
    gen_states: List[Optional[torch.Tensor]]   # per live lane
    # Per live lane, the request's own draw source for this view (a
    # request that brought its draws, ``ViewRequest.draws``); None where
    # the lane draws from its generator.  Pickled with the plan, so the
    # rank that runs the lane replays it.
    draws: List[Optional[Any]]
    pad_seed: int
    generation: int             # weight swaps applied before this step


def state_digest(state: Dict[str, torch.Tensor]) -> str:
    """sha256 over a state dict's keys, dtypes, shapes and bytes."""
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().to("cpu").contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


class RankChannel:
    """The leader's stream of plans and control messages to its followers
    (see the module docstring), over a gloo group of every rank of
    ``mesh`` (a serving mesh: the data axis over every rank, a model axis
    of one).  Built on every rank, in the same order (it makes a group).

    ``name`` (a replica's) goes into its log lines and errors.  With
    ``own_gather`` it also makes :attr:`gather_group`, a group over the
    data axis of its own (the mesh's backend) that the replica's samplers
    gather their views over; without it (one replica on the mesh) they
    gather over the mesh's group, as ``Sampler(mesh)`` does anywhere."""

    def __init__(self, mesh, name: Optional[str] = None,
                 own_gather: bool = False):
        if mesh.device_mesh is None:
            raise ValueError("a serving mesh needs a process group: "
                             "launch the ranks with torchrun")
        if mesh.model_size != 1:
            raise ValueError(
                f"a serving mesh splits the lanes over its data axis; a "
                f"model axis of {mesh.model_size} ranks is not served")
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if mesh.data_size != self.world:
            raise ValueError(f"the serving mesh's data axis ({mesh.data_size}"
                             f") must span every rank ({self.world})")
        self.name = name
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
        #: The group this replica's views are gathered over (None: the
        #: mesh's own).
        self.gather_group = None
        if own_gather:
            self.gather_group = dist.new_group(
                ranks=dist.get_process_group_ranks(mesh.group),
                backend=dist.get_backend(mesh.group))
        # One collective at a time (the engine thread's plans, the boot's
        # and the stop's messages never overlap, but the order must hold).
        self._io = threading.Lock()
        self._lock = threading.Lock()
        self._broken: Optional[str] = None  # guarded-by: self._lock
        self._stopped = False  # guarded-by: self._lock
        self._last_send = time.monotonic()  # guarded-by: self._lock
        #: Messages sent (leader) or received (follower), by kind.
        self.counts: Dict[str, int] = {}  # guarded-by: self._lock

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def owned(self, lanes: int) -> range:
        """The lanes this rank runs of a ``lanes``-lane step."""
        m = lanes // self.world
        return range(self.rank * m, (self.rank + 1) * m)

    @property
    def label(self) -> str:
        """``"serving mesh"``, with the replica's name when it has one."""
        return ("serving mesh" if self.name is None
                else f"serving mesh ({self.name})")

    def snapshot(self) -> dict:
        """The channel's block of a replica's ``/fleet`` and ``/stats``
        entry: its name, this rank, the ranks, the messages by kind and
        why it broke (None while it serves).  Host reads only."""
        with self._lock:
            return {"name": self.name, "rank": self.rank,
                    "mesh_ranks": self.world, "messages": dict(self.counts),
                    "broken": self._broken}

    @property
    def broken(self) -> Optional[str]:
        """Why the mesh broke (None while it serves)."""
        with self._lock:
            return self._broken

    @contextlib.contextmanager
    def _collective(self, what: str):
        """One collective at a time; any failure breaks the mesh for
        good."""
        with self._io:
            why = self.broken
            if why is not None:
                raise MeshBroken(f"broken earlier: {why}")
            try:
                yield
            except Exception as e:  # noqa: BLE001 - any failure is fatal
                why = f"{self.label}: {what} on rank {self.rank}: {e}"
                with self._lock:
                    self._broken = why
                raise MeshBroken(why) from e

    def _count(self, kind: str) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1

    # -- the leader's side -------------------------------------------------

    def send(self, msg: tuple) -> None:
        """Broadcast one message to the followers (leader only)."""
        if not self.leader:
            raise RuntimeError("only the leader sends")

        with self._collective(f"send {msg[0]}"):
            dist.broadcast_object_list([msg], src=0, group=self.group)
        with self._lock:
            self._last_send = time.monotonic()
        self._count(msg[0])

    def tick(self) -> None:
        """A heartbeat if nothing was sent for ``TICK_S``."""
        with self._lock:
            due = time.monotonic() - self._last_send >= TICK_S
        if due:
            self.send(("tick",))

    def stop(self) -> None:
        """Tell the followers to leave their loop (once; skipped on a
        broken mesh, whose followers leave by themselves)."""
        with self._lock:
            if self._stopped or self._broken is not None:
                return
            self._stopped = True
        self.send(("stop",))

    def send_state(self, version: str,
                   state: Dict[str, torch.Tensor]) -> None:
        """A staged weight swap to the followers: its layout, then one
        flat buffer per dtype (leader only; :meth:`recv_state` takes
        it)."""
        layout = self._layout(state)
        self.send(("swap", version, layout))
        self._send_flat(state, layout)

    @staticmethod
    def _layout(state) -> list:
        return [(k, str(state[k].dtype).replace("torch.", ""),
                 tuple(state[k].shape)) for k in sorted(state)]

    def _send_flat(self, state, layout) -> None:
        by_dtype: Dict[str, list] = {}
        for k, dt, _ in layout:
            by_dtype.setdefault(dt, []).append(
                state[k].detach().to("cpu").reshape(-1))
        for _, parts in sorted(by_dtype.items()):
            with self._collective("state payload"):
                dist.broadcast(torch.cat(parts), src=0, group=self.group)

    def gather_stats(self, own: Any) -> List[Any]:
        """Every rank's ``own`` (leader: sends ``("stats",)`` first; each
        follower answers with its own in :meth:`gather`)."""
        self.send(("stats",))
        return self.gather(own)

    # -- the followers' side -----------------------------------------------

    def recv(self) -> tuple:
        """The next message from the leader (followers only)."""
        if self.leader:
            raise RuntimeError("the leader does not receive")
        box = [None]
        with self._collective("receive"):
            dist.broadcast_object_list(box, src=0, group=self.group)
        self._count(box[0][0])
        return box[0]

    def recv_state(self, layout) -> Dict[str, torch.Tensor]:
        """The state :meth:`_send_flat` sends in ``layout`` (a swap, after
        its ``("swap", version, layout)``)."""
        sizes: Dict[str, int] = {}
        for _, dt, shape in layout:
            sizes[dt] = sizes.get(dt, 0) + int(np.prod(shape, dtype=np.int64))
        flat = {}
        for dt in sorted(sizes):
            buf = torch.empty(sizes[dt], dtype=getattr(torch, dt))
            with self._collective("state payload"):
                dist.broadcast(buf, src=0, group=self.group)
            flat[dt] = buf
        out, at = {}, {dt: 0 for dt in flat}
        for k, dt, shape in layout:
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = flat[dt][at[dt]:at[dt] + n].view(shape)
            at[dt] += n
        return out

    # -- every rank ----------------------------------------------------------

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        got: List[Any] = [None] * self.world
        with self._collective("gather"):
            dist.all_gather_object(got, obj, group=self.group)
        return got

    def agree(self, err: Optional[BaseException],
              states: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Every rank's verdict on its share of one attempt (``err`` None:
        it ran) and the generator states its lanes reached.  Raises this
        rank's own ``err``, or :class:`RankStepFailed` when another rank
        failed; otherwise returns every rank's lane states."""
        report = (None if err is None else (
            f"{type(err).__name__}: {err}".splitlines()[0][:300],
            is_transient_backend_error(err)), states)
        got = self.gather(report)
        if err is not None:
            raise err
        failed = [(r, rep[0]) for r, rep in enumerate(got)
                  if rep[0] is not None]
        if failed:
            raise RankStepFailed(
                "; ".join(f"rank {r}: {why}" for r, (why, _) in failed),
                transient=all(t for _, (_, t) in failed))
        merged: Dict[int, torch.Tensor] = {}
        for _, lane_states in got:
            merged.update(lane_states)
        return merged

    def sync_weights(self, model: torch.nn.Module) -> str:
        """Rank 0's weights copied into every rank's ``model`` in place
        (captured graphs keep their addresses), then every rank's digest
        gathered: a rank that holds other weights fails the boot.
        Returns the digest."""
        state = model.state_dict()
        layout = self._layout(state)
        if self.leader:
            self._send_flat(state, layout)
        else:
            with torch.no_grad():
                for k, t in self.recv_state(layout).items():
                    state[k].copy_(t)
        return self.check_weights(model)

    def check_weights(self, model: torch.nn.Module) -> str:
        """Every rank's digest of ``model``'s state gathered: a rank that
        holds other weights than rank 0 fails the boot.  Returns the
        digest."""
        digest = state_digest(model.state_dict())
        digests = self.gather(digest)
        if len(set(digests)) != 1:
            raise RuntimeError(f"{self.label}: the ranks hold different "
                               f"weights (digests {digests})")
        return digest


def watch_parent(parent_pid: int, poll_s: float = 0.5) -> threading.Thread:
    """Exit this process (code 3) once ``parent_pid`` is no longer its
    parent: a follower whose leader died must not keep its card, even
    while it waits inside a collective."""
    def watch():
        while True:
            if os.getppid() != parent_pid:
                log.error("leader %d gone: follower exits", parent_pid)
                os._exit(3)
            time.sleep(poll_s)

    t = threading.Thread(target=watch, name="diff3d-serving-parent-watch",
                         daemon=True)
    t.start()
    return t


def lane_generators(states: Sequence[Optional[torch.Tensor]],
                    device: torch.device) -> List[Optional[torch.Generator]]:
    """Generators on ``device`` at the plan's lane states."""
    gens = []
    for st in states:
        g = None
        if st is not None:
            g = torch.Generator(device)
            g.set_state(st)
        gens.append(g)
    return gens


__all__ = ["TICK_S", "TIMEOUT_S", "MeshBroken", "RankChannel",
           "RankStepFailed", "StepPlan", "lane_generators", "state_digest",
           "watch_parent"]
