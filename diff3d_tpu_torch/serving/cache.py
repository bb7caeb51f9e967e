"""Caches for the inference service: captured graphs, weights, results
(counterpart: ``diff3d_tpu/serving/cache.py``).

Three independent layers, cheapest first:

  * :class:`ResultCache` — LRU over full request results keyed by content
    hash (inputs + seed + weights version); a copy of the JAX package's.
    The sampler is deterministic given the key, so a replayed request
    costs a dict lookup instead of ``steps * (n_views-1)`` model calls.
  * :class:`ProgramCache` — the executables are the samplers' captured
    CUDA graphs, one per ``(bucket, lanes)``: a key's first use runs the
    view's first reverse step eagerly and captures the step (timed as
    ``compile_s`` and counted in ``serving_program_compiles_total``),
    later uses replay it (``serving_program_hits_total``).  On the card
    the first use also records the bytes it added at its peak
    (``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``);
    a worker's admission gate takes these as its pins.  Cascade phase
    samplers ride a registry of their own keyed by the bucket's phase
    tag (:meth:`ProgramCache.register_phase`).
  * :class:`ParamsRegistry` — hot weight swap.  The captured graphs read
    the model's parameters at the addresses they had at capture, so a
    swap is an in-place ``copy_`` into the one model every sampler of
    the engine shares; it never recaptures.  The registry checks the new
    state dict against the template before anything is copied, and the
    engine applies a pending swap at the start of a view step, so one
    view step runs on one version.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diff3d_tpu_torch.diffusion import Draws


class ParamsRegistry:
    """Versioned weights of the engine's model, swapped in place."""

    def __init__(self, model: torch.nn.Module, version: str = "v0"):
        self._lock = threading.Lock()
        # The model's own tensors (state_dict shares their storage), and
        # their (shape, dtype): written once here, only read afterwards.
        self._live = model.state_dict()
        self._template = {k: (tuple(t.shape), t.dtype)
                          for k, t in self._live.items()}
        self._version = version  # guarded-by: self._lock
        self._applied = version  # guarded-by: self._lock
        self._pending: Optional[tuple] = None  # guarded-by: self._lock
        self.swaps = 0  # guarded-by: self._lock
        # Swaps copied into the model so far (the engine thread's
        # apply()); a phase adapter refreshes when it moves.
        self.applied = 0  # guarded-by: self._lock

    @property
    def version(self) -> str:
        """The newest version: the one every view step that starts from
        now on runs with."""
        with self._lock:
            return self._version

    def swap(self, state_dict: Dict[str, torch.Tensor],
             version: Optional[str] = None) -> str:
        """Stage new weights for every *subsequent* view step (a step in
        flight finishes on the old version).  Raises ``ValueError`` naming
        the first key whose presence, shape or dtype differs from the
        model's; then nothing is staged and the live weights stay as they
        were."""
        missing = sorted(set(self._template) - set(state_dict))
        extra = sorted(set(state_dict) - set(self._template))
        if missing or extra:
            raise ValueError(
                f"params key mismatch: missing {missing[:3]}, unexpected "
                f"{extra[:3]}")
        for k in sorted(self._template):
            got = (tuple(state_dict[k].shape), state_dict[k].dtype)
            if got != self._template[k]:
                raise ValueError(f"params {k!r} shape/dtype mismatch: {got} "
                                 f"!= {self._template[k]}")
        with self._lock:
            self.swaps += 1
            self._version = version or f"v{self.swaps}"
            self._pending = (self._version, dict(state_dict))
            return self._version

    def apply(self, publish: Optional[Callable[[str, dict], None]] = None
              ) -> str:
        """Copy a staged swap into the model (the engine's thread, between
        view steps) and return the version now live.  ``publish(version,
        state_dict)`` (the serving mesh's leader: it sends the swap to
        its followers) runs first, on a swap that is applied now.

        The engine issues its work on a stream of its own, so a staged
        device tensor is waited for first (the caller's stream may still
        be writing it), and the copies are waited for after (the caller's
        tensors may be freed and their memory reused once dropped)."""
        with self._lock:
            pending, self._pending = self._pending, None
            if pending is None:
                return self._applied
        # Only the engine thread applies, so the copies need no lock; a
        # swap staged meanwhile waits for the next view step.
        version, new = pending
        if publish is not None:
            publish(version, new)
        on_card = any(t.is_cuda for t in new.values())
        if on_card:
            torch.cuda.synchronize()
        with torch.no_grad():
            for k, t in new.items():
                self._live[k].copy_(t)
        if on_card:
            torch.cuda.current_stream().synchronize()
        with self._lock:
            self._applied = version
            self.applied += 1
            return self._applied


class ProgramCache:
    """Tracks the captured view-step graphs by ``(bucket, lanes)``.

    ``sampler`` may be a single :class:`~diff3d_tpu_torch.sampling.Sampler`
    or a dict ``{(sampler_kind, steps): Sampler}`` (the engine's schedule
    registry, all sharing one model): a bucket whose ``steps`` /
    ``sampler`` fields are set routes to the matching sampler, so the
    schedule rides the same key space as the shapes.  A bucket whose
    ``phase`` is set routes to the cascade phase sampler registered under
    it instead: a refine step takes a drafts operand, so it must never be
    reachable through the plain schedule space, even at equal shapes.
    """

    def __init__(self, sampler, metrics=None):
        if isinstance(sampler, dict):
            if not sampler:
                raise ValueError("ProgramCache: empty sampler dict")
            self._samplers = dict(sampler)
            self._sampler = next(iter(sampler.values()))
        else:
            self._samplers = {(sampler.sampler_kind, sampler.steps): sampler}
            self._sampler = sampler
        self._phase_samplers: Dict[str, object] = {}
        # Per-phase weight adapters (the draft phase's in-place refresh of
        # its resized pos_emb) and the registry generation each last ran
        # at, so a swap is adapted once, not every view step.
        self._phase_adapt: Dict[str, Callable[[], None]] = {}
        self._phase_adapted: Dict[str, int] = {}  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._programs: Dict[tuple, dict] = {}  # guarded-by: self._lock
        m = metrics
        self._compiles = m.counter(
            "serving_program_compiles_total",
            "distinct (bucket, lanes) graphs captured") if m else None
        self._hits = m.counter(
            "serving_program_hits_total",
            "view steps served by an already-captured graph") if m \
            else None

    def register_phase(self, phase: str, sampler,
                       adapt: Optional[Callable[[], None]] = None) -> None:
        """Attach a cascade phase sampler: buckets tagged ``phase``
        dispatch here instead of the schedule registry.  ``adapt``
        (optional) brings the phase's weights up to date with the served
        model's, in place; it runs on the engine thread before the
        phase's first step after each applied swap."""
        if phase not in ("draft", "refine"):
            raise ValueError(f"phase={phase!r} not in ('draft', 'refine')")
        self._phase_samplers[phase] = sampler
        if adapt is not None:
            self._phase_adapt[phase] = adapt

    def _adapt_phase(self, phase: str, generation: int) -> None:
        """Run ``phase``'s adapter once per registry generation."""
        adapt = self._phase_adapt.get(phase)
        if adapt is None:
            return
        with self._lock:
            if self._phase_adapted.get(phase) == generation:
                return
        adapt()
        with self._lock:
            self._phase_adapted[phase] = generation

    def _sampler_for(self, bucket):
        """The sampler serving ``bucket``'s schedule (the default sampler
        for an unresolved schedule; the phase registry for a cascade
        phase's bucket)."""
        if bucket.phase is not None:
            try:
                return self._phase_samplers[bucket.phase]
            except KeyError:
                raise KeyError(
                    f"no {bucket.phase!r} phase sampler (bucket "
                    f"{tuple(bucket)}); the engine should have rejected "
                    "this cascade at submit time") from None
        kind, steps = bucket.sampler, bucket.steps
        if kind is None and steps is None:
            return self._sampler
        key = (kind if kind is not None else self._sampler.sampler_kind,
               steps if steps is not None else self._sampler.steps)
        try:
            return self._samplers[key]
        except KeyError:
            raise KeyError(
                f"no sampler for schedule {key} (bucket {tuple(bucket)}); "
                "the engine should have rejected this at submit time")

    def step_many(self, bucket, lanes: int, record_imgs, record_R,
                  record_T, steps, K, draws, *, drafts=None,
                  generation: int = 0, agree=None):
        """One batched view step on device tensors (``Sampler.step_many``'s
        arguments: the pose buffers carry every view's pose, ``draws``
        one draw source per lane).  ``drafts`` is the refine phase's
        ``[N, B, H, W, 3]`` upsampled-draft operand (None elsewhere);
        ``generation`` the weights registry's count of applied swaps;
        ``agree`` the serving mesh's agreement step (``Sampler.
        step_many``'s).  Returns its ``(out, record_imgs, steps + 1)``."""
        sampler = self._sampler_for(bucket)
        if bucket.phase is not None:
            self._adapt_phase(bucket.phase, generation)
        key = (tuple(bucket), int(lanes))
        with self._lock:
            entry = self._programs.get(key)
            first = entry is None
            if first:
                entry = self._programs[key] = {
                    "compile_s": None, "capture_s": None, "uses": 0,
                    "steps": sampler.steps, "sampler": sampler.sampler_kind,
                    "phase": bucket.phase, "memory": None}
            entry["uses"] += 1
        if first and self._compiles:
            self._compiles.inc()
        if not first and self._hits:
            self._hits.inc()
        device = sampler.device
        card = first and device.type == "cuda"
        if card:
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        graphs_before = set(sampler.graphs)
        t0 = time.monotonic()
        kw = {} if drafts is None else {"drafts": drafts}
        if agree is not None:
            kw["agree"] = agree
        out = sampler.step_many(record_imgs, record_R, record_T, steps, K,
                                draws, **kw)
        if first:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            new = [g for k, g in sampler.graphs.items()
                   if k not in graphs_before]
            memory = None
            if card:
                peak = torch.cuda.max_memory_allocated(device)
                memory = {
                    "peak_bytes": peak - before,
                    "argument_bytes": sum(
                        int(t.numel() * t.element_size())
                        for t in (record_imgs, record_R, record_T, K)),
                    "max_memory_allocated": peak}
            with self._lock:
                entry["compile_s"] = time.monotonic() - t0
                entry["capture_s"] = new[0].capture_s if new else None
                entry["memory"] = memory
        return out

    def warmup(self, bucket, lanes: int, guidance_B: int) -> float:
        """Capture the ``(bucket, lanes)`` graph ahead of traffic on a
        throwaway record (identity poses and intrinsics) and a throwaway
        generator; returns the wall seconds spent (0 if already
        captured)."""
        key = (tuple(bucket), int(lanes))
        with self._lock:
            if key in self._programs:
                return 0.0
        sampler = self._sampler_for(bucket)
        device = sampler.device
        H, W, cap = tuple(bucket)[:3]
        N = int(lanes)
        eye = torch.eye(3, device=device)
        gen = torch.Generator(device).manual_seed(0)
        drafts = (torch.zeros((N, guidance_B, H, W, 3), device=device)
                  if bucket.phase == "refine" else None)
        t0 = time.monotonic()
        out, _, _ = self.step_many(
            bucket, lanes,
            torch.zeros((N, cap, guidance_B, H, W, 3), device=device),
            eye.expand(N, cap, 3, 3).contiguous(),
            torch.zeros((N, cap, 3), device=device), [1] * N,
            eye.expand(N, 3, 3).contiguous(), [Draws(gen)] * N,
            drafts=drafts)
        out.cpu()
        return time.monotonic() - t0

    def lower(self, bucket, lanes: int):
        """The ``(bucket, lanes)`` view-step program traced on fake tensors
        (nothing staged, nothing executed): the analysis hook.  It goes
        through the same routing as :meth:`step_many` (``_sampler_for``),
        so the traced program is the one :meth:`warmup` captures;
        returns :meth:`Sampler.lower_step_many`'s
        :class:`~diff3d_tpu_torch.analysis.ir.Program`."""
        sampler = self._sampler_for(bucket)
        H, W, cap = tuple(bucket)[:3]
        return sampler.lower_step_many(int(lanes), int(cap), H=int(H),
                                       W=int(W))

    def supported_schedules(self) -> list:
        """Sorted ``"kind:steps"`` strings of the routable samplers."""
        return sorted(f"{k[0]}:{k[1]}" for k in self._samplers)

    def stats(self, include_memory: bool = False) -> dict:
        """Per program: uses, first-use seconds (``compile_s``), the
        capture's seconds, the schedule, and with ``include_memory`` the
        bytes its first use added at its peak (``peak_bytes``; None off
        the card), the staged inputs' bytes and the card's
        ``max_memory_allocated`` then.  Reads recorded values only; it
        never touches the device."""
        default = (self._sampler.sampler_kind, self._sampler.steps)

        def name(k):
            b, lanes = k
            s = f"H{b[0]}xW{b[1]}xcap{b[2]}"
            kind, steps = (b[4], b[3]) if len(b) >= 5 else (None, None)
            if ((kind is not None or steps is not None)
                    and (kind, steps) != default):
                s += (f"x{kind or 'default'}"
                      f"{steps if steps is not None else ''}")
            if len(b) >= 6 and b[5] is not None:
                s += f"x{b[5]}"      # cascade phase tag
            return s + f"xlanes{lanes}"

        def mem(v, field):
            if not include_memory or v["memory"] is None:
                return None
            return v["memory"][field]

        with self._lock:
            return {
                "programs": {
                    name(k): {
                        "uses": v["uses"],
                        "compile_s": v["compile_s"],
                        "capture_s": v["capture_s"],
                        "steps": v["steps"],
                        "sampler": v["sampler"],
                        "phase": v["phase"],
                        "peak_bytes": mem(v, "peak_bytes"),
                        "argument_bytes": mem(v, "argument_bytes"),
                        "max_memory_allocated": mem(
                            v, "max_memory_allocated"),
                    } for k, v in self._programs.items()
                },
                "num_programs": len(self._programs),
                "supported_schedules": self.supported_schedules(),
            }


class ResultCache:
    """Thread-safe LRU of completed request results.

    Keys come from :meth:`ViewRequest.content_key` (inputs + seed + params
    version); values are the ``[n_views-1, B, H, W, 3]`` output arrays.
    ``capacity=0`` disables caching entirely.
    """

    def __init__(self, capacity: int = 32, metrics=None):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, np.ndarray]" = (
            OrderedDict())  # guarded-by: self._lock
        m = metrics
        self._hit_ctr = m.counter(
            "serving_result_cache_hits_total",
            "requests answered from the result cache") if m else None

    def get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            val = self._entries.get(key)
            if val is not None:
                self._entries.move_to_end(key)
                if self._hit_ctr:
                    self._hit_ctr.inc()
            return val

    def put(self, key: str, value: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
