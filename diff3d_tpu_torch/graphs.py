"""A step body captured as a CUDA graph: the port's counterpart of the
JAX package's compiled programs (a jitted train step, the sampler's
``lax.scan`` body).

:class:`StepGraph` captures a function once and replays it; the function
must read every input from tensors whose addresses stay fixed (static
buffers filled before each replay) and must not wait for the device.
Its caller runs the body eagerly at least once before the capture, so
that the kernels' one-time setup (``cudaFuncSetAttribute``, cuDNN and
cuBLAS plans, lazily built state such as Adam's moments) happens outside
it.  A failed capture raises; nothing falls back to eager execution.

The kernel wrappers count their launches in Python, so a capture would
count the captured launches once and a replay not at all.  A capture
therefore puts the counts back where they were and keeps the captured
launches per kernel in :attr:`StepGraph.captured`; what ran on the card
is the wrappers' counts plus ``captured x replays`` of every graph
(:func:`graph_launches`).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from diff3d_tpu_torch.ops import launch_counts, set_launch_counts


class StepGraph:
    """``body`` captured as one CUDA graph.

    Args:
      body: the function to capture; it takes no arguments.
      generators: ``torch.Generator`` objects ``body`` draws from; each
        is registered with the graph, so a replay advances it as an eager
        call would, and reseeding it before a replay gives the draws of
        an eager call from the same seed.
      pool: a memory pool to share with another graph (``.pool()``).
    """

    def __init__(self, body: Callable[[], object], *,
                 generators: Sequence[torch.Generator] = (),
                 pool=None):
        if not torch.cuda.is_available():
            raise RuntimeError("StepGraph: CUDA graphs need a CUDA device")
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        # Garbage of the eager warm-up (the reference cycles of
        # torch.utils.checkpoint's frames hold a rematerialised step's
        # activations until a collection) would otherwise stay allocated
        # beside the graph's pool.
        gc.collect()
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool):
            self.output = body()
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        after = launch_counts()
        set_launch_counts(before)          # nothing launched while capturing
        self.captured: Dict[str, int] = {
            k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.replays = 0

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def graph_launches(graphs: Iterable[Optional[StepGraph]]) -> Dict[str, int]:
    """Kernel launches that replays of ``graphs`` ran: ``captured x
    replays``, summed per kernel."""
    out: Dict[str, int] = {}
    for g in graphs:
        if g is None:
            continue
        for k, n in g.captured.items():
            out[k] = out.get(k, 0) + n * g.replays
    return out


def use_cuda_graphs(cuda_graphs: Optional[bool],
                    device: torch.device) -> bool:
    """Resolve an entry point's ``cuda_graphs`` argument: ``None`` means
    graphs on a CUDA device and eager elsewhere; ``True`` off a CUDA
    device raises."""
    if cuda_graphs is None:
        return device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, not "
                         f"{device}")
    return bool(cuda_graphs)
