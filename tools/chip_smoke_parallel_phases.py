"""``chip_smoke.py``'s multi-rank phases alone, on the card: ``parallel``
(with the gloo ranks of ``tensor_parallel``, ``context_parallel`` and
``serve_mesh``), then those three phases, after the phases whose outputs
they read (``device``, ``build``, ``train_graph``, ``train``).

Run it with the root of a checkout as the working directory (that
checkout's ``chip_smoke.py`` is the one imported), e.g. to compare two
trees in one call, each unpacked with ``git archive`` into a directory
of its own under ``build/``::

    (cd build/tree_a && python3 ../../tools/chip_smoke_parallel_phases.py)

It prints every phase's line as ``chip_smoke.py`` does, then
``PHASES_S <seconds>``: the wall seconds from the start of ``parallel``
to the end of ``serve_mesh``.
"""

import gc
import os
import shutil
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    cs.phase_device()
    cs.phase_build()
    graph_run = cs.phase_train_graph(cs.TRAIN_ACCUM)
    cs.phase_train(cs.TRAIN_ACCUM)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, tp_run, cp_run, mesh_run = cs.phase_parallel(graph_run)
    del graph_run
    cs.phase_tensor_parallel(*tp_run)
    cs.phase_context_parallel(*cp_run)
    cs.phase_serve_mesh(*mesh_run, {})
    print("PHASES_S", round(time.perf_counter() - t0, 3), flush=True)
    shutil.rmtree(cs.WORKDIR, ignore_errors=True)


if __name__ == "__main__":
    main()
