#!/usr/bin/env python3
"""The srn64 end-to-end numbers of one checkout, for comparing two
commits in one call on the card: ``chip_smoke.py``'s ``sampler_graph``
phase (one view graph and eager) and ``train`` phase (the ``Trainer`` at
global batch 128 as CUDA graphs, then a resume), run from the checkout's
own ``chip_smoke.py``; prints one ``AB {...}`` line.

Usage (on the machine with the card; unpack the parent with ``git
archive`` into a git-ignored directory, then run parent, change, change,
parent, one process each):
    for d in build/parent . . build/parent; do
        python3 tools/ab_srn64.py $d; done
"""

import json
import os
import shutil
import sys


def main() -> None:
    d = os.path.abspath(sys.argv[1])
    os.chdir(d)
    sys.path.insert(0, d)
    import torch

    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    cfg, model = cs.srn64_model()
    sg = cs.phase_sampler_graph(cfg, model)
    del model
    torch.cuda.empty_cache()
    tr = cs.phase_train(1)
    shutil.rmtree(cs.WORKDIR, ignore_errors=True)
    print("AB", json.dumps({
        "dir": sys.argv[1], "graph_ms_per_step": sg["graph_ms_per_step"],
        "graph_first_view": sg["graph_ms_per_step_first_view"],
        "eager_ms": sg["eager_ms_per_step"],
        "train_s_per_step": tr["s_per_step"], "train_step_s": tr["step_s"]}),
        flush=True)


if __name__ == "__main__":
    main()
