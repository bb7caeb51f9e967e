#!/usr/bin/env python3
"""Where the PyTorch port's srn64 train step spends its time on the card,
and how much memory it takes.

Builds the trainer through ``cli/train_cli.py``'s code path (synthetic
dataset, srn64 at full width, global batch ``--batch`` in ``--accum``
microbatches), takes ``--warmup`` steps, then ``--steps`` steps under
``torch.profiler``, and prints one JSON line: wall seconds per step,
examples/s, the peak device memory over the run, the device-busy share
of the profiled wall time, and device time per step by kernel group and
for the top kernels, read from the exported Chrome trace.  The card's
name and power limit are printed first, as ``nvidia-smi`` gives them.  A
microbatch that does not fit ends the run with CUDA's out-of-memory
error.

Usage (on the machine with the card, from the repo root):
    python3 tools/profile_torch_train.py [--accum 1] [--steps 2] \
        [--trace build/profile/train_trace.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("groupnorm backward kernel", ("gn_bwd",)),
    ("groupnorm kernel", ("gn_fwd",)),
    ("attention backward kernels", ("flash_bwd",)),
    ("attention kernel", ("flash_fwd",)),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "nhwc", "fprop")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "sm90")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("cast / copy", ("copy", "cast", "convert")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--workdir", default="build/profile_train")
    p.add_argument("--trace", default="build/profile/train_trace.json")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.getcwd())
    from diff3d_tpu_torch.cli import train_cli

    shutil.rmtree(args.workdir, ignore_errors=True)
    n = args.warmup + args.steps
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args([
        "--synthetic", "--config", "srn64", "--batch", str(args.batch),
        "--accum", str(args.accum), "--steps", str(n),
        "--warmup_examples", str(10 * args.batch), "--ckpt_every", "0",
        "--workdir", args.workdir]))
    # The warm-up ends in train()'s last-step checkpoint; the profiled
    # steps call the step directly, so no save falls inside the window.
    torch.cuda.reset_peak_memory_stats()
    trainer.train(max_steps=args.warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.step_fn(trainer.state, next(trainer.loader))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trainer.loader.close()
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    by_group, by_name = {}, {}
    for e in kernels:
        g = group_of(e["name"])
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_us = float(np.sum([e["dur"] for e in kernels]))
    per = 1e-3 / args.steps                  # us over the window -> ms/step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "batch": args.batch, "accum": args.accum, "steps": args.steps,
        "wall_s_per_step": wall / args.steps,
        "examples_per_s": args.batch * args.steps / wall,
        "max_memory_allocated": peak,
        "device_busy_ms_per_step": busy_us * per,
        "device_busy_share": busy_us * 1e-6 / wall,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "ms_per_step_by_group": {k: v * per for k, v in
                                 sorted(by_group.items(),
                                        key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n[:90], v * per] for n, v in top],
    }), flush=True)


if __name__ == "__main__":
    main()
