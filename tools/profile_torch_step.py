#!/usr/bin/env python3
"""Where the PyTorch port's denoise step spends its time on the card.

Builds the full-width X-UNet of ``--config`` (srn64 or srn128; bf16, every
weight random from a seed),
and for each path (``--mode``: the reverse step replayed as a CUDA graph,
the eager step, or both in turn) runs one warm-up view (for the graph path:
its first step, the capture, the replays), one view of ``--steps`` reverse
steps of ``Sampler.synthesize`` (batch 2B=16 per model call) timed without
the profiler, then one under ``torch.profiler``, and prints one JSON line
per path: the wall time per denoise step (both ways), the device-busy share
of the profiled wall time, and device time per step by kernel group and for
the top kernels, read from the exported Chrome trace.  The card's name and
power limit are printed first, as ``nvidia-smi`` gives them.

Usage (on the machine with the card, from the repo root):
    python3 tools/profile_torch_step.py [--config srn64] [--steps 8] \
        [--mode both] [--trace build/profile/step_trace.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("groupnorm kernel", ("gn_fwd",)),
    ("attention kernel", ("flash_fwd",)),
    ("convolution", ("conv", "implicit", "dgrad", "wgrad", "nhwc", "fprop")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "sm90")),
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
    p.add_argument("--config", choices=["srn64", "srn128"], default="srn64")
    p.add_argument("--steps", type=int, default=8,
                   help="reverse steps in the profiled view (divides 256)")
    p.add_argument("--mode", choices=["both", "graph", "eager"],
                   default="both")
    p.add_argument("--trace", default="build/profile/step_trace.json")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.sampling import Sampler

    cfg = getattr(config_lib, f"{args.config}_config")()
    model = chip_smoke.random_model(cfg)
    views = chip_smoke.orbit_views(2, cfg.model.H, seed=3)
    modes = {"both": (True, False), "graph": (True,),
             "eager": (False,)}[args.mode]
    for graphs in modes:
        sampler = Sampler(model, cfg, device="cuda", steps=args.steps,
                          cuda_graphs=graphs)
        gen = torch.Generator("cuda").manual_seed(0)

        def view():              # one generated view, ends in a fetch
            sampler.synthesize(views, gen)

        view()                   # warm-up: kernels, cuDNN plans, capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            view()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        base, ext = os.path.splitext(args.trace)
        trace = f"{base}_{'graph' if graphs else 'eager'}{ext}"
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events
                   if e.get("cat") == "kernel" and "dur" in e]
        by_group, by_name = {}, {}
        for e in kernels:
            by_group[group_of(e["name"])] = by_group.get(
                group_of(e["name"]), 0.0) + e["dur"]
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        busy_us = float(np.sum([e["dur"] for e in kernels]))
        per = 1e-3 / args.steps              # us over the view -> ms/step
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "config": args.config, "cuda_graphs": graphs,
            "steps": args.steps,
            "wall_ms_per_step": 1e3 * wall / args.steps,
            "wall_ms_per_step_unprofiled": 1e3 * plain_wall / args.steps,
            "device_busy_ms_per_step": busy_us * per,
            "device_busy_share": busy_us * 1e-6 / wall,
            "kernel_launches_per_step": len(kernels) / args.steps,
            "ms_per_step_by_group": {k: v * per for k, v in
                                     sorted(by_group.items(),
                                            key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [[n[:90], v * per] for n, v in top],
        }), flush=True)
        del sampler


if __name__ == "__main__":
    main()
