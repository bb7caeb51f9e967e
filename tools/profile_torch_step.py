#!/usr/bin/env python3
"""Where the PyTorch port's srn64 denoise step spends its time on the card.

Builds the srn64 full-width X-UNet (bf16, every weight random from a seed),
runs one warm-up view, then one view of ``--steps`` reverse steps of
``Sampler.synthesize`` (batch 2B=16 per model call) under ``torch.profiler``,
and prints one JSON line: the wall time per denoise step, the device-busy
share of that wall time, and device time per step by kernel group and for
the top kernels, read from the exported Chrome trace.  The card's name and
power limit are printed first, as ``nvidia-smi`` gives them.

Usage (on the machine with the card, from the repo root):
    python3 tools/profile_torch_step.py [--steps 8] [--trace build/profile/step_trace.json]
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
    p.add_argument("--steps", type=int, default=8,
                   help="reverse steps in the profiled view (divides 256)")
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
    from diff3d_tpu_torch.sampling import Sampler

    cfg, model = chip_smoke.srn64_model()
    sampler = Sampler(model, cfg, device="cuda", steps=args.steps)
    views = chip_smoke.orbit_views(2, cfg.model.H, seed=3)
    gen = torch.Generator("cuda").manual_seed(0)

    def view():                  # one generated view, ends in a fetch
        sampler.synthesize(views, gen)

    view()                                   # warm-up: kernels, cuDNN plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    by_group, by_name = {}, {}
    for e in kernels:
        by_group[group_of(e["name"])] = by_group.get(
            group_of(e["name"]), 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_us = float(np.sum([e["dur"] for e in kernels]))
    per = 1e-3 / args.steps                  # us over the view -> ms/step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "steps": args.steps, "wall_ms_per_step": 1e3 * wall / args.steps,
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
