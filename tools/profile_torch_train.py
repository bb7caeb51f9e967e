#!/usr/bin/env python3
"""Where the PyTorch port's train step spends its time on the card, and
how much memory it takes.

For each path (``--mode``: the step as CUDA graphs, the eager step, or
both in turn, one trainer at a time) builds the trainer through
``cli/train_cli.py``'s code path (synthetic dataset, ``--config`` srn64 or
srn128 at full width, srn128 with every block rematerialised under
``--remat_policy``, global batch ``--batch`` in ``--accum``
microbatches), takes ``--warmup``
steps (on the graph path the first is eager and ends in the capture),
``--steps`` steps timed without the profiler, then ``--steps`` steps under
``torch.profiler``, and prints one JSON line per path: wall seconds per
step (both ways), examples/s, the peak device memory over the run, the
device-busy share of the profiled wall time, and device time per step by
kernel group and for the top kernels, read from the exported Chrome
trace.  The card's
name and power limit are printed first, as ``nvidia-smi`` gives them.  A
microbatch that does not fit ends the run with CUDA's out-of-memory
error.  ``--distill K`` profiles the progressive-distillation step
(``train/distill.py``) at ``K`` student steps instead: the trainer's
state is the student, a second X-UNet with its weights the teacher, the
whole batch one microbatch.

Usage (on the machine with the card, from the repo root):
    python3 tools/profile_torch_train.py [--config srn64] [--accum 1] \
        [--steps 2] [--mode both] [--trace build/profile/train_trace.json]
    python3 tools/profile_torch_train.py --config srn128 --accum 2 \
        --mode graph
    python3 tools/profile_torch_train.py --distill 2
"""

from __future__ import annotations

import argparse
import gc
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
    p.add_argument("--config", choices=["srn64", "srn128"], default="srn64")
    p.add_argument("--remat_policy", choices=["nothing", "dots"],
                   default=None, help="srn128's remat policy (default: "
                                      "the config's)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--workdir", default="build/profile_train")
    p.add_argument("--mode", choices=["both", "graph", "eager"],
                   default="both")
    p.add_argument("--trace", default="build/profile/train_trace.json")
    p.add_argument("--distill", type=int, default=None, metavar="K",
                   help="profile the distill step at K student steps")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.getcwd())
    modes = {"both": (True, False), "graph": (True,),
             "eager": (False,)}[args.mode]
    for graphs in modes:
        profile_one(args, graphs)
        gc.collect()
        torch.cuda.empty_cache()


def profile_one(args, graphs: bool) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diff3d_tpu_torch.cli import train_cli

    shutil.rmtree(args.workdir, ignore_errors=True)
    n = args.warmup + 2 * args.steps
    policy = ([] if args.remat_policy is None
              else ["--remat_policy", args.remat_policy])
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args([
        "--synthetic", "--config", args.config, "--batch", str(args.batch),
        "--accum", str(args.accum), "--steps", str(n),
        "--warmup_examples", str(10 * args.batch), "--ckpt_every", "0",
        "--workdir", args.workdir] + policy
        + ([] if graphs else ["--eager"])))
    step_fn = trainer.step_fn
    if args.distill:
        from diff3d_tpu_torch.models import XUNet
        from diff3d_tpu_torch.train import make_distill_step

        teacher = XUNet(trainer.cfg.model).cuda().eval()
        teacher.requires_grad_(False)
        teacher.load_state_dict(trainer.state.model.state_dict())
        step_fn = make_distill_step(trainer.cfg, cuda_graphs=graphs)

    def one():
        if args.distill:
            step_fn(trainer.state, teacher, next(trainer.loader),
                    args.distill)
        else:
            step_fn(trainer.state, next(trainer.loader))

    # Every step is called directly: no checkpoint falls in the run.
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.warmup):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trainer_cfg = trainer.cfg
    trainer.loader.close()
    step_fn.release()
    del trainer
    shutil.rmtree(args.workdir, ignore_errors=True)
    base, ext = os.path.splitext(args.trace)
    trace = f"{base}_{'graph' if graphs else 'eager'}{ext}"
    os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
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
    mcfg = trainer_cfg.model
    print(json.dumps({
        "config": args.config, "distill_student_steps": args.distill,
        "remat": mcfg.remat,
        "remat_policy": mcfg.remat_policy if mcfg.remat else None,
        "cuda_graphs": graphs, "batch": args.batch, "accum": args.accum,
        "steps": args.steps, "wall_s_per_step": wall / args.steps,
        "wall_s_per_step_unprofiled": plain_wall / args.steps,
        "examples_per_s": args.batch * args.steps / plain_wall,
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
