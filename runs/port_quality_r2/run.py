#!/usr/bin/env python3
"""The port's quality run, held against the JAX package's
``runs/quality_r2`` (``RESULTS.md``, "Training run" and "Evaluation").

Trains the srn64 architecture at ``--ch 64 --emb_ch 512
--num_res_blocks 2`` (28.3M parameters), batch 32, on the ray-traced
synthetic scenes, in the reference run's two legs (the EMA half-life
changes at the step-6000 resume), scores the final EMA checkpoint with
``eval_cli`` on the training scenes, and writes a summary beside the
reference's numbers.  On one card, from the repo root:

    python3 runs/port_quality_r2/run.py [--out build/port_quality_r2]

Phases:
  1. host   -- seconds a batch of 32 takes the loader with every view
     ray-traced anew (a fresh dataset) and with every view already kept;
  2. leg 1  -- ``train_cli ... --steps 6000 --eval_every 1000`` (the
     default half-life), to its end;
  3. leg 2  -- ``train_cli ... --steps 20000 --ema_halflife_examples 50000
     --ckpt_every 5000 --eval_every 1000 --transfer``, stopped with SIGTERM
     once step ``--preempt_at`` is logged (the graceful path: exit 0, the
     exact step checkpointed), then
  4. leg 3  -- the same command again, resuming there, to step 20000;
  5. eval   -- ``eval_cli --synthetic_scenes --scenes_seed 0 --objects 4
     --max_views 8`` on the checkpoints (EMA, 256 steps, w = 0..7);
  6. profile -- the leg-2 configuration from a fresh directory for
     ``--profile_from + --profile_steps`` steps, the last
     ``--profile_steps`` under ``torch.profiler`` (``Trainer.train``'s
     ``profile_steps``): steps/s and the device's busy share (kernel time
     over the traced span) with the live data path;
  7. summary -- the train loss averaged over 1000-step windows and every
     val loss, the port's beside ``runs/quality_r2/metrics.jsonl``'s; the
     eval line beside ``runs/quality_r2/eval_train_final.jsonl``; steps/s;
     the legs; the card's name and power limit.

``metrics.jsonl``, ``eval_train_final.jsonl``, each leg's log and
``summary.json`` are copied to ``--out`` after each phase; the
checkpoints stay in the work directory.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
REF = os.path.join(ROOT, "runs", "quality_r2")
WIDTH = ["--config", "srn64", "--ch", "64", "--emb_ch", "512",
         "--num_res_blocks", "2"]
LEG1 = ["--synthetic_scenes", *WIDTH, "--batch", "32", "--steps", "6000",
        "--warmup_examples", "20000", "--eval_every", "1000"]
LEG2 = ["--synthetic_scenes", *WIDTH, "--batch", "32", "--steps", "20000",
        "--warmup_examples", "20000", "--ema_halflife_examples", "50000",
        "--ckpt_every", "5000", "--eval_every", "1000", "--transfer"]
EVAL = ["--synthetic_scenes", "--scenes_seed", "0", *WIDTH, "--objects",
        "4", "--max_views", "8"]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def host_batch_seconds(n: int = 4):
    """Seconds a loader batch of 32 takes: views ray-traced anew, then
    every view already kept."""
    from diff3d_tpu_torch.data import InfiniteLoader, SyntheticScenesDataset

    ds = SyntheticScenesDataset(num_objects=64, num_views=24, imgsize=64)
    loader = InfiniteLoader(ds, 32, num_workers=8)
    t0 = time.perf_counter()
    for s in range(n):
        fresh = SyntheticScenesDataset(num_objects=64, num_views=24,
                                       imgsize=64)
        loader.dataset = fresh
        loader.batch(s)
    uncached = (time.perf_counter() - t0) / n
    for o in range(64):
        for v in range(24):
            ds._view(o, v)
    loader.dataset = ds
    t0 = time.perf_counter()
    for s in range(20):
        loader.batch(s)
    cached = (time.perf_counter() - t0) / 20
    loader.close()
    return {"s_per_batch_rendered": uncached, "s_per_batch_kept": cached,
            "host_cpus": os.cpu_count()}


def train_cli(args, log_path):
    cmd = [sys.executable, "-m", "diff3d_tpu_torch.cli.train_cli", *args]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT)


def run_leg(name, args, workdir, out, preempt_at=None):
    """One leg; with ``preempt_at``, SIGTERM once that step is logged."""
    log_path = os.path.join(out, f"{name}.log")
    t0 = time.perf_counter()
    proc = train_cli(args + ["--workdir", workdir], log_path)
    sent = None
    metrics = os.path.join(workdir, "metrics.jsonl")
    while proc.poll() is None:
        time.sleep(2.0)
        if preempt_at is not None and sent is None:
            steps = [r["step"] for r in read_jsonl(metrics) if "loss" in r]
            if steps and steps[-1] >= preempt_at:
                proc.send_signal(signal.SIGTERM)
                sent = steps[-1]
    wall = time.perf_counter() - t0
    text = open(log_path).read()
    stopped = None
    for line in text.splitlines():
        if "preempted at step" in line:
            stopped = int(line.rsplit("step", 1)[1].split(";")[0])
    rec = {"leg": name, "argv": args, "rc": proc.returncode,
           "wall_s": wall, "sigterm_after_logged_step": sent,
           "preempted_at_step": stopped}
    print(json.dumps(rec), flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}: "
                           f"{text.splitlines()[-5:]}")
    if sent is not None and stopped is None:
        raise RuntimeError(f"{name}: SIGTERM did not stop it gracefully")
    return rec


def profile_window(workdir, start, steps):
    """The leg-2 configuration from a fresh directory: ``start + steps``
    steps, the last ``steps`` traced."""
    from diff3d_tpu_torch.cli import train_cli as cli

    shutil.rmtree(workdir, ignore_errors=True)
    argv = [a for a in LEG2 if a != "--transfer"]
    argv[argv.index("--steps") + 1] = str(start + steps)
    argv[argv.index("--ckpt_every") + 1] = "0"
    argv[argv.index("--eval_every") + 1] = "0"
    trainer = cli.build_trainer(cli.build_parser().parse_args(
        argv + ["--workdir", workdir]))
    t = []
    inner = trainer.step_fn

    def timed(state, batch, draws=None):
        m = inner(state, batch, draws)
        if state.step in (start, start + steps):
            float(m["loss"])                  # waits for the card
            t.append(time.perf_counter())
        return m

    trainer.step_fn = timed
    trainer.train(profile_steps=(start, start + steps))
    trainer.loader.close()
    (trace,) = glob.glob(os.path.join(workdir, "profile", "*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    timed_ev = [e for e in events if "ts" in e and "dur" in e]
    span_us = (max(e["ts"] + e["dur"] for e in timed_ev)
               - min(e["ts"] for e in timed_ev))
    busy_us = sum(e["dur"] for e in kernels)
    return {"steps": steps, "after_steps": start,
            "steps_per_s_profiled": steps / (t[1] - t[0]),
            "device_busy_ms_per_step": busy_us * 1e-3 / steps,
            "device_busy_share": busy_us / span_us,
            "kernels_per_step": len(kernels) / steps}


def windows(records, width=1000):
    """Mean train loss over ``(k - width, k]`` for k = width, 2 width..."""
    out = {}
    for r in records:
        if "loss" in r:
            k = -(-r["step"] // width) * width
            out.setdefault(k, []).append(r["loss"])
    return {k: sum(v) / len(v) for k, v in sorted(out.items())}


def summary(workdir, legs, host, prof):
    port = read_jsonl(os.path.join(workdir, "metrics.jsonl"))
    ref = read_jsonl(os.path.join(REF, "metrics.jsonl"))
    pw, rw = windows(port), windows(ref)
    pv = {r["step"]: r["val_loss"] for r in port if "val_loss" in r}
    rv = {r["step"]: r["val_loss"] for r in ref if "val_loss" in r}
    ev = read_jsonl(os.path.join(workdir, "eval_train_final.jsonl"))
    ref_ev = read_jsonl(os.path.join(REF, "eval_train_final.jsonl"))
    sps = [r["steps_per_sec"] for r in port
           if "loss" in r and r["step"] % 1000 not in (0, 50)]
    sps.sort()
    return {
        "card": card(), "legs": legs, "host": host, "profile": prof,
        "steps_per_s_median": sps[len(sps) // 2] if sps else None,
        "steps_per_s_p10_p90": ([sps[len(sps) // 10],
                                 sps[(9 * len(sps)) // 10]] if sps else None),
        "train_loss_1000_windows": {k: [pw.get(k), rw.get(k)]
                                    for k in sorted(set(pw) | set(rw))},
        "val_loss": {k: [pv.get(k), rv.get(k)]
                     for k in sorted(set(pv) | set(rv))},
        "eval": ev[-1] if ev else None,
        "eval_reference": ref_ev[-1] if ref_ev else None,
        "columns": "[port, reference runs/quality_r2]"}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=HERE)
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "port_quality_r2"),
                   help="where the records are copied")
    p.add_argument("--preempt_at", type=int, default=13000)
    p.add_argument("--profile_from", type=int, default=100)
    p.add_argument("--profile_steps", type=int, default=100)
    p.add_argument("--_profile", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    if args._profile:
        print(json.dumps(profile_window(
            os.path.join(ROOT, "build", "port_quality_profile"),
            args.profile_from, args.profile_steps)), flush=True)
        return

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("run.py: CUDA is not available")
    os.makedirs(args.out, exist_ok=True)
    print(card(), flush=True)
    wd = args.workdir
    for stale in ("metrics.jsonl", "eval_train_final.jsonl"):
        if os.path.exists(os.path.join(wd, stale)):
            raise SystemExit(f"{wd}/{stale} exists: a run is already there")
    shutil.rmtree(os.path.join(wd, "checkpoints"), ignore_errors=True)

    def save(extra):
        for name in ("metrics.jsonl", "eval_train_final.jsonl"):
            if os.path.exists(os.path.join(wd, name)):
                shutil.copy(os.path.join(wd, name), args.out)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(extra, f, indent=1)

    host = host_batch_seconds()
    print(json.dumps({"host": host}), flush=True)
    legs, prof, failed = [], None, None
    try:
        legs.append(run_leg("leg1", LEG1, wd, args.out))
        save({"legs": legs})
        legs.append(run_leg("leg2", LEG2, wd, args.out,
                            preempt_at=args.preempt_at))
        legs.append(run_leg("leg3", LEG2, wd, args.out))
        save({"legs": legs})
        t0 = time.perf_counter()
        with open(os.path.join(args.out, "eval.log"), "w") as log:
            rc = subprocess.run(
                [sys.executable, "-m", "diff3d_tpu_torch.cli.eval_cli",
                 "--model", os.path.join(wd, "checkpoints"), *EVAL, "--out",
                 os.path.join(wd, "eval_train_final.jsonl")],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT).returncode
        legs.append({"leg": "eval", "rc": rc,
                     "wall_s": time.perf_counter() - t0})
        if rc:
            raise RuntimeError(f"eval_cli exited {rc}")
    except Exception as e:          # the summary is written all the same
        failed = repr(e)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--_profile",
         "--profile_from", str(args.profile_from), "--profile_steps",
         str(args.profile_steps)], cwd=ROOT, capture_output=True, text=True)
    prof = (json.loads(out.stdout.strip().splitlines()[-1])
            if out.returncode == 0 else {"error": out.stderr[-2000:]})
    res = summary(wd, legs, host, prof)
    res["failed"] = failed
    save(res)
    print(json.dumps(res), flush=True)
    if failed:
        raise SystemExit(f"run.py: {failed}")


if __name__ == "__main__":
    main()
