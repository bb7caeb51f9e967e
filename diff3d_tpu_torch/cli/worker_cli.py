"""Fleet worker process: one replica on one card (counterpart:
``diff3d_tpu/cli/worker_cli.py``).

Boots a single serving replica in THIS process on one CUDA device and
serves the framed socket protocol (``serving/transport.py``) that
``serve_cli --workers`` fronts.  N workers on one host each take a card
of their own::

    python -m diff3d_tpu_torch.cli.worker_cli --model ckpt.pt \\
        --devices 0 --port 0 --name w0
    python -m diff3d_tpu_torch.cli.worker_cli --model ckpt.pt \\
        --devices 1 --port 0 --name w1

With ``--port 0`` the worker binds an ephemeral port and prints one
JSON ready line to stdout (``{"ready": true, "port": ..., "name":
..., "http_port": ...}``) so a supervisor can harvest the address.  It
captures its graphs before that line (every lane count up to
``--max_batch`` of every schedule, at the ``--max_views`` record
capacity), and their first-use bytes are the admission gate's pins.

``--hbm_budget_bytes`` arms the admission gate: requests whose
resident-records + program-peak arithmetic exceeds the budget are
rejected at the door with a typed ``ReplicaOverBudget``.  On SIGTERM or
SIGINT the worker drains (no new admissions; in-flight requests finish,
up to ``--drain_s``), stops and exits 0.

Runs on the card (``--devices`` names it) unless ``--device`` names
another torch device.  Refused, each with its reason: a ``--devices``
slice of several cards (a multi-process serving loop, ROADMAP A10b), ``--compile_cache``
(XLA's persistent compile cache; a worker captures its CUDA graphs at
boot), ``--host_device_count`` (XLA's virtual host devices) and
``--memcheck_dir`` (the JAX package's StableHLO memory manifests; the
port pins what its warm-up measures).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import threading

from diff3d_tpu_torch.cli._common import (add_model_width_args,
                                          apply_model_width_overrides)

#: Flags of the JAX worker with no CUDA counterpart, and why.
_NO_COUNTERPART = {
    "compile_cache": "XLA's persistent compilation cache has no CUDA "
                     "counterpart: a worker captures its CUDA graphs at "
                     "boot",
    "host_device_count": "XLA's virtual host devices have no CUDA "
                         "counterpart",
    "memcheck_dir": "the JAX package's StableHLO memory manifests have no "
                    "counterpart: the port's admission pins are the bytes "
                    "its warm-up measures on the card",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None,
                   help="checkpoint directory, ckpt_<step>.pt, port state "
                        "dict (.pt) or Flax params (.npz); omit with "
                        "--init random")
    p.add_argument("--init", choices=["checkpoint", "random"],
                   default="checkpoint")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--name", default=None,
                   help="replica name (fleet-wide identity; default "
                        "'w<pid>')")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for the socket transport")
    p.add_argument("--port", type=int, default=0,
                   help="transport port (0 = ephemeral; the bound port "
                        "is printed on the JSON ready line)")
    p.add_argument("--http_port", type=int, default=None,
                   help="also serve the worker's own HTTP surface "
                        "(/healthz /metrics /stats) on this port "
                        "(0 = ephemeral)")
    p.add_argument("--devices", required=True,
                   help="the CUDA device this replica owns, by index "
                        "('0'); a slice of several waits for a "
                        "multi-process serving loop (ROADMAP A10b) and is "
                        "refused")
    p.add_argument("--device", default=None,
                   help="torch device instead of the card --devices names "
                        "(the CPU only when named, as the tests do)")
    p.add_argument("--sampler", choices=["ancestral", "ddim"],
                   default="ancestral")
    p.add_argument("--sampler_steps", type=int, default=None,
                   help="reverse steps per view for the default sampler "
                        "(default: the config's dense grid)")
    p.add_argument("--schedules", default=None,
                   help="extra schedules beyond the default, "
                        "'kind:steps,...' — same grammar as serve_cli "
                        "--schedules (no 'i@' prefix: one worker is one "
                        "replica)")
    p.add_argument("--scan_chunks", type=int, default=1)
    p.add_argument("--max_batch", type=int, default=None,
                   help="device-batch lane ceiling (default: config, 8); "
                        "the warm-up captures every lane count up to it")
    p.add_argument("--hbm_budget_bytes", type=int, default=0,
                   help="device memory budget for admission control "
                        "(0 disables): resident records + program peak "
                        "past it -> typed ReplicaOverBudget 503")
    p.add_argument("--drain_s", type=float, default=30.0,
                   help="on SIGTERM/SIGINT, stop admitting work and wait "
                        "up to this long for in-flight requests before "
                        "stopping")
    for flag in _NO_COUNTERPART:
        p.add_argument(f"--{flag}", default=None,
                       help="refused: " + _NO_COUNTERPART[flag])
    p.add_argument("--shallow", action="store_true",
                   help="with --config test: shallow 2-level UNet")
    p.add_argument("--max_views", type=int, default=None)
    p.add_argument("--timeout_s", type=float, default=None)
    p.add_argument("--raw_params", action="store_true")
    add_model_width_args(p)
    return p


def parse_schedules(spec: str):
    scheds = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, steps_s = entry.partition(":")
        try:
            scheds.append((kind, int(steps_s)))
        except ValueError:
            raise SystemExit(
                f"--schedules entry {entry!r}: expected 'kind:steps'")
    return scheds


def build_worker(args):
    """Config + weights -> Worker (not started)."""
    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.serving.worker import boot_worker, device_slice

    for flag, why in _NO_COUNTERPART.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag}: {why}")
    if args.config == "test":
        cfg = config_lib.test_config(
            imgsize=args.imgsize or 16,
            ch=args.ch or 8,
            shallow=args.shallow)
    else:
        cfg = {"srn64": config_lib.srn64_config,
               "srn128": config_lib.srn128_config}[args.config]()
        cfg = apply_model_width_overrides(cfg, args)
    over = {}
    if args.max_views is not None:
        over["max_views"] = args.max_views
    if args.timeout_s is not None:
        over["default_timeout_s"] = args.timeout_s
    if args.max_batch is not None:
        over["max_batch"] = args.max_batch
    try:
        if over:
            cfg = dataclasses.replace(
                cfg, serving=dataclasses.replace(cfg.serving, **over))
        cfg.validate()
        devices = device_slice(args.devices)
    except ValueError as e:
        raise SystemExit(str(e))
    if len(devices) != 1:
        raise SystemExit(
            f"--devices {args.devices}: a worker runs on one card; a slice "
            "of several waits for a multi-process serving loop "
            "(ROADMAP A10b)")

    weights, version = None, "random-init"
    if args.init == "checkpoint":
        if not args.model:
            raise SystemExit("--model is required unless --init random")
        weights, version = args.model, args.model

    name = args.name or f"w{os.getpid()}"
    try:
        return boot_worker(
            cfg, name=name, devices=devices, device=args.device,
            sampler_kind=args.sampler, steps=args.sampler_steps,
            extra_schedules=(parse_schedules(args.schedules)
                             if args.schedules else None),
            weights=weights, raw_params=args.raw_params,
            params_version=version, host=args.host, port=args.port,
            hbm_budget_bytes=args.hbm_budget_bytes,
            scan_chunks=args.scan_chunks)
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    worker = build_worker(args)
    worker.start(http_port=args.http_port)
    # Machine-readable ready line: supervisors (serve_cli --workers, the
    # tests) harvest the ephemeral port.
    print(json.dumps({"ready": True, "name": worker.replica.name,
                      "port": worker.port,
                      "http_port": worker.http_port}), flush=True)
    logging.info("worker %s: transport on %s:%d",
                 worker.replica.name, args.host, worker.port)

    done = threading.Event()

    def _sig(signum, frame):
        logging.info("signal %d: draining", signum)
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        done.wait()
        drained = worker.replica.drain(timeout=args.drain_s)
        logging.info("drain %s", "complete" if drained else "incomplete")
    finally:
        worker.stop()
        logging.info("stopped")


if __name__ == "__main__":
    main()
