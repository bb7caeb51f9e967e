"""Fleet worker process: one replica on a slice of cards (counterpart:
``diff3d_tpu/cli/worker_cli.py``).

Boots a single serving replica in THIS process on one CUDA device, or on
a slice of several, and serves the framed socket protocol
(``serving/transport.py``) that ``serve_cli --workers`` fronts.  N
workers on one host split its cards::

    python -m diff3d_tpu_torch.cli.worker_cli --model ckpt.pt \\
        --devices 0-1 --port 0 --name w0
    python -m diff3d_tpu_torch.cli.worker_cli --model ckpt.pt \\
        --devices 2-3 --port 0 --name w1

A slice of N cards makes this process rank 0 on ``cuda:<first>``; it
starts N-1 follower processes (this module again, rank r on the slice's
r-th card) over a private rendezvous on localhost (NCCL across the cards,
gloo with ``--device cpu``), and the replica's view steps split their
lanes over the ranks (``serving/ranks.py``).  Only rank 0 talks to the
router.  On SIGTERM rank 0 drains, then stops its followers; a follower
whose rank 0 dies (even by SIGKILL) exits within about a second (its
collective fails on the closed socket, or it sees its parent gone), and
at the latest after the serving group's timeout.

With ``--port 0`` the worker binds an ephemeral port and prints one
JSON ready line to stdout (``{"ready": true, "port": ..., "name":
..., "http_port": ..., "ranks": N, "followers": [pid, ...]}``) so a
supervisor can harvest the address.  Every rank captures its graphs
before that line (every lane count up to ``--max_batch`` of every
schedule, at the ``--max_views`` record capacity), and their largest
first-use bytes over the ranks are the admission gate's pins.

``--hbm_budget_bytes`` arms the admission gate: requests whose
resident-records + program-peak arithmetic exceeds the budget are
rejected at the door with a typed ``ReplicaOverBudget``.  On SIGTERM or
SIGINT the worker drains (no new admissions; in-flight requests finish,
up to ``--drain_s``), stops and exits 0.

Runs on the cards ``--devices`` names unless ``--device`` names another
torch device (every rank on it).  Refused, each with its reason: a
duplicate or out-of-range index in ``--devices``, ``--compile_cache``
(XLA's persistent compile cache; a worker captures its CUDA graphs at
boot), ``--host_device_count`` (XLA's virtual host devices) and
``--memcheck_dir`` (the JAX package's StableHLO memory manifests; the
port pins what its warm-up measures).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import logging
import os
import signal
import socket
import subprocess
import sys
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
                   help="the CUDA devices this replica owns: '0', '0-3' "
                        "(inclusive range) or '0,2' (list); a slice of "
                        "several runs one rank per card, disjoint across "
                        "workers on one host")
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


def _worker_config(args):
    """The worker's config and device slice from its flags."""
    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.serving.worker import device_slice

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
    import torch

    if args.device is None and torch.cuda.is_available():
        bad = [d for d in devices if d >= torch.cuda.device_count()]
        if bad:           # before a slice starts any rank
            raise SystemExit(f"--devices {args.devices}: indices {bad} out "
                             f"of range ({torch.cuda.device_count()} CUDA "
                             "devices)")
    return cfg, devices


def _boot(args, cfg, devices):
    from diff3d_tpu_torch.serving.worker import boot_worker

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


def _join_group(init_method: str, world: int, rank: int, device,
                devices) -> None:
    """Join the slice's private process group as ``rank``: NCCL on the
    rank's card, gloo with ``--device cpu``."""
    import torch
    import torch.distributed as dist

    kw = {}
    backend = "gloo"
    if device is None or torch.device(device).type == "cuda":
        backend = "nccl"
        card = torch.device("cuda", devices[rank])
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600), **kw)


def _start_slice(argv, devices, device) -> list:
    """Rank 0 of a slice: start ranks 1..N-1 (this module, each told its
    rank) and join the group with them; returns their processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init = f"tcp://127.0.0.1:{port}"
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # a rendezvous on lo
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    try:
        for r in range(1, len(devices)):
            spec = json.dumps({"argv": list(argv), "rank": r,
                               "world": len(devices), "init": init,
                               "parent": os.getpid()})
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "from diff3d_tpu_torch.cli.worker_cli import "
                 "follower_main; follower_main()", spec],
                env=env, stdout=subprocess.DEVNULL))
        _join_group(init, len(devices), 0, device, devices)
    except BaseException:
        _end_followers(procs, 0.0)
        raise
    return procs


def _end_followers(procs, timeout: float) -> None:
    """Wait up to ``timeout`` for the followers to exit, then kill what
    is left."""
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def follower_main() -> None:
    """A slice's rank r > 0 (started by rank 0, its spec the JSON in
    ``sys.argv[1]``): join the group, build the same replica, follow rank
    0's engine until it stops, exit 0."""
    import torch.distributed as dist

    from diff3d_tpu_torch.serving.ranks import watch_parent

    spec = json.loads(sys.argv[1])
    watch_parent(spec["parent"])
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(spec["argv"])
    cfg, devices = _worker_config(args)
    _join_group(spec["init"], spec["world"], spec["rank"], args.device,
                devices)
    try:
        _boot(args, cfg, devices)
    finally:
        dist.destroy_process_group()


def build_worker(args, argv=None):
    """Config + weights -> Worker (not started).  A slice of several
    cards first starts its follower ranks (``argv``: this process's flags,
    which they take too); their processes are the worker's
    ``followers``."""
    cfg, devices = _worker_config(args)
    procs = []
    if len(devices) > 1:
        if argv is None:
            raise SystemExit(f"--devices {args.devices}: a slice of "
                             "several cards starts from the command line")
        procs = _start_slice(argv, devices, args.device)
    try:
        worker = _boot(args, cfg, devices)
    except BaseException:
        _end_followers(procs, 0.0)
        raise
    worker.followers = procs
    return worker


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    worker = build_worker(args, argv)
    worker.start(http_port=args.http_port)
    # Machine-readable ready line: supervisors (serve_cli --workers, the
    # tests) harvest the ephemeral port.
    print(json.dumps({"ready": True, "name": worker.replica.name,
                      "port": worker.port,
                      "http_port": worker.http_port,
                      "ranks": 1 + len(worker.followers),
                      "followers": [p.pid for p in worker.followers],
                      "rank_programs": worker.rank_programs}),
          flush=True)
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
        worker.stop()                 # the followers leave their loop
        _end_followers(worker.followers, 30.0)
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        logging.info("stopped")


if __name__ == "__main__":
    main()
