"""Long-running novel-view inference service (counterpart:
``diff3d_tpu/cli/serve_cli.py``).

Loads weights and serves ``POST /synthesize`` — concurrent requests are
microbatched into shared view steps (:mod:`diff3d_tpu_torch.serving`), so
the card stays occupied under live load instead of running one request's
guidance sweep at a time.  ``--model`` is anything
:func:`~diff3d_tpu_torch.cli._common.load_eval_params` reads (a
checkpoint directory of the port's ``Trainer``, a ``ckpt_<step>.pt``, a
plain state dict, a Flax ``.npz``); the EMA weights by default.  Runs on
the card unless ``--device`` names another; there every view step
replays a captured CUDA graph.

Usage:
    python -m diff3d_tpu_torch.cli.serve_cli --model ./checkpoints \\
        [--config srn64] [--port 8080] [--max_batch 8] [--max_wait_ms 50]

    # smoke-serve random weights on the CPU (no checkpoint):
    python -m diff3d_tpu_torch.cli.serve_cli --init random --config test \\
        --device cpu

    # two replicas behind the fleet router, and progressive previews:
    python -m diff3d_tpu_torch.cli.serve_cli --model ckpt.pt --replicas 2 \\
        --schedules 'ancestral:64,1@ddim:16'
    python -m diff3d_tpu_torch.cli.serve_cli --model ckpt.pt \\
        --config srn128 --cascade 'draft=64:ddim:8,refine=128:ancestral:64@t0.40625'

    # front worker processes (cli/worker_cli.py), no local engine:
    python -m diff3d_tpu_torch.cli.serve_cli --workers 127.0.0.1:9100

    # one service over the cards of a host (rank 0 serves HTTP, the other
    # ranks follow its view steps; lanes split over the ranks), and two
    # replicas over them (each over every card):
    torchrun --standalone --nproc_per_node 4 \
        -m diff3d_tpu_torch.cli.serve_cli --mesh --model ckpt.pt
    torchrun --standalone --nproc_per_node 4 \
        -m diff3d_tpu_torch.cli.serve_cli --mesh --replicas 2 \
        --model ckpt.pt --schedules 'ancestral:64,1@ddim:16'

Endpoints: ``POST /synthesize``, ``POST /trajectory``, ``POST /cascade``
(with ``--cascade``), ``GET /result/<id>``, ``GET /healthz``, ``GET
/metrics`` (text; ``?format=json`` for the structured snapshot), ``GET
/stats``, and ``GET /fleet`` behind the fleet router (``--replicas`` > 1
or ``--workers``).  With ``--workers`` alone no engine is built and the
process touches no device.

``--mesh`` serves over ``make_mesh(cfg.mesh)``: the data axis over every
rank of the process group (torchrun's, or one its caller already made),
one process per card.  Each rank holds the whole model (rank 0's weights,
checked by digest on every rank at boot) and runs its share of each view
step's lanes; the lane counts and ``--max_batch`` round up to the number
of ranks.  Rank 0 takes every decision (``serving/ranks.py``); the other
ranks follow it and exit 0 when it stops.  With ``--replicas N`` every
rank builds the same N replicas (the same ``--schedules``, ``i@`` entries
included, and ``--cascade``), each over every rank with a channel of its
own, as the JAX package's replicas share its mesh; they take turns on
each card in rank 0's order.  Rank 0 fronts them (and any ``--workers``)
with the fleet router; the other ranks follow every replica and exit 0
once each has stopped, non-zero if any channel broke.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import signal
import threading

from diff3d_tpu_torch.cli._common import (add_model_width_args,
                                          apply_model_width_overrides,
                                          load_eval_params)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", action="store_true",
                   help="serve over the process group's ranks (cfg.mesh; "
                        "launch with torchrun, one rank per card): each "
                        "view step's lanes split over the data axis, every "
                        "rank holds the whole model, lane counts round up "
                        "to the data-axis size; rank 0 serves HTTP and the "
                        "other ranks follow it.  With --replicas N each "
                        "replica spans every rank, over a channel of its "
                        "own")
    p.add_argument("--model", default=None,
                   help="checkpoint directory, ckpt_<step>.pt, port state "
                        "dict (.pt) or Flax params (.npz); omit with "
                        "--init random")
    p.add_argument("--init", choices=["checkpoint", "random"],
                   default="checkpoint",
                   help="'random' serves freshly initialised weights — for "
                        "smoke tests, no --model needed")
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--host", default=None,
                   help="bind address (default: config, 127.0.0.1)")
    p.add_argument("--port", type=int, default=None,
                   help="bind port (default: config, 8080; 0 = ephemeral)")
    p.add_argument("--max_batch", type=int, default=None,
                   help="device-batch lane ceiling per shape bucket")
    p.add_argument("--max_views", type=int, default=None,
                   help="views a request may span (default: config, 16); "
                        "--warmup captures the bucket of this many")
    p.add_argument("--max_wait_ms", type=float, default=None,
                   help="microbatch flush deadline after the first "
                        "request of a bucket arrives")
    p.add_argument("--max_queue", type=int, default=None,
                   help="bounded queue size; beyond it submissions get "
                        "HTTP 429")
    p.add_argument("--timeout_s", type=float, default=None,
                   help="default per-request deadline")
    p.add_argument("--watchdog_s", type=float, default=None,
                   help="watchdog deadline per view step: past it the "
                        "engine rejects the stuck batch with a retryable "
                        "error and degrades (0 disables)")
    p.add_argument("--drain_s", type=float, default=10.0,
                   help="on SIGTERM/SIGINT, stop admitting work and wait "
                        "up to this long for in-flight requests before "
                        "stopping (0 = immediate stop)")
    p.add_argument("--steps", type=int, default=None,
                   help="diffusion timesteps, the dense grid (reference: "
                        "256); see --sampler_steps for a few-step subset")
    p.add_argument("--sampler", choices=["ancestral", "ddim"],
                   default="ancestral",
                   help="default reverse-process update: 'ancestral' (the "
                        "paper's stochastic sampler) or 'ddim' "
                        "(deterministic, eta = 0)")
    p.add_argument("--sampler_steps", type=int, default=None,
                   help="reverse steps per view of the default sampler, a "
                        "divisor of the dense grid; default = full grid")
    p.add_argument("--schedules", default=None,
                   help="extra schedules to serve beyond the default, as "
                        "'kind:steps,...' (e.g. 'ddim:16'); requests "
                        "naming any other schedule get a typed 503 with "
                        "this list.  With --replicas N, prefix an entry "
                        "with 'i@' to give it to replica i only (e.g. "
                        "'1@ddim:16') — the router places requests on a "
                        "replica that serves their schedule")
    p.add_argument("--replicas", type=int, default=None,
                   help="in-process engine replicas behind the fleet "
                        "router front door (default: config, 1 = plain "
                        "single-engine service); each has its own copy of "
                        "the weights, samplers and graphs.  Sessions "
                        "(payload 'session_id') pin to a replica; adds GET "
                        "/fleet and router counters to GET /metrics")
    p.add_argument("--workers", default=None,
                   help="front pre-started worker processes "
                        "(diff3d_tpu_torch.cli.worker_cli) as remote "
                        "replicas: 'host:port,host:port'.  Mixes with "
                        "--replicas: N in-process replicas plus the listed "
                        "workers form one fleet; with --workers alone no "
                        "local engine is built, so this process touches "
                        "no device")
    p.add_argument("--cascade", default=None, metavar="PLAN",
                   help="serve progressive-preview cascades (POST "
                        "/cascade): 'draft=RES:kind:steps,refine=RES:kind:"
                        "steps@tSTART', e.g. 'draft=64:ddim:8,refine=128:"
                        "ancestral:64@t0.40625' — the draft streams first "
                        "at RES, then a truncated refine pass (from "
                        "t=START, a grid point of its schedule) replaces "
                        "each frame in place; refine RES must equal the "
                        "config's image size")
    p.add_argument("--scan_chunks", type=int, default=1,
                   help="split each view's reverse steps into this many "
                        "segments (must divide the per-view step count; "
                        "bit-identical to 1)")
    p.add_argument("--pallas", action="store_true",
                   help="the fused GroupNorm kernels: the port runs them on "
                        "the card anyway (accepted and logged)")
    p.add_argument("--raw_params", action="store_true",
                   help="serve raw weights instead of the EMA")
    p.add_argument("--warmup", action="store_true",
                   help="capture the single-lane view step of the "
                        "max_views bucket for every schedule before "
                        "accepting traffic")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    add_model_width_args(p)
    return p


def _config(args):
    from diff3d_tpu_torch import config as config_lib

    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    if args.steps:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
            cfg.diffusion, timesteps=args.steps))
    cfg = apply_model_width_overrides(cfg, args)
    over = {k: getattr(args, k) for k in
            ("host", "port", "max_batch", "max_queue", "max_wait_ms",
             "max_views")
            if getattr(args, k) is not None}
    if args.replicas:            # 0 = remote-only fleet, keep cfg valid
        over["replicas"] = args.replicas
    if args.timeout_s is not None:
        over["default_timeout_s"] = args.timeout_s
    if args.watchdog_s is not None:
        over["watchdog_timeout_s"] = args.watchdog_s
    if over:
        cfg = dataclasses.replace(
            cfg, serving=dataclasses.replace(cfg.serving, **over))
    cfg.validate()
    return cfg


def _schedules(spec: str, n_replicas: int):
    """``'[i@]kind:steps,...'`` -> ``[(replica index or None, (kind,
    steps)), ...]``."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        target, at, rest = entry.partition("@")
        idx = None
        if at:
            try:
                idx = int(target)
            except ValueError:
                raise SystemExit(
                    f"--schedules entry {entry!r}: replica prefix must be "
                    "an integer index ('i@kind:steps')") from None
            if not 0 <= idx < n_replicas:
                raise SystemExit(
                    f"--schedules entry {entry!r}: replica index {idx} "
                    f"outside --replicas {n_replicas}")
        else:
            rest = entry
        kind, _, steps_s = rest.partition(":")
        try:
            out.append((idx, (kind, int(steps_s))))
        except ValueError:
            raise SystemExit(f"--schedules entry {entry!r}: expected "
                             "'[i@]kind:steps'") from None
    return out


def _worker_addrs(spec):
    addrs = []
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, _, port_s = entry.rpartition(":")
        try:
            addrs.append((host or "127.0.0.1", int(port_s)))
        except ValueError:
            raise SystemExit(f"--workers entry {entry!r}: expected "
                             "'host:port'") from None
    return addrs


def _remotes(addrs, cfg):
    from diff3d_tpu_torch.serving.transport import (RemoteReplica,
                                                   TransportError)

    reps = []
    for host, port in addrs:
        try:
            reps.append(RemoteReplica(
                host, port,
                heartbeat_interval_s=cfg.serving.heartbeat_interval_s,
                heartbeat_timeout_s=cfg.serving.heartbeat_timeout_s,
                max_frame_bytes=cfg.serving.max_frame_bytes))
        except TransportError as e:
            raise SystemExit(
                f"--workers {host}:{port}: worker unreachable ({e}) — "
                "start it first with 'python -m "
                "diff3d_tpu_torch.cli.worker_cli'") from None
    return reps


def build_service(args):
    """Config + weights + sampler(s) -> a :class:`ServingService`, or a
    :class:`FleetService` with ``--replicas`` > 1 or ``--workers``, not
    started; with ``--warmup`` every local engine's graphs of the
    ``max_views`` bucket are already captured."""
    from diff3d_tpu_torch.serving import FleetService

    if args.pallas:
        logging.info("--pallas: the hand-written CUDA kernels "
                     "(ops/csrc/film.cu, attention.cu) run on the card; off "
                     "the card their plain versions run")
    try:
        cfg = _config(args)
    except ValueError as e:
        raise SystemExit(str(e))
    worker_addrs = _worker_addrs(args.workers)
    # Local in-process replicas: with --workers present, default to a
    # remote-only fleet unless --replicas asks for local ones too.
    n_local = args.replicas if args.replicas is not None else (
        0 if worker_addrs else cfg.serving.replicas)
    if n_local < 0 or (n_local == 0 and not worker_addrs):
        raise SystemExit(f"--replicas {n_local} needs --workers (and is "
                         "never negative)")
    extra_specs = (_schedules(args.schedules, n_local) if args.schedules
                   else [])
    if n_local == 0:
        # Remote-only front door: no local engine, no device touched.
        if args.cascade:
            raise SystemExit("--cascade needs local replicas: the worker "
                             "transport carries no cascade")
        logging.info("fronting %d remote workers, no local replicas",
                     len(worker_addrs))
        return FleetService(_remotes(worker_addrs, cfg), cfg)
    if any(i is not None for i, _ in extra_specs) and n_local < 2:
        raise SystemExit("per-replica 'i@kind:steps' schedules require "
                         "--replicas > 1")
    return _local_service(args, cfg, n_local, extra_specs, worker_addrs)


def _serving_mesh(cfg):
    """``make_mesh(cfg.mesh)`` over the process group and its
    :class:`~diff3d_tpu_torch.serving.ranks.RankChannel` (None without a
    group: one process serves alone)."""
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.serving.ranks import RankChannel

    try:
        mesh = make_mesh(cfg.mesh)
        ranks = (RankChannel(mesh) if mesh.device_mesh is not None
                 else None)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e}")
    logging.info("serving on mesh data=%d x model=%d (lane multiple %d)",
                 mesh.data_size, mesh.model_size, mesh.data_size)
    return mesh, ranks


def _local_service(args, cfg, n_local, extra_specs, worker_addrs):
    """The service over ``n_local`` in-process replicas (plus the
    ``worker_addrs`` remotes)."""
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import FleetService, ServingService
    from diff3d_tpu_torch.serving.fleet import build_fleet

    device = resolve_device(args.device)
    mesh, ranks = _serving_mesh(cfg) if args.mesh else (None, None)
    model = build_model(cfg.model, device)
    if args.init == "random":
        version = "random-init"
    else:
        if not args.model:
            raise SystemExit("--model is required unless --init random")
        try:
            step = load_eval_params(args.model, model, args.raw_params)
        except ValueError as e:
            raise SystemExit(str(e))
        version = f"{args.model}@step{step}"
    if ranks is not None:
        digest = ranks.sync_weights(model)
        logging.info("rank %d/%d holds rank 0's weights (sha256 %s)",
                     ranks.rank, ranks.world, digest[:16])
    logging.info("serving %s weights on %s", version, device)

    def sampler(kind, steps):
        try:
            return Sampler(model, cfg, device=device, sampler_kind=kind,
                           steps=steps, scan_chunks=args.scan_chunks,
                           mesh=mesh)
        except ValueError as e:
            raise SystemExit(f"schedule {kind}:{steps}: {e}")

    default = sampler(args.sampler, args.sampler_steps)
    cascade = None
    if args.cascade:
        from diff3d_tpu_torch.cascade import CascadePlan, CascadeSampler

        try:
            plan = CascadePlan.parse(args.cascade)
            if plan.refine.resolution != cfg.model.H:
                raise ValueError(
                    f"refine resolution {plan.refine.resolution} must "
                    f"equal the config's image size {cfg.model.H} "
                    f"(--config {args.config})")
            cascade = CascadeSampler(model, cfg, plan, device=device,
                                     mesh=mesh)
        except ValueError as e:
            raise SystemExit(f"--cascade: {e}")
        logging.info("cascade plan %s (draft %d^2 -> refine %d^2 from "
                     "t=%g)", plan.spec(), plan.draft.resolution,
                     plan.refine.resolution, plan.refine.start_t)
    extra, per_replica = {}, {}
    for idx, sched in extra_specs:
        if sched == (default.sampler_kind, default.steps):
            continue                        # already the default sampler
        target = extra if idx is None else per_replica.setdefault(idx, {})
        target[sched] = sampler(*sched)
    if ranks is not None and not ranks.leader:
        # A follower: the leader's local replicas without the front door
        # (the leader alone fronts the remote workers).
        if n_local == 1:
            return ServingService(default, cfg, params_version=version,
                                  extra_samplers=extra or None,
                                  cascade=cascade, ranks=ranks)
        return FleetService(build_fleet(
            default, cfg, n_local, extra_samplers=extra or None,
            per_replica_extra=per_replica or None, params_version=version,
            cascade=cascade, ranks=ranks), cfg)
    if worker_addrs or n_local > 1:
        service = FleetService(build_fleet(
            default, cfg, n_local, extra_samplers=extra or None,
            per_replica_extra=per_replica or None, params_version=version,
            cascade=cascade, ranks=ranks) + _remotes(worker_addrs, cfg),
            cfg)
    else:
        service = ServingService(default, cfg, params_version=version,
                                 extra_samplers=extra or None,
                                 cascade=cascade, ranks=ranks)
    if args.warmup:
        for eng in _local_engines(service):
            warmup(eng, cfg)
    return service


def warmup(eng, cfg) -> None:
    """Capture ``eng``'s single-lane view step (one lane per rank on a
    serving mesh) of the ``max_views`` bucket for every schedule and
    cascade phase."""
    from diff3d_tpu_torch.sampling import record_capacity
    from diff3d_tpu_torch.serving import Bucket

    cap = record_capacity(cfg.serving.max_views)
    phases = ([("draft", eng.cascade.draft), ("refine", eng.cascade.refine)]
              if eng.cascade is not None else [])
    for phase, s in [(None, s) for s in eng.samplers.values()] + phases:
        bucket = Bucket(s.cfg.model.H, s.cfg.model.W, cap, s.steps,
                        s.sampler_kind, phase)
        secs = eng.warmup(bucket, s.lane_multiple)
        logging.info("warmed bucket %s in %.1fs", tuple(bucket), secs)


def main(argv=None) -> None:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    owned = False
    if args.mesh and not dist.is_initialized():
        # Before anything touches the card: NCCL takes LOCAL_RANK's card.
        from diff3d_tpu_torch.parallel import maybe_initialize_distributed

        owned = maybe_initialize_distributed(device=args.device)
    try:
        _serve(args)
    finally:
        if owned:
            from diff3d_tpu_torch.parallel import shutdown_distributed

            shutdown_distributed()


def _local_engines(service) -> list:
    """The engines of ``service``'s in-process replicas."""
    if hasattr(service, "engine"):
        return [service.engine]
    return [rep.engine for rep in service.replicas if hasattr(rep, "engine")]


def _serve(args) -> None:
    from diff3d_tpu_torch.serving.engine import follow_all

    service = build_service(args)
    engines = _local_engines(service)
    ranks = engines[0].ranks if engines else None
    if ranks is not None and not ranks.leader:
        logging.info("rank %d of %d follows rank 0's %d replica(s)",
                     ranks.rank, ranks.world, len(engines))
        follow_all(engines)
        logging.info("rank 0 stopped: rank %d exits", ranks.rank)
        return
    service.start(serve_http=True)
    fleet = ", GET /fleet" if hasattr(service, "fleet_snapshot") else ""
    logging.info("listening on http://%s:%d (POST /synthesize, POST "
                 "/trajectory, POST /cascade, GET /healthz, GET /metrics, "
                 "GET /stats%s)", service.cfg.serving.host, service.port,
                 fleet)

    done = threading.Event()

    def _sig(signum, frame):
        logging.info("signal %d: shutting down", signum)
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        done.wait()
    finally:
        service.stop(drain_s=args.drain_s)
        logging.info("stopped")


if __name__ == "__main__":
    main()
