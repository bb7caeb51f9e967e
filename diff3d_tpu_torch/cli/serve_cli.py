"""Long-running novel-view inference service (counterpart:
``diff3d_tpu/cli/serve_cli.py``, its single-engine path).

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

Endpoints: ``POST /synthesize``, ``POST /trajectory``, ``GET
/result/<id>``, ``GET /healthz``, ``GET /metrics`` (text; ``?format=json``
for the structured snapshot), ``GET /stats``.
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

_WAITING = ("Not in this slice of the port (see ROADMAP.md): --workers and "
            "--cascade (ROADMAP A9b: the cross-process fleet and cascades) "
            "and --mesh (A10: the parallel layer) are not flags here, so "
            "they are refused; --replicas above 1 and per-replica "
            "'i@kind:steps' entries of --schedules exit non-zero (A9b: the "
            "fleet router).  --pallas has no counterpart: the port runs one "
            "implementation per device (ops/dispatch.py).")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=_WAITING)
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
                        "this list")
    p.add_argument("--replicas", type=int, default=None,
                   help="engine replicas; the port serves 1 (the fleet "
                        "router is ROADMAP A9b)")
    p.add_argument("--scan_chunks", type=int, default=1,
                   help="split each view's reverse steps into this many "
                        "segments (must divide the per-view step count; "
                        "bit-identical to 1)")
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
            ("host", "port", "max_batch", "max_queue", "max_wait_ms")
            if getattr(args, k) is not None}
    if args.timeout_s is not None:
        over["default_timeout_s"] = args.timeout_s
    if args.watchdog_s is not None:
        over["watchdog_timeout_s"] = args.watchdog_s
    if over:
        cfg = dataclasses.replace(
            cfg, serving=dataclasses.replace(cfg.serving, **over))
    cfg.validate()
    return cfg


def _schedules(spec: str):
    """``'kind:steps,...'`` -> ``[(kind, steps), ...]``."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "@" in entry:
            raise SystemExit(
                f"--schedules entry {entry!r}: per-replica schedules "
                "('i@kind:steps') need the fleet router (ROADMAP A9b)")
        kind, _, steps_s = entry.partition(":")
        try:
            out.append((kind, int(steps_s)))
        except ValueError:
            raise SystemExit(f"--schedules entry {entry!r}: expected "
                             "'kind:steps'") from None
    return out


def build_service(args):
    """Config + weights + sampler(s) -> a :class:`ServingService`, not
    started; with ``--warmup`` its graphs of the ``max_views`` bucket
    are already captured."""
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler, record_capacity
    from diff3d_tpu_torch.serving import Bucket, ServingService

    if args.replicas is not None and args.replicas > 1:
        raise SystemExit(f"--replicas {args.replicas}: the port serves one "
                         "engine; the fleet router is ROADMAP A9b")
    extra_specs = _schedules(args.schedules) if args.schedules else []
    device = resolve_device(args.device)
    try:
        cfg = _config(args)
    except ValueError as e:
        raise SystemExit(str(e))
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
    logging.info("serving %s weights on %s", version, device)

    def sampler(kind, steps):
        try:
            return Sampler(model, cfg, device=device, sampler_kind=kind,
                           steps=steps, scan_chunks=args.scan_chunks)
        except ValueError as e:
            raise SystemExit(f"schedule {kind}:{steps}: {e}")

    default = sampler(args.sampler, args.sampler_steps)
    extra = {}
    for sched in extra_specs:
        if sched != (default.sampler_kind, default.steps):
            extra[sched] = sampler(*sched)
    service = ServingService(default, cfg, params_version=version,
                             extra_samplers=extra or None)
    if args.warmup:
        eng = service.engine
        cap = record_capacity(cfg.serving.max_views)
        for s in eng.samplers.values():
            bucket = Bucket(cfg.model.H, cfg.model.W, cap, s.steps,
                            s.sampler_kind)
            secs = eng.programs.warmup(bucket, s.lane_multiple,
                                       eng.guidance_B)
            logging.info("warmed bucket %s in %.1fs", tuple(bucket), secs)
    return service


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    service = build_service(args)
    service.start(serve_http=True)
    logging.info("listening on http://%s:%d (POST /synthesize, POST "
                 "/trajectory, GET /healthz, GET /metrics, GET /stats)",
                 service.cfg.serving.host, service.port)

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
