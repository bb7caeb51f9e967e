"""Multi-process bring-up (counterpart: ``diff3d_tpu/parallel/multihost.py``).

One process per card, launched by ``torchrun`` (``torchrun --standalone
--nproc_per_node N -m diff3d_tpu_torch.cli.train_cli ...``), which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT``.  :func:`maybe_initialize_distributed` reads them and
dials the rendezvous (``torch.distributed.init_process_group``) under a
retry, as the JAX package dials its coordinator: workers race the
rendezvous at bring-up.  Without that environment it creates no group and
returns False (a one-process run), where the JAX package's
``jax.distributed.initialize`` falls through the same way.

The backend is NCCL for the card; gloo only when the caller asks for the
CPU or names it.  A failed NCCL bring-up raises: nothing falls back to
gloo.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from diff3d_tpu_torch.runtime.retry import (RetryPolicy,
                                            is_transient_backend_error)

log = logging.getLogger(__name__)

#: Rendezvous dial retry (the JAX package's coordinator dial): only
#: transient transport faults retry; a configuration error surfaces at once.
_INIT_RETRY = RetryPolicy(max_attempts=4, base_delay_s=5.0,
                          max_delay_s=30.0,
                          classify=is_transient_backend_error)

_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launch_env(environ: Optional[Dict[str, str]] = None
               ) -> Optional[Dict[str, object]]:
    """torchrun's variables from ``environ`` (default ``os.environ``):
    ``{"rank", "world_size", "local_rank", "init_method"}``, or None when
    they are absent (not launched by torchrun)."""
    env = os.environ if environ is None else environ
    if not all(k in env for k in _ENV_KEYS):
        return None
    return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"])),
            "init_method": (f"tcp://{env['MASTER_ADDR']}:"
                            f"{env['MASTER_PORT']}")}


def default_backend(device: Optional[str] = None) -> str:
    """NCCL unless the caller runs on the CPU (``device="cpu"``)."""
    return "gloo" if device is not None and \
        torch.device(device).type == "cpu" else "nccl"


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None, *,
                                 device: Optional[str] = None,
                                 backend: Optional[str] = None,
                                 retry: Optional[RetryPolicy] = None,
                                 timeout_s: float = 600.0) -> bool:
    """Join the process group if this is a multi-process job; returns
    whether a group is up.

    The rendezvous comes from the arguments or, where they are None, from
    torchrun's environment; with neither this is a one-process run and
    nothing is created (False).  An initialised group returns True.
    ``backend`` defaults to :func:`default_backend` of ``device``.  On
    NCCL the process takes card ``LOCAL_RANK`` first.  Transient dial
    faults are retried under ``retry`` (default: 4 attempts, 5-30 s
    backoff)."""
    if dist.is_initialized():
        return True
    env = launch_env()
    if init_method is None and env is not None:
        init_method = env["init_method"]
    if world_size is None and env is not None:
        world_size = env["world_size"]
    if rank is None and env is not None:
        rank = env["rank"]
    if init_method is None or world_size is None or rank is None:
        log.debug("one-process run: no rendezvous configured")
        return False
    backend = backend or default_backend(device)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA; pass device='cpu' (gloo) "
                               "to run the group on the CPU")
        local = env["local_rank"] if env is not None else rank
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    policy = retry or _INIT_RETRY
    policy.call(lambda: dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw),
        describe="torch.distributed.init_process_group")
    log.info("torch.distributed up: rank %d/%d over %s", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def shutdown_distributed() -> bool:
    """Destroy the process group if one is up; returns whether it was.
    The elastic supervisor calls this between re-mesh cycles; a
    one-process run is a no-op (False)."""
    if not dist.is_initialized():
        return False
    try:
        dist.destroy_process_group()
    except Exception as e:  # pragma: no cover - best-effort teardown
        log.warning("destroy_process_group failed: %s", e)
        return False
    log.info("torch.distributed torn down")
    return True


def reinitialize_distributed(init_method: Optional[str] = None,
                             world_size: Optional[int] = None,
                             rank: Optional[int] = None, *,
                             device: Optional[str] = None,
                             backend: Optional[str] = None,
                             retry: Optional[RetryPolicy] = None) -> bool:
    """One re-mesh cycle of the elastic loop: :func:`shutdown_distributed`,
    then :func:`maybe_initialize_distributed` under the bring-up retry.
    Returns the new multi-process status (False and nothing done in a
    one-process run)."""
    shutdown_distributed()
    return maybe_initialize_distributed(init_method, world_size, rank,
                                        device=device, backend=backend,
                                        retry=retry)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and metrics (rank 0)."""
    return rank() == 0


def shard_host_local(batch, device):
    """This rank's batch on ``device``: each rank's loader yields its own
    ``global_batch / world_size`` slice and keeps it (the counterpart of
    ``jax.make_array_from_process_local_data``, which assembles the
    slices into one global array; a rank here never sees the others')."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
