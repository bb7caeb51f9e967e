"""Run a function on a group of spawned ranks (the multi-rank half of the
parallel layer's tests, on the CPU over gloo).

:func:`spawn` starts ``world_size`` fresh interpreters (``python -c``,
so nothing of the caller's process -- threads, locks, its main module --
is inherited), joins them into one gloo process group over a file store
in a temporary directory (no port to pick), runs ``"module:function"`` in
each as ``function(rank, world_size, *args)`` with one torch thread, and
returns the ranks' results in rank order (each written with
``torch.save``, so tensors and numpy arrays pass).  A function that
raises, a rank that dies (unless listed in ``may_exit``: a test of a
rank's death; its result is then None), or a group that outlives
``timeout_s`` fails the whole call with the ranks' errors; every child
is stopped before :func:`spawn` returns.  The named module is imported in the child, so it
should import only what the ranks need (``torch`` and this package: no
JAX).
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List


def _child(target: str, rank: int, world_size: int, workdir: str) -> None:
    """A rank's body (runs in the child)."""
    import torch
    import torch.distributed as dist

    out = os.path.join(workdir, f"rank_{rank}.pt")
    try:
        torch.set_num_threads(1)
        with open(os.path.join(workdir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(workdir, "store"),
            world_size=world_size, rank=rank)
        module, _, name = target.partition(":")
        fn = getattr(importlib.import_module(module), name)
        try:
            result = fn(rank, world_size, *args)
        finally:
            if dist.is_initialized():        # the body may tear it down
                dist.destroy_process_group()
        torch.save({"ok": True, "value": result}, out + ".tmp")
    except BaseException:  # noqa: BLE001 - reported to the parent
        torch.save({"ok": False, "value": traceback.format_exc()},
                   out + ".tmp")
    os.replace(out + ".tmp", out)


def spawn(target: str, world_size: int, *args,
          timeout_s: float = 300.0, may_exit=()) -> List[Any]:
    """``[result of rank 0, ..., rank world_size - 1]`` of ``target``
    (``"module:function"``) run on ``world_size`` gloo ranks; the ranks in
    ``may_exit`` may end without a result (None)."""
    import torch

    workdir = tempfile.mkdtemp(prefix="d3d_gloo_")
    with open(os.path.join(workdir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    procs = []
    try:
        for r in range(world_size):
            code = ("from diff3d_tpu_torch.testing.distributed import "
                    f"_child; _child({target!r}, {r}, {world_size}, "
                    f"{workdir!r})")
            with open(os.path.join(workdir, f"stderr_{r}"), "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], env=env,
                    stdout=subprocess.DEVNULL, stderr=err))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"spawn({target}): the group did not "
                                   f"finish within {timeout_s} s")
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0) and r not in may_exit]
            if failed:
                break
            time.sleep(0.05)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"rank_{r}.pt")
            if not os.path.exists(path) and r in may_exit:
                p.kill()
                p.wait()
                results.append(None)
                continue
            if not os.path.exists(path):
                p.kill()
                p.wait()
                with open(os.path.join(workdir, f"stderr_{r}"), "rb") as f:
                    err = f.read().decode(errors="replace")
                errors.append(f"rank {r} exited {p.returncode} with no "
                              f"result:\n{err[-4000:]}")
                continue
            got = torch.load(path, weights_only=False)
            if not got["ok"]:
                errors.append(f"rank {r} failed:\n{got['value']}")
            results.append(got["value"])
        if errors:
            raise RuntimeError(f"spawn({target}):\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
