"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library, loaded with :mod:`ctypes`.  Nothing
is built when a module is imported: :func:`library` builds on first use,
and :func:`build_all` builds every source at once, one ``nvcc`` per
source, all started together.  Libraries land in ``build/torch_kernels/``
at the repo root (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("film", "attention")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are compiled on the machine with the "
                           "card")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> subprocess.Popen:
    target = _target(name)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that has no current library, all
    at once.  Returns ``{name: nvcc output}`` (``-Xptxas -v`` prints each
    kernel's registers and shared memory); raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _target(n).exists()}
    logs = {}
    failed = []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        target = _target(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
        (BUILD_DIR / f"{name}.log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
