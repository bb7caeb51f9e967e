"""The randomness check (counterpart: ``diff3d_tpu/analysis/rngcheck.py``
and ``rngflow.py``).

**Per program**: the ordered draw stream of one run, as ``op shape dtype
generator part`` events (``generator`` ``g<k>`` by first draw, or
``default`` where no generator is named), and its sha256, pinned under
``runs/torch_rngcheck/``:

  * RC501 -- the stream changed; the finding names the first differing
    event;
  * RC502 -- a traced draw names no generator.

**Over the package's sources** (``diff3d_tpu_torch/``), an AST pass --
the port's randomness contract (ROADMAP "Randomness"): every draw takes
an explicit generator, so a test can replay another stream and a resumed
run the same one.

  * RC503 -- a call of ``torch.rand`` / ``randn`` / ``randint`` /
    ``randperm`` / ``bernoulli`` / ``normal`` / ``multinomial`` / the
    ``*_like`` draws, a tensor's in-place ``normal_`` / ``uniform_`` /
    ``bernoulli_`` / ``random_`` / ``exponential_``, or a dropout
    of torch's (``F.dropout``, ``nn.Dropout``: they take no generator),
    without ``generator=``;
  * RC506 -- a seed taken from the clock, the process id or
    ``os.urandom`` (inside a ``manual_seed`` / ``seed`` /
    ``SeedSequence`` / ``default_rng`` call or a ``seed=`` argument).

A line may carry ``# rngcheck: <reason>`` to suppress its finding; a
suppression without a reason is RC002.
"""

from __future__ import annotations

import ast
import hashlib
import os
from typing import List, Sequence

from diff3d_tpu_torch.analysis import ir
from diff3d_tpu_torch.analysis.manifests import Finding

TOOL = "torch_rngcheck"
PREFIX = "RC"
MANIFEST_DIR = "runs/torch_rngcheck"

_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli", "normal",
          "multinomial", "rand_like", "randn_like", "randint_like"}
_INPLACE = {"normal_", "uniform_", "bernoulli_", "random_",
            "exponential_"}
_DROPOUT = {"dropout", "dropout1d", "dropout2d", "dropout3d",
            "alpha_dropout", "feature_alpha_dropout", "Dropout",
            "Dropout1d", "Dropout2d", "Dropout3d", "AlphaDropout"}
_SEEDS = {"manual_seed", "seed", "SeedSequence", "default_rng",
          "RandomState"}
_ENTROPY = {"time", "time_ns", "perf_counter", "perf_counter_ns",
            "monotonic", "monotonic_ns", "getpid", "urandom", "now"}
#: Names torch's dropout is called through (``F.dropout``,
#: ``nn.Dropout``, ``torch.dropout``).
_TORCH_NAMES = {"F", "nn", "torch", "functional"}
SUPPRESS = "# rngcheck:"


def events(program: ir.Program) -> List[str]:
    return [f"{e['op']} {tuple(e['shape'])} {e['dtype']} {e['generator']} "
            f"{e['part']}" for e in ir.random_events(program)]


def digest(evs: Sequence[str]) -> str:
    return hashlib.sha256("\n".join(evs).encode()).hexdigest()


def observe(program: ir.Program) -> tuple:
    evs = events(program)
    d = digest(evs)
    return ({"digest": d, "n_events": len(evs)},
            {"digest": d, "events": evs, "config": program.config})


def check(program: ir.Program, manifest: dict) -> List[Finding]:
    name = program.name
    evs = events(program)
    pin = manifest.get("budgets", {})
    out: List[Finding] = []
    if digest(evs) != pin.get("digest"):
        was = manifest.get("observed", {}).get("events", [])
        i = next((i for i, (a, b) in enumerate(zip(evs, was)) if a != b),
                 min(len(evs), len(was)))
        now = evs[i] if i < len(evs) else "(end of stream)"
        then = was[i] if i < len(was) else "(end of stream)"
        out.append(Finding("RC501", name, "stream",
                           f"draw {i} is `{now}`, pinned `{then}` "
                           f"({len(evs)} draws, pinned {len(was)})"))
    for e in evs:
        if " default " in e:
            out.append(Finding("RC502", name, e.split(" ")[0],
                               f"a draw names no generator: `{e}`"))
    return out


# ---- the source pass ---------------------------------------------------------


def _callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _owner(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return ""


def _kwargs(node: ast.Call) -> set:
    return {k.arg for k in node.keywords}


def _entropy(node: ast.AST) -> str:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _callee(sub) in _ENTROPY:
            return _callee(sub)
    return ""


def lint_source(source: str, path: str) -> List[Finding]:
    """RC503 / RC506 findings of one file (inline suppressions applied)."""
    lines = source.splitlines()
    out: List[Finding] = []
    for node in ast.walk(ast.parse(source, path)):
        if not isinstance(node, ast.Call):
            continue
        name = _callee(node)
        rule = msg = None
        if (name in _DRAWS and _owner(node) == "torch") \
                or name in _INPLACE:
            if "generator" not in _kwargs(node):
                rule, msg = "RC503", f"{name}(...) without generator="
        elif name in _DROPOUT and _owner(node) in _TORCH_NAMES:
            rule, msg = "RC503", (f"{_owner(node)}.{name}(...) draws its "
                                  "mask from the global generator")
        elif name in _SEEDS or "seed" in _kwargs(node):
            args = list(node.args) + [k.value for k in node.keywords
                                      if name in _SEEDS or k.arg == "seed"]
            src = next((_entropy(a) for a in args if _entropy(a)), "")
            if src:
                rule, msg = "RC506", f"a seed taken from {src}()"
        if rule is None:
            continue
        end = getattr(node, "end_lineno", node.lineno)
        text = " ".join(lines[node.lineno - 1:end])
        key = f"{os.path.basename(path)}:{node.lineno}"
        f = Finding(rule, path, key, msg)
        if SUPPRESS in text:
            reason = text.split(SUPPRESS, 1)[1].strip()
            if not reason:
                out.append(Finding("RC002", path, key,
                                   "an rngcheck suppression needs a "
                                   "reason"))
                continue
            f = Finding(rule, path, key, msg, suppressed=True,
                        reason=reason)
        out.append(f)
    return out


def lint_package(root: str) -> List[Finding]:
    """The source pass over every ``.py`` file under ``root``."""
    out: List[Finding] = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, encoding="utf-8") as f:
                    out += lint_source(f.read(), os.path.relpath(
                        path, os.path.dirname(os.path.abspath(root))))
    return out
