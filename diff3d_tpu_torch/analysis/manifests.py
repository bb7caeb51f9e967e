"""The manifest contract of the four program checks (the port's copy of
``diff3d_tpu/analysis/manifests.py``'s contract, with the torch version
added).

  * a manifest is ``{version, tool, program, torch, budgets, observed,
    suppressions}`` (plus an optional ``note``), written with
    ``indent=1, sort_keys=True`` and a trailing newline so diffs are
    line-stable;
  * ``torch`` is the version the observations were pinned under; a check
    under another version reports one finding of its own naming both
    (``<PREFIX>001``), so a torch upgrade fails with one clear reason
    instead of pins that silently go stale;
  * loading validates ``version`` / ``tool`` and raises ``ValueError``;
    an unreadable manifest is a finding at the call site, never a crash;
  * suppressions are key-scoped (``key`` names one subject, ``"*"`` the
    whole rule) and must carry a reason: a reasonless one is itself a
    finding (``<PREFIX>002``);
  * ``--update`` re-pins the observations and keeps the suppressions.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import torch

VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One finding: ``rule`` (e.g. ``TS201``), the program, the subject
    ``key`` and a message."""

    rule: str
    program: str
    key: str
    message: str
    suppressed: bool = False
    reason: Optional[str] = None

    def render(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.program}: {self.rule} {self.key}: {self.message}{tag}"


def torch_version() -> str:
    return torch.__version__


def manifest_path(program: str, manifest_dir: str) -> str:
    return os.path.join(manifest_dir, f"{program}.json")


def load(path: str, tool: str) -> dict:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if (not isinstance(data, dict) or data.get("version") != VERSION
            or data.get("tool") != tool):
        raise ValueError(f"{path}: not a {tool} manifest (version "
                         f"{VERSION})")
    return data


def write(path: str, data: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")


def make(tool: str, program: str, budgets: dict, observed: dict,
         suppressions: Sequence[dict] = (), note: Optional[str] = None
         ) -> dict:
    data = {"version": VERSION, "tool": tool, "program": program,
            "torch": torch_version(), "budgets": budgets,
            "observed": observed, "suppressions": list(suppressions)}
    if note:
        data["note"] = note
    return data


def carried_suppressions(path: str, tool: str) -> list:
    """The committed suppressions of ``path`` (none when it is absent or
    unreadable): ``--update`` keeps them."""
    if not os.path.exists(path):
        return []
    try:
        return list(load(path, tool).get("suppressions", []))
    except (ValueError, json.JSONDecodeError):
        return []


def read_or_finding(path: str, tool: str, prefix: str, program: str):
    """``(manifest, None)`` or ``(None, finding)`` for a missing or
    unreadable manifest, and the version finding beside a readable one
    pinned under another torch: ``(manifest, finding)``."""
    if not os.path.exists(path):
        return None, Finding(f"{prefix}003", program, "manifest",
                             f"no manifest at {path} (pin it with "
                             "--update)")
    try:
        data = load(path, tool)
    except (ValueError, json.JSONDecodeError) as e:
        return None, Finding(f"{prefix}003", program, "manifest",
                             f"unreadable manifest: {e}")
    pinned = data.get("torch")
    if pinned != torch_version():
        return data, Finding(
            f"{prefix}001", program, "torch",
            f"pinned under torch {pinned}, checked under torch "
            f"{torch_version()}: re-pin with --update after reviewing the "
            "other findings")
    return data, None


def apply_suppressions(findings: Sequence[Finding], manifest: Optional[dict],
                       prefix: str, program: str) -> List[Finding]:
    """Mark each finding a suppression covers (same rule, key ``"*"`` or
    the finding's key) and add a finding per reasonless suppression."""
    supps = (manifest or {}).get("suppressions", [])
    out = []
    for f in findings:
        s = next((s for s in supps if s.get("rule") == f.rule
                  and s.get("key", "*") in ("*", f.key)), None)
        if s is not None:
            f = dataclasses.replace(f, suppressed=True,
                                    reason=s.get("reason"))
        out.append(f)
    for s in supps:
        if not s.get("reason"):
            out.append(Finding(f"{prefix}002", program,
                               f"{s.get('rule')}:{s.get('key', '*')}",
                               "a suppression needs a reason"))
    return out
