"""The equivalence check (counterpart: ``diff3d_tpu/analysis/
equivcheck.py``).

Reads each registered program's canonical form
(:mod:`~diff3d_tpu_torch.analysis.equiv`) against its manifest under
``runs/torch_equivcheck/`` (rules EQ6xx; EQ001-003 are the manifest
contract's):

  * EQ601 -- the semantic fingerprint changed; the finding names the
    first divergent line (its index, the pinned line's hash and the
    current node);
  * EQ602 -- more dead nodes than pinned;
  * EQ603 -- more duplicate subcomputations than pinned.
"""

from __future__ import annotations

from typing import List

from diff3d_tpu_torch.analysis import equiv, ir
from diff3d_tpu_torch.analysis.manifests import Finding

TOOL = "torch_equivcheck"
PREFIX = "EQ"
MANIFEST_DIR = "runs/torch_equivcheck"


def observe(program: ir.Program) -> tuple:
    rep = equiv.analyze_equiv(program)
    observed = rep.to_json()
    observed["config"] = program.config
    budgets = {"fingerprint": rep.fingerprint, "n_lines": rep.n_lines,
               "dead": len(rep.dead), "duplicates": rep.duplicates}
    return budgets, observed


def first_divergence(lines: List[str], pinned: List[str]) -> int:
    """Index of the first line whose hash differs from the pinned one (the
    shorter length when one is a prefix of the other)."""
    for i, (line, h) in enumerate(zip(lines, pinned)):
        if equiv.line_hash(line) != h:
            return i
    return min(len(lines), len(pinned))


def check(program: ir.Program, manifest: dict) -> List[Finding]:
    name = program.name
    rep = equiv.analyze_equiv(program)
    pin = manifest.get("budgets", {})
    out: List[Finding] = []
    if rep.fingerprint != pin.get("fingerprint"):
        pinned = manifest.get("observed", {}).get("line_hashes", [])
        i = first_divergence(rep.lines, pinned)
        now = rep.lines[i] if i < len(rep.lines) else "(end of program)"
        was = pinned[i] if i < len(pinned) else "(end of program)"
        out.append(Finding(
            "EQ601", name, "fingerprint",
            f"the program changed: first divergent line {i} (pinned hash "
            f"{was}), now `{now}`; {rep.n_lines} lines, pinned "
            f"{len(pinned)}"))
    if len(rep.dead) > pin.get("dead", 0):
        out.append(Finding("EQ602", name, "dead",
                           f"{len(rep.dead)} dead nodes, pinned "
                           f"{pin.get('dead', 0)}; first: {rep.dead[0]}"))
    if rep.duplicates > pin.get("duplicates", 0):
        out.append(Finding("EQ603", name, "duplicates",
                           f"{rep.duplicates} duplicate subcomputations "
                           f"({rep.duplicate_flops} FLOPs a run), pinned "
                           f"{pin.get('duplicates', 0)}"))
    return out
