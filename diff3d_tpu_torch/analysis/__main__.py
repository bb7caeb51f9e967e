"""``python -m diff3d_tpu_torch.analysis {shardcheck,memcheck,equivcheck,
rngcheck}``: the four program checks over the registry's programs.

    python -m diff3d_tpu_torch.analysis shardcheck --device cpu
    python -m diff3d_tpu_torch.analysis memcheck --programs-tier1 \\
        --device cpu --format json
    python -m diff3d_tpu_torch.analysis equivcheck --program step_many \\
        --update --device cpu          # re-pin (suppressions kept)
    python -m diff3d_tpu_torch.analysis rngcheck --list

Each program is traced on fake tensors of ``--device`` (default
``cuda``: fake CUDA tensors, which needs a CUDA build of torch; ``cpu``
on a machine without one) in a fake process group of 8 ranks opened in
this process.  Exit codes: 0 clean, 1 unsuppressed findings, 2 bad
invocation.  Manifests: ``runs/torch_<check>/<program>.json``
(``--manifest_dir`` names another directory).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional, Sequence

from diff3d_tpu_torch.analysis import (equivcheck, manifests, memcheck,
                                       rngcheck, shardcheck)

TOOLS = {"shardcheck": shardcheck, "memcheck": memcheck,
         "equivcheck": equivcheck, "rngcheck": rngcheck}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = os.path.join(ROOT, "diff3d_tpu_torch")
#: Notes written into a program's manifests.
NOTES = {
    "step_many_pallas": "the JAX registry's Pallas program; the port's "
                        "counterpart is step_many with set_kernels('torch') "
                        "(the plain versions), since every port program "
                        "already holds its kernels as op nodes",
    "train_step": "fsdp: FSDP2 traced through make_fx (its all-gathers and "
                  "reduce-scatters are c10d nodes); the eager FSDP step's "
                  "Adam is not capturable, so its bias corrections read "
                  "each step count on the host (local_scalar_dense)",
    "distill_step": "fsdp, as train_step",
}


def check(tool: str, names: Sequence[str], device: str,
          manifest_dir: str, update: bool = False) -> List:
    """Check (or with ``update`` re-pin) ``names``; returns ``(findings,
    written paths)``."""
    mod = TOOLS[tool]
    findings: List[manifests.Finding] = []
    written = []
    for name in names:
        path = manifests.manifest_path(name, manifest_dir)
        try:
            program = shardcheck.build_program(name, device)
        except Exception as e:  # noqa: BLE001 - a failed trace is a finding
            findings.append(manifests.Finding(
                f"{mod.PREFIX}004", name, "trace",
                f"the program does not trace: {type(e).__name__}: {e}"))
            continue
        if update:
            budgets, observed = mod.observe(program)
            manifests.write(path, manifests.make(
                mod.TOOL, name, budgets, observed,
                manifests.carried_suppressions(path, mod.TOOL),
                NOTES.get(name)))
            written.append(path)
            continue
        manifest, contract = manifests.read_or_finding(
            path, mod.TOOL, mod.PREFIX, name)
        found = [contract] if contract else []
        if manifest is not None:
            found += mod.check(program, manifest)
        findings += manifests.apply_suppressions(found, manifest,
                                                 mod.PREFIX, name)
    if tool == "rngcheck" and not update:
        findings += rngcheck.lint_package(PACKAGE)
    return findings, written


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m diff3d_tpu_torch.analysis",
        description="program checks over the port's traced programs")
    p.add_argument("tool", choices=sorted(TOOLS))
    p.add_argument("--program", action="append", dest="programs",
                   choices=sorted(shardcheck.REGISTRY),
                   help="one program (repeatable; default: all)")
    p.add_argument("--programs-tier1", action="store_true",
                   help=f"the tier-1 set {shardcheck.TIER1_PROGRAMS}")
    p.add_argument("--update", action="store_true",
                   help="re-pin the manifests (suppressions kept), exit 0")
    p.add_argument("--list", action="store_true", dest="list_programs")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--show-suppressed", action="store_true")
    p.add_argument("--manifest_dir", default=None)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                   help="the fake tensors' device (default: the card's)")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    if args.list_programs:
        for spec in shardcheck.REGISTRY.values():
            tag = " [tier1]" if spec.tier1 else ""
            print(f"{spec.name:26s} {spec.description}{tag}")
        return 0
    if args.programs and args.programs_tier1:
        print(f"{args.tool}: --program and --programs-tier1 are exclusive",
              file=sys.stderr)
        return 2
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{args.tool}: --device cuda traces on fake CUDA tensors, "
              "which needs CUDA; pass --device cpu", file=sys.stderr)
        return 2
    names = args.programs or (list(shardcheck.TIER1_PROGRAMS)
                              if args.programs_tier1
                              else list(shardcheck.REGISTRY))
    mdir = args.manifest_dir or os.path.join(
        ROOT, TOOLS[args.tool].MANIFEST_DIR)
    findings, written = check(args.tool, names, args.device, mdir,
                              args.update)
    for path in written:
        print(f"{args.tool}: wrote {path}")
    live = [f for f in findings if not f.suppressed]
    if args.format == "json":
        print(json.dumps({
            "tool": args.tool, "device": args.device,
            "torch": manifests.torch_version(), "programs": names,
            "findings": [dataclasses.asdict(f) for f in findings],
            "unsuppressed": len(live),
            "suppressed": len(findings) - len(live)}, indent=1))
    else:
        for f in (findings if args.show_suppressed else live):
            print(f.render())
        print(f"{args.tool}: {len(live)} finding(s), "
              f"{len(findings) - len(live)} suppressed, "
              f"{len(names)} program(s) on fake {args.device} tensors")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
