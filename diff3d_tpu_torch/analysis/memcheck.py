"""The memory check (counterpart: ``diff3d_tpu/analysis/memcheck.py``).

Reads each registered program's :class:`~diff3d_tpu_torch.analysis.mem.
MemReport` against its manifest under ``runs/torch_memcheck/`` (rules
MC4xx; MC001-003 are the manifest contract's):

  * MC401 -- the peak bytes by liveness grew past the pin;
  * MC402 -- an input the program is meant to update in place (its
    ``donated`` set: a sampler's records, a train step's parameters,
    Adam's state and EMA) is no longer written in place: the update went
    to a copy;
  * MC404 -- the step-invariant FLOPs (work of the reverse step that is
    the same at every step) grew past the pin.

The serving programs' ``budgets.peak_bytes`` are also the admission pins
``worker_cli --memcheck_dir`` loads (:data:`SERVING_PROGRAMS`).
"""

from __future__ import annotations

from typing import List

from diff3d_tpu_torch.analysis import ir, mem
from diff3d_tpu_torch.analysis.manifests import Finding

TOOL = "torch_memcheck"
PREFIX = "MC"
MANIFEST_DIR = "runs/torch_memcheck"

#: The programs whose pins the serving admission gate reads.
SERVING_PROGRAMS = ("step_many", "step_many_ddim", "serving_warmup",
                    "step_many_cascade_draft", "step_many_cascade_refine")


def observe(program: ir.Program) -> tuple:
    rep = mem.analyze_memory(program)
    observed = rep.to_json()
    observed["config"] = program.config
    budgets = {"peak_bytes": rep.peak_bytes,
               "argument_bytes": rep.argument_bytes,
               "donated": sorted(set(rep.donated)
                                 & set(rep.written_inputs)),
               "step_invariant_flops": rep.step_invariant_flops}
    return budgets, observed


def check(program: ir.Program, manifest: dict) -> List[Finding]:
    name = program.name
    budgets, obs = observe(program)
    pin = manifest.get("budgets", {})
    out: List[Finding] = []
    if budgets["peak_bytes"] > pin.get("peak_bytes", 0):
        out.append(Finding("MC401", name, "peak_bytes",
                           f"peak {budgets['peak_bytes']} bytes, pinned "
                           f"{pin.get('peak_bytes', 0)}"))
    written = set(obs["written_inputs"])
    for k in pin.get("donated", []):
        if k not in written:
            out.append(Finding(
                "MC402", name, k,
                f"{k} is no longer updated in place: the program writes "
                "a copy"))
    if budgets["step_invariant_flops"] > pin.get("step_invariant_flops", 0):
        out.append(Finding(
            "MC404", name, "step_invariant_flops",
            f"{budgets['step_invariant_flops']} step-invariant FLOPs a "
            f"step, pinned {pin.get('step_invariant_flops', 0)}"))
    return out
