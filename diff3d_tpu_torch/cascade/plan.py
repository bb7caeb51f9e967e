"""Cascade plans: what runs at which resolution, and where refinement
starts (counterpart: ``diff3d_tpu/cascade/plan.py``, a copy).

A cascade serves one object twice: a cheap low-resolution
*draft* pass (typically the distilled student, few DDIM steps) whose
frames stream to the client immediately, and a truncated high-resolution
*refine* pass that upsamples each draft, renoises it to ``start_t`` via
the forward process, and runs only the remaining reverse steps.  The plan
is the static description of that pair — everything the serving layer
needs to build both compiled programs before any request arrives.

The CLI grammar (``serve_cli --cascade``) is
``draft=64:ddim:8,refine=128:ancestral:64@t0.4`` — per phase
``resolution:sampler:steps``, the refine phase carrying its truncation
point as ``@t<start_t>``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from diff3d_tpu_torch.diffusion import SAMPLER_KINDS


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One cascade phase: ``resolution`` (square H=W), the reverse-process
    ``sampler_kind``/``steps`` schedule, and — refine phase only — the
    ``start_t`` grid point truncation begins at."""

    resolution: int
    sampler_kind: str
    steps: int
    start_t: Optional[float] = None

    def __post_init__(self):
        if self.resolution < 1:
            raise ValueError(f"resolution={self.resolution} must be >= 1")
        if self.sampler_kind not in SAMPLER_KINDS:
            raise ValueError(
                f"sampler_kind={self.sampler_kind!r} not in "
                f"{SAMPLER_KINDS}")
        if self.steps < 1:
            raise ValueError(f"steps={self.steps} must be >= 1")

    def spec(self) -> str:
        """The CLI form, e.g. ``"128:ancestral:64@t0.4"``."""
        s = f"{self.resolution}:{self.sampler_kind}:{self.steps}"
        if self.start_t is not None:
            s += f"@t{self.start_t:g}"
        return s

    @classmethod
    def parse(cls, text: str) -> "PhaseSpec":
        body, _, trunc = text.partition("@")
        parts = body.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"phase spec {text!r}: expected "
                "'<resolution>:<sampler>:<steps>[@t<start_t>]'")
        start_t = None
        if trunc:
            if not trunc.startswith("t"):
                raise ValueError(
                    f"phase spec {text!r}: truncation suffix must be "
                    "'@t<start_t>' (e.g. '@t0.4')")
            start_t = float(trunc[1:])
        try:
            resolution, steps = int(parts[0]), int(parts[2])
        except ValueError:
            raise ValueError(
                f"phase spec {text!r}: resolution and steps must be "
                "integers") from None
        return cls(resolution=resolution, sampler_kind=parts[1],
                   steps=steps, start_t=start_t)


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """The draft → upsample → refine pair.

    Invariants enforced here (not per-phase): the draft never truncates
    (it starts from pure noise — there is nothing upstream of it), the
    refine phase always does (``start_t`` is what makes it a refinement
    rather than a second full pass), and refinement runs at a strictly
    higher resolution than the draft it consumes.
    """

    draft: PhaseSpec
    refine: PhaseSpec

    def __post_init__(self):
        if self.draft.start_t is not None:
            raise ValueError(
                f"draft phase {self.draft.spec()!r} must not carry a "
                "start_t — drafts start from pure noise")
        if self.refine.start_t is None:
            raise ValueError(
                f"refine phase {self.refine.spec()!r} needs a start_t "
                "truncation point ('@t<start_t>')")
        if self.refine.resolution <= self.draft.resolution:
            raise ValueError(
                f"refine resolution {self.refine.resolution} must exceed "
                f"the draft's {self.draft.resolution}")

    def spec(self) -> str:
        return f"draft={self.draft.spec()},refine={self.refine.spec()}"

    @classmethod
    def parse(cls, text: str) -> "CascadePlan":
        """Parse ``draft=64:ddim:8,refine=128:ancestral:64@t0.4``."""
        phases = {}
        for item in text.split(","):
            name, eq, spec = item.partition("=")
            if not eq or name not in ("draft", "refine"):
                raise ValueError(
                    f"cascade plan item {item!r}: expected "
                    "'draft=<spec>' or 'refine=<spec>'")
            if name in phases:
                raise ValueError(f"cascade plan {text!r} repeats {name!r}")
            phases[name] = PhaseSpec.parse(spec)
        missing = {"draft", "refine"} - phases.keys()
        if missing:
            raise ValueError(
                f"cascade plan {text!r} is missing {sorted(missing)}")
        return cls(draft=phases["draft"], refine=phases["refine"])
