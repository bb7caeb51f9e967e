"""Which part of the served bf16 srn64 path turns a view to NaN after a
weights swap of +0.05 (``chip_smoke.py`` phase ``serve``'s swap) at 2
lanes a call: the hand-written kernels (rows 1 and 3), or bf16's range.

One process on one card: srn64 at full width with ``chip_smoke.py``'s
seeded random weights serves phase ``serve_mesh``'s traffic (3 requests,
then a fourth and the swap after the first view step) at up to 4 lanes a
call, each view step's plan recorded.  Every plan is then run again,
eagerly, with the weights of its generation: at 2 lanes a call (each
half of the lanes, as a rank of a data=2 mesh runs it) in bf16 with the
kernels, in bf16 with the plain versions of rows 1 and 3
(``set_kernels(model, "torch")``), in float32 with the kernels (TF32
off), and at the plan's own lanes with the kernels in both (each view
step's rel. L2 between 2 lanes a call and the plan's lanes: what the
batch shape alone moves, in bf16 and in float32).  For the
first half-plan whose bf16 views hold a NaN, the run is repeated with a
forward hook on every module, which names the first module whose output
is not finite and the largest magnitude of its input.

Prints one JSON object per line (``"what"``: ``served``, ``step``,
``first_non_finite``, ``summary``), the card's name and power limit
first.  Run on the card from the repo root:

    python tools/serve_nan_witness.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from diff3d_tpu_torch.diffusion import Draws  # noqa: E402
from diff3d_tpu_torch.models.layers import set_kernels  # noqa: E402
from diff3d_tpu_torch.ops import build  # noqa: E402
from diff3d_tpu_torch.sampling import Sampler  # noqa: E402
from diff3d_tpu_torch.serving.ranks import lane_generators  # noqa: E402

SWAP = 0.05                     # the serve phase's swap: every weight + SWAP
WAYS = ("bf16_kernels_2_lanes", "bf16_plain_rows_1_3_2_lanes",
        "f32_kernels_2_lanes", "bf16_kernels_plan_lanes",
        "f32_kernels_plan_lanes")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def serve(cfg, model, swap):
    """Phase ``serve_mesh``'s traffic on one process: the results, the
    plans and each view step's returned views."""
    svc = cs._mesh_service(cfg, model)
    eng = svc.engine
    plans, make_plan = [], eng._plan

    def plan_of(active):
        plans.append(make_plan(active))
        return plans[-1]

    eng._plan = plan_of
    steps = cs._mesh_recorder(eng)
    results, log = cs._mesh_traffic(svc, swap)
    return results, plans, steps, log


def run_plan(sampler, plan, lanes_a_call):
    """The plan's views, ``lanes_a_call`` lanes at a time (float32, on
    the host)."""
    device = sampler.device
    draws = [Draws(g) for g in lane_generators(plan.gen_states, device)]
    draws += [Draws(torch.Generator(device).manual_seed(plan.pad_seed))
              for _ in range(plan.lanes - plan.n)]
    outs = []
    for at in range(0, plan.lanes, lanes_a_call):
        sl = slice(at, at + lanes_a_call)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[sl])).to(device)

        out, _, _ = sampler.step_many(
            t(plan.record_imgs), t(plan.record_R), t(plan.record_T),
            plan.steps[sl], t(plan.K), draws[sl])
        outs.append(out.float().cpu())
    return torch.cat(outs)


def load(model, state):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(state[k])


def first_non_finite(model, fn):
    """``fn()`` with a forward hook on every module of ``model``: the
    first module (in call order) whose output holds a non-finite value,
    its NaN and inf counts, and the largest magnitude of its input."""
    found = {}

    def hook(name):
        def check(mod, args, out):
            if found or not torch.is_tensor(out) or \
                    not out.is_floating_point():
                return
            if not bool(torch.isfinite(out).all()):
                x = next((a for a in args if torch.is_tensor(a)), None)
                found.update(
                    module=name, type=type(mod).__name__,
                    nan=int(torch.isnan(out).sum()),
                    inf=int(torch.isinf(out).sum()),
                    input_max_abs=(None if x is None else
                                   float(x.float().abs().max())),
                    input_finite=(None if x is None else
                                  bool(torch.isfinite(x).all())))
        return check

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules() if n]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return found or None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serve_nan_witness: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    cfg = cs._mesh_cfg()
    model = cs.random_model(cfg)
    weights = [{k: v.clone() for k, v in model.state_dict().items()}]
    weights.append({k: v + SWAP for k, v in weights[0].items()})
    results, plans, steps, log = serve(cfg, model, weights[1])
    emit({"what": "served", "lanes": [r["lanes"] for r in log],
          "nan_per_request": [int(np.isnan(r).sum()) for r in results],
          "nan_per_step": [int(torch.isnan(s["views"]).sum())
                           for s in steps]})

    cfg32, f32 = cs._tp_f32(cfg, cs.random_model(cfg))
    samplers = {
        "bf16": Sampler(model, cfg, device="cuda", steps=cs.SERVE_STEPS,
                        cuda_graphs=False),
        "f32": Sampler(f32, cfg32, device="cuda", steps=cs.SERVE_STEPS,
                       cuda_graphs=False)}
    half = cs.RING_WORLD
    culprit = None
    counts = {w: 0 for w in WAYS}
    for i, (plan, got) in enumerate(zip(plans, steps)):
        load(model, weights[plan.generation])
        load(f32, weights[plan.generation])
        m = max(1, plan.lanes // half)
        views = {"bf16_kernels_2_lanes": run_plan(samplers["bf16"], plan, m)}
        set_kernels(model, "torch")
        views["bf16_plain_rows_1_3_2_lanes"] = run_plan(
            samplers["bf16"], plan, m)
        set_kernels(model, "cuda")
        with cs._NoTF32():
            views["f32_kernels_2_lanes"] = run_plan(samplers["f32"], plan, m)
        views["bf16_kernels_plan_lanes"] = run_plan(
            samplers["bf16"], plan, plan.lanes)
        with cs._NoTF32():
            views["f32_kernels_plan_lanes"] = run_plan(
                samplers["f32"], plan, plan.lanes)
        row = {"what": "step", "step": i, "lanes": plan.lanes,
               "lanes_a_call_halves": m, "generation": plan.generation,
               "served_nan": int(torch.isnan(got["views"]).sum())}
        for w, v in views.items():
            nan = torch.isnan(v).flatten(1).sum(1)
            fin = v[torch.isfinite(v)]
            row[w] = {"nan": int(nan.sum()),
                      "lanes_with_nan": [int(k) for k in
                                         torch.nonzero(nan).flatten()],
                      "max_abs_finite": (float(fin.abs().max())
                                         if fin.numel() else None)}
            counts[w] += int(nan.sum())
        row["rel_l2_f32_vs_bf16_kernels"] = cs._rel_l2(
            torch.nan_to_num(views["bf16_kernels_2_lanes"]),
            views["f32_kernels_2_lanes"])
        # One view step at 2 lanes a call against the plan's own lanes
        # (the NaN lanes left out): what the batch shape alone moves.
        row["rel_l2_2_lanes_vs_plan_lanes"] = {
            dt: cs._rel_l2(views[f"{dt}_kernels_2_lanes"][ok],
                           views[f"{dt}_kernels_plan_lanes"][ok])
            for dt in ("bf16", "f32")
            for ok in [~torch.isnan(views[f"{dt}_kernels_2_lanes"])
                       .flatten(1).any(1)] if bool(ok.any())}
        emit(row)
        if culprit is None and row["bf16_kernels_2_lanes"]["nan"]:
            lane = row["bf16_kernels_2_lanes"]["lanes_with_nan"][0]
            culprit = (plan, lane - lane % m, m)
    if culprit is not None:
        plan, at, m = culprit
        load(model, weights[plan.generation])
        for impl in ("cuda", "torch"):
            set_kernels(model, impl)
            found = first_non_finite(model, lambda: run_plan(
                samplers["bf16"], _half(plan, at, m), m))
            emit({"what": "first_non_finite", "kernels": impl,
                  "plan_lanes": [at, at + m], "found": found})
        set_kernels(model, "cuda")
    emit({"what": "summary", "nan_by_way": counts,
          "seconds": round(time.perf_counter() - t0, 3)})


def _half(plan, at, m):
    """The plan cut to lanes ``[at, at + m)`` (their generator states;
    a padding lane's seed stays the plan's)."""
    sl = slice(at, at + m)
    live = max(0, min(plan.n, at + m) - at)
    return dataclasses.replace(
        plan, lanes=m, n=live, record_imgs=plan.record_imgs[sl],
        record_R=plan.record_R[sl], record_T=plan.record_T[sl],
        K=plan.K[sl], steps=plan.steps[sl],
        gen_states=plan.gen_states[at:at + live],
        draws=plan.draws[at:at + live])


if __name__ == "__main__":
    main()
