#!/usr/bin/env python3
"""Time the port's GroupNorm backward kernel at the srn64 train step's
GroupNorm sites under its default cluster plan and the alternatives.

The sites are recorded with forward hooks on the srn64 X-UNet at one
microbatch of ``--batch`` examples (N = 2 x batch frames), as
``chip_smoke.py`` records them.  For each site, bf16 inputs from a seed
(FiLM halves as strided views of one ``[N, L, 2C]`` tensor), the wrapper
``groupnorm_backward``'s kernel is timed with CUDA events under
``cuda_film.backward_plan``'s plan and under each alternative: half,
the same and twice the cluster, each keeping x and g in shared memory
and re-reading them (a plan whose rows do not fit is reported as
refused).  Every plan's result is checked against the
plain version at the card tolerance, as ``chip_smoke.py`` checks.  Prints the
card's name and power limit, then one JSON line: per site and plan the
time, the bound (bytes over 3.35 TB/s: x, g, scale and, under SiLU,
shift read once; dx, dscale, dshift written once) and the share of the
bound, and
per train step the sum over sites of each site's default and best plan.

Usage (on the machine with the card, from the repo root):
    python3 tools/bench_gn_backward.py [--batch 128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    from diff3d_tpu_torch.ops import build, cuda_film

    card = chip_smoke.phase_device()
    lib = build.library("film")
    cfg, model = chip_smoke.srn64_model()
    gn_sites, _ = chip_smoke.record_sites(
        model, *chip_smoke.model_batch(cfg, args.batch, seed=6))
    del model
    torch.cuda.empty_cache()

    sites, total = [], {"default_ms": 0.0, "best_ms": 0.0, "bound_ms": 0.0}
    for si, ((N, L, C, G, film, silu), count) in enumerate(
            sorted(gn_sites.items())):
        x, gamma, beta, kw = chip_smoke.gn_inputs((N, L, C, G),
                                                  torch.bfloat16, film, si)
        gen = torch.Generator("cuda").manual_seed(100 + si)
        g = torch.randn(N, L, C, generator=gen, device="cuda").to(x.dtype)
        stats = cuda_film.groupnorm_stats_reference(x, G).contiguous()
        sc, sh = kw.get("scale"), kw.get("shift")
        want = cuda_film.groupnorm_backward_reference(
            x, g, gamma, beta, sc, sh, stats, num_groups=G, silu=silu)
        default = cuda_film.backward_plan(N, L, C, G, 2)
        cs, _, onchip = default
        plans = [default] + [
            (c2, -(-L // c2), oc) for c2 in (cs // 2, cs, cs * 2)
            for oc in (onchip, not onchip)
            if 1 <= c2 <= cuda_film.MAX_CLUSTER
            and (c2, -(-L // c2), oc) != default]
        elems = N * L * C
        nbytes = (2 * elems * (2 + film + (film and silu))  # x, g, sc, sh
                  + 2 * elems * (1 + (2 if film else 0))    # dx, dsc, dsh
                  + 16 * C + 8 * N * G)
        bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        rows = []
        for plan in plans:
            def run(plan=plan):
                return cuda_film.launch_backward(
                    lib, x, g, gamma, beta, sc, sh, stats, num_groups=G,
                    silu=silu, stream=None, plan=plan)
            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as e:       # a plan the card cannot place
                rows.append({"plan": plan, "error": str(e)})
                continue
            worst = 0.0
            for n, a, b in zip(("dx", "dscale", "dshift", "dgamma", "dbeta"),
                               got, want):
                if b is None:
                    continue
                tol = (chip_smoke.SUM_TOL if n in ("dgamma", "dbeta")
                       else chip_smoke.BF16_TOL)
                worst = max(worst, chip_smoke._err_over_tol(a, b, tol)[1])
            if not worst <= 1.0:
                raise AssertionError(f"plan {plan} at {(N, L, C, G)}: "
                                     f"error {worst} of tolerance")
            ms = chip_smoke.cuda_ms(run, args.iters)
            rows.append({"plan": plan, "us": round(ms * 1e3, 2),
                         "pct_of_bound": round(100 * bound_ms / ms, 1),
                         "worst_err_over_tol": round(worst, 4)})
        timed = [r for r in rows if "us" in r]
        best = min(timed, key=lambda r: r["us"])
        total["default_ms"] += count * timed[0]["us"] / 1e3
        total["best_ms"] += count * best["us"] / 1e3
        total["bound_ms"] += count * bound_ms
        sites.append({"N": N, "L": L, "C": C, "G": G, "film": film,
                      "silu": silu, "per_train_step": count,
                      "bound_us": round(bound_ms * 1e3, 3), "plans": rows})
    total = {k: round(v, 3) for k, v in total.items()}
    total["default_pct_of_bound"] = round(
        100 * total["bound_ms"] / total["default_ms"], 1)
    print(json.dumps({"card": card, "batch": args.batch, "sites": sites,
                      "per_train_step": total}), flush=True)


if __name__ == "__main__":
    main()
