#!/usr/bin/env python3
"""Time the port's GroupNorm forward kernel at every srn64 GroupNorm site
under its default cluster plan and every alternative.

The sites are recorded with forward hooks on the srn64 X-UNet, as
``chip_smoke.py`` records them: the train step's at one microbatch of
``--batch`` examples (N = 2 x batch frames) and the sampler step's at
2B = 16 (N = 32).  For each site and dtype (bf16, f32), inputs from a
seed (FiLM halves as strided views of one ``[N, L, 2C]`` tensor), the
kernel is launched through ``cuda_film.launch`` under every plan
``(cluster, rows_per_cta, onchip)`` with cluster 1..16 that fits the 227
KB a CTA may use and that ``cudaOccupancyMaxActiveClusters`` says the
card can hold (a plan that does not is reported as refused).  Each plan's
output and statistics are checked against the plain version at
``chip_smoke.py``'s tolerances, and its device time taken with CUDA events
behind a spinning stream (``chip_smoke.device_ms``: the host is out of the
window).  The train sites save the statistics (as autograd records them);
the sampler's do not.  Prints the card's name and power limit, then one
JSON line: per site and plan the time, the bound (bytes over 3.35 TB/s,
``chip_smoke.gn_forward_work``) and the share of the bound, and per step
and dtype the sum over sites of each site's default and best plan.

Usage (on the machine with the card, from the repo root):
    python3 tools/bench_gn_forward.py [--batch 128] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def candidate_plans(L, C, G, itemsize):
    """Every ``(cluster, rows_per_cta, onchip)`` whose CTA fits 227 KB."""
    from diff3d_tpu_torch.ops import cuda_film

    aux = cuda_film._fwd_aux_bytes(C, G, itemsize)
    plans = []
    for cs in (1, 2, 4, 8, 16):
        rows = -(-L // cs)
        for onchip in (True, False):
            if aux + (rows * C * itemsize if onchip else 0) \
                    <= cuda_film.SMEM_MAX:
                plans.append((cs, rows, onchip))
    return plans


def bench_site(lib, site, count, dtype, save_stats, seed, iters):
    import torch

    from diff3d_tpu_torch.ops import cuda_film

    N, L, C, G, film, silu = site
    x, gamma, beta, kw = chip_smoke.gn_inputs((N, L, C, G), dtype, film,
                                              seed)
    sc, sh = kw.get("scale"), kw.get("shift")
    tol = chip_smoke.F32_TOL if dtype == torch.float32 \
        else chip_smoke.BF16_TOL
    ref_stats = cuda_film.groupnorm_stats_reference(x, G)
    ref = cuda_film.groupnorm_reference(x, gamma, beta, silu=silu,
                                        stats=ref_stats, **kw)
    itemsize = x.element_size()
    default = cuda_film.forward_plan(N, L, C, G, itemsize, film)
    plans = candidate_plans(L, C, G, itemsize)
    plans.remove(default)
    _, nbytes = chip_smoke.gn_forward_work(N, L, C, G, film, save_stats,
                                           itemsize)
    bound_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    rows = []
    for plan in [default] + plans:
        clusters = cuda_film.max_active_clusters(lib, L, C, G, plan, dtype,
                                                 film, silu)
        if clusters < 1:
            rows.append({"plan": plan, "refused": "max active clusters 0"})
            continue

        def run(plan=plan):
            return cuda_film.launch(lib, x, gamma, beta, sc, sh,
                                    num_groups=G, silu=silu,
                                    stream=chip_smoke._stream(),
                                    save_stats=True, plan=plan)

        out, stats = run()
        torch.cuda.synchronize()
        worst = max(chip_smoke._err_over_tol(out, ref, tol)[1],
                    chip_smoke._err_over_tol(stats, ref_stats,
                                             chip_smoke.F32_TOL)[1])
        if not worst <= 1.0:
            raise AssertionError(f"plan {plan} at {site} {dtype}: error "
                                 f"{worst} of tolerance")

        def timed(plan=plan):
            return cuda_film.launch(lib, x, gamma, beta, sc, sh,
                                    num_groups=G, silu=silu,
                                    stream=chip_smoke._stream(),
                                    save_stats=save_stats, plan=plan)

        ms = chip_smoke.device_ms(timed, iters)
        rows.append({"plan": plan, "max_active_clusters": clusters,
                     "us": round(ms * 1e3, 2),
                     "pct_of_bound": round(100 * bound_ms / ms, 1),
                     "worst_err_over_tol": round(worst, 4)})
    if "us" not in rows[0]:
        raise AssertionError(f"forward_plan's {default} at {site} {dtype} "
                             "does not fit the card")
    best = min((r for r in rows if "us" in r), key=lambda r: r["us"])
    return ({"N": N, "L": L, "C": C, "G": G, "film": film, "silu": silu,
             "dtype": str(dtype).replace("torch.", ""), "count": count,
             "bound_us": round(bound_ms * 1e3, 3), "plans": rows,
             "best": best["plan"]},
            count * rows[0]["us"] / 1e3, count * best["us"] / 1e3,
            count * bound_ms)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None,
                   help="write the full JSON here and print only the "
                        "per-step sums")
    args = p.parse_args(argv)

    import torch

    from diff3d_tpu_torch.ops import build

    card = chip_smoke.phase_device()
    lib = build.library("film")
    cfg, model = chip_smoke.srn64_model()
    paths = {
        "train": (chip_smoke.record_sites(
            model, *chip_smoke.model_batch(cfg, args.batch, seed=6))[0],
            True),
        "sampler": (chip_smoke.record_sites(
            model, *chip_smoke.model_batch(
                cfg, 2 * len(cfg.diffusion.guidance_weights), seed=5))[0],
            False)}
    del model
    torch.cuda.empty_cache()

    sites, totals = [], {}
    for path, (gn_sites, save_stats) in paths.items():
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{path}_{str(dtype).replace('torch.', '')}"
            tot = {"default_ms": 0.0, "best_ms": 0.0, "bound_ms": 0.0}
            for si, (site, count) in enumerate(sorted(gn_sites.items())):
                row, d, b, bound = bench_site(lib, site, count, dtype,
                                              save_stats, si, args.iters)
                row["path"] = path
                sites.append(row)
                tot["default_ms"] += d
                tot["best_ms"] += b
                tot["bound_ms"] += bound
            tot = {k: round(v, 3) for k, v in tot.items()}
            tot["default_pct_of_bound"] = round(
                100 * tot["bound_ms"] / tot["default_ms"], 1)
            totals[key] = tot
    result = {"card": card, "batch": args.batch, "per_step": totals,
              "sites": sites}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
        del result["sites"]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
