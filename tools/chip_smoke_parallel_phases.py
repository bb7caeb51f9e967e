"""Parts of ``chip_smoke.py`` alone, on the card, for comparing two trees
in one call.  One mode a run:

* ``parallel`` (the default): ``parallel`` (with the gloo ranks of
  ``tensor_parallel``, ``context_parallel`` and ``serve_mesh``), then
  those three phases, after the phases whose outputs they read
  (``device``, ``build``, ``train_graph``, ``train``); ends with
  ``PHASES_S <seconds>``, the wall seconds from the start of ``parallel``
  to the end of ``serve_mesh``.
* ``tail``: the phases after ``serve_mesh``, in ``chip_smoke.py``'s
  order (``distill`` and its sites, ``convert``, the srn128 phases,
  ``srn128_init_from``), after the phases whose outputs they read
  (``device``, ``build``, the srn64 training sites, ``train``); ends
  with ``TAIL_S <seconds>`` from the start of ``distill``.
* ``eager``: the srn64 sampler's reverse step through
  ``Sampler.step_many``, eager (``cuda_graphs=False``) and as a CUDA
  graph, for N = 1 and 4 objects (2B = 16 rows each, bf16, seeded random
  weights, ``EAGER_STEPS`` ancestral steps a view): one JSON line with
  the wall ms per step of each of ``EAGER_REPEATS`` views (each after a
  warm-up view, each ending in a device sync), the card's name and
  power limit, and the tree's directory.
* ``opcall``: the host microseconds a call of the GroupNorm wrapper
  (``fused_groupnorm``, bf16 [2, 64, 128], 32 groups, SiLU, under
  ``inference_mode``) costs, over ``OPCALL_CALLS`` calls ending in a
  device sync, ``OPCALL_REPEATS`` times: the kernel takes a few
  microseconds, so the call's host path is the time.  One JSON line.

Run it with the root of a checkout as the working directory (that
checkout's ``chip_smoke.py`` and ``diff3d_tpu_torch`` are the ones
imported), e.g. with two trees, each unpacked with ``git archive`` into a
directory of its own under ``build/``, in the order a, b, b, a::

    (cd build/tree_a && python3 ../../tools/chip_smoke_parallel_phases.py tail)

Every phase prints its line as ``chip_smoke.py`` does.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

EAGER_STEPS = 16
EAGER_REPEATS = 10
OPCALL_CALLS = 3000
OPCALL_REPEATS = 7


def parallel() -> None:
    import torch

    cs.phase_device()
    cs.phase_build()
    graph_run = cs.phase_train_graph(cs.TRAIN_ACCUM)
    cs.phase_train(cs.TRAIN_ACCUM)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, tp_run, cp_run, mesh_run = cs.phase_parallel(graph_run)
    del graph_run
    cs.phase_tensor_parallel(*tp_run)
    cs.phase_context_parallel(*cp_run)
    cs.phase_serve_mesh(*mesh_run, {})
    print("PHASES_S", round(time.perf_counter() - t0, 3), flush=True)
    shutil.rmtree(cs.WORKDIR, ignore_errors=True)


def tail() -> None:
    import torch

    cs.phase_device()
    ptxas = cs.phase_build()
    cfg, model = cs.srn64_model()
    mb = cs.TRAIN_BATCH // cs.TRAIN_ACCUM
    gn_train, attn_train = cs.record_sites(model,
                                           *cs.model_batch(cfg, mb, seed=6))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cs.phase_train(cs.TRAIN_ACCUM)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cs.phase_distill()
    cs.phase_groupnorm(gn_train, phase="distill_groupnorm", odd_shapes=False)
    cs.phase_attention(attn_train, phase="distill_attention",
                       extra_shapes=False)
    cs.phase_convert()
    cfg128, model128 = cs.phase_srn128_model(ptxas)
    cs.phase_srn128_sampler(cfg128, model128)
    _, csites = cs.phase_serve_cascade(cfg128, model128)
    for p in ("draft", "refine"):
        cs.phase_groupnorm(csites[p][0], phase="serve_cascade_groupnorm",
                           odd_shapes=False, site=p)
    for p in ("draft", "refine"):
        cs.phase_attention(csites[p][1], phase="serve_cascade_attention",
                           extra_shapes=False, site=p)
    gc.collect()
    torch.cuda.empty_cache()
    t128 = cs.phase_srn128_train(cfg128, model128)
    del model128
    gc.collect()
    torch.cuda.empty_cache()
    cs.phase_srn128_sites(cfg128, t128["accum_steps"],
                          t128["launches_per_step"])
    cs.phase_srn128_init_from(t128["accum_steps"])
    print("TAIL_S", round(time.perf_counter() - t0, 3), flush=True)
    shutil.rmtree(cs.WORKDIR, ignore_errors=True)


def eager() -> None:
    import numpy as np
    import torch

    from diff3d_tpu_torch.config import srn64_config
    from diff3d_tpu_torch.diffusion import Draws
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler, record_capacity

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    cfg = srn64_config()
    model = build_model(cfg.model, "cuda", seed=0, randomize_zero_init=True)
    H, B = cfg.model.H, len(cfg.diffusion.guidance_weights)
    out = {"tree": os.getcwd(), "card": card, "steps": EAGER_STEPS}
    for graphs in (False, True):
        sampler = Sampler(model, cfg, device="cuda", steps=EAGER_STEPS,
                          cuda_graphs=graphs)
        for n in (1, 4):
            cap = record_capacity(2)
            rng = np.random.default_rng(n)
            rec = torch.tensor(rng.uniform(-1, 1, (n, cap, B, H, H, 3)),
                               dtype=torch.float32, device="cuda")
            eye = torch.eye(3, device="cuda")
            R = eye.expand(n, cap, 3, 3).contiguous()
            T = torch.zeros((n, cap, 3), device="cuda")
            K = eye.expand(n, 3, 3).contiguous()

            def view():
                gens = [Draws(torch.Generator("cuda").manual_seed(i))
                        for i in range(n)]
                sampler.step_many(rec.clone(), R, T, [1] * n, K, gens)
                torch.cuda.synchronize()

            view()                                   # warm-up (capture)
            times = []
            for _ in range(EAGER_REPEATS):
                t0 = time.perf_counter()
                view()
                times.append(1e3 * (time.perf_counter() - t0) / EAGER_STEPS)
            out[f"{'graph' if graphs else 'eager'}_lanes{n}_ms_per_step"] \
                = [round(t, 3) for t in times]
    print(json.dumps(out), flush=True)


def opcall() -> None:
    import torch

    from diff3d_tpu_torch.ops import cuda_film

    x = torch.randn(2, 64, 128, device="cuda", dtype=torch.bfloat16)
    g = torch.ones(128, device="cuda")
    b = torch.zeros(128, device="cuda")

    def call():
        cuda_film.fused_groupnorm(x, g, b, num_groups=32, silu=True)

    call()                                           # builds the kernel
    torch.cuda.synchronize()
    per = []
    with torch.inference_mode():
        for _ in range(OPCALL_REPEATS):
            t0 = time.perf_counter()
            for _ in range(OPCALL_CALLS):
                call()
            torch.cuda.synchronize()
            per.append(round(1e6 * (time.perf_counter() - t0)
                             / OPCALL_CALLS, 3))
    print(json.dumps({"tree": os.getcwd(),
                      "fused_groupnorm_us_per_call": per}), flush=True)


MODES = {"parallel": parallel, "tail": tail, "eager": eager,
         "opcall": opcall}


def main() -> None:
    MODES[sys.argv[1] if len(sys.argv) > 1 else "parallel"]()


if __name__ == "__main__":
    main()
