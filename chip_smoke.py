#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diff3d_tpu_torch``) on one NVIDIA card.

Phases, one JSON line each; any failure raises and the run exits nonzero:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile both CUDA sources with nvcc (in parallel); the
     tensor-core kernels (forward, dK/dV, dQ) at a padded head dim <= 128
     must not spill.
  3. groupnorm — the fused GroupNorm kernel against its plain version on
     every GroupNorm site shape of the srn64 sampler and the odd shapes of
     ``tests/test_pallas_film.py`` (and G up to C = 4096, L = 1), all four
     variants, bf16 and f32; every sampler site's cluster plan (it must
     fit the card: ``cudaOccupancyMaxActiveClusters`` > 0), output and
     statistics bit-identical over two runs; per site the wrapper's time
     back to back, its device time, its host time and its share of the
     bound; times of the plain version and ``F.group_norm`` + elementwise
     ops.
  4. attention — the flash kernel against its plain version at the srn64
     and srn128 attention sites plus padded / non-square shapes, bf16 and
     f32; times of kernel, plain version and
     ``F.scaled_dot_product_attention``.  D = 320 and 512 are checked,
     untimed.
  5. model   — the srn64 full-width X-UNet, bf16, batch 2B=16, seeded
     random weights: kernel path against plain path, ms per forward and
     launches per forward.
  6. sampler — ``Sampler.synthesize`` on one seeded synthetic object (three
     views, orbit poses, SRN-like K): two views on the 256-step ancestral
     schedule with guidance weights 0..7.  This is the sampling path: the
     kernels' launch counts are set to 0 just before it and read after.
  7. groupnorm_backward — at every GroupNorm site shape of one srn64
     training microbatch (recorded with hooks), bf16 and f32, random
     upstream gradients: ``fused_groupnorm`` as autograd records it (with
     ``save_stats``) and ``.backward`` through it, against the plain
     versions; times of the wrappers, the plain version,
     the autograd backward of ``F.group_norm`` + FiLM/SiLU ops, and the
     bound, per site (with the forward's and the backward's share of
     their bounds and cluster plans) and per train step; the backward
     cluster kernel's edge shapes checked untimed.
  8. attention_backward — the same at the srn64 training attention sites
     and srn128's two shapes: ``flash_attention_lse`` as autograd records
     it and ``backward`` through it, with and without an lse cotangent,
     against the plain versions; the dK/dV and dQ wrappers timed beside the
     autograd backward of ``F.scaled_dot_product_attention``.  D = 320 and
     512 are checked, untimed.
  9. train_step — one srn64 train step (seeded random weights, batch 16)
     through the kernels and through the plain versions
     (``set_kernels(model, "torch")``) from the same state with the same
     draws, in f32 and in bf16: loss and gradients compared with fixed
     limits; the bf16 plain step's distance from f32 is reported beside.
 10. train — the ``Trainer`` through ``cli/train_cli.py``'s code path on
     the synthetic dataset at srn64, global batch 128: the training path,
     with the launch counts set to 0 just before it and read after;
     s/step, examples/s, peak memory, loss and grad_norm per step; then a
     checkpoint restored into a fresh trainer takes one step, which must
     equal the first trainer's next step bit for bit.

Then one ``{"kernels": [...]}`` line and, last, the device line.  The
library calls are timing yardsticks only; the port never calls them.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
F32_FLOPS = 67e12               # f32 outside the tensor cores
F32_TOL = 1e-5                  # f32 tolerance, relative to 1 + max|ref|
BF16_TOL = 2.0 ** -7            # one bf16 ulp at the output's magnitude
# f32 outputs that are sums over a whole axis (dgamma / dbeta over N*L;
# dq / dk / dv over L*D products with the cancelling dP - delta factor).
SUM_TOL = 1e-4
TRAIN_BATCH = 128               # srn64_config's global batch
TRAIN_ACCUM = 1                 # one microbatch of 128 fits (PERF.md: memory)
TRAIN_STEPS = 6
STEP_BATCH = 16                 # the kernel-vs-plain train step
# Its limits (PERF.md section 6 gives the readings each sits between): f32
# paths differ only in summation order; the bf16 gradient limit lies
# between the kernel path's distance from the plain path and the bf16
# plain step's own distance from f32.
F32_STEP_LOSS_TOL = 1e-5
F32_STEP_GRAD_TOL = 1e-5
BF16_STEP_LOSS_TOL = 1e-2
BF16_STEP_GRAD_TOL = 1e-2
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_train")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs
    (CUDA events, after ``warmup`` runs).  Python's garbage collector is
    off while they run, as in ``timeit``: a collection of this process's
    heap would otherwise land in one window as a host pause."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host time of one ``fn()`` call in µs: ``perf_counter`` over
    ``iters`` calls that are not synchronised (fewer than the launch queue
    holds), GC off."""
    import torch

    fn()
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` in ms with the host taken out: the
    stream first spins (``torch.cuda._sleep``) for longer than the host
    takes to enqueue ``iters`` calls, so the CUDA events bracket the
    kernels back to back."""
    import torch

    per_call = host_us(fn, 10) * 1e-6
    cycles = int(4e9 * (per_call * iters + 2e-4))   # 2x margin at ~2 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        gc.enable()
    return start.elapsed_time(end) / iters


def gn_forward_work(N, L, C, G, film, save_stats, itemsize=2):
    """``(f32 flops, bytes)`` of one fused GroupNorm forward, for its
    bound: ~10 flops per element; x (and scale and shift at a FiLM site)
    read once, the output written once, gamma and beta (f32), and the
    ``[2, N, G]`` f32 statistics under ``save_stats``."""
    elems = N * L * C
    return 10.0 * elems, (itemsize * elems * (2 + (2 if film else 0))
                          + 8 * C + (8 * N * G if save_stats else 0))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    # Full-precision f32 products in the plain versions (stated, not
    # assumed): TF32 would keep ~3 decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return card


def ptxas_kernels(log: str):
    """``{kernel: (registers, spill store bytes, spill load bytes)}`` from
    ``nvcc -Xptxas -v`` output, names demangled by ``c++filt`` where the
    machine has it."""
    kernels, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            kernels[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            kernels[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            kernels[name][0] = int(m.group(1))
    if kernels and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(kernels),
                               capture_output=True, text=True).stdout
        kernels = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", d): v
                   for d, v in zip(names.splitlines(), kernels.values())}
    return kernels


def phase_build():
    from diff3d_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {src: {k: f"{r} registers, {ss}/{sl} bytes spill stores/loads"
                   for k, (r, ss, sl) in ptxas_kernels(log).items()}
             for src, log in logs.items()}
    # The tensor-core kernels (forward, dK/dV, dQ) at a padded head dim
    # <= 128 must not spill (null when attention.cu was already built and
    # nvcc did not run).
    mma = {k: v for k, v in ptxas_kernels(logs.get("attention", "")).items()
           if "mma" in k}
    small = {k: v for k, v in mma.items()
             if int((re.findall(r"\d+", k.split("<")[-1]) or ["0"])[0])
             <= 128}
    dq = {k: v for k, v in small.items() if "dq_mma" in k}
    if mma and len(dq) != 3:
        raise AssertionError(f"build: dQ mma kernels at D <= 128: {dq}")
    spill_free = all(v[1] == v[2] == 0 for v in small.values())
    gn_fwd = {k: v for k, v in ptxas_kernels(logs.get("film", "")).items()
              if "gn_fwd" in k}
    emit({"phase": "build", "seconds": round(seconds, 3),
          "mma_kernels_d_le_128_spill_free": spill_free if small else None,
          "gn_fwd_kernels_spill_free": (
              all(v[1] == v[2] == 0 for v in gn_fwd.values())
              if gn_fwd else None),
          "dq_mma_kernels": {k: f"{v[0]} registers, {v[1]}/{v[2]} bytes "
                                f"spill stores/loads" for k, v in dq.items()},
          "ptxas": ptxas})
    if small and not spill_free:
        raise AssertionError("build: a tensor-core kernel at D <= 128 "
                             "spills")


# Head dims above the tensor-core kernels' 256, inside the Pallas kernel's
# 512: checked against the plain versions, not timed (no configuration
# runs them).
WIDE_ATTN = [(2, 40, 33, 2, 320), (1, 33, 70, 2, 512)]

SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def fastest_sdpa(make, iters: int = 20):
    """``(ms, backend)``: the fastest ``torch.nn.attention.sdpa_kernel``
    backend for one ``F.scaled_dot_product_attention`` call.  ``make()``,
    run under each backend, returns the callable to time; a backend that
    does not take the shape raises and is skipped."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = (math.inf, None)
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                fn = make()
                ms = cuda_ms(fn, iters)
            except RuntimeError:
                continue
        best = min(best, (ms, name))
    if best[1] is None:
        raise RuntimeError("no SDPA backend takes this call")
    return best


def _tol(ref, dtype):
    import torch

    mag = float(ref.float().abs().max())
    return (F32_TOL if dtype == torch.float32 else BF16_TOL) * (1.0 + mag)


def record_sites(model, batch, cond_mask):
    """GroupNorm and attention call shapes of one model forward, with
    their counts, from forward hooks."""
    import torch

    from diff3d_tpu_torch.models.layers import AttnLayer, FrameGroupNorm

    gn, attn = {}, {}

    def gn_hook(mod, args, kwargs, out):
        h = args[0]
        N, H, W, C = h.shape
        film = len(args) > 1 or kwargs.get("scale") is not None
        key = (N, H * W, C, mod.num_groups, film, mod.silu)
        gn[key] = gn.get(key, 0) + 1

    def attn_hook(mod, args, out):
        q, kv = args
        H = mod.num_heads
        key = (q.shape[0], q.shape[1], kv.shape[1], H, q.shape[2] // H)
        attn[key] = attn.get(key, 0) + 1

    hooks = []
    for m in model.modules():
        if isinstance(m, FrameGroupNorm):
            hooks.append(m.register_forward_hook(gn_hook, with_kwargs=True))
        elif isinstance(m, AttnLayer):
            hooks.append(m.register_forward_hook(attn_hook))
    with torch.inference_mode():
        model(batch, cond_mask)
    for h in hooks:
        h.remove()
    return gn, attn


def gn_inputs(shape, dtype, film, seed):
    import torch

    N, L, C, G = shape
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(N, L, C, generator=g, device="cuda").to(dtype)
    gamma = torch.randn(C, generator=g, device="cuda")
    beta = torch.randn(C, generator=g, device="cuda")
    kw = dict(num_groups=G)
    if film:
        e = (0.3 * torch.randn(N, L, 2 * C, generator=g,
                               device="cuda")).to(dtype)
        kw["scale"], kw["shift"] = e[..., :C], e[..., C:]   # strided views
    return x, gamma, beta, kw


def phase_groupnorm(gn_sites):
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops import build, cuda_film
    from diff3d_tpu_torch.ops.cuda_film import (fused_groupnorm,
                                                groupnorm_reference)

    odd = [(2, 256, 128, 32), (2, 256, 256, 32), (1, 256, 512, 32),
           (1, 64, 1024, 32), (2, 64, 96, 32), (1, 1000, 144, 24),
           (3, 1, 128, 32),                             # L = 1
           (2, 64, 2048, 2048), (1, 16, 4096, 4096)]    # G up to C <= 4096
    shapes = sorted({k[:4] for k in gn_sites}) + odd
    worst = 0.0
    checked = 0
    for si, shape in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            for film in (False, True):
                for silu in (False, True):
                    x, gamma, beta, kw = gn_inputs(shape, dtype, film, si)
                    out = fused_groupnorm(x, gamma, beta, silu=silu, **kw)
                    ref = groupnorm_reference(x, gamma, beta, silu=silu,
                                              **kw)
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    tol = _tol(ref, dtype)
                    if not err <= tol:
                        raise AssertionError(
                            f"groupnorm {shape} {dtype} film={film} "
                            f"silu={silu}: max abs err {err} > {tol}")
                    worst = max(worst, err / tol)
                    checked += 1

    # Times at the sampler's sites, in the model's dtype (bf16).
    lib = build.library("film")
    per_step = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "max_abs_err": 0.0}
    sites = []
    for (N, L, C, G, film, silu), count in sorted(gn_sites.items()):
        x, gamma, beta, kw = gn_inputs((N, L, C, G), torch.bfloat16, film,
                                       7)
        plan = cuda_film.forward_plan(N, L, C, G, 2, film)
        clusters = cuda_film.max_active_clusters(lib, L, C, G, plan,
                                                 x.dtype, film, silu)
        if clusters < 1:
            raise AssertionError(f"groupnorm: plan {plan} at {(N, L, C, G)}"
                                 " does not fit the card")
        runs = [cuda_film.launch(lib, x, gamma, beta, kw.get("scale"),
                                 kw.get("shift"), num_groups=G, silu=silu,
                                 stream=_stream(), save_stats=True)
                for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"groupnorm {(N, L, C, G)}: two runs "
                                 "differ")
        out = fused_groupnorm(x, gamma, beta, silu=silu, **kw)
        ref = groupnorm_reference(x, gamma, beta, silu=silu, **kw)
        err = float((out.float() - ref.float()).abs().max())

        def call():
            return fused_groupnorm(x, gamma, beta, silu=silu, **kw)

        ms = cuda_ms(call)
        dev = device_ms(call)
        host = host_us(call)
        plain = cuda_ms(lambda: groupnorm_reference(x, gamma, beta,
                                                    silu=silu, **kw))
        H = int(math.isqrt(L))
        x4 = x.view(N, H, L // H, C).permute(0, 3, 1, 2)   # channels_last
        gb, bb = gamma.to(x.dtype), beta.to(x.dtype)
        if film:
            sc4 = kw["scale"].reshape(N, H, L // H, C).permute(0, 3, 1, 2)
            sh4 = kw["shift"].reshape(N, H, L // H, C).permute(0, 3, 1, 2)

        def library():
            y = F.group_norm(x4, G, gb, bb, 1e-5)
            if film:
                y = y * (1.0 + sc4) + sh4
            return F.silu(y) if silu else y

        lib_ms = cuda_ms(library)
        flops, nbytes = gn_forward_work(N, L, C, G, film, False)
        bound = _bound(per_step, count, flops, F32_FLOPS, nbytes)
        sites.append({"N": N, "L": L, "C": C, "G": G, "film": film,
                      "silu": silu, "per_forward": count, "plan": plan,
                      "max_active_clusters": clusters,
                      "us": round(ms * 1e3, 2),
                      "device_us": round(dev * 1e3, 2),
                      "host_us": round(host, 2),
                      "set_by": "host" if host > dev * 1e3 else "device",
                      "device_pct_of_bound": round(100.0 * bound / dev, 1),
                      "plain_us": round(plain * 1e3, 2),
                      "library_us": round(lib_ms * 1e3, 2),
                      "bound_us": round(bound * 1e3, 3),
                      "max_abs_err": err})
        per_step["ms"] += count * ms
        per_step["device_ms"] += count * dev
        per_step["plain_ms"] += count * plain
        per_step["library_ms"] += count * lib_ms
        per_step["max_abs_err"] = max(per_step["max_abs_err"], err)
    per_step = _finish(per_step)
    emit({"phase": "groupnorm", "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|)",
          "bit_identical_run_to_run": True,
          "sites": sites, "per_step": per_step})
    return per_step


def attn_inputs(shape, dtype, seed):
    import torch

    B, Lq, Lk, H, D = shape
    g = torch.Generator("cuda").manual_seed(seed)
    # [B, L, C] projection outputs viewed as [B, L, H, D]: no copies.
    q = torch.randn(B, Lq, H * D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Lk, H * D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Lk, H * D, generator=g, device="cuda").to(dtype)
    return (q.view(B, Lq, H, D), k.view(B, Lk, H, D),
            v.view(B, Lk, H, D))


def phase_attention(attn_sites):
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops.cuda_attention import (attention_reference,
                                                     flash_attention)

    extra = [(32, 1024, 1024, 4, 128), (32, 256, 256, 4, 256),  # srn128
             (1, 200, 200, 2, 32), (1, 96, 160, 2, 64),
             (1, 64, 64, 2, 160), (1, 63, 65, 2, 64), (1, 129, 127, 2, 128),
             (1, 65, 63, 3, 36)]
    shapes = sorted(attn_sites) + extra
    worst = 0.0
    for si, shape in enumerate(shapes + WIDE_ATTN):     # WIDE_ATTN untimed
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(shape, dtype, si)
            out = flash_attention(q, k, v)
            ref = attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = _tol(ref, dtype)
            if not err <= tol:
                raise AssertionError(f"attention {shape} {dtype}: max abs "
                                     f"err {err} > {tol}")
            worst = max(worst, err / tol)

    per_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0, "max_abs_err": 0.0}
    flop_ms = byte_ms = 0.0
    sites = []
    for shape in shapes:
        B, Lq, Lk, H, D = shape
        count = attn_sites.get(shape, 0)
        q, k, v = attn_inputs(shape, torch.bfloat16, 11)
        out = flash_attention(q, k, v)
        err = float((out.float() - attention_reference(q, k, v).float())
                    .abs().max())
        ms = cuda_ms(lambda: flash_attention(q, k, v))
        plain = cuda_ms(lambda: attention_reference(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib, backend = fastest_sdpa(
            lambda: lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * B * H * Lq * Lk * D
        nbytes = 2.0 * B * H * D * (2 * Lq + 2 * Lk)
        bound_s = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
        sites.append({"B": B, "Lq": Lq, "Lk": Lk, "H": H, "D": D,
                      "per_forward": count, "us": round(ms * 1e3, 2),
                      "plain_us": round(plain * 1e3, 2),
                      "library_us": round(lib * 1e3, 2),
                      "library_backend": backend,
                      "bound_us": round(bound_s * 1e6, 3),
                      "bound_by": ("operations" if flops / BF16_FLOPS
                                   > nbytes / HBM_BYTES_PER_S
                                   else "bytes"),
                      "max_abs_err": err})
        if count:
            per_step["ms"] += count * ms
            per_step["plain_ms"] += count * plain
            per_step["library_ms"] += count * lib
            per_step["bound_ms"] += count * bound_s * 1e3
            per_step["max_abs_err"] = max(per_step["max_abs_err"], err)
            flop_ms += count * flops / BF16_FLOPS * 1e3
            byte_ms += count * nbytes / HBM_BYTES_PER_S * 1e3
    per_step["bound_by"] = "operations" if flop_ms > byte_ms else "bytes"
    emit({"phase": "attention", "checked": 2 * len(shapes + WIDE_ATTN),
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|)",
          "sites": sites, "per_step": per_step})
    return per_step


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _err_over_tol(got, want, tol):
    """(max abs error, error / (tol * (1 + max|want|)))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (tol * (1.0 + float(want.float().abs().max())))


def _add(acc, key, count, value):
    acc[key] = acc.get(key, 0.0) + count * value


def _bound(acc, count, flops, peak, nbytes):
    """Add one site's bound to ``acc`` and return it in ms."""
    f_ms, b_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    _add(acc, "flop_ms", count, f_ms)
    _add(acc, "byte_ms", count, b_ms)
    _add(acc, "bound_ms", count, max(f_ms, b_ms))
    return max(f_ms, b_ms)


def _finish(acc):
    out = {k: v for k, v in acc.items() if k not in ("flop_ms", "byte_ms")}
    out["bound_by"] = ("operations" if acc.get("flop_ms", 0.0)
                       > acc.get("byte_ms", 0.0) else "bytes")
    return out


def _leaf(t):
    return t.detach().clone().requires_grad_()


GN_BWD_EDGES = [(2, 4095, 128, 32), (1, 4096, 128, 32), (2, 40, 4096, 32),
                (1, 9, 4096, 2048)]


def phase_groupnorm_backward(gn_sites, accum):
    """The save_stats forward and the backward kernel at the training
    GroupNorm sites, both through the wrappers the model calls: the
    autograd ``fused_groupnorm`` on inputs that require grad (its saved
    statistics read from the autograd node), ``.backward(g)`` through it,
    and ``groupnorm_backward``.  Per-step sums count every site of the
    ``accum`` microbatches of one train step."""
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops import cuda_film
    from diff3d_tpu_torch.ops.cuda_film import (
        fused_groupnorm, groupnorm_backward, groupnorm_backward_reference,
        groupnorm_reference, groupnorm_stats_reference)

    worst, checked = 0.0, 0
    # The cluster kernel's edges, untimed: L not a multiple of the cluster,
    # N = 1, C = 4096 at G = 32 and G = 2048.
    for si, (N, L, C, G) in enumerate(GN_BWD_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, kw = gn_inputs((N, L, C, G), dtype, True, 50 + si)
            gen = torch.Generator("cuda").manual_seed(60 + si)
            g = torch.randn(N, L, C, generator=gen, device="cuda").to(dtype)
            stats = groupnorm_stats_reference(x, G).contiguous()
            args = (x, g, gamma, beta, kw["scale"], kw["shift"], stats)
            got = groupnorm_backward(*args, num_groups=G, silu=True)
            want = groupnorm_backward_reference(*args, num_groups=G,
                                                silu=True)
            torch.cuda.synchronize()
            for n, a, b in zip(("dx", "dscale", "dshift", "dgamma", "dbeta"),
                               got, want):
                t = (SUM_TOL if n in ("dgamma", "dbeta") else
                     F32_TOL if dtype == torch.float32 else BF16_TOL)
                err, ratio = _err_over_tol(a, b, t)
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"groupnorm_backward {(N, L, C, G)} {dtype}: {n} max "
                        f"abs err {err} over tolerance")
                worst = max(worst, ratio)
                checked += 1
    fwd = {"max_abs_err": 0.0}
    bwd = {"max_abs_err": 0.0}
    sites = []
    names = ("dx", "dscale", "dshift", "dgamma", "dbeta")
    for si, ((N, L, C, G, film, silu), count) in enumerate(
            sorted(gn_sites.items())):
        count *= accum
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, kw = gn_inputs((N, L, C, G), dtype, film, si)
            gen = torch.Generator("cuda").manual_seed(100 + si)
            g = torch.randn(N, L, C, generator=gen, device="cuda").to(dtype)
            sc, sh = kw.get("scale"), kw.get("shift")
            xr, gr, br = _leaf(x), _leaf(gamma), _leaf(beta)
            lkw = dict(num_groups=G, silu=silu)
            if film:    # the FiLM Dense output: one [N, L, 2C] leaf
                e = _leaf(torch.cat([sc, sh], -1))
                lkw.update(scale=e[..., :C], shift=e[..., C:])
            n0 = (fused_groupnorm.launches, groupnorm_backward.launches)
            out = fused_groupnorm(xr, gr, br, **lkw)
            stats = out.grad_fn.saved_tensors[-1]
            out.backward(g)
            torch.cuda.synchronize()
            if (fused_groupnorm.launches - n0[0],
                    groupnorm_backward.launches - n0[1]) != (1, 1):
                raise AssertionError("groupnorm_backward: the autograd "
                                     "path did not launch both kernels")
            got = (xr.grad, e.grad[..., :C] if film else None,
                   e.grad[..., C:] if film else None, gr.grad, br.grad)
            ref_stats = groupnorm_stats_reference(x, G)
            ref_out = groupnorm_reference(x, gamma, beta, silu=silu,
                                          stats=ref_stats, **kw)
            want = groupnorm_backward_reference(
                x, g, gamma, beta, sc, sh, stats, num_groups=G, silu=silu)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            checks = [("out", out, ref_out, tol),
                      ("stats", stats, ref_stats, F32_TOL)]
            checks += [(n, a, b, SUM_TOL if n in ("dgamma", "dbeta")
                        else tol)
                       for n, a, b in zip(names, got, want) if b is not None]
            errs = {}
            for n, a, b, t in checks:
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"groupnorm_backward: {n} is "
                                         f"{a.dtype} {tuple(a.shape)}")
                err, ratio = _err_over_tol(a, b, t)
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"groupnorm_backward {(N, L, C, G)} {dtype} "
                        f"film={film} silu={silu}: {n} max abs err {err} "
                        f"over tolerance")
                worst = max(worst, ratio)
                errs[n] = err
                checked += 1
        # Times at the model's dtype (bf16), through the wrappers: the
        # forward as autograd records it (save_stats), the backward kernel's
        # wrapper on the saved statistics.
        H = int(math.isqrt(L))
        ms_f = cuda_ms(lambda: fused_groupnorm(xr, gr, br, **lkw))
        ms_b = cuda_ms(lambda: groupnorm_backward(
            x, g, gamma, beta, sc, sh, stats, num_groups=G, silu=silu))
        plain_b = cuda_ms(lambda: groupnorm_backward_reference(
            x, g, gamma, beta, sc, sh, stats, num_groups=G, silu=silu),
            iters=5)
        plain_f = cuda_ms(lambda: groupnorm_reference(
            x, gamma, beta, silu=silu,
            stats=groupnorm_stats_reference(x, G), **kw), iters=5)
        x4 = x.view(N, H, L // H, C).permute(0, 3, 1, 2).detach() \
            .requires_grad_()
        gb = gamma.to(dtype).requires_grad_()
        bb = beta.to(dtype).requires_grad_()
        inputs = [x4, gb, bb]
        if film:
            e = torch.cat([sc, sh], -1).detach().requires_grad_()
            inputs.append(e)
            sc4 = e[..., :C].reshape(N, H, L // H, C).permute(0, 3, 1, 2)
            sh4 = e[..., C:].reshape(N, H, L // H, C).permute(0, 3, 1, 2)

        def library():
            y = F.group_norm(x4, G, gb, bb, 1e-5)
            if film:
                y = y * (1.0 + sc4) + sh4
            return F.silu(y) if silu else y

        with torch.no_grad():
            lib_f = cuda_ms(library)
        y = library()
        g4 = g.view(N, H, L // H, C).permute(0, 3, 1, 2)
        lib_b = cuda_ms(lambda: torch.autograd.grad(y, inputs, g4,
                                                    retain_graph=True))
        del y
        elems = N * L * C
        flops, nbytes = gn_forward_work(N, L, C, G, film, True)
        bound_f = _bound(fwd, count, flops, F32_FLOPS, nbytes)
        # The backward reads x, g, scale and, only under SiLU (the one use
        # of y), shift; it writes dx, dscale, dshift.
        bound_b = _bound(bwd, count, 30.0 * elems, F32_FLOPS,
                         2 * elems * (2 + film + (film and silu))
                         + 2 * elems * (1 + (2 if film else 0))
                         + 16 * C + 8 * N * G)
        for acc, ms, plain, lb, err in (
                (fwd, ms_f, plain_f, lib_f, errs["out"]),
                (bwd, ms_b, plain_b, lib_b, max(errs[n] for n in names
                                                if n in errs))):
            _add(acc, "ms", count, ms)
            _add(acc, "plain_ms", count, plain)
            _add(acc, "library_ms", count, lb)
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
        sites.append({"N": N, "L": L, "C": C, "G": G, "film": film,
                      "silu": silu, "per_train_step": count,
                      "plan": cuda_film.backward_plan(N, L, C, G, 2),
                      "fwd_plan": cuda_film.forward_plan(N, L, C, G, 2, film),
                      "fwd_pct_of_bound": round(100.0 * bound_f / ms_f, 1),
                      "bwd_pct_of_bound": round(100.0 * bound_b / ms_b, 1),
                      "bwd_us": round(ms_b * 1e3, 2),
                      "bwd_plain_us": round(plain_b * 1e3, 2),
                      "bwd_library_us": round(lib_b * 1e3, 2),
                      "bwd_bound_us": round(bound_b * 1e3, 3),
                      "fwd_stats_us": round(ms_f * 1e3, 2),
                      "fwd_plain_us": round(plain_f * 1e3, 2),
                      "fwd_library_us": round(lib_f * 1e3, 2),
                      "fwd_bound_us": round(bound_f * 1e3, 3),
                      "bf16_errs": errs})
    fwd, bwd = _finish(fwd), _finish(bwd)
    emit({"phase": "groupnorm_backward", "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|); "
                       "dgamma/dbeta (f32 sums over N*L) 1e-4*(1+max|ref|)",
          "sites": sites, "per_train_step_forward_save_stats": fwd,
          "per_train_step_backward": bwd})
    return fwd, bwd


def phase_attention_backward(attn_sites, accum):
    """The lse forward and the backward kernels at the training attention
    sites (and srn128's), through the wrappers: ``flash_attention_lse`` on
    inputs that require grad, ``backward`` through it with the lse
    cotangent (when given) on its ``[B, L, H]`` lse, then
    ``attention_backward_dkdv`` / ``attention_backward_dq`` timed on their
    own.  Per-step sums over the srn64 sites of one train step."""
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops.cuda_attention import (
        attention_backward_dkdv, attention_backward_dq,
        attention_backward_reference, attention_lse_reference,
        flash_attention, flash_attention_lse)

    extra = [(16, 1024, 1024, 4, 128), (16, 256, 256, 4, 256)]  # srn128
    shapes = sorted(attn_sites) + extra
    worst, checked = 0.0, 0
    rows = {"lse": {"max_abs_err": 0.0}, "dkdv": {"max_abs_err": 0.0},
            "dq": {"max_abs_err": 0.0}}
    sites = []

    def launches():
        return (flash_attention.launches, attention_backward_dkdv.launches,
                attention_backward_dq.launches)

    for si, shape in enumerate(shapes + WIDE_ATTN):
        B, Lq, Lk, H, D = shape
        count = attn_sites.get(shape, 0) * accum
        for dtype in (torch.float32, torch.bfloat16):
            for with_glse in (False, True):
                q, k, v = attn_inputs(shape, dtype, si)
                qr, kr, vr = _leaf(q), _leaf(k), _leaf(v)
                gen = torch.Generator("cuda").manual_seed(200 + si)
                do = torch.randn(B, Lq, H, D, generator=gen,
                                 device="cuda").to(dtype)
                gl = (torch.randn(B, Lq, H, generator=gen, device="cuda")
                      if with_glse else None)           # [B, L, H]
                n0 = launches()
                o, lse = flash_attention_lse(qr, kr, vr)
                torch.autograd.backward(
                    [o, lse] if with_glse else [o],
                    [do, gl] if with_glse else [do])
                torch.cuda.synchronize()
                if tuple(a - b for a, b in zip(launches(), n0)) != (1, 1, 1):
                    raise AssertionError("attention_backward: the autograd "
                                         "path did not launch all kernels")
                o_ref, lse_ref = attention_lse_reference(q, k, v)
                lse_bhl = lse.detach().transpose(1, 2).contiguous()
                want = attention_backward_reference(
                    q, k, v, o.detach(), lse_bhl, do,
                    None if gl is None else gl.transpose(1, 2).contiguous())
                tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                stol = SUM_TOL if dtype == torch.float32 else BF16_TOL
                errs = {}
                for n, a, b, t in (("o", o, o_ref, tol),
                                   ("lse", lse, lse_ref.transpose(1, 2),
                                    F32_TOL),
                                   ("dq", qr.grad, want[0], stol),
                                   ("dk", kr.grad, want[1], stol),
                                   ("dv", vr.grad, want[2], stol)):
                    if a.dtype != b.dtype or a.shape != b.shape:
                        raise AssertionError(f"attention_backward: {n} is "
                                             f"{a.dtype} {tuple(a.shape)}")
                    err, ratio = _err_over_tol(a, b, t)
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"attention_backward {shape} {dtype} glse="
                            f"{with_glse}: {n} max abs err {err} over "
                            "tolerance")
                    worst = max(worst, ratio)
                    errs[n] = err
                    checked += 1
        if shape in WIDE_ATTN:
            continue
        # Times in bf16 through the wrappers, no lse cotangent (the
        # training path).
        o = o.detach()
        _, _, delta = attention_backward_dkdv(q, k, v, o, lse_bhl, do)
        ms_lse = cuda_ms(lambda: flash_attention_lse(qr, kr, vr))
        ms_dkdv = cuda_ms(lambda: attention_backward_dkdv(
            q, k, v, o, lse_bhl, do))
        ms_dq = cuda_ms(lambda: attention_backward_dq(
            q, k, v, o, lse_bhl, do, delta))
        plain_b = cuda_ms(lambda: attention_backward_reference(
            q, k, v, o, lse_bhl, do), iters=5)
        plain_f = cuda_ms(lambda: attention_lse_reference(q, k, v),
                          iters=5)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        with torch.no_grad():
            lib_f, backend_f = fastest_sdpa(
                lambda: lambda: F.scaled_dot_product_attention(qt, kt, vt))

        def sdpa_backward():     # the forward records under the backend
            y = F.scaled_dot_product_attention(qt, kt, vt)
            return lambda: torch.autograd.grad(
                y, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)

        lib_b, backend_b = fastest_sdpa(sdpa_backward)
        fl = B * H * Lq * Lk * D
        qb, kb = 2 * B * Lq * H * D, 2 * B * Lk * H * D   # bf16 bytes
        lse_b = 4 * B * H * Lq
        b_lse = _bound(rows["lse"], count, 4.0 * fl, BF16_FLOPS,
                       2 * qb + 2 * kb + lse_b)
        b_dkdv = _bound(rows["dkdv"], count, 8.0 * fl, BF16_FLOPS,
                        3 * qb + 2 * kb + lse_b + 2 * kb)
        b_dq = _bound(rows["dq"], count, 6.0 * fl, BF16_FLOPS,
                      3 * qb + 2 * kb + 2 * lse_b)
        for name, ms, plain, lb, err in (
                ("lse", ms_lse, plain_f, lib_f, max(errs["o"],
                                                    errs["lse"])),
                ("dkdv", ms_dkdv, plain_b, lib_b, max(errs["dk"],
                                                      errs["dv"])),
                ("dq", ms_dq, plain_b, lib_b, errs["dq"])):
            acc = rows[name]
            if count:
                _add(acc, "ms", count, ms)
                _add(acc, "plain_ms", count, plain)
                _add(acc, "library_ms", count, lb)
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
        sites.append({"B": B, "Lq": Lq, "Lk": Lk, "H": H, "D": D,
                      "per_train_step": count,
                      "fwd_lse_us": round(ms_lse * 1e3, 2),
                      "fwd_plain_us": round(plain_f * 1e3, 2),
                      "fwd_library_us": round(lib_f * 1e3, 2),
                      "fwd_bound_us": round(b_lse * 1e3, 3),
                      "dkdv_us": round(ms_dkdv * 1e3, 2),
                      "dkdv_bound_us": round(b_dkdv * 1e3, 3),
                      "dq_us": round(ms_dq * 1e3, 2),
                      "dq_bound_us": round(b_dq * 1e3, 3),
                      "bwd_plain_us": round(plain_b * 1e3, 2),
                      "bwd_library_us": round(lib_b * 1e3, 2),
                      "fwd_library_backend": backend_f,
                      "bwd_library_backend": backend_b,
                      "bf16_errs": errs})
    rows = {k: _finish(v) for k, v in rows.items()}
    emit({"phase": "attention_backward", "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "o f32 1e-5 / bf16 2^-7; lse 1e-5; dq/dk/dv f32 "
                       "1e-4 / bf16 2^-7, each *(1+max|ref|)",
          "sites": sites, "per_train_step": rows,
          "note": "plain_ms and library_ms of dkdv and dq are the whole "
                  "backward (dq, dk, dv together)"})
    return rows


def orbit_views(n_views: int, H: int, seed: int):
    """A synthetic object: ``n_views`` cameras on a circle of radius 1.3
    at elevation 0.5 looking at the origin (SRN's world-from-camera,
    OpenCV axes), an SRN-like K, and smooth random images in [-1, 1]."""
    rng = np.random.default_rng(seed)
    Rs, Ts = [], []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        pos = np.array([1.3 * np.cos(a), 1.3 * np.sin(a), 0.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        Rs.append(np.stack([right, down, fwd], axis=1))
        Ts.append(pos)
    f = 131.25 * H / 128.0                 # SRN cars' focal at 128^2
    K = np.array([[f, 0, H / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    coarse = rng.uniform(-1, 1, (n_views, H // 8, H // 8, 3))
    imgs = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    return {"imgs": imgs.astype(np.float32),
            "R": np.stack(Rs).astype(np.float32),
            "T": np.stack(Ts).astype(np.float32), "K": K}


def srn64_model():
    """The srn64 full-width X-UNet, bf16, every weight random from a seed
    (the zero-initialised convs and the GroupNorm affines too)."""
    import torch

    from diff3d_tpu_torch.config import srn64_config
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.models.layers import FrameGroupNorm

    cfg = srn64_config()
    model = build_model(cfg.model, "cuda", seed=0, randomize_zero_init=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrameGroupNorm):
                C = m.weight.shape[0]
                m.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
                m.bias.copy_(0.1 * torch.randn(C, generator=g))
    return cfg, model


def model_batch(cfg, B: int, seed: int):
    import torch

    views = orbit_views(2, cfg.model.H, seed)
    rng = np.random.default_rng(seed)
    H = cfg.model.H

    def t(a):
        return torch.tensor(np.array(a, np.float32), device="cuda")

    batch = {
        "x": t(rng.uniform(-1, 1, (B, H, H, 3))),
        "z": t(rng.normal(size=(B, H, H, 3))),
        "logsnr": t(np.stack([np.full(B, 20.0),
                              rng.uniform(-20, 20, B)], 1)),
        "R": t(np.broadcast_to(views["R"], (B, 2, 3, 3))),
        "t": t(np.broadcast_to(views["T"], (B, 2, 3))),
        "K": t(np.broadcast_to(views["K"], (B, 3, 3))),
    }
    cond_mask = torch.arange(B, device="cuda") < B // 2
    return batch, cond_mask


def phase_model(cfg, model, batch, cond_mask):
    import torch

    from diff3d_tpu_torch.models.layers import set_kernels
    from diff3d_tpu_torch.ops.cuda_attention import flash_attention
    from diff3d_tpu_torch.ops.cuda_film import fused_groupnorm

    with torch.inference_mode():
        fused_groupnorm.launches = flash_attention.launches = 0
        out = model(batch, cond_mask)
        torch.cuda.synchronize()
        launches = {"fused_groupnorm": fused_groupnorm.launches,
                    "flash_attention": flash_attention.launches}
        set_kernels(model, "torch")
        ref = model(batch, cond_mask)
        plain_ms = cuda_ms(lambda: model(batch, cond_mask), iters=5)
        set_kernels(model, "cuda")
        ms = cuda_ms(lambda: model(batch, cond_mask), iters=5)
    if not torch.isfinite(out).all():
        raise AssertionError("model: non-finite output")
    err = float((out - ref).abs().max())
    rel = float((out - ref).norm() / ref.norm())
    if not rel <= 3e-2:
        raise AssertionError(f"model: kernel path vs plain path relative "
                             f"L2 error {rel} > 3e-2")
    emit({"phase": "model", "config": "srn64", "batch": int(out.shape[0]),
          "max_abs_err": err, "rel_l2_err": rel,
          "max_abs_ref": float(ref.abs().max()), "tolerance": "rel L2 3e-2",
          "ms_per_forward": round(ms, 3),
          "plain_ms_per_forward": round(plain_ms, 3),
          "launches_per_forward": launches})
    return launches


def phase_sampler(cfg, model):
    import torch

    from diff3d_tpu_torch.ops.cuda_attention import flash_attention
    from diff3d_tpu_torch.ops.cuda_film import fused_groupnorm
    from diff3d_tpu_torch.sampling import Sampler

    views = orbit_views(3, cfg.model.H, seed=3)
    sampler = Sampler(model, cfg, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_groupnorm.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = sampler.synthesize(views, gen)        # ends in a device fetch
    seconds = time.perf_counter() - t0
    launches = {"fused_groupnorm": fused_groupnorm.launches,
                "flash_attention": flash_attention.launches}
    n_gen = views["imgs"].shape[0] - 1
    B = len(cfg.diffusion.guidance_weights)
    if outs.shape != (n_gen, B, cfg.model.H, cfg.model.W, 3):
        raise AssertionError(f"sampler: output shape {outs.shape}")
    if not np.isfinite(outs).all():
        raise AssertionError("sampler: non-finite output")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"sampler: {name} never launched")
    steps = n_gen * sampler.model_calls_per_view
    emit({"phase": "sampler", "views_generated": n_gen,
          "steps_per_view": sampler.model_calls_per_view,
          "guidance_weights": B, "seconds": round(seconds, 3),
          "s_per_view": round(seconds / n_gen, 4),
          "ms_per_denoise_step": round(1e3 * seconds / steps, 3),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "out_abs_max": float(np.abs(outs).max()),
          "launches": launches})
    return launches, steps


def _launch_counts(reset: bool = False):
    """The launch count of every kernel wrapper (set to 0 first when
    ``reset``)."""
    from diff3d_tpu_torch.ops.cuda_attention import (attention_backward_dkdv,
                                                     attention_backward_dq,
                                                     flash_attention)
    from diff3d_tpu_torch.ops.cuda_film import (fused_groupnorm,
                                                groupnorm_backward)

    counters = {"fused_groupnorm": fused_groupnorm,
                "groupnorm_backward": groupnorm_backward,
                "flash_attention": flash_attention,
                "attention_backward_dkdv": attention_backward_dkdv,
                "attention_backward_dq": attention_backward_dq}
    if reset:
        for fn in counters.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in counters.items()}


def train_batch(cfg, B: int, step: int):
    """Global batch ``step`` of the port's loader over the synthetic
    dataset at the model's resolution, on the card."""
    import torch

    from diff3d_tpu_torch.data import InfiniteLoader, SyntheticDataset

    loader = InfiniteLoader(SyntheticDataset(num_objects=64, num_views=32,
                                             imgsize=cfg.model.H), B,
                            num_workers=0)
    return {k: torch.from_numpy(v).cuda() for k, v in
            loader.batch(step).items()}


def phase_train_step(cfg, model):
    """One srn64 train step through the kernels and through the plain
    versions, from the same weights, with the same draws (and dropout
    masks), on the bf16 model and on an f32 copy of it.  In f32 the two
    paths differ only in summation order; the bf16 plain step's distance
    from the f32 one is reported beside the bf16 comparison."""
    import torch

    from diff3d_tpu_torch.diffusion import TrainDraws
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.models.layers import set_kernels
    from diff3d_tpu_torch.train import create_train_state, make_train_step

    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=STEP_BATCH, accum_steps=1,
        warmup_examples=10 * STEP_BATCH))
    batch = train_batch(cfg, STEP_BATCH, 0)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(tcfg)

    def run(m, impl):
        m.load_state_dict(weights)
        set_kernels(m, impl)
        state = create_train_state(m, tcfg.train)
        draws = [TrainDraws(torch.Generator("cuda").manual_seed(7))]
        _launch_counts(reset=True)
        metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        launches = _launch_counts()
        grads = [p.grad.detach().float().clone() for p in m.parameters()]
        return float(metrics["loss"]), grads, launches

    loss_k, grads_k, launches = run(model, "cuda")
    loss_p, grads_p, _ = run(model, "torch")
    m32 = XUNet(dataclasses.replace(cfg.model, dtype="float32")).cuda()
    loss_32k, grads_32k, launches_32 = run(m32, "cuda")
    loss_32, grads_32, _ = run(m32, "torch")
    del m32
    model.load_state_dict(weights)
    set_kernels(model, "cuda")
    model.eval()

    def rel(a, b):
        num = sum(float((x - y).norm() ** 2) for x, y in zip(a, b))
        return (num / sum(float(y.norm() ** 2) for y in b)) ** 0.5

    out = {"batch": STEP_BATCH, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2": rel(grads_k, grads_p),
           "f32_loss_kernel": loss_32k, "f32_loss_plain": loss_32,
           "f32_loss_rel_err": abs(loss_32k - loss_32) / abs(loss_32),
           "f32_grad_rel_l2": rel(grads_32k, grads_32),
           "bf16_plain_vs_f32_grad_rel_l2": rel(grads_p, grads_32),
           "bf16_kernel_vs_f32_grad_rel_l2": rel(grads_k, grads_32),
           "launches": launches, "launches_f32": launches_32,
           "tolerance": f"f32 (TF32 off): loss {F32_STEP_LOSS_TOL} "
                        f"relative, gradients {F32_STEP_GRAD_TOL} relative "
                        "L2 over all parameters (the paths differ only in "
                        f"summation order); bf16: loss {BF16_STEP_LOSS_TOL}"
                        f" relative, gradients {BF16_STEP_GRAD_TOL}"}
    emit(dict(phase="train_step", **out))
    if not all(math.isfinite(x) for x in (loss_k, loss_p, loss_32k, loss_32)):
        raise AssertionError("train_step: non-finite loss")
    for key, tol in (("f32_loss_rel_err", F32_STEP_LOSS_TOL),
                     ("f32_grad_rel_l2", F32_STEP_GRAD_TOL),
                     ("loss_rel_err", BF16_STEP_LOSS_TOL),
                     ("grad_rel_l2", BF16_STEP_GRAD_TOL)):
        if not out[key] <= tol:
            raise AssertionError(f"train_step: {key} {out[key]} > {tol}")
    for name, n in [*launches.items(), *launches_32.items()]:
        if n == 0:
            raise AssertionError(f"train_step: {name} never launched")
    return out


def _state_tensors(state):
    tensors = dict(state.model.state_dict())
    tensors.update({f"ema.{k}": v for k, v in state.ema.items()})
    for i, st in enumerate(state.optimizer.state.values()):
        tensors.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return tensors


def phase_train(accum):
    """The Trainer through ``cli/train_cli.py``'s code path: the training
    path.  Every launch count is set to 0 just before ``train()`` and read
    after it."""
    import torch

    from diff3d_tpu_torch.cli import train_cli

    shutil.rmtree(WORKDIR, ignore_errors=True)
    argv = ["--synthetic", "--config", "srn64", "--batch", str(TRAIN_BATCH),
            "--accum", str(accum), "--steps", str(TRAIN_STEPS),
            "--warmup_examples", str(10 * TRAIN_BATCH), "--ckpt_every",
            str(TRAIN_STEPS), "--num_workers", "8", "--workdir", WORKDIR]

    def trainer_of(extra):
        trainer = train_cli.build_trainer(
            train_cli.build_parser().parse_args(argv + extra))
        record = []
        inner = trainer.step_fn

        def timed(state, batch, draws=None):     # one sync per step
            m = inner(state, batch, draws)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            record.append({"t": time.perf_counter(), "loss": loss,
                           "grad_norm": gnorm, "lr": m["lr"]})
            return m

        trainer.step_fn = timed
        return trainer, record

    first, rec = trainer_of([])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    first.train()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = np.diff([t0] + [r["t"] for r in rec])
    s_per_step = float(np.mean(times[1:]))
    if len(rec) != TRAIN_STEPS or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            for r in rec):
        raise AssertionError(f"train: steps {rec}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"train: {name} never launched")

    # Resume: a fresh trainer restores the step-6 checkpoint; both take
    # step 7, which must agree bit for bit.
    second, rec2 = trainer_of(["--transfer", "--steps",
                               str(TRAIN_STEPS + 1)])
    if second.state.step != TRAIN_STEPS:
        raise AssertionError(f"train: restored step {second.state.step}")
    first.train(max_steps=TRAIN_STEPS + 1)
    want = {k: v.clone() for k, v in _state_tensors(first.state).items()}
    first.loader.close()
    del first
    second.train()
    got = _state_tensors(second.state)
    second.loader.close()
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    same_metrics = (rec[-1]["loss"] == rec2[-1]["loss"]
                    and rec[-1]["grad_norm"] == rec2[-1]["grad_norm"])
    out = {"config": "srn64", "global_batch": TRAIN_BATCH,
           "accum_steps": accum, "steps": TRAIN_STEPS,
           "first_step_s": float(times[0]), "s_per_step": s_per_step,
           "examples_per_s": TRAIN_BATCH / s_per_step,
           "step_s": [float(t) for t in times],
           "max_memory_allocated": peak,
           "loss": [r["loss"] for r in rec[:TRAIN_STEPS]],
           "grad_norm": [r["grad_norm"] for r in rec[:TRAIN_STEPS]],
           "lr": [r["lr"] for r in rec[:TRAIN_STEPS]],
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()},
           "resume_step_loss": [rec[-1]["loss"], rec2[-1]["loss"]],
           "resume_bit_exact": not differ and same_metrics,
           "resume_tensors_compared": len(want)}
    emit(dict(phase="train", **out))
    if differ or not same_metrics:
        raise AssertionError(f"train: the resumed step differs "
                             f"({len(differ)} tensors, e.g. {differ[:3]})")
    shutil.rmtree(WORKDIR, ignore_errors=True)
    return out


def main() -> None:
    import torch

    phase_device()
    phase_build()
    cfg, model = srn64_model()
    batch, cond_mask = model_batch(cfg, 2 * len(cfg.diffusion.guidance_weights),
                                   seed=5)
    gn_sites, attn_sites = record_sites(model, batch, cond_mask)
    gn = phase_groupnorm(gn_sites)
    attn = phase_attention(attn_sites)
    phase_model(cfg, model, batch, cond_mask)
    launches, steps = phase_sampler(cfg, model)

    # The training sites: one microbatch of the train phase.
    mb = TRAIN_BATCH // TRAIN_ACCUM
    gn_train, attn_train = record_sites(model, *model_batch(cfg, mb, seed=6))
    gn_fwd, gn_bwd = phase_groupnorm_backward(gn_train, TRAIN_ACCUM)
    attn_rows = phase_attention_backward(attn_train, TRAIN_ACCUM)
    phase_train_step(cfg, model)
    del model
    torch.cuda.empty_cache()
    train = phase_train(TRAIN_ACCUM)
    tl = train["launches"]

    film, att = ("diff3d_tpu_torch/ops/csrc/film.cu",
                 "diff3d_tpu_torch/ops/csrc/attention.cu")
    sample_per = "one denoise step (2B=16) at srn64, summed over sites"
    train_per = (f"one train step (global batch {TRAIN_BATCH}, accum_steps "
                 f"{TRAIN_ACCUM}) at srn64, summed over sites")
    cluster = "one thread-block cluster per sample, DSMEM exchange"
    design = {"fused_groupnorm": cluster,
              "fused_groupnorm[save_stats]": cluster,
              "flash_attention": "mma.sync bf16",
              "flash_attention[save_lse]": "mma.sync bf16",
              "attention_backward_dkdv": "mma.sync bf16",
              "attention_backward_dq": "mma.sync bf16",
              "groupnorm_backward": cluster}
    kernels = []
    for name, source, replaces, n, stats, per in (
            ("fused_groupnorm", film, "diff3d_tpu/ops/pallas_film.py:277",
             launches["fused_groupnorm"], gn, sample_per),
            ("fused_groupnorm[save_stats]", film,
             "diff3d_tpu/ops/pallas_film.py:277", tl["fused_groupnorm"],
             gn_fwd, train_per),
            ("groupnorm_backward", film,
             "diff3d_tpu/ops/pallas_film.py:414", tl["groupnorm_backward"],
             gn_bwd, train_per),
            ("flash_attention", att,
             "diff3d_tpu/ops/pallas_attention.py:185",
             launches["flash_attention"], attn, sample_per),
            ("flash_attention[save_lse]", att,
             "diff3d_tpu/ops/pallas_attention.py:185",
             tl["flash_attention"], attn_rows["lse"], train_per),
            ("attention_backward_dkdv", att,
             "diff3d_tpu/ops/pallas_attention.py:287",
             tl["attention_backward_dkdv"], attn_rows["dkdv"], train_per),
            ("attention_backward_dq", att,
             "diff3d_tpu/ops/pallas_attention.py:306",
             tl["attention_backward_dq"], attn_rows["dq"], train_per)):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": stats["max_abs_err"],
            "ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": stats["library_ms"], "per": per,
            "design": design.get(name, "cuda cores")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
