#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diff3d_tpu_torch``) on one NVIDIA card.

Phases, one JSON line each; any failure raises and the run exits nonzero:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile both CUDA sources with nvcc (in parallel).
  3. groupnorm — the fused GroupNorm kernel against its plain version on
     every GroupNorm site shape of the srn64 sampler and the odd shapes of
     ``tests/test_pallas_film.py``, all four variants, bf16 and f32; times
     of kernel, plain version and ``F.group_norm`` + elementwise ops.
  4. attention — the flash kernel against its plain version at the srn64
     and srn128 attention sites plus padded / non-square shapes, bf16 and
     f32; times of kernel, plain version and
     ``F.scaled_dot_product_attention``.
  5. model   — the srn64 full-width X-UNet, bf16, batch 2B=16, seeded
     random weights: kernel path against plain path, ms per forward and
     launches per forward.
  6. sampler — ``Sampler.synthesize`` on one seeded synthetic object (three
     views, orbit poses, SRN-like K): two views on the 256-step ancestral
     schedule with guidance weights 0..7.  This is the main path: the
     kernels' launch counts are set to 0 just before it and read after.

Then one ``{"kernels": [...]}`` line and, last, the device line.  The
library calls in phases 3-4 are timing yardsticks only; the port never
calls them.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS = 989e12             # dense bf16 tensor-core peak
F32_FLOPS = 67e12               # f32 outside the tensor cores
F32_TOL = 1e-5                  # f32 tolerance, relative to 1 + max|ref|
BF16_TOL = 2.0 ** -7            # one bf16 ulp at the output's magnitude


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs
    (CUDA events, after ``warmup`` runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_build():
    from diff3d_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln][:12]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": ptxas})


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

    from diff3d_tpu_torch.ops.cuda_film import (fused_groupnorm,
                                                groupnorm_reference)

    odd = [(2, 256, 128, 32), (2, 256, 256, 32), (1, 256, 512, 32),
           (1, 64, 1024, 32), (2, 64, 96, 32), (1, 1000, 144, 24)]
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
    per_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0, "bound_by": "bytes", "max_abs_err": 0.0}
    sites = []
    for (N, L, C, G, film, silu), count in sorted(gn_sites.items()):
        x, gamma, beta, kw = gn_inputs((N, L, C, G), torch.bfloat16, film,
                                       7)
        out = fused_groupnorm(x, gamma, beta, silu=silu, **kw)
        ref = groupnorm_reference(x, gamma, beta, silu=silu, **kw)
        err = float((out.float() - ref.float()).abs().max())
        ms = cuda_ms(lambda: fused_groupnorm(x, gamma, beta, silu=silu,
                                             **kw))
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

        lib = cuda_ms(library)
        nbytes = 2 * N * L * C * (2 if film else 1) + 2 * N * L * C + 8 * C
        bound = max(nbytes / HBM_BYTES_PER_S,
                    10.0 * N * L * C / F32_FLOPS) * 1e3
        sites.append({"N": N, "L": L, "C": C, "G": G, "film": film,
                      "silu": silu, "per_forward": count,
                      "us": round(ms * 1e3, 2),
                      "plain_us": round(plain * 1e3, 2),
                      "library_us": round(lib * 1e3, 2),
                      "bound_us": round(bound * 1e3, 3),
                      "max_abs_err": err})
        per_step["ms"] += count * ms
        per_step["plain_ms"] += count * plain
        per_step["library_ms"] += count * lib
        per_step["bound_ms"] += count * bound
        per_step["max_abs_err"] = max(per_step["max_abs_err"], err)
    emit({"phase": "groupnorm", "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|)",
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
             (1, 64, 64, 2, 160)]
    shapes = sorted(attn_sites) + extra
    worst = 0.0
    for si, shape in enumerate(shapes):
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
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * B * H * Lq * Lk * D
        nbytes = 2.0 * B * H * D * (2 * Lq + 2 * Lk)
        bound_s = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
        sites.append({"B": B, "Lq": Lq, "Lk": Lk, "H": H, "D": D,
                      "per_forward": count, "us": round(ms * 1e3, 2),
                      "plain_us": round(plain * 1e3, 2),
                      "library_us": round(lib * 1e3, 2),
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
    emit({"phase": "attention", "checked": 2 * len(shapes),
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|)",
          "sites": sites, "per_step": per_step})
    return per_step


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

    kernels = []
    for name, source, replaces, stats in (
            ("fused_groupnorm", "diff3d_tpu_torch/ops/csrc/film.cu",
             "diff3d_tpu/ops/pallas_film.py:277", gn),
            ("flash_attention", "diff3d_tpu_torch/ops/csrc/attention.cu",
             "diff3d_tpu/ops/pallas_attention.py:185", attn)):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": stats["max_abs_err"],
            "ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": stats["library_ms"],
            "per": "one denoise step (2B=16) at srn64, summed over sites"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
