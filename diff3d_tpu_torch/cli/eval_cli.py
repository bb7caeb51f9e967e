"""Evaluation entry point: PSNR / SSIM / FID of synthesised novel views
(counterpart: ``diff3d_tpu/cli/eval_cli.py``).

For each of the first ``--objects`` evaluation objects the model (the
checkpoint's EMA weights, or the raw ones under ``--raw_params``)
synthesises every view autoregressively from view 0, and the generated
views are scored against ground truth:

  * PSNR / SSIM per view at the guidance weight ``--w_index`` (default 1,
    w=1 in the 0..7 sweep), averaged; PSNR at every w (``psnr_per_w``).
  * FID between the pooled generated and the pooled ground-truth views.
    With ``--feature_weights <local VGG16 state dict>`` the VGG16-fc2
    extractor is used and the number is reported as ``fid``; without it
    the seeded random embedding, reported as ``fid_randfeat``.  The
    port's random embedding is drawn from a torch generator, not from
    ``jax.random``: its ``fid_randfeat`` is not comparable with the JAX
    package's.

Synthesis and scoring are separate phases.  Each object's generated views
are written to ``--resume_dir`` (default ``<out>.objdir``) as its batch
finishes (``obj_s<step>_<obj>.npz``: the float16 views and the settings
they were made under); a re-run of the same command skips those objects
and goes on to scoring, which always recomputes every metric from the
records, so the JSON line is the same whether the run took one pass or
several.  A record made under other settings is a hard error.

Randomness: every generated view draws from its own ``torch.Generator``,
seeded from ``(--seed, object, view)`` (object = its position among the
evaluation objects, then the ``--w_select`` objects, then the orbits), so
scores do not depend on ``--object_batch`` or on where a run resumed,
and the ``--parity_objects`` oracle shares each view's stream with the
sampler under test.  Records carry ``"rng": "torch"``: generations from
the JAX package's ``jax.random`` streams are another protocol and are
refused.

``--w_select K`` synthesises K extra objects (after the evaluation set,
disjoint from it), picks the guidance weight with the best mean PSNR on
them, and also scores the evaluation set there (``*_w_selected``).
``--parity_objects`` scores the sampler under test against the full-grid
ancestral sampler from the same streams (``sampler_parity``).
``--orbit N`` renders an N-frame turntable per ``--orbit_objects`` object
and scores its reprojection consistency (``orbit_consistency``).

Runs on the card unless ``--device`` names another; there the reverse
step runs as a CUDA graph.  ``--mesh`` splits each object batch over the
ranks of a ``torchrun`` job (``Sampler(mesh=...)``: each rank synthesises
its objects, the views are all-gathered; ``--object_batch`` is rounded up
to a multiple of the data axis's rank count); rank 0 writes the records,
the images and the metrics.  ``--model_parallel N --param_sharding tp``
(or ``fsdp+tp``) splits the model over a model axis of N ranks: the
ranks of one model group synthesise the same objects, each on its blocks
of the weights.  Writes one JSON line to stdout and, with ``--out``,
appends it there.

Usage:
    python -m diff3d_tpu_torch.cli.eval_cli --model ./checkpoints \
        --synthetic_scenes [--objects 8]
    python -m diff3d_tpu_torch.cli.eval_cli --device cpu --config test \
        --model /tmp/t/checkpoints --synthetic_scenes --objects 2 \
        --max_views 3 --steps 4
    torchrun --standalone --nproc_per_node 2 -m \
        diff3d_tpu_torch.cli.eval_cli --mesh --model ./checkpoints \
        --synthetic_scenes
    torchrun --standalone --nproc_per_node 2 -m \
        diff3d_tpu_torch.cli.eval_cli --mesh --model_parallel 2 \
        --param_sharding tp --model ./checkpoints --synthetic_scenes
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from diff3d_tpu_torch.cli._common import (add_mesh_args,
                                          add_model_width_args,
                                          apply_mesh_overrides,
                                          apply_model_width_overrides,
                                          load_eval_params)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True,
                   help="checkpoint directory, ckpt_<step>.pt, port state "
                        "dict (.pt) or Flax params (.npz)")
    p.add_argument("--val_data", default=None,
                   help="SRN split dir (val objects are drawn from the "
                        "same 90/10 split the trainer used)")
    p.add_argument("--synthetic_scenes", action="store_true",
                   help="evaluate on ray-traced sphere scenes instead of "
                        "--val_data (default seed 1 = the held-out set "
                        "train_cli --synthetic_scenes validates on)")
    p.add_argument("--scenes_seed", type=int, default=1,
                   help="scene generator seed for --synthetic_scenes "
                        "(0 = the training scenes, 1 = held-out)")
    p.add_argument("--scene_objects", type=int, default=None,
                   help="the --scene_objects count the model was TRAINED "
                        "with; with --scenes_seed 0 ('the training "
                        "scenes'), --objects beyond it were never seen in "
                        "training and would skew a train-vs-heldout "
                        "comparison, so that combination errors out")
    p.add_argument("--object_batch", type=int, default=None,
                   help="objects synthesised together, batched into every "
                        "model call (per-object scores match --object_batch "
                        "1 to float tolerance).  Default: 8 at <=64^2, 2 "
                        "above (the batched model call and the record "
                        "buffer both scale with it; lower if out of "
                        "memory)")
    add_model_width_args(p)
    p.add_argument("--picklefile", default=None)
    p.add_argument("--config", choices=["srn64", "srn128", "test"],
                   default="srn64")
    p.add_argument("--objects", type=int, default=8,
                   help="number of val objects to evaluate")
    p.add_argument("--max_views", type=int, default=None,
                   help="cap views per object (full object if omitted)")
    p.add_argument("--steps", type=int, default=None,
                   help="diffusion steps (reference: 256) — the DENSE "
                        "training grid; see --sampler_steps for the "
                        "few-step sampling subset")
    p.add_argument("--sampler", choices=["ancestral", "ddim"],
                   default="ancestral",
                   help="reverse-process update: 'ancestral' (paper's "
                        "stochastic sampler) or 'ddim' (deterministic "
                        "eta=0, enables few-step sampling)")
    p.add_argument("--sampler_steps", type=int, default=None,
                   help="few-step schedule: reverse steps per view, a "
                        "divisor of the dense grid (e.g. 16 with 256 "
                        "timesteps); default = full grid")
    p.add_argument("--parity_objects", type=int, default=0,
                   help="ALSO synthesise this many eval objects with the "
                        "full-grid ancestral oracle at matched seeds and "
                        "report PSNR/SSIM of the evaluated sampler "
                        "against it (sampler_parity in the output JSON) — "
                        "quantifies few-step quality degradation")
    p.add_argument("--scan_chunks", type=int, default=1,
                   help="split each view's reverse diffusion into this many "
                        "segments (must divide the step count; "
                        "bit-identical to 1)")
    p.add_argument("--w_index", type=int, default=1,
                   help="guidance-sweep index scored for PSNR/SSIM/FID")
    p.add_argument("--w_select", type=int, default=0,
                   help="ALSO score at a validation-selected guidance "
                        "weight: synthesise this many extra selection "
                        "objects (disjoint from the eval set, drawn after "
                        "it), pick the w with the best mean PSNR on them, "
                        "and report *_w_selected fields at that w")
    p.add_argument("--feature_weights", default=None,
                   help="local VGG16 state-dict file (.pth/.pt/.npz, "
                        "torchvision key names) for real-feature FID; "
                        "omitted -> random-feature fallback, reported as "
                        "fid_randfeat")
    p.add_argument("--raw_params", action="store_true",
                   help="score the raw weights instead of the EMA")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="append final JSONL here")
    p.add_argument("--resume_dir", default=None,
                   help="per-object synthesis records live here (one .npz "
                        "per object, written as each object completes); "
                        "re-running skips objects already present.  "
                        "Default: <--out>.objdir when --out is given, "
                        "else a fresh temp dir (no resumability)")
    p.add_argument("--save_dir", default=None,
                   help="dump gt/generated view PNGs here "
                        "(<obj>/view{V}_{gt,gen}.png)")
    p.add_argument("--orbit", type=int, default=0,
                   help="ALSO render an N-frame orbit turntable per "
                        "--orbit_objects eval object (radius/elevation "
                        "derived from its GT poses) and report the "
                        "multi-view reprojection-consistency metric "
                        "(orbit_consistency in the output JSON); with "
                        "--save_dir the frames land in "
                        "<obj>/orbit/frame_%%03d.png + a contact sheet")
    p.add_argument("--orbit_objects", type=int, default=1,
                   help="eval objects to render orbits for (first K)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; the CPU only when "
                        "named)")
    p.add_argument("--mesh", action="store_true",
                   help="split each object batch over the ranks of a "
                        "torchrun job (NCCL on the card, gloo with "
                        "--device cpu); rank 0 writes the results")
    add_mesh_args(p)
    return p


def _record_path(resume_dir: str, obj, step: int) -> str:
    # The checkpoint step is part of the name, not of the settings stamp:
    # after more training the same command finds no records for the new
    # step and synthesises afresh, while a dataset / model / seed /
    # schedule mismatch at the same step stays a hard error.
    return os.path.join(resume_dir, f"obj_s{step}_{obj}.npz")


def _save_object_record(resume_dir: str, obj, gen, meta: dict) -> None:
    """Atomically write one object's generated views (every guidance
    weight, float16) and the settings they were made under."""
    path = _record_path(resume_dir, obj, meta["checkpoint_step"])
    tmp = path + ".tmp"
    np.savez_compressed(tmp, gen=gen.astype(np.float16),
                        meta=json.dumps(meta))
    if os.path.exists(tmp + ".npz"):     # np.savez appends .npz
        tmp += ".npz"
    os.replace(tmp, path)


def _load_object_record(resume_dir: str, obj, expect_meta: dict):
    """``(gen float16, True)`` for a valid record, ``(None, False)`` for
    none; a record made under other settings is a hard error (mixing
    protocols would corrupt the aggregate)."""
    path = _record_path(resume_dir, obj, expect_meta["checkpoint_step"])
    if not os.path.exists(path):
        return None, False
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        gen = z["gen"]
    if meta != expect_meta:
        raise SystemExit(
            f"resume record {path} was synthesised under different "
            f"settings ({meta} != {expect_meta}); clear --resume_dir or "
            "point it elsewhere")
    return gen, True


def view_draws(seed: int, obj_index: int, n_gen: int, device) -> list:
    """One :class:`~diff3d_tpu_torch.diffusion.Draws` per generated view
    of object ``obj_index``, each on its own generator seeded from
    ``(seed, obj_index, view)``."""
    import torch

    from diff3d_tpu_torch.diffusion import Draws

    out = []
    for v in range(n_gen):
        hi, lo = np.random.SeedSequence([seed, obj_index, v]) \
            .generate_state(2, np.uint32)
        s = ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)
        out.append(Draws(torch.Generator(device).manual_seed(s)))
    return out


def main(argv=None) -> None:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    owned = False
    if args.mesh and not dist.is_initialized():
        # Before anything touches the card: NCCL takes LOCAL_RANK's card.
        from diff3d_tpu_torch.parallel import maybe_initialize_distributed

        owned = maybe_initialize_distributed(device=args.device)
    try:
        _main(args)
    finally:
        if owned:
            from diff3d_tpu_torch.parallel import shutdown_distributed

            shutdown_distributed()


def _main(args) -> None:

    # Dataset-choice errors fire before the model is built.
    if args.synthetic_scenes and args.val_data:
        raise SystemExit(
            "--synthetic_scenes and --val_data are mutually exclusive")
    if not (args.synthetic_scenes or args.val_data):
        raise SystemExit("pass --val_data or --synthetic_scenes")
    if (args.synthetic_scenes and args.scenes_seed == 0
            and args.scene_objects is not None
            and args.objects + args.w_select > args.scene_objects):
        raise SystemExit(
            f"--scenes_seed 0 scores training scenes, but --objects "
            f"{args.objects} + --w_select {args.w_select} exceeds the "
            f"trained --scene_objects {args.scene_objects}: objects "
            "beyond the trained count were never seen in training and "
            "would be mislabeled as 'train' scores — lower --objects or "
            "drop --scene_objects")
    if args.object_batch is not None and args.object_batch < 1:
        raise SystemExit("--object_batch must be >= 1")
    if args.orbit and args.orbit < 2:
        raise SystemExit("--orbit needs >= 2 frames to score consistency")

    import dataclasses

    import torch

    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.data import SRNDataset, SyntheticScenesDataset
    from diff3d_tpu_torch.device import resolve_device
    from diff3d_tpu_torch.evaluation import (fid_from_stats, gaussian_stats,
                                             psnr, ssim)
    from diff3d_tpu_torch.evaluation.features import resolve_feature_fn
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.sampling import Sampler

    mesh_env, primary = None, True
    device = resolve_device(args.device)
    cfg = {"srn64": config_lib.srn64_config,
           "srn128": config_lib.srn128_config,
           "test": config_lib.test_config}[args.config]()
    if args.steps:
        cfg = dataclasses.replace(
            cfg, diffusion=dataclasses.replace(cfg.diffusion,
                                               timesteps=args.steps))
    cfg = apply_model_width_overrides(cfg, args)
    if not args.mesh and (args.model_parallel is not None
                          or args.param_sharding is not None):
        raise SystemExit("--model_parallel / --param_sharding take --mesh")
    cfg = apply_mesh_overrides(cfg, args)

    # A bad --feature_weights fails before any sampling.
    feature_fn, fid_key = resolve_feature_fn(args.feature_weights)

    model = build_model(cfg.model, device)
    step = load_eval_params(args.model, model, args.raw_params)
    if step is None:            # a state dict or .npz records no step
        step = 0

    n_dataset_objs = max(8, args.objects + args.w_select)
    if args.synthetic_scenes:
        ds = SyntheticScenesDataset(num_objects=n_dataset_objs,
                                    imgsize=cfg.model.H,
                                    seed=args.scenes_seed)
    else:
        ds = SRNDataset("val", args.val_data, args.picklefile,
                        imgsize=cfg.model.H,
                        split_seed=cfg.data.split_seed,
                        train_fraction=cfg.data.train_fraction)
    if args.mesh:
        from diff3d_tpu_torch.parallel import is_primary, make_mesh

        mesh_env = make_mesh(cfg.mesh)
        primary = is_primary()
        logging.info("sampling on mesh %s (object axis over '%s')",
                     mesh_env.topology_summary()["axes"], cfg.mesh.data_axis)
    try:
        sampler = Sampler(model, cfg, device=device,
                          scan_chunks=args.scan_chunks,
                          sampler_kind=args.sampler,
                          steps=args.sampler_steps, mesh=mesh_env)
    except ValueError as e:     # a step count that does not divide
        raise SystemExit(str(e))

    if args.object_batch is None:
        # The batched model call (N * 2B examples) and the [N, capacity,
        # B, H, W, 3] record buffer both grow with N.
        args.object_batch = 8 if cfg.model.H <= 64 else 2
        logging.info("object_batch auto -> %d (H=%d)", args.object_batch,
                     cfg.model.H)
    if args.object_batch % sampler.lane_multiple:
        # synthesize_many pads, but the padding lanes' work is wasted in
        # every view: round the batch itself.
        args.object_batch = (-(-args.object_batch // sampler.lane_multiple)
                             * sampler.lane_multiple)
        logging.info("object_batch rounded -> %d (mesh data-axis size %d)",
                     args.object_batch, sampler.lane_multiple)

    if args.resume_dir is None:
        if args.out:
            args.resume_dir = args.out + ".objdir"
        else:
            import atexit
            import shutil
            import tempfile

            # No --out and no --resume_dir: the records still go through
            # disk (one scoring path), in a directory removed at exit.
            args.resume_dir = tempfile.mkdtemp(prefix="diff3d_eval_")
            atexit.register(shutil.rmtree, args.resume_dir,
                            ignore_errors=True)
    os.makedirs(args.resume_dir, exist_ok=True)

    if len(ds.ids) < args.objects + args.w_select:
        raise SystemExit(
            f"dataset has {len(ds.ids)} val objects; --objects "
            f"{args.objects} + --w_select {args.w_select} requested")
    # Object positions key the streams: evaluation objects first, then
    # the selection objects, so --w_select never moves an evaluation
    # object's stream.
    eval_objs = list(ds.ids[: args.objects])
    sel_objs = list(ds.ids[args.objects: args.objects + args.w_select])
    all_objs = eval_objs + sel_objs
    obj_index = {obj: k for k, obj in enumerate(all_objs)}
    obj_views = {obj: ds.all_views(obj) for obj in all_objs}

    def n_views_of(v) -> int:
        n = int(v["imgs"].shape[0])
        return min(n, args.max_views) if args.max_views else n

    def draws_of(obj):
        return view_draws(args.seed, obj_index[obj],
                          max(n_views_of(obj_views[obj]) - 1, 0), device)

    # The settings stamp: a record is valid only if it was made by the
    # same protocol, on the same dataset, from the same model.
    dataset_id = (f"scenes:{args.scenes_seed}" if args.synthetic_scenes
                  else f"srn:{os.path.abspath(args.val_data)}")
    expect_meta = {
        "model": os.path.abspath(args.model),
        "dataset": dataset_id,
        "checkpoint_step": int(step),
        "timesteps": int(cfg.diffusion.timesteps),
        "sampler": sampler.sampler_kind,
        "sampler_steps": int(sampler.steps),
        "seed": int(args.seed),
        "max_views": args.max_views,
        "H": int(cfg.model.H),
        "guidance_weights": [float(w) for w in
                             cfg.diffusion.guidance_weights],
        "rng": "torch",
    }

    # ---- Phase 1: synthesis (each object on disk as its batch ends) ----
    gens, todo = {}, []
    for obj in all_objs:
        gen, ok = _load_object_record(args.resume_dir, obj, expect_meta)
        if ok:
            gens[obj] = gen
        else:
            todo.append(obj)
    if gens:
        logging.info("resume: %d/%d objects already synthesised in %s",
                     len(gens), len(all_objs), args.resume_dir)

    progress_path = os.path.join(args.resume_dir, "progress.jsonl")
    i = 0
    while i < len(todo):
        # <= object_batch consecutive objects with equal view counts
        # (synthesize_many takes the batch's smallest count).
        j = i + 1
        nv = n_views_of(obj_views[todo[i]])
        while (j < len(todo) and j - i < args.object_batch
               and n_views_of(obj_views[todo[j]]) == nv):
            j += 1
        batch = todo[i:j]
        outs = sampler.synthesize_many([obj_views[o] for o in batch], None,
                                       max_views=args.max_views,
                                       draws=[draws_of(o) for o in batch])
        for obj, out in zip(batch, outs):
            # float16 in memory and on disk: a fresh and a resumed pass
            # score the same pixels.
            gens[obj] = np.asarray(out, np.float16)
            if not primary:
                continue
            _save_object_record(args.resume_dir, obj, gens[obj],
                                expect_meta)
            with open(progress_path, "a") as f:
                f.write(json.dumps({"object": str(obj),
                                    "views": int(out.shape[0])}) + "\n")
            logging.info("synthesised object %s (%d views) -> %s", obj,
                         out.shape[0],
                         _record_path(args.resume_dir, obj,
                                      expect_meta["checkpoint_step"]))
        i = j

    # ---- Phase 2: scoring, recomputed from the records ----------------
    def on_device(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def score_object(obj):
        """PSNR per view at every w, and the copy-view-0 baseline."""
        out = gens[obj]
        if out.shape[0] == 0:
            return None
        views = obj_views[obj]
        gt = views["imgs"][1: 1 + out.shape[0]]
        gt_d = on_device(gt)
        w_psnrs = [psnr(on_device(out[:, wi]), gt_d).tolist()
                   for wi in range(out.shape[1])]
        copy0 = np.broadcast_to(views["imgs"][:1], gt.shape)
        base = psnr(on_device(copy0), gt_d).tolist()
        return {"out": out, "gt": gt, "w_psnrs": w_psnrs, "base": base}

    scored = {obj: score_object(obj) for obj in all_objs}
    eval_scored = [(o, scored[o]) for o in eval_objs if scored[o]]
    if not eval_scored:
        raise SystemExit(
            "no views generated: every object had < 2 usable views "
            "(check --max_views / the dataset)")

    # Guidance selection on the disjoint selection objects: the best
    # pooled mean PSNR over their views.
    w_selected = None
    if args.w_select:
        sel_scored = [scored[o] for o in sel_objs if scored[o]]
        if not sel_scored:
            raise SystemExit("--w_select objects produced no views")
        n_w = len(sel_scored[0]["w_psnrs"])
        sel_per_w = [float(np.mean([v for s in sel_scored
                                    for v in s["w_psnrs"][wi]]))
                     for wi in range(n_w)]
        w_selected = int(np.argmax(sel_per_w))
        logging.info("w_select: per-w PSNR on %d selection objects: %s "
                     "-> w_selected=%d", len(sel_scored),
                     [round(v, 3) for v in sel_per_w], w_selected)

    # The ground truth's features do not depend on w: one stats pass.
    gt_stats = gaussian_stats([on_device(s["gt"]) for _, s in eval_scored],
                              feature_fn)
    agg_cache = {}

    def aggregate(w_index):
        """The evaluation set's headline and per-object stats at one w."""
        if w_index in agg_cache:
            return agg_cache[w_index]
        per_object, psnrs, base_psnrs, ssims = [], [], [], []
        gen_views = []
        for obj, s in eval_scored:
            obj_psnrs = s["w_psnrs"][w_index]
            gen = on_device(s["out"][:, w_index])
            obj_ssims = ssim(gen, on_device(s["gt"])).tolist()
            psnrs.extend(obj_psnrs)
            ssims.extend(obj_ssims)
            base_psnrs.extend(s["base"])
            gen_views.append(gen)
            per_object.append({
                "id": str(obj),
                "views": len(obj_psnrs),
                "psnr": round(float(np.mean(obj_psnrs)), 3),
                "psnr_std": round(float(np.std(obj_psnrs)), 3),
                "psnr_copy_view0": round(float(np.mean(s["base"])), 3),
                "ssim": round(float(np.mean(obj_ssims)), 4),
            })
        fid = fid_from_stats(gt_stats,
                             gaussian_stats(gen_views, feature_fn))
        margins = [o["psnr"] - o["psnr_copy_view0"] for o in per_object]
        obj_means = [o["psnr"] for o in per_object]
        agg_cache[w_index] = {
            "objects": len(per_object),
            "views": len(psnrs),
            "psnr": round(float(np.mean(psnrs)), 3),
            "psnr_copy_view0_baseline": round(float(np.mean(base_psnrs)),
                                              3),
            "psnr_obj_mean": round(float(np.mean(obj_means)), 3),
            "psnr_obj_std": round(float(np.std(obj_means)), 3),
            "psnr_margin_mean": round(float(np.mean(margins)), 3),
            "psnr_margin_std": round(float(np.std(margins)), 3),
            "objects_above_baseline": int(sum(m > 0 for m in margins)),
            "ssim": round(float(np.mean(ssims)), 4),
            fid_key: round(float(fid), 3),
            "per_object": per_object,
        }
        return agg_cache[w_index]

    if fid_key == "fid_randfeat":
        logging.warning(
            "FID below uses the seeded random embedding — reported as "
            "'fid_randfeat', comparable neither with paper FID nor with "
            "the JAX package's fid_randfeat.  Pass --feature_weights "
            "<local VGG16 state dict> for VGG16-feature FID.")

    n_w = len(eval_scored[0][1]["w_psnrs"])
    per_w_psnrs = [
        round(float(np.mean([v for _, s in eval_scored
                             for v in s["w_psnrs"][wi]])), 3)
        for wi in range(n_w)]

    record = {"checkpoint_step": step, **aggregate(args.w_index),
              "psnr_per_w": per_w_psnrs, "w_index": args.w_index,
              "timesteps": cfg.diffusion.timesteps,
              "sampler": sampler.sampler_kind,
              "sampler_steps": int(sampler.steps)}

    # Matched-seed parity against the full-grid ancestral oracle: the
    # same streams, so the generations differ only by the schedule.
    if args.parity_objects:
        from diff3d_tpu_torch.evaluation import matched_seed_parity

        par_objs = eval_objs[: args.parity_objects]
        oracle = Sampler(model, cfg, device=device,
                         scan_chunks=args.scan_chunks, mesh=mesh_env)
        oracle_outs = [oracle.synthesize(obj_views[o],
                                         max_views=args.max_views,
                                         draws=draws_of(o))
                       for o in par_objs]
        record["sampler_parity"] = {
            "oracle": f"ancestral:{cfg.diffusion.timesteps}",
            "sampler": f"{sampler.sampler_kind}:{sampler.steps}",
            "objects": len(par_objs),
            **matched_seed_parity([gens[o] for o in par_objs],
                                  oracle_outs, w_index=args.w_index),
        }
    if w_selected is not None:
        sel_agg = aggregate(w_selected)
        record["w_selected"] = w_selected
        record["w_select_objects"] = [str(o) for o in sel_objs]
        for key in ("psnr", "psnr_margin_mean", "psnr_margin_std",
                    "objects_above_baseline", "ssim", fid_key):
            record[f"{key}_w_selected"] = sel_agg[key]
        record["per_object_w_selected"] = sel_agg["per_object"]

    # Orbit turntables and their reprojection consistency.  Radius and
    # elevation come from each object's own ground-truth poses, so the
    # orbit stays on the poses the model was trained on.
    if args.orbit:
        from diff3d_tpu_torch.evaluation import reprojection_consistency
        from diff3d_tpu_torch.trajectory import orbit_path, trajectory_views

        per_orbit = []
        for j, obj in enumerate(eval_objs[: args.orbit_objects]):
            views = obj_views[obj]
            T_gt = np.asarray(views["T"], np.float64)
            radii = np.linalg.norm(T_gt, axis=-1)
            radius = float(radii.mean())
            elevation = float(np.rad2deg(np.arcsin(
                np.clip(T_gt[:, 2] / np.maximum(radii, 1e-9),
                        -1.0, 1.0)).mean()))
            path_R, path_T = orbit_path(args.orbit, radius=radius,
                                        elevation_deg=elevation)
            tviews = trajectory_views(views["imgs"][0], views["R"][0],
                                      views["T"][0], views["K"],
                                      path_R, path_T)
            # synthesize sizes the record from imgs: tile the conditioning
            # image across the path (only imgs[0] is read).
            tviews["imgs"] = np.broadcast_to(
                tviews["imgs"][:1], (args.orbit + 1,) +
                tviews["imgs"].shape[1:])
            frames = sampler.synthesize(tviews, draws=view_draws(
                args.seed, len(all_objs) + j, args.orbit, device))
            gen = frames[:, args.w_index].astype(np.float32)
            score = reprojection_consistency(gen, path_R, path_T,
                                             views["K"])
            entry = {"id": str(obj), "radius": round(radius, 3),
                     "elevation_deg": round(elevation, 2),
                     "consistency_l1": score["consistency_l1"],
                     "consistency_psnr": score["consistency_psnr"],
                     "valid_frac": round(score["valid_frac"], 4)}
            if args.save_dir and primary:
                from diff3d_tpu_torch.sampling.runtime import (
                    save_frame_sequence)

                art = save_frame_sequence(
                    os.path.join(args.save_dir, str(obj), "orbit"), gen)
                entry["frames_dir"] = art["dir"]
                logging.info("orbit frames for %s -> %s", obj, art["dir"])
            per_orbit.append(entry)
        l1s = [o["consistency_l1"] for o in per_orbit
               if o["consistency_l1"] is not None]
        ps = [o["consistency_psnr"] for o in per_orbit
              if o["consistency_psnr"] is not None]
        record["orbit_consistency"] = {
            "frames": args.orbit,
            "objects": len(per_orbit),
            "w_index": args.w_index,
            "consistency_l1": (round(float(np.mean(l1s)), 5)
                               if l1s else None),
            "consistency_psnr": (round(float(np.mean(ps)), 3)
                                 if ps else None),
            "per_object": per_orbit,
        }

    if not primary:
        return
    if args.save_dir:
        from diff3d_tpu_torch.sampling.runtime import save_image

        for obj, s in eval_scored:
            gen = s["out"][:, args.w_index]
            d = os.path.join(args.save_dir, str(obj))
            save_image(os.path.join(d, "view0_cond.png"),
                       obj_views[obj]["imgs"][0])
            for v in range(gen.shape[0]):
                save_image(os.path.join(d, f"view{v + 1}_gt.png"),
                           s["gt"][v])
                save_image(os.path.join(d, f"view{v + 1}_gen.png"),
                           gen[v].astype(np.float32))

    print(json.dumps(record))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")


if __name__ == "__main__":
    main()
