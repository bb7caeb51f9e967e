#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``diff3d_tpu_torch``) on one NVIDIA card.

Phases, one JSON line each; any failure raises and the run exits nonzero:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile both CUDA sources with nvcc (in parallel); the
     tensor-core kernels (forward, dK/dV, dQ) at a padded head dim <= 128
     must not spill.
  2b. native — the data path's native PNG decoder (``g++``, libpng) on
     the card's host: built or not (the build's last line if not); where
     built, a PNG written with zlib and struct decoded to half size alone
     and through the pool, against the float box mean (1e-6) and the PIL
     path where PIL is installed (4.5/255).
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
  6. sampler — ``Sampler.synthesize`` on one seeded synthetic object (two
     views, orbit poses, SRN-like K): one view on the 256-step
     ancestral schedule with guidance weights 0..7, the reverse step
     replayed as a CUDA graph.  This is the sampling path: the kernels' launch counts
     are set to 0 just before it and read after; what ran is the eager
     launches (the first step, before the capture) plus each graph's
     captured launches x its replays.
  6b. sampler_graph — one srn64 view (16 steps, cut from 256) through
     the graph path and through the eager path (``cuda_graphs=False``) from the same generator seed,
     in the order eager, graph, graph, eager: bit-identical views; wall
     ms per step of each, the capture's seconds, launches (captured x
     replays) and peak memory.
  6c. sampler_many — ``step_many`` over N = 4 objects at record lengths
     1-4: on an f32 copy of the model at 4 steps (cut from 8) against
     ``step`` per object (rel. L2 1e-3); ``synthesize_many`` of one view
     of 4 objects at 16 steps (cut from 256) in bf16 timed, with finite
     outputs.
 6d. serve — the single-engine service at srn64 full width through
     ``cli/serve_cli.py``'s ``build_service`` (chip_smoke's random weights
     as a state dict, ``--sampler_steps 8`` (cut from 64), ``--schedules
     ddim:16 --max_batch 4 --warmup``) and HTTP on an ephemeral port: the serving
     path, counts set to 0 before ``build_service`` and read after.
     Three concurrent requests (4 lanes, one padding) bit-identical to
     ``synthesize_many`` on the same sampler over the same lanes; a
     5-view request admitted while a 7-view one runs finishes first; a
     replay answered from the result cache; a ``ddim:16`` request; a hot
     swap (every weight + 0.05) changes the views with no new graph and
     no moved parameter, and swapping back restores them bit for bit;
     ``/healthz``, ``/metrics``, ``/stats``; ``stop`` joins the engine.
     s per view step at lanes 1, 2, 4, time to first view, each graph's
     first-use seconds and bytes, peak memory, launches.  Then
     serve_groupnorm / serve_attention: rows 1 and 3 at the 4-lane view
     step's sites, checked and timed.
 6e. serve_fleet — two srn64 replicas behind the fleet router
     (``serve_cli --replicas 2 --sampler_steps 8 --schedules
     ancestral:8,1@ddim:16 --max_batch 2 --warmup``, each replica with
     its own weights, samplers and graphs) over HTTP: four sticky
     sessions, two owned by each replica by rendezvous, posted 0.1 s apart
     so both replicas meet their first 2-lane use at once; each replica's
     views bit-identical to ``synthesize_many`` on its own sampler over the
     same lanes; the ``1@ddim:16`` request on replica 1 only; a rolling
     rollout (every weight + 0.05) changes the views and rolling back
     restores them bit for bit, every graph and ``data_ptr`` kept; replica
     0 killed: its session gets ``SessionLost`` (503, Retry-After) and
     sessionless traffic fails over.  s per view step of each replica at
     lanes 1 and 2, each first use's seconds and bytes, weight bytes per
     replica, launches.  Then serve_fleet_groupnorm /
     serve_fleet_attention: rows 1 and 3 at the 2-lane sites.
 6f. serve_workers — ``worker_cli --devices 0 --port 0`` as a process on
     the card, fronted by ``serve_cli --workers`` (no engine of its own,
     no device memory allocated): its views against the in-process
     engine's for the same payload and seed (bit-identical, else rel. L2
     1e-3); SIGTERM drains it, exit 0; a second worker with
     ``--hbm_budget_bytes`` one byte above the first's pin plus one
     record admits one request and refuses a second ``ReplicaOverBudget``
     (503, Retry-After), exit 0.  Boot seconds; the worker's launches
     read over the wire.
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
 9b. train_graph — 3 srn64 steps at global batch 128 as CUDA graphs
     (the first eager, then captured micro and update graphs replayed)
     and 3 eager steps (``--eager``), each from a ``Trainer`` built by
     ``cli/train_cli.py`` from the same seeds: losses, gradient norms,
     parameters, Adam's state and the EMA bit-identical; s/step of each.
 10. train — the ``Trainer`` through ``cli/train_cli.py``'s code path on
     the synthetic dataset at srn64, global batch 128, the step as CUDA
     graphs: the training path, with the launch counts set to 0 just
     before it and read after (eager launches plus captured x replays);
     s/step, examples/s, peak memory, loss and grad_norm per step; then a
     checkpoint restored into a fresh trainer (whose step runs eagerly and
     recaptures) takes one step, which must equal the first trainer's
     next, replayed, step bit for bit.  Then the same run with
     ``--eval_every 3`` on the synthetic val set in two trainers: a
     SIGTERM delivered through ``testing.faults.wrap_iter`` at the 4th
     batch of the first (the preemption handler installed): ``train()``
     returns at step 4 with that step's checkpoint on disk and the
     handler uninstalls; the second resumes with ``--transfer`` to step
     6.  Finite val losses at steps 3 and 6; the state at step 6
     bit-identical to the first trainer's, which neither evaluated nor
     stopped; each eval's launches; the val forward (EMA weights, one val
     batch, injected draws) through the kernels against the plain
     versions (loss and denoiser output, relative 1e-2).  Each trainer's
     graphs are released before the next captures.
 11. eval — ``cli/eval_cli.py`` on that checkpoint (EMA) on synthetic
     scenes: 2 objects, 3 views, a 32-step dense grid (the parity
     oracle's, cut from 256), DDIM at 4 steps (cut from 32),
     ``--w_select 1
     --parity_objects 1 --orbit 4``; finite PSNR / SSIM / fid_randfeat per
     w, the parity and orbit fields, s per object; run again, it
     re-synthesises nothing and prints the same line.
 12. srn128_model — the srn128 X-UNet (bf16, seeded random weights) at
     2B = 16: kernel path against plain path (rel. L2 3e-2, as srn64), ms
     and launches per forward, and the ptxas registers and spill bytes of
     every kernel instance its path launches (reported, not gated).
 13. srn128_sampler — one srn128 view, 16 ancestral steps (cut from
     256: the step is the same), w = 0..7, the reverse step as a CUDA graph:
     the srn128 sampling path, counts set to 0 before and read after; ms
     per step, s per view, peak memory; then a 16-step view graph against
     eager, bit-identical.
 13b. serve_cascade — ``serve_cli --config srn128 --cascade
     draft=64:ddim:8,refine=128:ancestral:16@t0.4375 --max_batch 2`` on
     the srn128 weights over HTTP: two concurrent 3-view cascades walked
     through ``?from=K`` (4 events each, each view's draft before its
     refine, a gapless cursor, finite views); one cascade alone
     bit-identical to ``CascadeSampler.synthesize_cascade``; a swap
     refreshes the draft's ``pos_emb`` in place with no new capture.  s
     per view step of each phase at lanes 1 and 2, each request's times
     to first draft / refined frame, launches split by phase.  Then
     serve_cascade_groupnorm / serve_cascade_attention: rows 1 and 3 at
     the draft's (64^2) and the refine's (128^2) 2-lane sites.
 14. srn128_train — remat against no remat on one srn128 step at batch 4
     (f32 and bf16, dropout 0.1, the same draws): loss and gradients
     bit-identical, peak memory of each; the peaks of an eager Trainer
     step at two batches under each remat policy predict the smallest
     ``--accum`` that leaves 8 GiB of the card free, and under "nothing"
     that accum is tried on the graph path in a child process, on one
     microbatch of its size (doubled if
     it does not fit there: a capture needs more); then the ``Trainer``
     built by
     ``train_cli --config srn128 --remat --synthetic_scenes`` at global
     batch 128 as CUDA graphs, 2 steps under "nothing" (``train()``: the
     srn128 training path, counts set to 0 before and read after; the
     recompute launches every block's forward kernels again) and 2 under
     "dots" (cut from 4 each, then "nothing" to 2); s/step, examples/s, peak memory, loss and grad_norm per step;
     then ``sample_cli --config srn128`` on the "nothing" checkpoint (EMA)
     at 8 steps (cut from 32): finite views.
 15. srn128_sites — every GroupNorm and attention site of a srn128
     sampler step and of one training microbatch: each kernel against
     its plain version, the forward's cluster plans fit the card; per
     site and per step the time, bound, plain version and library call.

 16. srn128_init_from — ``train_cli --config srn128 --ch 128 --init_from
     <the srn64 train checkpoint> --init_res 64 --synthetic_scenes --accum
     <srn128_train's>`` (``--ckpt_mode ema_bf16``), 2 steps at global
     batch 128 on the graph path: before the first step every tensor but
     ``pos_emb`` equals the srn64 source's EMA and ``pos_emb`` is 128 x
     128; finite losses; s/step.

Between 11 and 12 (after eval, on the srn64 train checkpoint):
 11a. parallel — data parallelism at srn64 full width, global batch 128:
     (a) the replicated ``Trainer`` (``train_cli``'s) over an NCCL group
     of world size 1 made in this process (rendezvous on a free local
     port; a failed init raises), 3 steps as CUDA graphs with the
     gradient all-reduce captured in the update graph, bit-identical to
     the same Trainer without a group (train_graph's graph run: the same
     argv and seeds); ms per step of both and the
     all-reduce's own ms and share; (b) the ``--param_sharding fsdp``
     Trainer on that group, 2 eager steps, its loss and state against
     (a)'s after 2 steps (relative 1e-2; at world size 1 the reference's
     rule replicates every leaf); (c) two processes sharing the card over
     gloo (``testing.distributed.spawn``; gloo takes no CUDA tensor for
     point-to-point or all-to-all, so those transfers are staged through
     pinned host memory): ``ring_sdpa`` and ``ulysses_sdpa`` at srn128's
     L = 1024 site split in 2 (bf16, 32 x 1024 x 4 x 128), forward and
     gradients against the unsharded kernel and the plain version within
     ``_tol``, rows 4, 5 and 6 launched on each rank; the whole calls
     timed beside the plain engines and ``F.scaled_dot_product_attention``,
     and the kernels alone, the ranks in turn (rows 4-6 on one 512 x 512
     ring block, the backward with a non-zero lse cotangent; row 3 on
     Ulysses' local heads), beside the same; (d) one ``torchrun
     --standalone --nproc_per_node 1`` launch of this script
     (``--torchrun-entry-points``) that runs ``train_cli.main
     --param_sharding fsdp`` (2 steps), then ``eval_cli.main --mesh`` on
     its checkpoint (1 object, DDIM 4), then ``serve_cli.main --mesh
     --replicas 2`` on that checkpoint (both replicas over the mesh at
     world 1, led by rank 0: 2 HTTP requests, then SIGTERM), in the group torchrun's environment names (one
     start-up for all three): exit 0, the checkpoint's manifest carries
     the topology, finite PSNR, two finite answers; the torchrun start-up
     seconds.  (c) runs after (d).
 11a'. tensor_parallel — the ``tp`` placement over a model axis of two
     processes sharing the card (gloo; its collectives staged through
     pinned host memory; the two processes of 11a (c), which run this
     phase's ranks after their ring and Ulysses work, the one-rank
     references computed before them), srn64 at full width, dp1 x mp2:
     (a) one X-UNet
     forward at 2B = 16 (seeded random weights, placed: each rank its
     blocks) against the one-rank forward on the card (rel. L2 3e-2);
     (b) ``Sampler(mesh)`` on a float32 copy (TF32 off): one view of 1
     DDIM step (cut from 2) against the one-rank ``Sampler`` from the same
     generator seed (rel. L2 3e-2);
     (c) the ``Trainer`` built by ``train_cli --param_sharding tp
     --model_parallel 2`` from the train phase's checkpoint (the lr put on
     the batch-8 schedule at its step), 1 eager step (cut from 2) at
     global batch 8, against one rank's eager step from the same
     checkpoint: losses, gradient norms and lrs within 1e-3, and every
     parameter's update (its change over the step) within 3e-2 rel. L2 of
     one rank's, or
     every element of it within 2 float32 spacings of the parameter plus
     1e-8 (a leaf that barely moves differs by the rounding of ``p + u``;
     the k_proj biases, whose exact gradient is zero, by bf16's summation
     noise); then the control, which the same gate must refuse:
     the tp state restored to the checkpoint and the first step retaken on
     the same batch with the model axis's ``copy`` not summing its
     gradient over the ranks (its backward the identity), against one
     rank's first update; the
     launch counts set to 0 before (a) + (b) and before (c), read after
     each: rows 1 and 3 in the first window, rows 1 (with statistics),
     2, 4, 5 and 6 in the second, on each rank; (d) the tp checkpoint
     (gathered, written by rank 0) restored at world 1 (into the one-rank
     trainer of (c)): each rank's blocks of every tensor (parameters, EMA, Adam's moments) cut from
     the restored whole tensors bit-identical to the rank's own; (e) on
     rank 0 (rank 1's sites are the same shapes, the inputs seeded by
     shape), rows 1-6 at the shapes the model axis
     gives them there (C/2 channels, G/2 groups, 2 of 4 heads), held
     against their plain versions and timed beside their bounds (the
     site phases' functions, run without the extra shapes), and rows 1
     and 3 without statistics at the train step's sites (the distill
     teacher's); the staged collectives' ms per forward and per train
     step; (f) the distill leg (``distill_leg``, its one-rank half
     ``distill_leg_prepare`` before the ranks): from a world-1 mid-round
     checkpoint (the train checkpoint's EMA as teacher and student after
     one one-rank distill step; Adam's state then set so that each update
     is linear in its gradient), restored into the placed student
     through ``CheckpointManager``, the teacher's whole weights placed
     like it, 1 eager distill step (cut from 2) at k = 8 and global
     batch 8 against one rank's: losses, gradient norms and lrs within 1e-2, each leaf's
     update within (c)'s gate; then the first step retaken from the start
     with ``copy``'s backward unsummed, which the gate must refuse with
     its loss bit-identical; the launch counts set to 0 before the step
     and read after: rows 1 (teacher and student), 2, 3-4, 5 and 6
     on each rank, no plain version called.
 11a''. context_parallel — ``MeshConfig.context_parallel`` (the
     ``replicated`` placement) over a model axis of the same two
     processes (after their tp ranks; the one-rank references are 11a''s),
     srn64 at full width, dp1 x mp2, each rank its 32 of the 64 rows at
     level 0 (16, 8, 4 below): (a) one forward at 2B = 16 against one
     rank's (rel. L2 3e-2), the staged collectives per forward (calls,
     bytes, ms); (d) ``Sampler(mesh).synthesize`` on a float32 copy (TF32
     off), its single-object path split by rows: one view of 1 DDIM step
     against one rank's (3e-2); (c) the ``Trainer`` built by ``train_cli
     --context_parallel --model_parallel 2`` from the train phase's
     checkpoint, 2 eager steps at global batch 8 against one rank's:
     losses, gradient norms and lrs within 1e-3, each leaf's update
     within 3e-2 rel. L2 of one rank's or every element within 2 float32
     spacings of the parameter + 1e-8 (11a''s gate), both ranks the same
     update; the control, which the gate must refuse: the first step
     retaken from the checkpoint with the halo's backward not adding the
     neighbours' share to a rank's edge rows; (e) the second step's peak
     allocated bytes above what it starts with, against one process's at
     batch 8 (at most 0.75x); the launch counts set to 0 before (a) + (d)
     and before (c), read after each: the split-statistics GroupNorm (a)
     and (b) and row 3 in the first window, (a)-(d) and rows 4-6 in the
     second, the unsplit GroupNorm kernels never; (b) on rank 0 (rank
     1's rows are the same shapes), the four split-statistics entry
     points at every
     GroupNorm site of the rank's rows against their plain versions (bf16
     and f32; sums and statistics bit-identical over two runs), timed
     beside their bounds, their plain versions and ``F.group_norm`` +
     FiLM; rows 3-6 at ``Lq = L/2``, ``Lk = L`` (row 3 also at the train
     sites: the distill teacher's); (f) the distill leg, as (f) of 11a'
     with the row split, its control the halo's backward add removed:
     the split-statistics (a)-(d) and rows 3-6 launched on each rank, the
     unsplit GroupNorm never, no plain version called; (g) cp with the
     ``tp`` placement (split leaves held as this rank's blocks, each layer
     gathering them whole): one forward of the same seeded weights at
     2B = 16, bit-identical to (a)'s, its leaf gathers' calls, bytes and
     host ms; the ``Trainer`` of ``train_cli --context_parallel
     --model_parallel 2 --param_sharding tp`` from the same checkpoint,
     one eager step on (c)'s first batch, each leaf's update (blocks
     summed over the ranks) against one rank's first update by (c)'s
     gate, the bytes a rank holds for the parameters, Adam's moments and
     the EMA at most 0.6x (c)'s, the step's peak above its start at most
     0.75x one process's; the launch counts set to 0 before the forward
     and before the step: (a)-(d) and rows 3-6 on each rank, the unsplit
     GroupNorm never, no plain version called.
 11a'''. serve_mesh — serving over a data=2 mesh of the same two
     processes (after their cp ranks; the one-process references on this
     process after them), srn64 at full width, seeded random weights,
     views of 8 ancestral steps (fewer broke the serve phase's
     late-request check):
     a ``ServingService`` over ``Sampler(mesh)`` and a ``RankChannel``
     (rank 0 leads: its engine sends each view step's plan; rank 1
     follows), the weights' digests equal; lanes 2 and 4 warmed on both
     ranks; 3 requests at once (4 lanes, 2 a rank), a fourth admitted and
     a weights swap (every weight x 1.01) staged after the first view
     step, both landing at the second; the last view of the fourth alone
     (2 lanes); then the fleet leg's pair of requests at once (2 lanes,
     its reference).  Every rank's views of every step bit-identical; each
     view step again on one process, each rank's share of the leader's
     plan (records, lengths, the lanes' generator states, the weights of
     its generation) at the rank's shape, bit-identical; the swapped
     weights in float32 (TF32 off) serving the same traffic without the
     swap at one lane a rank (max_batch 2; views of 2 steps), each
     request against one process's engine at one lane a call on the same
     traffic (rel. L2 1e-4: rank 1's lanes end to end, the generator
     states it hands back included); the launch counts
     set to 0 before the bf16 service and read after its stop: rows 1 and
     3 launched on each rank for its share, 101 and 30 a model call, no
     plain version called; s per view step by lanes beside the serve
     phase's (one process, the same config),
     the staged gather's calls, bytes and ms; then the fleet leg:
     ``serve_cli.build_service`` with ``--mesh --replicas 2 --warmup``
     on both ranks from the swapped weights (every replica over both
     ranks, each with its own channel and views' gather; replica 1 a
     copy checked by digest on each rank), the launch counts set to 0
     before and read after: two sessions on each replica at once (2
     lanes, one a rank), a rollout (x 1.01) named for replica 1, one more
     request in its session, replica 1 killed (its session's next
     request lost), the fleet stopped; each replica's view steps
     bit-identical across the ranks and, for the pair, to the one-replica
     service's tail; replica 1's rollout landing at one step on both
     ranks (generation 1), replica 0's never moving; replica 1's
     follower loop ended within 5 s of the kill, before replica 0's;
     rows 1 and 3 launched by each replica's graphs on each rank, no
     plain version; the leader's s per view step per replica (wall and
     held), each channel's messages; then ``boot_worker`` over
     the same two ranks (both on ``cuda:0``, gloo): the boot's seconds,
     one session through its socket, finite views; rows 1 and 3 at a
     rank's 2-lane sites, on rank 0 (both ranks record the same sites),
     against their plain versions and timed.
 11b. distill — ``distill(start_steps=8, final_steps=2, round_steps=2)``
     (round_steps cut from 3)
     at srn64 full width, batch 128, the teacher the train checkpoint's
     EMA, one CUDA graph for every round (the distillation path: counts
     set to 0 before, read after; s/step, peak); each round's
     ``full_sliced`` checkpoint; the same run eagerly, bit-identical;
     the last checkpoint restored bit for bit; round 2 rerun from round
     1's checkpoint, bit for bit; one step at batch 16 kernels vs plain
     (bf16: loss and gradients 1e-2); a 2-step DDIM view, finite.  Then
     distill_groupnorm / distill_attention: rows 1 and 3 (no statistics)
     at the teacher's sites (the train step's), checked and timed.
 11c. convert — reference ``.pt`` files at srn64 and srn128 full width
     from seeded random weights: ``convert_cli --verify`` then
     ``convert_cli``; key counts; a dropped key and a changed shape exit
     non-zero; ``sample_cli --sampler ddim --steps 8`` on the converted
     srn64 checkpoint, finite.

Then one ``{"kernels": [...]}`` line (each kernel per srn64 step, per
served step (single engine, fleet, worker), per cascade step (draft and
refine apart), per srn128 step, per distill step, then per val forward of
the Trainer's evaluation) and, last, the device line.  The library calls are timing
yardsticks only; the port never calls them.

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
import signal
import struct
import subprocess
import sys
import time
import zlib

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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps(dict(obj, elapsed_s=round(time.perf_counter() - _T0,
                                               1))), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back runs
    (CUDA events, after ``warmup`` runs).  Python's garbage collector is
    off while they run, as in ``timeit``: a collection of this process's
    heap would otherwise land in one window as a host pause.  No
    collection is forced first: with this process's heap one takes ~0.1
    s, and the site phases time hundreds of calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb [H, W, 3]`` written with zlib and struct
    (no image library)."""
    h, w, _ = rgb.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


NATIVE_TOL = 1e-6               # native decode vs the float box mean
PIL_TOL = 4.5 / 255             # native vs PIL (uint8 fixed-point resize)


def phase_native():
    """The data path's native PNG decoder on the card's host: whether it
    built (with the build's last line if not).  Where it did, a 64 x 64
    PNG written here decoded to 32 x 32 alone and through the shared
    pool, against the float 2 x 2 box mean (1e-6) and against the port's
    PIL path where PIL is installed (4.5 / 255: PIL resizes in uint8)."""
    from diff3d_tpu_torch import native
    from diff3d_tpu_torch.data import srn

    t0 = time.perf_counter()
    ok = native.available()
    out = {"available": ok, "build_error": native.build_error(),
           "build_s": round(time.perf_counter() - t0, 3)}
    if not ok:
        out["path"] = "the SRN readers take the PIL path on this host"
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    out["pil_installed"] = have_pil
    if ok:
        rgb = np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)
        d = os.path.join(WORKDIR + "_native")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "view.png")
        write_png(path, rgb)
        got = native.decode_image(path, 32)
        pool = native.shared_pool().decode_batch([path] * 4, 32)
        box = (rgb.astype(np.float64).reshape(32, 2, 32, 2, 3).mean((1, 3))
               / 255.0 * 2.0 - 1.0)
        out["max_abs_err_vs_box_mean"] = float(np.abs(got - box).max())
        out["pool_equal"] = bool((pool == got[None]).all())
        if have_pil:
            pil = srn.load_view_image(path, 32, use_native=False)
            out["max_abs_err_vs_pil"] = float(np.abs(got - pil).max())
        else:
            out["pil"] = ("PIL is not installed here: the non-native path "
                          "cannot run on this host")
        shutil.rmtree(d, ignore_errors=True)
    elif not have_pil:
        out["pil"] = ("neither the native decoder nor PIL can run on this "
                      "host: SRN data cannot be read here")
    emit(dict(phase="native", **out))
    if ok and not (out["max_abs_err_vs_box_mean"] <= NATIVE_TOL
                   and out["pool_equal"]
                   and out.get("max_abs_err_vs_pil", 0.0) <= PIL_TOL):
        raise AssertionError(f"native: {out}")
    return out


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
    return {src: ptxas_kernels(log) for src, log in logs.items()}


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


def phase_groupnorm(gn_sites, phase="groupnorm", odd_shapes=True,
                    site=None):
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops import build, cuda_film
    from diff3d_tpu_torch.ops.cuda_film import (fused_groupnorm,
                                                groupnorm_reference)

    odd = [(2, 256, 128, 32), (2, 256, 256, 32), (1, 256, 512, 32),
           (1, 64, 1024, 32), (2, 64, 96, 32), (1, 1000, 144, 24),
           (3, 1, 128, 32),                             # L = 1
           (2, 64, 2048, 2048), (1, 16, 4096, 4096)]    # G up to C <= 4096
    shapes = sorted({k[:4] for k in gn_sites}) + (odd if odd_shapes else [])
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
    emit({"phase": phase, **({"site": site} if site else {}),
          "checked": checked,
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


def phase_attention(attn_sites, phase="attention", extra_shapes=True,
                    site=None):
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops.cuda_attention import (attention_reference,
                                                     flash_attention)

    extra = [(32, 1024, 1024, 4, 128), (32, 256, 256, 4, 256),  # srn128
             (1, 200, 200, 2, 32), (1, 96, 160, 2, 64),
             (1, 64, 64, 2, 160), (1, 63, 65, 2, 64), (1, 129, 127, 2, 128),
             (1, 65, 63, 3, 36)]
    wide = WIDE_ATTN if extra_shapes else []
    shapes = sorted(attn_sites) + (extra if extra_shapes else [])
    worst = 0.0
    for si, shape in enumerate(shapes + wide):          # wide: untimed
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
    emit({"phase": phase, **({"site": site} if site else {}),
          "checked": 2 * len(shapes + wide),
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


def phase_groupnorm_backward(gn_sites, accum, phase="groupnorm_backward",
                             edges=True, f32_max_n=None):
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
    for si, (N, L, C, G) in enumerate(GN_BWD_EDGES if edges else []):
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
            nb = (N if dtype == torch.bfloat16 or f32_max_n is None
                  else min(N, f32_max_n))
            x, gamma, beta, kw = gn_inputs((nb, L, C, G), dtype, film, si)
            gen = torch.Generator("cuda").manual_seed(100 + si)
            g = torch.randn(nb, L, C, generator=gen, device="cuda").to(dtype)
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
    emit({"phase": phase, "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "f32 1e-5*(1+max|ref|); bf16 2^-7*(1+max|ref|); "
                       "dgamma/dbeta (f32 sums over N*L) 1e-4*(1+max|ref|)",
          "f32_checked_samples": f32_max_n or "all",
          "sites": sites, "per_train_step_forward_save_stats": fwd,
          "per_train_step_backward": bwd})
    return fwd, bwd


def phase_attention_backward(attn_sites, accum, phase="attention_backward",
                             extra_shapes=True, f32_max_n=None):
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
    wide = WIDE_ATTN if extra_shapes else []
    shapes = sorted(attn_sites) + (extra if extra_shapes else [])
    worst, checked = 0.0, 0
    rows = {"lse": {"max_abs_err": 0.0}, "dkdv": {"max_abs_err": 0.0},
            "dq": {"max_abs_err": 0.0}}
    sites = []

    def launches():
        return (flash_attention.launches, attention_backward_dkdv.launches,
                attention_backward_dq.launches)

    for si, shape in enumerate(shapes + wide):
        B, Lq, Lk, H, D = shape
        count = attn_sites.get(shape, 0) * accum
        for dtype in (torch.float32, torch.bfloat16):
            nb = (B if dtype == torch.bfloat16 or f32_max_n is None
                  else min(B, f32_max_n))
            for with_glse in (False, True):
                q, k, v = attn_inputs((nb,) + shape[1:], dtype, si)
                qr, kr, vr = _leaf(q), _leaf(k), _leaf(v)
                gen = torch.Generator("cuda").manual_seed(200 + si)
                do = torch.randn(nb, Lq, H, D, generator=gen,
                                 device="cuda").to(dtype)
                gl = (torch.randn(nb, Lq, H, generator=gen, device="cuda")
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
    emit({"phase": phase, "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "o f32 1e-5 / bf16 2^-7; lse 1e-5; dq/dk/dv f32 "
                       "1e-4 / bf16 2^-7, each *(1+max|ref|)",
          "f32_checked_batch_heads": f32_max_n or "all",
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


def random_model(cfg):
    """The X-UNet of ``cfg`` on the card, every weight random from a seed
    (the zero-initialised convs and the GroupNorm affines too)."""
    import torch

    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.models.layers import FrameGroupNorm

    model = build_model(cfg.model, "cuda", seed=0, randomize_zero_init=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrameGroupNorm):
                C = m.weight.shape[0]
                m.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
                m.bias.copy_(0.1 * torch.randn(C, generator=g))
    return model


def srn64_model():
    """The srn64 full-width X-UNet, bf16, seeded random weights."""
    from diff3d_tpu_torch.config import srn64_config

    cfg = srn64_config()
    return cfg, random_model(cfg)


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


def phase_model(cfg, model, batch, cond_mask, config="srn64",
                phase="model"):
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
        raise AssertionError(f"{phase}: kernel path vs plain path relative "
                             f"L2 error {rel} > 3e-2")
    out = {"phase": phase, "config": config, "batch": int(out.shape[0]),
           "max_abs_err": err, "rel_l2_err": rel,
           "max_abs_ref": float(ref.abs().max()), "tolerance": "rel L2 3e-2",
           "ms_per_forward": round(ms, 3),
           "plain_ms_per_forward": round(plain_ms, 3),
           "launches_per_forward": launches}
    return out


def phase_sampler(cfg, model):
    import torch

    from diff3d_tpu_torch.sampling import Sampler

    views = orbit_views(2, cfg.model.H, seed=3)   # one view generated
    sampler = Sampler(model, cfg, device="cuda")
    if not sampler.cuda_graphs:
        raise AssertionError("sampler: the card's path is not the graph")
    gen = torch.Generator("cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    outs = sampler.synthesize(views, gen)        # ends in a device fetch
    seconds = time.perf_counter() - t0
    eager = {k: v for k, v in _launch_counts().items()
             if k in ("fused_groupnorm", "flash_attention")}
    ran = _launch_counts(graphs=sampler.graphs.values())
    launches = {k: ran[k] for k in eager}
    graphs = list(sampler.graphs.values())
    if not graphs or any(g.captured.get(k, 0) == 0 or g.replays == 0
                         for g in graphs for k in launches):
        raise AssertionError(f"sampler: the graph path did not run both "
                             f"kernels: {_graph_summary(graphs)}")
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
          "launches": launches, "eager_launches": eager,
          "graphs": _graph_summary(graphs)})
    return launches, steps



def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


SAMPLER_GRAPH_STEPS = 16        # graph against eager (cut from 256)


def phase_sampler_graph(cfg, model):
    """One srn64 view (``SAMPLER_GRAPH_STEPS`` ancestral steps, w = 0..7)
    through the graph path and the eager path from the same generator
    seed, in the order eager, graph (its first view: one eager step, the
    capture, the replays), graph (replays only), eager.  The views must be
    bit-identical."""
    import torch

    from diff3d_tpu_torch.sampling import Sampler

    views = orbit_views(2, cfg.model.H, seed=4)
    runs, outs = [], {}
    samplers = {g: Sampler(model, cfg, device="cuda", cuda_graphs=g,
                           steps=SAMPLER_GRAPH_STEPS)
                for g in (False, True)}
    for graphs in (False, True, True, False):
        sampler = samplers[graphs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _launch_counts(reset=True)
        replays0 = {k: g.replays for k, g in sampler.graphs.items()}
        t0 = time.perf_counter()
        out = sampler.synthesize(views,
                                 torch.Generator("cuda").manual_seed(0))
        seconds = time.perf_counter() - t0
        eager = _launch_counts()
        ran = dict(eager)
        for k, g in sampler.graphs.items():
            for name, n in g.captured.items():
                if name in ran:
                    ran[name] += n * (g.replays - replays0.get(k, 0))
        outs.setdefault(graphs, []).append(out)
        runs.append({"cuda_graphs": graphs, "seconds": round(seconds, 4),
                     "ms_per_step": round(
                         1e3 * seconds / sampler.model_calls_per_view, 3),
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(),
                     "launches": {k: ran[k] for k in
                                  ("fused_groupnorm", "flash_attention")},
                     "eager_launches": {k: eager[k] for k in
                                        ("fused_groupnorm",
                                         "flash_attention")}})
    graphs = list(samplers[True].graphs.values())
    ref = outs[False][0]
    identical = all(np.array_equal(o, ref) for o in outs[False] + outs[True])
    rel = max(_rel_l2(o, ref) for o in outs[True])
    eager_ms = [r["ms_per_step"] for r in runs if not r["cuda_graphs"]]
    graph_ms = [r["ms_per_step"] for r in runs if r["cuda_graphs"]]
    out = {"config": "srn64", "steps_per_view": SAMPLER_GRAPH_STEPS,
           "guidance_weights":
           len(cfg.diffusion.guidance_weights), "runs": runs,
           "eager_ms_per_step": eager_ms,
           "graph_ms_per_step_first_view": graph_ms[0],
           "graph_ms_per_step": graph_ms[1],
           "capture_s": [round(g.capture_s, 3) for g in graphs],
           "graphs": _graph_summary(graphs),
           "bit_identical": identical, "rel_l2_graph_vs_eager": rel,
           "tolerance": "bit-identical"}
    emit(dict(phase="sampler_graph", **out))
    if not np.isfinite(ref).all():
        raise AssertionError("sampler_graph: non-finite view")
    if not identical:
        raise AssertionError(f"sampler_graph: graph and eager views differ "
                             f"(rel. L2 {rel})")
    return out


SAMPLER_MANY_STEPS = 16         # the timed batched view (cut from 256)
SAMPLER_MANY_F32_STEPS = 4      # step_many vs step (cut from 8)


def phase_sampler_many(cfg, model):
    """``step_many`` over N = 4 objects at record lengths 1-4 against
    ``step`` per object on an f32 copy of the model at
    ``SAMPLER_MANY_F32_STEPS`` steps (rel. L2
    1e-3: the batched convolutions and matmuls may take other algorithms);
    then ``synthesize_many`` of one view of 4 objects at
    ``SAMPLER_MANY_STEPS`` steps in bf16, timed."""
    import torch

    from diff3d_tpu_torch.diffusion import Draws
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.sampling import Sampler

    N, cap = 4, 8                       # record lengths 1-4 < capacity
    B = len(cfg.diffusion.guidance_weights)
    H = cfg.model.H
    objs = [orbit_views(cap, H, seed=10 + n) for n in range(N)]
    lens = [1, 2, 3, 4]
    rec = np.zeros((N, cap, B, H, H, 3), np.float32)
    rng = np.random.default_rng(11)
    for n, valid in enumerate(lens):
        rec[n, :valid] = rng.uniform(-1, 1, (valid, B, H, H, 3))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device="cuda")

    R, T, K = (t([o[k] for o in objs]) for k in ("R", "T", "K"))
    m32 = XUNet(dataclasses.replace(cfg.model, dtype="float32")).cuda()
    m32.load_state_dict(model.state_dict())
    sampler = Sampler(m32, cfg, device="cuda", steps=SAMPLER_MANY_F32_STEPS)

    def draws():
        return [Draws(torch.Generator("cuda").manual_seed(20 + n))
                for n in range(N)]

    many_rec = t(rec)
    out_many, _, _ = sampler.step_many(many_rec, R, T, lens, K, draws())
    seq = []
    for n, d in enumerate(draws()):
        one_rec = t(rec[n])
        o, _, _ = sampler.step(one_rec, R[n], T[n], lens[n], K[n], d)
        seq.append(o)
    seq = torch.stack(seq)
    rel = float((out_many - seq).norm() / seq.norm())
    del sampler, m32
    gc.collect()
    torch.cuda.empty_cache()

    bf16 = Sampler(model, cfg, device="cuda", steps=SAMPLER_MANY_STEPS)
    views = [orbit_views(2, H, seed=30 + n) for n in range(N)]
    gens = [torch.Generator("cuda").manual_seed(40 + n) for n in range(N)]
    bf16.synthesize_many(views, gens)          # warm-up: the capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = bf16.synthesize_many(views, gens)
    seconds = time.perf_counter() - t0
    out = {"objects": N, "record_lens": lens, "record_capacity": cap,
           "f32_steps": SAMPLER_MANY_F32_STEPS, "rel_l2_many_vs_step": rel,
           "tolerance": "rel L2 1e-3 (f32, TF32 off)",
           "bf16_steps": SAMPLER_MANY_STEPS,
           "bf16_seconds": round(seconds, 4),
           "bf16_ms_per_step": round(1e3 * seconds / SAMPLER_MANY_STEPS, 3),
           "bf16_ms_per_object_step": round(
               1e3 * seconds / SAMPLER_MANY_STEPS / N, 3),
           "bf16_max_memory_allocated": torch.cuda.max_memory_allocated(),
           "bf16_out_abs_max": float(np.abs(outs).max()),
           "graphs": _graph_summary(bf16.graphs.values())}
    emit(dict(phase="sampler_many", **out))
    if outs.shape != (N, 1, B, H, H, 3) or not np.isfinite(outs).all():
        raise AssertionError(f"sampler_many: output {outs.shape}, finite "
                             f"{np.isfinite(outs).all()}")
    if not rel <= 1e-3:
        raise AssertionError(f"sampler_many: step_many vs step rel. L2 "
                             f"{rel} > 1e-3")
    return out


SERVE_WORKDIR = WORKDIR + "_serve"
SERVE_STEPS = 8                 # steps of a served view (cut from 64)
SERVE_ARGV = ["--config", "srn64", "--port", "0", "--sampler_steps",
              str(SERVE_STEPS),
              "--schedules", "ddim:16", "--max_batch", "4", "--max_wait_ms",
              "500", "--warmup"]
SERVE_WAIT_S = 600.0            # every HTTP wait's limit


def _serve_http(port, path, payload=None):
    """One request to the service on this host: ``(status, body)``."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
        return r.status, r.read()


def _serve_payload(views, seed, **kw):
    return {"views": {k: np.asarray(v).tolist() for k, v in views.items()},
            "seed": seed, "n_views": int(views["imgs"].shape[0]), **kw}


def _post_all(port, payloads, gap_s=0.0, path="/synthesize"):
    """POST ``payloads`` to ``path`` at once (``gap_s`` apart, in order),
    one thread each; their JSON bodies in order, with the wall time each
    answered at."""
    import threading

    out, errs = [None] * len(payloads), []

    def run(i):
        try:
            status, body = _serve_http(port, path, payloads[i])
            if status not in (200, 202):
                raise AssertionError(f"serve: status {status}")
            out[i] = dict(json.loads(body), answered=time.perf_counter())
        except Exception as e:       # re-raised below, on this thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
        time.sleep(gap_s)
    for t in threads:
        t.join(SERVE_WAIT_S)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: requests failed: {errs}")
    return out


def _views_of(body):
    return np.asarray(body["views"], np.float32)


def phase_serve(cfg, model):
    """The single-engine service at srn64 full width, built by
    ``serve_cli``'s own ``build_service`` from chip_smoke's seeded random
    weights (a state dict, ``--model``) and driven over HTTP on an
    ephemeral port: ``--sampler_steps 8 --schedules ddim:16 --max_batch
    4 --warmup``.  Three concurrent requests (4 lanes, one padding) must
    be bit-identical to ``synthesize_many`` on the same sampler over the
    three objects plus a fourth repeating object 0 under another seed; a
    5-view request posted after a 7-view one has committed its first
    view must finish first; a replay comes from the result cache; a
    ``ddim:16`` request; a hot swap (every weight + 0.05) changes the
    views without a new graph or a moved parameter, and swapping back
    restores them bit for bit; ``/healthz``, ``/metrics``, ``/stats``;
    ``stop`` joins the engine thread.  The counts are set to 0 before
    ``build_service`` (its warm-up captures are part of the path) and
    read after; the reference's replays are taken out."""
    import threading

    import torch

    from diff3d_tpu_torch.cli import serve_cli
    from diff3d_tpu_torch.serving import lane_count

    H = cfg.model.H
    os.makedirs(SERVE_WORKDIR, exist_ok=True)
    weights = os.path.join(SERVE_WORKDIR, "srn64_random.pt")
    torch.save(model.state_dict(), weights)
    argv = ["--model", weights] + SERVE_ARGV
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    service = serve_cli.build_service(serve_cli.build_parser().parse_args(
        argv))
    build_s = time.perf_counter() - t0
    eng = service.engine
    sampler = eng.samplers[("ancestral", SERVE_STEPS)]

    def graphs():
        return [g for s in eng.samplers.values() for g in s.graphs.values()]

    steps_log, seen = [], set()
    inner = eng._run_view_step

    def timed(active):           # the engine thread's view step, timed
        b = active[0].req.bucket
        key = (f"{b.sampler}:{b.steps}", lane_count(len(active),
                                                     eng.max_batch),
               b.capacity)
        t = time.perf_counter()
        inner(active)
        steps_log.append({"schedule": key[0], "lanes": key[1],
                          "capacity": key[2], "live": len(active),
                          "first_use": key not in seen,
                          "s": time.perf_counter() - t})
        seen.add(key)

    eng._run_view_step = timed
    service.start(serve_http=True)
    port = service.port

    def counter(name):
        snap = json.loads(_serve_http(port, "/metrics?format=json")[1])
        return snap["counters"].get(name, 0.0)

    def ttfv(body):
        req = service.get_request(body["id"])
        return req.first_view_time - req.submit_time

    # Three concurrent requests: 4 lanes, one of them padding.
    objs = [orbit_views(3, H, seed=50 + i) for i in range(3)]
    first = _post_all(port, [_serve_payload(v, i)
                             for i, v in enumerate(objs)])
    before_ref = _launch_counts(graphs=graphs())
    ref = sampler.synthesize_many(
        objs + [objs[0]],
        [torch.Generator("cuda").manual_seed(s) for s in (0, 1, 2, 1234)])
    after_ref = _launch_counts(graphs=graphs())
    identical = all(np.array_equal(_views_of(first[i]), ref[i])
                    for i in range(3))

    # Admission between views: a 5-view request joins a 7-view one.
    done0 = counter("serving_views_completed_total")
    late = {}
    long_t = threading.Thread(target=lambda: late.update(long=_post_all(
        port, [_serve_payload(orbit_views(7, H, seed=60), 7)])[0]))
    long_t.start()
    deadline = time.perf_counter() + SERVE_WAIT_S
    while counter("serving_views_completed_total") <= done0:
        if time.perf_counter() > deadline:
            raise AssertionError("serve: the 7-view request made no view")
        time.sleep(0.05)
    late["short"] = _post_all(port, [_serve_payload(
        orbit_views(5, H, seed=61), 8)])[0]
    long_t.join(SERVE_WAIT_S)
    if "long" not in late:
        raise AssertionError("serve: the 7-view request failed")
    admitted_first = late["short"]["answered"] < late["long"]["answered"]
    late_finite = all(np.isfinite(_views_of(late[k])).all()
                      and _views_of(late[k]).shape[0] == n
                      for k, n in (("long", 6), ("short", 4)))

    # The result cache, then the second schedule.
    views_before = counter("serving_views_completed_total")
    (cached,) = _post_all(port, [_serve_payload(objs[0], 0)])
    cache_ok = (cached["cached"] and cached["views"] == first[0]["views"]
                and counter("serving_views_completed_total")
                == views_before)
    (ddim,) = _post_all(port, [_serve_payload(
        orbit_views(3, H, seed=62), 9, sampler_kind="ddim", steps=16)])
    ddim_finite = bool(np.isfinite(_views_of(ddim)).all())

    status, health = _serve_http(port, "/healthz")
    health = json.loads(health)
    text = _serve_http(port, "/metrics")[1].decode()
    metric_lines = [ln for ln in text.splitlines()
                    if ln and not ln.startswith("#")]
    for ln in metric_lines:
        float(ln.rsplit(" ", 1)[1])             # each sample parses

    # Hot swap: every weight + 0.05, then back.
    live = eng.sampler.model
    ptrs = {k: p.data_ptr() for k, p in live.named_parameters()}
    n_graphs = len(graphs())
    orig = {k: t.clone() for k, t in live.state_dict().items()}
    again = [_serve_payload(v, i) for i, v in enumerate(objs)]
    service.registry.swap({k: t + 0.05 for k, t in orig.items()},
                          version="swap-1")
    swapped = _post_all(port, again)
    service.registry.swap(orig, version="swap-2")
    restored = _post_all(port, again)
    del orig
    swap = {
        "cached": [b["cached"] for b in swapped + restored],
        "differs_from_first": all(
            not np.array_equal(_views_of(s), _views_of(f))
            for s, f in zip(swapped, first)),
        "restored_bit_identical": all(
            np.array_equal(_views_of(r), _views_of(f))
            for r, f in zip(restored, first)),
        "graphs_before": n_graphs, "graphs_after": len(graphs()),
        "data_ptrs_unchanged": ptrs == {
            k: p.data_ptr() for k, p in live.named_parameters()},
        "params_version": json.loads(_serve_http(port, "/healthz")[1])[
            "params_version"]}

    stats = json.loads(_serve_http(port, "/stats")[1])["engine"]
    ran = _launch_counts(graphs=graphs())
    launches = {k: ran[k] - (after_ref[k] - before_ref[k])
                for k in ("fused_groupnorm", "flash_attention")}
    summary = _graph_summary(graphs())
    first_view = {"concurrent_3": [round(ttfv(b), 3) for b in first],
                  "admitted_mid_job": round(ttfv(late["short"]), 3),
                  "alone_7_views": round(ttfv(late["long"]), 3)}
    service.stop(drain_s=10.0)
    stopped = not eng.alive
    programs = stats["program_cache"]["programs"]
    peak = max([torch.cuda.max_memory_allocated()]
               + [p["max_memory_allocated"] for p in programs.values()])
    del service, eng, sampler, live
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(weights)

    def steady(lanes):
        s = [r["s"] for r in steps_log if r["lanes"] == lanes
             and r["schedule"] == f"ancestral:{SERVE_STEPS}"
             and not r["first_use"]]
        return round(float(np.median(s)), 4) if s else None

    per_lanes = {f"lanes_{n}": steady(n) for n in (1, 2, 4)}
    out = {"config": "srn64", "argv": SERVE_ARGV,
           "build_and_warmup_s": round(build_s, 3),
           "s_per_view_step": per_lanes,
           "ms_per_denoise_step": {k: (None if v is None
                                       else round(1e3 * v / SERVE_STEPS,
                                                  3))
                                   for k, v in per_lanes.items()},
           "lanes4_over_4x_lanes1": (
               None if None in (per_lanes["lanes_1"], per_lanes["lanes_4"])
               else round(per_lanes["lanes_4"]
                          / (4 * per_lanes["lanes_1"]), 4)),
           "view_steps": [dict(r, s=round(r["s"], 4)) for r in steps_log],
           "time_to_first_view_s": first_view,
           "programs": programs,
           "baseline_allocated": baseline,
           "max_memory_allocated": peak,
           "launches": launches,
           "reference_launches": {k: after_ref[k] - before_ref[k]
                                  for k in launches},
           "graphs": summary,
           "graphs_note": "replays include the reference "
                          "synthesize_many's; launches do not",
           "bit_identical_to_synthesize_many": identical,
           "late_request_finished_first": admitted_first,
           "late_views_finite": late_finite, "cached_replay": cache_ok,
           "ddim16_finite": ddim_finite, "swap": swap,
           "healthz": [status, health["status"]],
           "metrics_samples": len(metric_lines), "stopped": stopped}
    emit(dict(phase="serve", **out))
    failed = [k for k, ok in (
        ("bit_identical_to_synthesize_many", identical),
        ("late_request_finished_first", admitted_first),
        ("late_views_finite", late_finite), ("cached_replay", cache_ok),
        ("ddim16_finite", ddim_finite),
        ("first_views_finite", all(np.isfinite(_views_of(b)).all()
                                   for b in first)),
        ("swap_not_cached", not any(swap["cached"])),
        ("swap_differs", swap["differs_from_first"]),
        ("swap_restored", swap["restored_bit_identical"]),
        ("swap_no_recapture",
         swap["graphs_before"] == swap["graphs_after"]),
        ("swap_in_place", swap["data_ptrs_unchanged"]),
        ("healthz", status == 200 and health["status"] == "ok"),
        ("stopped", stopped),
        ("launches", all(n > 0 for n in launches.values())),
        ("graphs", all(g["replays"] > 0 and g["captured"].get(k, 0) > 0
                       for g in summary
                       for k in ("fused_groupnorm", "flash_attention"))),
        ("program_bytes", all(p["peak_bytes"] for p in programs.values())))
        if not ok]
    if failed:
        raise AssertionError(f"serve: {failed}")
    return out


FLEET_ARGV = ["--config", "srn64", "--port", "0", "--replicas", "2",
              "--sampler_steps", str(SERVE_STEPS), "--schedules",
              f"ancestral:{SERVE_STEPS},1@ddim:16", "--max_batch", "2",
              "--max_wait_ms", "500", "--warmup"]


def _http_error(port, path, payload):
    """POST ``payload``, which must be refused: ``(status, Retry-After,
    body)``."""
    import urllib.error

    try:
        _serve_http(port, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())
    raise AssertionError(f"{path}: the request was not refused")


class _HeldTurns:
    """An engine's device turns, timed: ``held`` accumulates the seconds
    this engine held the card (its view steps' work on the device, not
    the wait for another engine's turn)."""

    def __init__(self, turns):
        self.turns, self.held = turns, 0.0

    def __enter__(self):
        self.turns.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.held += time.perf_counter() - self.t
        self.turns.__exit__(*exc)

    def __getattr__(self, name):            # the mesh's tickets
        return getattr(self.turns, name)


def _log_view_steps(name, eng, log):
    """Wrap ``eng``'s view step to append, per step, the replica, the
    bucket's schedule / phase, lane count, live requests (in lane order),
    whether the key was new, the step's wall interval and the seconds it
    held the card (``held_s``; the wall minus any wait for another
    engine's turn)."""
    from diff3d_tpu_torch.serving import lane_count

    inner, seen = eng._run_view_step, set()
    eng.turns = _HeldTurns(eng.turns)

    def timed(active):
        b = active[0].req.bucket
        key = (b.phase or f"{b.sampler}:{b.steps}",
               lane_count(len(active), eng.max_batch, eng.lane_multiple),
               b.capacity)
        t, held = time.perf_counter(), eng.turns.held
        inner(active)
        log.append({"replica": name, "schedule": key[0], "lanes": key[1],
                    "capacity": key[2], "live": len(active),
                    "ids": [s.req.id for s in active],
                    "first_use": key not in seen, "start": t,
                    "s": time.perf_counter() - t,
                    "held_s": eng.turns.held - held})
        seen.add(key)

    eng._run_view_step = timed


def _steady(log, field="held_s", **match):
    """Median ``field`` of the logged view steps matching ``match``, the
    key's first use left out."""
    s = [r[field] for r in log if not r["first_use"]
         and all(r[k] == v for k, v in match.items())]
    return round(float(np.median(s)), 4) if s else None


def _sessions_by_owner(replicas, per):
    """``per`` session ids whose rendezvous owner is each replica."""
    from diff3d_tpu_torch.serving import Router

    out = {r.name: [] for r in replicas}
    i = 0
    while any(len(v) < per for v in out.values()):
        sid = f"obj-{i}"
        owner = Router.rendezvous_order(sid, replicas)[0].name
        if len(out[owner]) < per:
            out[owner].append(sid)
        i += 1
    return out


def phase_serve_fleet(cfg, model):
    """Two srn64 replicas behind the fleet router, built by ``serve_cli``'s
    ``build_service`` (``--replicas 2 --sampler_steps 8 --schedules
    ancestral:8,1@ddim:16 --max_batch 2 --warmup``) and driven over HTTP:
    four sticky sessions posted 0.1 s apart (two owned by each replica by
    rendezvous) meet both replicas' first use of their 2-lane graph at
    once; each replica's views bit-identical to ``synthesize_many`` on its
    own sampler over the same lanes; the ``1@ddim:16`` request on replica
    1 only; a rolling rollout (every weight + 0.05) changes the views and
    rolling back restores them bit for bit with every graph and every
    ``data_ptr`` kept; then replica 0 killed: sessionless traffic fails
    over to replica 1 and r0's session gets ``SessionLost`` (503 with
    Retry-After).  Counts set to 0 before ``build_service``, read after;
    the references' replays taken out."""
    import torch

    from diff3d_tpu_torch.cli import serve_cli

    H = cfg.model.H
    os.makedirs(SERVE_WORKDIR, exist_ok=True)
    weights = os.path.join(SERVE_WORKDIR, "srn64_random.pt")
    torch.save(model.state_dict(), weights)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    service = serve_cli.build_service(serve_cli.build_parser().parse_args(
        ["--model", weights] + FLEET_ARGV))
    build_s = time.perf_counter() - t0
    reps = service.replicas
    r0, r1 = reps
    sampler_key = r0.engine.default_schedule
    log = []
    for rep in reps:
        _log_view_steps(rep.name, rep.engine, log)

    def graphs():
        return [g for rep in reps for s in rep.engine.samplers.values()
                for g in s.graphs.values()]

    service.start(serve_http=True)
    port = service.port
    owned = _sessions_by_owner(reps, 2)
    order = [owned["r0"][0], owned["r1"][0], owned["r0"][1],
             owned["r1"][1]]
    objs = {sid: orbit_views(3, H, seed=70 + i)
            for i, sid in enumerate(order)}
    seeds = {sid: 70 + i for i, sid in enumerate(order)}

    def sticky():
        return _post_all(port, [_serve_payload(
            objs[sid], seeds[sid], session_id=sid) for sid in order],
            gap_s=0.1)

    first = dict(zip(order, sticky()))
    sticky_ok = all(rep.session_count(sid) == 1
                    for rep in reps for sid in owned[rep.name])
    firsts = {rep.name: next(r for r in log if r["replica"] == rep.name
                             and r["first_use"] and r["lanes"] == 2)
              for rep in reps}
    a, b = firsts["r0"], firsts["r1"]
    overlap = (a["start"] < b["start"] + b["s"]
               and b["start"] < a["start"] + a["s"])

    # Each replica's two sessions ran as one 2-lane batch: the lane
    # order of its first step is the reference's object order.
    before_ref = _launch_counts(graphs=graphs())
    identical = {}
    sid_of = {first[sid]["id"]: sid for sid in order}
    for rep in reps:
        lanes = [sid_of[rid] for rid in firsts[rep.name]["ids"]]
        ref = rep.engine.sampler.synthesize_many(
            [objs[sid] for sid in lanes],
            [torch.Generator("cuda").manual_seed(seeds[sid])
             for sid in lanes])
        identical[rep.name] = all(
            np.array_equal(_views_of(first[sid]), ref[n])
            for n, sid in enumerate(lanes))
    after_ref = _launch_counts(graphs=graphs())

    # The schedule only replica 1 serves (1@ddim:16).
    (only1,) = set(r1.supported_schedules()) - set(r0.supported_schedules())
    kind, n_steps = only1.split(":")
    (ddim,) = _post_all(port, [_serve_payload(
        orbit_views(3, H, seed=79), 79, sampler_kind=kind,
        steps=int(n_steps))])
    ddim_on = {rep.name: sum(p["uses"] for p in rep.engine.programs
                             .stats()["programs"].values()
                             if (p["sampler"], p["steps"])
                             == (kind, int(n_steps)))
               for rep in reps}

    # Rolling rollout and back.
    ptrs = [{k: p.data_ptr() for k, p in
             rep.engine.sampler.model.named_parameters()} for rep in reps]
    n_graphs = len(graphs())
    orig = {k: t.clone() for k, t in r0.engine.sampler.model
            .state_dict().items()}
    t_roll = time.perf_counter()
    report = service.rollout({k: t + 0.05 for k, t in orig.items()},
                             version="roll-1")
    roll_s = time.perf_counter() - t_roll
    rolled = dict(zip(order, sticky()))
    back_report = service.rollout(orig, version="roll-2")
    back = dict(zip(order, sticky()))
    del orig
    rollout = {
        "report": report, "back": back_report, "seconds": round(roll_s, 3),
        "differs": all(not np.array_equal(_views_of(rolled[s]),
                                          _views_of(first[s]))
                       for s in order),
        "restored_bit_identical": all(
            np.array_equal(_views_of(back[s]), _views_of(first[s]))
            for s in order),
        "graphs_before": n_graphs, "graphs_after": len(graphs()),
        "data_ptrs_unchanged": ptrs == [
            {k: p.data_ptr() for k, p in
             rep.engine.sampler.model.named_parameters()} for rep in reps],
        "params_versions": service.health()["params_versions"]}

    # Lanes-1 steps on each replica, then replica 0 dies.
    lone = [_post_all(port, [_serve_payload(orbit_views(3, H, seed=80 + i),
                                            80 + i)])[0] for i in range(2)]
    r0.kill("killed by chip_smoke")
    lost = _http_error(port, "/synthesize", _serve_payload(
        objs[owned["r0"][0]], 90, session_id=owned["r0"][0]))
    failover = [_post_all(port, [_serve_payload(
        orbit_views(3, H, seed=82 + i), 82 + i)])[0] for i in range(2)]
    snap = json.loads(_serve_http(port, "/metrics?format=json")[1])
    fleet = json.loads(_serve_http(port, "/fleet")[1])
    health = service.health()
    ran = _launch_counts(graphs=graphs())
    launches = {k: ran[k] - (after_ref[k] - before_ref[k])
                for k in ("fused_groupnorm", "flash_attention")}
    summary = _graph_summary(graphs())
    programs = {rep.name: rep.engine.programs.stats(include_memory=True)[
        "programs"] for rep in reps}
    ttfv = {sid: round(service.get_request(first[sid]["id"])
                       .first_view_time
                       - service.get_request(first[sid]["id"]).submit_time,
                       3) for sid in order}
    service.stop(drain_s=10.0)
    stopped = not any(rep.engine.alive for rep in reps)
    peak = max([torch.cuda.max_memory_allocated()]
               + [p["max_memory_allocated"] for ps in programs.values()
                  for p in ps.values()])
    weights_bytes = {rep.name: rep.weights_bytes for rep in reps}
    del service, reps, r0, r1
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(weights)

    steps = [dict({k: v for k, v in r.items() if k not in ("ids",
                                                           "start")},
                  s=round(r["s"], 4), held_s=round(r["held_s"], 4))
             for r in log]
    default = "{}:{}".format(*sampler_key)
    per_lanes = {rep: {f"lanes_{n}": _steady(log, replica=rep, lanes=n,
                                               schedule=default)
                       for n in (1, 2)} for rep in ("r0", "r1")}
    wall_lanes = {rep: {f"lanes_{n}": _steady(log, "s", replica=rep,
                                                lanes=n, schedule=default)
                        for n in (1, 2)} for rep in ("r0", "r1")}
    sessions_lost = {"status": lost[0], "retry_after": lost[1],
                     "error": lost[2]["error"][:160]}
    out = {"config": "srn64", "argv": FLEET_ARGV,
           "build_and_warmup_s": round(build_s, 3),
           "s_per_view_step": per_lanes,
           "s_per_view_step_note": "seconds each view step held the card "
                                   "(its device turn); wall, with any wait "
                                   "for the other replica's turn, beside",
           "wall_s_per_view_step": wall_lanes,
           "first_uses": {k: {"start_s": round(v["start"] - t0, 3),
                              "s": round(v["s"], 3)}
                          for k, v in firsts.items()},
           "first_uses_overlap": overlap, "view_steps": steps,
           "time_to_first_view_s": ttfv, "programs": programs,
           "weights_bytes": weights_bytes,
           "baseline_allocated": baseline, "max_memory_allocated": peak,
           "launches": launches,
           "reference_launches": {k: after_ref[k] - before_ref[k]
                                  for k in launches},
           "graphs": summary, "sessions": owned,
           "sticky_on_rendezvous_owner": sticky_ok,
           "bit_identical_to_synthesize_many": identical,
           "replica_1_schedule": only1, "replica_1_schedule_uses": ddim_on,
           "ddim16_finite": bool(np.isfinite(_views_of(ddim)).all()),
           "rollout": rollout, "session_lost": sessions_lost,
           "failover_views_finite": all(np.isfinite(_views_of(b)).all()
                                        for b in failover + lone),
           "router_failover_total": snap["counters"].get(
               "router_failover_total"),
           "router_sessions_lost_total": snap["counters"].get(
               "router_sessions_lost_total"),
           "fleet_health": health["replicas"],
           "fleet_replicas": sorted(fleet["replicas"]),
           "stopped": stopped}
    emit(dict(phase="serve_fleet", **out))
    failed = [k for k, ok in (
        ("sticky_on_rendezvous_owner", sticky_ok),
        ("first_uses_overlap", overlap),
        ("bit_identical_to_synthesize_many", all(identical.values())),
        ("first_views_finite", all(np.isfinite(_views_of(v)).all()
                                   for v in first.values())),
        ("replica_1_schedule_on_replica_1_only",
         ddim_on["r0"] == 0 and ddim_on["r1"] > 0),
        ("ddim16_finite", out["ddim16_finite"]),
        ("rollout_swapped", report["ok"] and back_report["ok"]),
        ("rollout_differs", rollout["differs"]),
        ("rollback_restored", rollout["restored_bit_identical"]),
        ("rollout_no_recapture",
         rollout["graphs_before"] == rollout["graphs_after"]),
        ("rollout_in_place", rollout["data_ptrs_unchanged"]),
        ("session_lost_503", lost[0] == 503 and lost[1] is not None
         and "lost" in lost[2]["error"]),
        ("failover", out["failover_views_finite"]
         and (out["router_failover_total"] or 0) >= 1
         and health["replicas"] == {"r0": "dead", "r1": "ok"}),
        ("stopped", stopped),
        ("launches", all(n > 0 for n in launches.values())),
        ("program_bytes", all(p["peak_bytes"] for ps in programs.values()
                              for p in ps.values())))
        if not ok]
    if failed:
        raise AssertionError(f"serve_fleet: {failed}")
    return out


WORKER_SERVE = ["--config", "srn64", "--sampler_steps", str(SERVE_STEPS),
                "--max_batch", "2"]
WORKER_ARGV = WORKER_SERVE + ["--max_views", "3", "--devices", "0",
                              "--port", "0"]
WORKER_BOOT_S = 600.0


def _worker_proc(weights, name, budget=0):
    """``worker_cli`` as a process on the card: ``(process, ready line,
    seconds to the ready line)``."""
    import select

    cmd = [sys.executable, "-m", "diff3d_tpu_torch.cli.worker_cli",
           "--model", weights, "--name", name] + WORKER_ARGV
    if budget:
        cmd += ["--hbm_budget_bytes", str(budget)]
    root = os.path.dirname(os.path.abspath(__file__))
    err = open(os.path.join(SERVE_WORKDIR, f"{name}.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], WORKER_BOOT_S)
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait(60)
        with open(os.path.join(SERVE_WORKDIR, f"{name}.log")) as f:
            tail = f.read()[-2000:]
        raise AssertionError(f"serve_workers: {name} did not start: {tail}")
    return proc, json.loads(line), time.perf_counter() - t0


def _front_door(port):
    """``serve_cli --workers 127.0.0.1:<port>``: the remote-only fleet."""
    from diff3d_tpu_torch.cli import serve_cli

    return serve_cli.build_service(serve_cli.build_parser().parse_args(
        WORKER_SERVE + ["--port", "0", "--workers", f"127.0.0.1:{port}"])
    ).start(serve_http=True)


def _sigterm(proc):
    """SIGTERM ``proc`` and wait: ``(exit code, seconds)``."""
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout=120), time.perf_counter() - t0


def phase_serve_workers(cfg, model):
    """``worker_cli --devices 0 --port 0`` (``--sampler_steps 8
    --max_batch 2 --max_views 3``) as a process on the card, on a state
    dict of the same weights, fronted by ``serve_cli --workers`` with no
    engine of its own (the front door allocates no device memory): its
    views equal to the in-process engine's (``serve_cli`` without
    ``--workers``) for the same payload and seed; SIGTERM drains it and
    it exits 0.  A second worker, booted with ``--hbm_budget_bytes`` one
    byte above the first worker's pin plus one request's record, admits
    one request and refuses a second concurrent one
    ``ReplicaOverBudget`` (503 with Retry-After), then exits 0 on
    SIGTERM.  The phase's launches are the in-process engine's (a
    worker's run in its own process)."""
    import torch

    from diff3d_tpu_torch.cli import serve_cli
    from diff3d_tpu_torch.serving import ViewRequest
    from diff3d_tpu_torch.serving.worker import HbmAdmission

    H = cfg.model.H
    os.makedirs(SERVE_WORKDIR, exist_ok=True)
    weights = os.path.join(SERVE_WORKDIR, "srn64_random.pt")
    torch.save(model.state_dict(), weights)
    obj = orbit_views(3, H, seed=95)
    payload = _serve_payload(obj, 95)
    _launch_counts(reset=True)
    local = serve_cli.build_service(serve_cli.build_parser().parse_args(
        ["--model", weights, "--port", "0"] + WORKER_SERVE)).start(
        serve_http=True)
    (want,) = _post_all(local.port, [payload])
    local_graphs = [g for s in local.engine.samplers.values()
                    for g in s.graphs.values()]
    launches = _launch_counts(graphs=local_graphs)
    local.stop(drain_s=10.0)
    del local
    gc.collect()
    torch.cuda.empty_cache()

    procs = []
    try:
        proc, ready, boot_s = _worker_proc(weights, "w0")
        procs.append(proc)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        front = _front_door(ready["port"])
        remote_only = not any(hasattr(r, "engine") for r in front.replicas)
        (got,) = _post_all(front.port, [payload])
        snap = front.replicas[0].snapshot()
        worker_launches = snap["kernel_launches"]
        front.stop()
        torch.cuda.synchronize()
        no_device_memory = (torch.cuda.memory_allocated() == allocated
                            and torch.cuda.memory_reserved() == reserved)
        identical = np.array_equal(_views_of(got), _views_of(want))
        rel = _rel_l2(_views_of(got), _views_of(want))
        rc0, drain0_s = _sigterm(proc)

        pins = snap["hbm"]["program_peaks"]
        if not pins:
            raise AssertionError("serve_workers: the worker's warm-up "
                                 "measured no pins")
        record = HbmAdmission(guidance_B=len(cfg.diffusion.guidance_weights)
                              ).record_bytes(ViewRequest(obj))
        budget = max(pins.values()) + record + 1
        proc, ready1, boot1_s = _worker_proc(weights, "w1", budget)
        procs.append(proc)
        front = _front_door(ready1["port"])
        (held,) = _post_all(front.port, [dict(payload, block=False)])
        # A session's first request: the router re-raises the worker's
        # ReplicaOverBudget itself (a sessionless one would fail over and
        # come back FleetOverloaded).
        refused = _http_error(front.port, "/synthesize", _serve_payload(
            obj, 96, session_id="over-budget"))
        deadline = time.perf_counter() + SERVE_WAIT_S
        while True:
            status, body = _serve_http(front.port, f"/result/{held['id']}")
            if status == 200:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("serve_workers: the admitted request "
                                     "did not finish")
            time.sleep(0.1)
        held_views = np.asarray(json.loads(body)["views"], np.float32)
        gate = front.replicas[0].snapshot()["hbm"]
        front.stop()
        rc1, drain1_s = _sigterm(proc)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
            p.stdout.close()
    os.remove(weights)
    out = {"config": "srn64", "argv": WORKER_ARGV,
           "worker_boot_s": [round(boot_s, 3), round(boot1_s, 3)],
           "ready": [ready, ready1], "remote_only": remote_only,
           "front_door_allocates_nothing": no_device_memory,
           "bit_identical_to_in_process": identical,
           "rel_l2_to_in_process": rel, "pins": pins,
           "pins_second_worker": gate["program_peaks"],
           "record_bytes": record, "budget_bytes": budget,
           "refused": {"status": refused[0], "retry_after": refused[1],
                       "error": refused[2]["error"][:200]},
           "gate": gate, "admitted_views_finite":
               bool(np.isfinite(held_views).all()),
           "sigterm_exit_codes": [rc0, rc1],
           "sigterm_to_exit_s": [round(drain0_s, 3), round(drain1_s, 3)],
           "launches": {k: worker_launches[k] for k in ("fused_groupnorm",
                                                        "flash_attention")},
           "launches_note": "the first worker's, counted in its process "
                            "from its start (warm-up captures, the served "
                            "request) and read over the wire",
           "in_process_launches": {k: launches[k] for k in (
               "fused_groupnorm", "flash_attention")}}
    emit(dict(phase="serve_workers", **out))
    failed = [k for k, ok in (
        ("remote_only", remote_only),
        ("front_door_allocates_nothing", no_device_memory),
        ("views_match_in_process", identical or rel <= 1e-3),
        ("views_finite", bool(np.isfinite(_views_of(got)).all())),
        ("over_budget_503", refused[0] == 503 and refused[1] is not None
         and f"> budget {budget}" in refused[2]["error"]),
        ("gate_counted", gate["rejects"] == 1),
        ("admitted_views_finite", out["admitted_views_finite"]),
        ("sigterm_exit_0", rc0 == 0 and rc1 == 0),
        ("launches", all(n > 0 for n in out["launches"].values())))
        if not ok]
    if failed:
        raise AssertionError(f"serve_workers: {failed}")
    return out


# The refine on a 16-step schedule (cut from 64): t0.4375 is its grid
# point 7 (13 of 32 before, 26 of 64).
CASCADE_PLAN = "draft=64:ddim:8,refine=128:ancestral:16@t0.4375"
CASCADE_ARGV = ["--config", "srn128", "--port", "0", "--cascade",
                CASCADE_PLAN, "--max_batch", "2", "--max_wait_ms", "500"]


def _poll_cascade(port, rid):
    """Walk ``GET /result/<id>?from=K`` to the end: the events, and
    whether the cursor was gapless."""
    events, nxt, gapless = [], 0, True
    deadline = time.perf_counter() + SERVE_WAIT_S
    while True:
        poll = json.loads(_serve_http(port, f"/result/{rid}?from={nxt}")[1])
        gapless &= (poll["from"] == nxt and [e["event"] for e in
                                             poll["events"]]
                    == list(range(nxt, poll["next"])))
        events += poll["events"]
        nxt = poll["next"]
        if poll["status"] != "running":
            return events, gapless and poll["status"] == "done"
        if time.perf_counter() > deadline:
            raise AssertionError(f"serve_cascade: {rid} did not finish")
        time.sleep(0.05)


def phase_serve_cascade(cfg, model):
    """The served cascade at srn128 full width (ch 256), built by
    ``serve_cli --cascade draft=64:ddim:8,refine=128:ancestral:16@t0.4375
    --max_batch 2`` on a state dict of the srn128 phases' seeded random
    weights, over HTTP: two concurrent 3-view cascades (posted 0.1 s
    apart, ``block=false``) walked through ``?from=K``: 4 events each,
    each view's draft event before its refine event, a gapless cursor,
    finite views; one cascade alone bit-identical to
    ``CascadeSampler.synthesize_cascade`` on the same phase seeds; a swap
    (every weight + 0.05) refreshes the draft's ``pos_emb`` in place (the
    same address, the served one resized) with no new capture.  Counts
    set to 0 before ``build_service``, read after; the reference's
    replays taken out and the launches split by phase.  Returns the
    record and the draft's and refine's kernel sites at 2 lanes."""
    import torch

    from diff3d_tpu_torch.cli import serve_cli
    from diff3d_tpu_torch.convert.progressive import POS_EMB, resize_bilinear

    H = cfg.model.H
    os.makedirs(SERVE_WORKDIR, exist_ok=True)
    weights = os.path.join(SERVE_WORKDIR, "srn128_random.pt")
    torch.save(model.state_dict(), weights)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    service = serve_cli.build_service(serve_cli.build_parser().parse_args(
        ["--model", weights] + CASCADE_ARGV))
    build_s = time.perf_counter() - t0
    os.remove(weights)
    eng = service.engine
    casc = eng.cascade
    log = []
    _log_view_steps("r0", eng, log)
    service.start(serve_http=True)
    port = service.port
    objs = [orbit_views(3, H, seed=100 + i) for i in range(2)]
    heads = _post_all(port, [_serve_payload(o, 100 + i, block=False)
                             for i, o in enumerate(objs)], gap_s=0.1,
                      path="/cascade")
    walks = [_poll_cascade(port, h["id"]) for h in heads]
    reqs = [service.get_request(h["id"]) for h in heads]
    order_ok = all(
        [e["phase"] for e in ev if e["frame"] == f] == ["draft", "refine"]
        for ev, _ in walks for f in (0, 1))
    finite = all(np.isfinite(np.asarray(e["view"], np.float32)).all()
                 for ev, _ in walks for e in ev)
    timing = [{"draft_first_s": round(r.first_draft_time - r.submit_time,
                                      3),
               "refined_first_s": round(r.first_refined_time
                                        - r.submit_time, 3),
               "done_s": round(r.done_time - r.submit_time, 3)}
              for r in reqs]

    def graphs():
        return (list(casc.draft.graphs.values())
                + list(casc.refine.graphs.values()))

    # One cascade alone, then the offline reference on the same samplers.
    alone = orbit_views(3, H, seed=110)
    (lone,) = _post_all(port, [_serve_payload(alone, 110)], path="/cascade")
    lone_events = service.get_request(lone["id"]).events_since(0)
    replays = {id(g): g.replays for g in graphs()}
    before_ref = _launch_counts(graphs=graphs())
    ref = casc.synthesize_cascade(alone, seed=110)
    after_ref = _launch_counts(graphs=graphs())
    ref_replays = {id(g): g.replays - replays[id(g)] for g in graphs()}
    identical = np.array_equal(_views_of(lone), ref["refined"])
    drafts_identical = all(np.array_equal(
        e["frame"], ref["draft"][e["view"] - 1]) for e in lone_events
        if e["phase"] == "draft")

    # A swap: the draft's pos_emb refreshed in place, nothing recaptured.
    served = casc.refine.model
    pe = casc.draft.model.get_parameter(POS_EMB)
    pe_ptr, n_graphs = pe.data_ptr(), len(graphs())
    orig = {k: t.clone() for k, t in served.state_dict().items()}
    service.registry.swap({k: t + 0.05 for k, t in orig.items()}, "swap-1")
    del orig
    (swapped,) = _post_all(port, [_serve_payload(alone, 110)],
                           path="/cascade")
    with torch.no_grad():
        refreshed = torch.equal(pe, resize_bilinear(
            served.get_parameter(POS_EMB), tuple(pe.shape[:2])))
    swap = {"draft_pos_emb_in_place": pe.data_ptr() == pe_ptr,
            "draft_pos_emb_refreshed": refreshed,
            "graphs_before": n_graphs, "graphs_after": len(graphs()),
            "differs": not np.array_equal(_views_of(swapped),
                                          _views_of(lone))}

    ran = _launch_counts(graphs=graphs())
    launches = {k: ran[k] - (after_ref[k] - before_ref[k])
                for k in ("fused_groupnorm", "flash_attention")}
    by_phase = {}
    for phase, s in (("draft", casc.draft), ("refine", casc.refine)):
        by_phase[phase] = {k: sum(
            g.captured.get(k, 0) * (g.replays + 1 - ref_replays[id(g)])
            for g in s.graphs.values()) for k in launches}
    stats = eng.programs.stats(include_memory=True)["programs"]
    summary = _graph_summary(graphs())
    calls = {"draft": casc.draft.model_calls_per_view,
             "refine": casc.refine.model_calls_per_view}
    service.stop(drain_s=10.0)
    stopped = not eng.alive
    lanes = 2 * 2 * len(cfg.diffusion.guidance_weights)
    sites = {}
    for phase, s in (("draft", casc.draft), ("refine", casc.refine)):
        sites[phase] = record_sites(
            s.model, *model_batch(s.cfg, lanes, seed=120))
    peak = max([torch.cuda.max_memory_allocated()]
               + [p["max_memory_allocated"] for p in stats.values()])
    del service, eng, casc, served, pe
    gc.collect()
    torch.cuda.empty_cache()

    steps = [dict({k: v for k, v in r.items() if k not in ("ids", "start")},
                  s=round(r["s"], 4), held_s=round(r["held_s"], 4))
             for r in log]
    per_step = {phase: {f"lanes_{n}": _steady(log, schedule=phase, lanes=n)
                        for n in (1, 2)} for phase in ("draft", "refine")}
    ms_step = {phase: {k: (None if v is None else round(
        1e3 * v / calls[phase], 3)) for k, v in d.items()}
        for phase, d in per_step.items()}
    out = {"config": "srn128", "argv": CASCADE_ARGV,
           "model_calls_per_view": calls,
           "build_s": round(build_s, 3), "requests": timing,
           "s_per_view_step": per_step, "ms_per_denoise_step": ms_step,
           "view_steps": steps, "programs": stats,
           "baseline_allocated": baseline, "max_memory_allocated": peak,
           "launches": launches, "launches_by_phase": by_phase,
           "reference_launches": {k: after_ref[k] - before_ref[k]
                                  for k in launches},
           "graphs": summary,
           "events": [len(ev) for ev, _ in walks],
           "draft_before_refine": order_ok,
           "cursor_gapless": [g for _, g in walks], "views_finite": finite,
           "alone_bit_identical_to_synthesize_cascade": identical,
           "alone_drafts_identical": drafts_identical, "swap": swap,
           "stopped": stopped}
    emit(dict(phase="serve_cascade", **out))
    failed = [k for k, ok in (
        ("four_events", all(len(ev) == 4 for ev, _ in walks)),
        ("draft_before_refine", order_ok),
        ("cursor_gapless", all(g for _, g in walks)),
        ("views_finite", finite),
        ("bit_identical_to_synthesize_cascade",
         identical and drafts_identical),
        ("swap_refreshes_draft_in_place",
         swap["draft_pos_emb_in_place"] and swap["draft_pos_emb_refreshed"]),
        ("swap_no_recapture", swap["graphs_before"] == swap["graphs_after"]),
        ("swap_differs", swap["differs"]),
        ("stopped", stopped),
        ("launches", all(n > 0 for n in launches.values())),
        ("launches_split", all(
            by_phase["draft"][k] + by_phase["refine"][k] == launches[k]
            for k in launches)),
        ("program_bytes", all(p["peak_bytes"] for p in stats.values())))
        if not ok]
    if failed:
        raise AssertionError(f"serve_cascade: {failed}")
    return out, sites


#: The wrappers of rows 1-6 on every path but context parallelism's; the
#: split-statistics GroupNorm's (``split=True``) run only there.
UNSPLIT_ROWS = ("fused_groupnorm", "groupnorm_backward", "flash_attention",
                "attention_backward_dkdv", "attention_backward_dq")


def _launch_counts(reset: bool = False, graphs=(), split: bool = False):
    """The launch count of every kernel wrapper of ``UNSPLIT_ROWS`` (with
    ``split``, of every wrapper; each set to 0 first when ``reset``), plus
    the launches that the replays of ``graphs`` ran (each graph's captured
    launches x its replays)."""
    from diff3d_tpu_torch.graphs import graph_launches
    from diff3d_tpu_torch.ops import launch_counts, set_launch_counts

    if reset:
        set_launch_counts({k: 0 for k in launch_counts()})
    counts = {k: n for k, n in launch_counts().items()
              if split or k in UNSPLIT_ROWS}
    for k, n in graph_launches(graphs).items():
        if k in counts:
            counts[k] += n
    return counts


def _graph_summary(graphs):
    """Per captured graph: its launches per kernel, its replays and its
    capture's seconds."""
    return [{"captured": g.captured, "replays": g.replays,
             "capture_s": round(g.capture_s, 3)} for g in graphs]


def train_batch(cfg, B: int, step: int, scenes: bool = False):
    """Global batch ``step`` of the port's loader over the synthetic
    dataset (or, with ``scenes``, the ray-traced scenes) at the model's
    resolution, on the card."""
    import torch

    from diff3d_tpu_torch.data import (InfiniteLoader, SyntheticDataset,
                                       SyntheticScenesDataset)

    ds = (SyntheticScenesDataset(num_objects=8, num_views=24,
                                 imgsize=cfg.model.H) if scenes else
          SyntheticDataset(num_objects=64, num_views=32,
                           imgsize=cfg.model.H))
    loader = InfiniteLoader(ds, B, num_workers=0)
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


TRAIN_GRAPH_STEPS = 3


def phase_train_graph(accum):
    """3 srn64 steps at global batch 128 as CUDA graphs and 3 eager steps
    (``--eager``), each from a ``Trainer`` that ``cli/train_cli.py``
    builds from the same seeds (weights, data, draws): every step's loss
    and gradient norm, and the parameters, Adam's state and the EMA after
    the third, bit-identical."""
    import torch

    from diff3d_tpu_torch.cli import train_cli

    workdir = WORKDIR + "_graph"
    argv = ["--synthetic", "--config", "srn64", "--batch", str(TRAIN_BATCH),
            "--accum", str(accum), "--steps", str(TRAIN_GRAPH_STEPS),
            "--warmup_examples", str(10 * TRAIN_BATCH), "--ckpt_every", "0",
            "--num_workers", "8", "--workdir", workdir]
    runs = {}
    for eager in (False, True):
        shutil.rmtree(workdir, ignore_errors=True)
        trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
            argv + (["--eager"] if eager else [])))
        step = trainer.step_fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, times = [], []
        for _ in range(TRAIN_GRAPH_STEPS):
            t0 = time.perf_counter()
            m = step(trainer.state, next(trainer.loader))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            times.append(time.perf_counter() - t0)
        tensors = {k: v.cpu() for k, v in
                   _state_tensors(trainer.state).items()}
        runs[eager] = {"metrics": metrics, "step_s": times,
                       "tensors": tensors,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated(),
                       "graphs": (None if eager
                                  else _graph_summary(step.graphs))}
        trainer.loader.close()
        step.release()
        del trainer, step
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    g, e = runs[False], runs[True]
    differ = [k for k in e["tensors"]
              if not torch.equal(g["tensors"][k], e["tensors"][k])]
    same = g["metrics"] == e["metrics"] and not differ
    out = {"config": "srn64", "global_batch": TRAIN_BATCH,
           "accum_steps": accum, "steps": TRAIN_GRAPH_STEPS,
           "graph_step_s": g["step_s"], "eager_step_s": e["step_s"],
           "graph_s_per_step": float(np.mean(g["step_s"][1:])),
           "eager_s_per_step": float(np.mean(e["step_s"][1:])),
           "loss_grad_norm": g["metrics"],
           "graph_max_memory_allocated": g["max_memory_allocated"],
           "eager_max_memory_allocated": e["max_memory_allocated"],
           "graphs": g["graphs"], "bit_identical": same,
           "tensors_compared": len(e["tensors"]),
           "tensors_differing": len(differ)}
    emit(dict(phase="train_graph", **out))
    if not same:
        raise AssertionError(f"train_graph: graph and eager differ "
                             f"(metrics {g['metrics']} vs {e['metrics']}, "
                             f"{len(differ)} tensors, e.g. {differ[:3]})")
    # The graph run is phase parallel's trainer without a process group.
    return dict(out, graph_tensors=g["tensors"])


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
            str(TRAIN_STEPS), "--num_workers", "8"]

    def trainer_of(extra, workdir=WORKDIR, preemption=False):
        trainer = train_cli.build_trainer(
            train_cli.build_parser().parse_args(
                argv + ["--workdir", workdir] + extra),
            preemption=preemption)
        record = []
        inner = trainer.step_fn
        if not inner.cuda_graphs:
            raise AssertionError("train: the card's path is not the graph")

        def timed(state, batch, draws=None):     # one sync per step
            m = inner(state, batch, draws)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            record.append({"t": time.perf_counter(), "loss": loss,
                           "grad_norm": gnorm, "lr": m["lr"]})
            return m

        trainer.step_fn = timed
        return trainer, record, inner

    first, rec, first_step = trainer_of([])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    first.train()
    eager = _launch_counts()
    launches = _launch_counts(graphs=first_step.graphs)
    graphs = _graph_summary(first_step.graphs)
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
    micro, update = first_step.graphs
    if micro.replays == 0 or update.replays == 0 or any(
            micro.captured.get(k, 0) == 0 for k in launches):
        raise AssertionError(f"train: the graph path did not run every "
                             f"kernel: {graphs}")

    # Resume: a fresh trainer restores the step-6 checkpoint; both take
    # step 7 (the first trainer's a replay, the second's eager before its
    # capture), which must agree bit for bit.
    second, rec2, second_step = trainer_of(["--transfer", "--steps",
                                            str(TRAIN_STEPS + 1)])
    if second.state.step != TRAIN_STEPS:
        raise AssertionError(f"train: restored step {second.state.step}")
    want6 = {k: v.cpu() for k, v in _state_tensors(first.state).items()}
    first.train(max_steps=TRAIN_STEPS + 1)
    want = {k: v.clone() for k, v in _state_tensors(first.state).items()}
    first.loader.close()
    first_step.release()
    del first, first_step, micro, update
    gc.collect()
    torch.cuda.empty_cache()
    second.train()
    got = _state_tensors(second.state)
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    same_metrics = (rec[-1]["loss"] == rec2[-1]["loss"]
                    and rec[-1]["grad_norm"] == rec2[-1]["grad_norm"])
    _finish_trainer(second, second_step)
    del second, second_step, got, want
    gc.collect()
    torch.cuda.empty_cache()
    preempted = _train_preempted(trainer_of, want6)
    out = {"config": "srn64", "global_batch": TRAIN_BATCH,
           "accum_steps": accum, "steps": TRAIN_STEPS,
           "first_step_s": float(times[0]), "s_per_step": s_per_step,
           "examples_per_s": TRAIN_BATCH / s_per_step,
           "step_s": [float(t) for t in times],
           "max_memory_allocated": peak,
           "loss": [r["loss"] for r in rec[:TRAIN_STEPS]],
           "grad_norm": [r["grad_norm"] for r in rec[:TRAIN_STEPS]],
           "lr": [r["lr"] for r in rec[:TRAIN_STEPS]],
           "launches": launches, "eager_launches": eager,
           "graphs": graphs,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()},
           "resume_step_loss": [rec[-1]["loss"], rec2[-1]["loss"]],
           "resume_bit_exact": not differ and same_metrics,
           "resume_tensors_compared": len(want6),
           "preemption_and_eval": preempted}
    emit(dict(phase="train", **out))
    if differ or not same_metrics:
        raise AssertionError(f"train: the resumed step differs "
                             f"({len(differ)} tensors, e.g. {differ[:3]})")
    return out      # WORKDIR's checkpoints stay for the eval phase


EVAL_EVERY = 3                  # the train phase's --eval_every
PREEMPT_BATCH = 4               # SIGTERM at this batch of the second run
VAL_TOL = 1e-2                  # val forward, kernels vs plain (bf16)


def _finish_trainer(trainer, inner):
    """Close the loader and drop the captured graphs before the next
    trainer captures (one trainer's graphs hold most of the card)."""
    trainer.loader.close()
    inner.release()
    trainer.step_fn = None
    gc.collect()
    import torch

    torch.cuda.empty_cache()


def _train_preempted(trainer_of, want6):
    """The train phase's run again as a second and a third trainer, both
    with ``--eval_every 3`` on the synthetic val set: a SIGTERM delivered
    through ``wrap_iter`` at the 4th batch of the second (its preemption
    handler installed as ``train_cli.main`` installs it) makes ``train()``
    return at step 4 with ``preempt_observed_step == 4`` and the step-4
    checkpoint on disk, and the handler uninstalls; the third resumes
    (``--transfer``) to step 6.  Finite val losses at steps 3 and 6; the
    state at step 6 bit-identical to the first trainer's, which neither
    evaluated nor stopped; each eval's launches.  Then, with the graphs
    released, the val forward through the kernels against the plain
    versions on the step-6 EMA weights, one val batch and the same
    injected draws (loss and denoiser output, relative 1e-2)."""
    import torch

    from diff3d_tpu_torch.diffusion import TrainDraws
    from diff3d_tpu_torch.models.layers import set_kernels
    from diff3d_tpu_torch.testing import FaultInjector, wrap_iter

    workdir = WORKDIR + "_preempt"
    shutil.rmtree(workdir, ignore_errors=True)
    extra = ["--eval_every", str(EVAL_EVERY)]
    evals = []

    def counting(t):
        score = t._eval_step

        def counted(state, batch, draws):
            before = _launch_counts()
            t0 = time.perf_counter()
            loss = score(state, batch, draws)
            value = float(loss)
            after = _launch_counts()
            evals.append({"step": state.step, "val_loss": value,
                          "s": time.perf_counter() - t0,
                          "launches": {k: after[k] - before[k]
                                       for k in after}})
            return loss

        t._eval_step = counted

    before = signal.getsignal(signal.SIGTERM)
    t, _, inner = trainer_of(extra, workdir, preemption=True)
    counting(t)
    inj = FaultInjector()
    inj.add("loader.next", kind="sigterm", at_calls=(PREEMPT_BATCH,))
    t.loader = wrap_iter(t.loader, inj, "loader.next")
    t0 = time.perf_counter()
    t.train()
    stop_s = time.perf_counter() - t0
    stopped = (t.state.step, t.preempt_observed_step, t.ckpt.steps())
    t.install_preemption_handler()()       # the installed one's uninstall
    restored = signal.getsignal(signal.SIGTERM) is before
    del t._eval_step                # no cycle keeps the trainer alive
    _finish_trainer(t, inner)
    del t
    r, _, inner = trainer_of(extra + ["--transfer"], workdir)
    counting(r)
    resumed_at = r.state.step
    _launch_counts(reset=True)
    r.train()
    launches = _launch_counts(graphs=inner.graphs)
    got = _state_tensors(r.state)
    differ = [k for k in want6 if not torch.equal(want6[k], got[k].cpu())]
    del got
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        vals = {r_["step"]: r_["val_loss"] for r_ in map(json.loads, f)
                if "val_loss" in r_}
    # The comparison needs no graph: free their pool first (the plain
    # path's val forward at batch 128 does not fit beside it).
    del r._eval_step
    r.loader.close()
    inner.release()
    gc.collect()
    torch.cuda.empty_cache()
    model, vb = r.state.model, r.val_loader.batch(0)
    paths = {}
    for impl in ("cuda", "torch"):
        set_kernels(model, impl)
        outs = []
        hook = model.register_forward_hook(
            lambda m, a, o: outs.append(o.detach().float()))
        _launch_counts(reset=True)
        loss = float(r._eval_step(r.state, vb, TrainDraws(
            torch.Generator("cuda").manual_seed(11))))
        hook.remove()
        paths[impl] = (loss, outs[0], _launch_counts())
    set_kernels(model, "cuda")
    (lk, ok, nk), (lp, op, npl) = paths["cuda"], paths["torch"]
    val_fwd = {"loss_kernel": lk, "loss_plain": lp,
               "loss_rel_err": abs(lk - lp) / abs(lp),
               "out_rel_l2": float((ok - op).norm() / op.norm()),
               "launches_kernel": nk, "launches_plain": npl,
               "tolerance": f"bf16: loss and denoiser output {VAL_TOL} "
                            "relative (L2), as the train step's check"}
    del model, ok, op, paths
    r.step_fn = None
    del r
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    out = {"stopped_at": stopped[0], "preempt_observed_step": stopped[1],
           "checkpoints": stopped[2], "train_s": stop_s,
           "handler_uninstalled": restored, "resumed_at": resumed_at,
           "resume_launches": launches, "val_loss": vals, "evals": evals,
           "state_bit_identical_to_uninterrupted_no_eval": not differ,
           "tensors_compared": len(want6), "val_forward": val_fwd}
    if stopped[:2] != (PREEMPT_BATCH, PREEMPT_BATCH) \
            or PREEMPT_BATCH not in stopped[2] or not restored \
            or resumed_at != PREEMPT_BATCH:
        raise AssertionError(f"train: preemption {out}")
    if sorted(vals) != [EVAL_EVERY, TRAIN_STEPS] or not all(
            math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"train: val losses {vals}")
    if differ:
        raise AssertionError(f"train: the evaluated run resumed after "
                             f"SIGTERM differs from the plain run "
                             f"({len(differ)} tensors, e.g. {differ[:3]})")
    if not (val_fwd["loss_rel_err"] <= VAL_TOL
            and val_fwd["out_rel_l2"] <= VAL_TOL):
        raise AssertionError(f"train: val forward kernels vs plain "
                             f"{val_fwd}")
    for name in ("fused_groupnorm", "flash_attention"):
        if len(evals) != 2 or not all(e["launches"][name] > 0
                                      for e in evals) \
                or nk[name] == 0 or npl[name] != 0:
            raise AssertionError(f"train: {name} in the val forward "
                                 f"{evals} {nk} {npl}")
    return out


# ---- srn128: the paper's configuration, every UNet block rematerialised --

SRN128_WORKDIR = WORKDIR + "_srn128"
SRN128_SMALL_BATCH = 2          # remat against no remat (cut from 4)
SRN128_STEPS = 2                # Trainer steps under "nothing" (the path)
SRN128_DOTS_STEPS = 2           # and under "dots" (first + one replayed)
SRN128_VIEW_STEPS = 16          # the srn128 sampling path's view
SRN128_SAMPLE_STEPS = 8         # sample_cli's schedule on the trained model
HEADROOM_BYTES = 8 * 2 ** 30    # what --accum must leave free of the card
GRAPH_MARGIN = 2 * 2 ** 30      # the prediction's allowance for the CUDA
                                # graphs' private pool


def srn128_ptxas(ptxas, gn_sites):
    """Registers and spill bytes of every kernel instance the srn128 path
    launches: the bf16 GroupNorm forward / backward instances of its site
    variants, the parameter pass, and the bf16 tensor-core attention
    kernels at D = 128 and 256 with their delta pre-pass."""
    variants = {(film, silu) for (_, _, _, _, film, silu) in gn_sites}
    want = {f"gn_{d}_cluster_kernel<__nv_bfloat16, 8, {str(f).lower()}, "
            f"{str(si).lower()}>" for d in ("fwd", "bwd")
            for f, si in variants}
    want |= {"gn_bwd_param_kernel", "flash_bwd_delta_kernel<__nv_bfloat16>"}
    want |= {f"flash_{k}_mma_kernel<{dp}>" for k in ("fwd", "bwd_dkdv",
                                                      "bwd_dq")
             for dp in (128, 256)}
    out = {}
    for src in ("film", "attention"):
        for name, (regs, ss, sl) in ptxas.get(src, {}).items():
            if name in want:
                out[name] = {"registers": regs, "spill_stores": ss,
                             "spill_loads": sl}
    missing = sorted(want - set(out)) if ptxas.get("film") else []
    return out, missing


def phase_srn128_model(ptxas):
    """The srn128 X-UNet (bf16, seeded random weights) at 2B = 16: kernel
    path against plain path at the srn64 limit, ms and launches per
    forward, and the ptxas registers / spills of its kernel instances
    (reported, not gated)."""
    from diff3d_tpu_torch.config import srn128_config

    cfg = srn128_config()
    model = random_model(cfg)
    batch, cond_mask = model_batch(
        cfg, 2 * len(cfg.diffusion.guidance_weights), seed=21)
    out = phase_model(cfg, model, batch, cond_mask, config="srn128",
                      phase="srn128_model")
    gn_sites, _ = record_sites(model, batch, cond_mask)
    out["ptxas"], out["ptxas_missing"] = srn128_ptxas(ptxas, gn_sites)
    out["spilling"] = sorted(k for k, v in out["ptxas"].items()
                             if v["spill_stores"] or v["spill_loads"])
    emit(out)
    return cfg, model


def phase_srn128_sampler(cfg, model):
    """One srn128 view (``SRN128_VIEW_STEPS`` = 16 ancestral steps, w =
    0..7) from ``Sampler.synthesize`` on the graph path: the srn128
    sampling path,
    counts set to 0 just before and read after.  Then one view at 16
    steps through the graph path and the eager path from one seed,
    bit-identical."""
    import torch

    from diff3d_tpu_torch.sampling import Sampler

    views = orbit_views(3, cfg.model.H, seed=22)
    sampler = Sampler(model, cfg, device="cuda", steps=SRN128_VIEW_STEPS)
    if not sampler.cuda_graphs:
        raise AssertionError("srn128_sampler: the card's path is not the "
                             "graph")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    outs = sampler.synthesize(views, torch.Generator("cuda").manual_seed(0),
                              max_views=2)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    eager = {k: v for k, v in _launch_counts().items()
             if k in ("fused_groupnorm", "flash_attention")}
    ran = _launch_counts(graphs=sampler.graphs.values())
    launches = {k: ran[k] for k in eager}
    graphs = list(sampler.graphs.values())
    B = len(cfg.diffusion.guidance_weights)
    if outs.shape != (1, B, cfg.model.H, cfg.model.W, 3) \
            or not np.isfinite(outs).all():
        raise AssertionError(f"srn128_sampler: output {outs.shape}, finite "
                             f"{np.isfinite(outs).all()}")
    if not graphs or any(g.captured.get(k, 0) == 0 or g.replays == 0
                         for g in graphs for k in launches):
        raise AssertionError(f"srn128_sampler: the graph path did not run "
                             f"both kernels: {_graph_summary(graphs)}")
    steps = sampler.model_calls_per_view
    del sampler
    gc.collect()
    torch.cuda.empty_cache()

    bits = {}
    for graph in (False, True):
        s16 = Sampler(model, cfg, device="cuda", steps=16, cuda_graphs=graph)
        bits[graph] = s16.synthesize(views,
                                     torch.Generator("cuda").manual_seed(1),
                                     max_views=2)
        del s16
    identical = np.array_equal(bits[True], bits[False])
    out = {"config": "srn128", "views_generated": 1, "steps_per_view": steps,
           "guidance_weights": B, "seconds": round(seconds, 3),
           "s_per_view": round(seconds, 4),
           "ms_per_denoise_step": round(1e3 * seconds / steps, 3),
           "max_memory_allocated": peak,
           "out_abs_max": float(np.abs(outs).max()),
           "launches": launches, "eager_launches": eager,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "graphs": _graph_summary(graphs),
           "graph_vs_eager_steps": 16, "graph_vs_eager_bit_identical":
               identical}
    emit(dict(phase="srn128_sampler", **out))
    if not identical:
        raise AssertionError("srn128_sampler: graph and eager views differ "
                             f"(rel. L2 {_rel_l2(bits[True], bits[False])})")
    gc.collect()
    torch.cuda.empty_cache()
    return launches, steps


def _srn128_step(cfg, weights, dtype, remat, policy="nothing"):
    """One eager srn128 train step at the small batch from ``weights``,
    dropout 0.1, the step's own (seed, step) generator: ``(loss, grads,
    peak bytes)``."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import create_train_state, make_train_step

    c = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=dtype, remat=remat,
                                       remat_policy=policy),
        train=dataclasses.replace(cfg.train,
                                  global_batch=SRN128_SMALL_BATCH,
                                  accum_steps=1, warmup_examples=1280))
    model = XUNet(c.model).cuda()
    model.load_state_dict(weights)
    state = create_train_state(model.train(), c.train)
    batch = train_batch(c, SRN128_SMALL_BATCH, 0, scenes=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = make_train_step(c)(state, batch)
    loss = m["loss"].clone()
    grads = [p.grad.clone() for p in model.parameters()]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del model, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return loss, grads, peak


def _srn128_trainer(policy, accum, steps, workdir=SRN128_WORKDIR,
                    batch=TRAIN_BATCH):
    """A ``Trainer`` built by ``cli/train_cli.py --config srn128 --remat
    --remat_policy <policy> --synthetic_scenes --ckpt_mode ema_bf16`` at
    global batch ``batch`` (128): its checkpoint is what ``sample_cli``
    reads, the bf16 EMA (0.96 GB, where ``full`` writes 7.7 GB)."""
    from diff3d_tpu_torch.cli import train_cli

    shutil.rmtree(workdir, ignore_errors=True)
    argv = ["--config", "srn128", "--remat", "--remat_policy", policy,
            "--synthetic_scenes", "--batch", str(batch), "--accum",
            str(accum), "--steps", str(steps), "--warmup_examples",
            str(10 * TRAIN_BATCH), "--ckpt_every", str(steps),
            "--ckpt_mode", "ema_bf16", "--num_workers", "8", "--workdir",
            workdir]
    return train_cli.build_trainer(train_cli.build_parser().parse_args(argv))


def _run_srn128_trainer(policy, accum, steps, checkpoint):
    """Run a srn128 Trainer on the graph path: with ``checkpoint`` through
    ``Trainer.train`` (the main path: counts set to 0 before, read after,
    a checkpoint at the last step), else through its step function.
    Returns the phase's record."""
    import torch

    trainer = _srn128_trainer(policy, accum, steps)
    inner = trainer.step_fn
    if not inner.cuda_graphs:
        raise AssertionError("srn128_train: the card's path is not the graph")
    rec = []

    def timed(state, batch, draws=None):     # one sync per step
        m = inner(state, batch, draws)
        rec.append({"t": time.perf_counter(), "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    if checkpoint:
        trainer.step_fn = timed
        trainer.train()
    else:
        for _ in range(steps):
            timed(trainer.state, next(trainer.loader))
    eager = _launch_counts()
    launches = _launch_counts(graphs=inner.graphs)
    peak = torch.cuda.max_memory_allocated()
    graphs = _graph_summary(inner.graphs)
    micro, update = inner.graphs
    trainer.loader.close()
    inner.release()
    del trainer, inner
    gc.collect()
    torch.cuda.empty_cache()
    times = np.diff([t0] + [r["t"] for r in rec])
    s_per_step = float(np.mean(times[1:]))
    if len(rec) != steps or not all(math.isfinite(r["loss"])
                                    and math.isfinite(r["grad_norm"])
                                    for r in rec):
        raise AssertionError(f"srn128_train {policy}: steps {rec}")
    if micro.replays == 0 or update.replays == 0 or any(
            micro.captured.get(k, 0) == 0 for k in launches):
        raise AssertionError(f"srn128_train {policy}: the graph path did "
                             f"not run every kernel: {graphs}")
    free = torch.cuda.get_device_properties(0).total_memory - peak
    return {"remat_policy": policy, "headroom_bytes": free,
            "headroom_ok": free >= HEADROOM_BYTES, "accum_steps": accum,
            "steps": steps,
            "first_step_s": float(times[0]), "s_per_step": s_per_step,
            "examples_per_s": TRAIN_BATCH / s_per_step,
            "step_s": [float(t) for t in times],
            "max_memory_allocated": peak,
            "loss": [r["loss"] for r in rec],
            "grad_norm": [r["grad_norm"] for r in rec],
            "launches": launches, "eager_launches": eager,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "graphs": graphs}


def graph_trial(policy, accum):
    """Two srn128 Trainer steps on the graph path (the eager warm-up, the
    capture, one replay) of one microbatch of ``accum``'s size (global
    batch 128 / accum in one microbatch: the captured graphs and the
    state are those of ``accum``, which replays the micro graph ``accum``
    times over the same pool); prints ``{"peak": bytes}``, or ``{"oom":
    message}`` when the card runs out of memory.  Runs in its own process
    (``--srn128-graph-trial``): an out-of-memory error inside a capture
    would leave the caller's CUDA state unusable."""
    import torch

    torch.backends.cudnn.deterministic = True
    trainer = _srn128_trainer(policy, 1, 2,
                              workdir=SRN128_WORKDIR + "_trial",
                              batch=TRAIN_BATCH // accum)
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(2):
            trainer.step_fn(trainer.state, next(trainer.loader))
        torch.cuda.synchronize()
        out = {"peak": torch.cuda.max_memory_allocated()}
    except torch.OutOfMemoryError as e:
        out = {"oom": str(e).splitlines()[0][:200]}
    finally:
        trainer.loader.close()
    print(json.dumps(out), flush=True)


def _run_graph_trial(policy, accum):
    """:func:`graph_trial` in a child process; returns its record."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--srn128-graph-trial",
         policy, str(accum)], capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    shutil.rmtree(SRN128_WORKDIR + "_trial", ignore_errors=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        raise AssertionError(f"srn128_train: graph trial at accum {accum} "
                             f"failed: {proc.stderr[-2000:]}")
    return dict(json.loads(lines[-1]), accum_steps=accum)


def _pick_accum(peak_small, peak_per_example, budget):
    """The smallest accum_steps (a divisor of the global batch) whose
    microbatch's predicted peak stays within ``budget``, with the
    prediction it was chosen by."""
    for accum in (1, 2, 4, 8, 16, 32):
        mb = TRAIN_BATCH // accum
        pred = peak_small + (mb - SRN128_SMALL_BATCH) * peak_per_example
        if pred <= budget:
            return accum, pred
    raise AssertionError("srn128_train: no accum_steps fits the card")


def phase_srn128_train(cfg, model):
    """Remat against no remat on one srn128 step at the small batch (f32
    and bf16, dropout 0.1, the same draws): loss and gradients
    bit-identical, peak memory of each.  Then the ``Trainer`` built by
    ``train_cli --config srn128 --remat --synthetic_scenes`` at global
    batch 128 on the graph path, ``--accum`` the smallest whose
    predicted peak leaves 8 GiB free (predicted from the eager peaks at
    two batch sizes; under "nothing" then tried on the graph path in a
    child process, doubled if it does not fit), under "nothing"
    (``Trainer.train``, the
    srn128 training path, then a checkpoint) and under "dots" where it
    fits; then ``sample_cli --config srn128`` on the checkpoint (EMA):
    finite views."""
    import torch

    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    model.cpu()                 # the card holds only what each run makes
    gc.collect()
    torch.cuda.empty_cache()
    compare = {}
    for dtype in ("float32", "bfloat16"):
        runs = {}
        for remat in (False, True):
            torch.backends.cudnn.deterministic = True
            runs[remat] = _srn128_step(cfg, weights, dtype, remat)
        (l0, g0, p0), (l1, g1, p1) = runs[False], runs[True]
        differ = sum(not torch.equal(a, b) for a, b in zip(g0, g1))
        compare[dtype] = {"loss_no_remat": float(l0),
                          "loss_remat": float(l1),
                          "loss_bit_identical": bool(torch.equal(l0, l1)),
                          "grads_differing": differ,
                          "grads_compared": len(g0),
                          "peak_no_remat": p0, "peak_remat": p1}
        del runs, g0, g1
        gc.collect()
    # Peak of a bf16 Trainer step (parameters, gradients, Adam's moments
    # and the EMA resident) under each policy at two batches: its
    # per-example slope predicts the microbatch that fits.
    per_example = {}
    for policy in ("nothing", "dots"):
        pk = {b: _srn128_probe(cfg, weights, policy, b)
              for b in (SRN128_SMALL_BATCH, 4 * SRN128_SMALL_BATCH)}
        per_example[policy] = (
            pk[SRN128_SMALL_BATCH],
            (pk[4 * SRN128_SMALL_BATCH] - pk[SRN128_SMALL_BATCH])
            / (3 * SRN128_SMALL_BATCH))
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    budget = torch.cuda.get_device_properties(0).total_memory \
        - HEADROOM_BYTES
    chosen = {}
    for policy, (p_small, p_ex) in per_example.items():
        accum, pred = _pick_accum(p_small, p_ex, budget - GRAPH_MARGIN)
        chosen[policy] = {
            "peak_at_small_batch": p_small, "peak_per_example": p_ex,
            "accum_steps": accum, "predicted_peak": pred,
            "predicted_peak_at_half_accum": (
                None if accum == 1 else
                p_small + (2 * TRAIN_BATCH // accum - SRN128_SMALL_BATCH)
                * p_ex)}
    emit({"phase": "srn128_train_plan", "remat_vs_no_remat": compare,
          "small_batch": SRN128_SMALL_BATCH, "memory_budget": budget,
          "graph_margin": GRAPH_MARGIN, "chosen": chosen,
          "tolerance": "bit-identical (cuDNN deterministic)"})
    for dtype, c in compare.items():
        if not c["loss_bit_identical"] or c["grads_differing"]:
            raise AssertionError(f"srn128_train: remat vs no remat differ in "
                                 f"{dtype}: {c}")
    # The predicted peak is the eager step's; the graph's capture needs
    # more (its private pool cannot be trimmed while capturing), so the
    # predicted accum is tried on the graph path in a child process, and
    # doubled if it runs out of memory there or leaves < 8 GiB free.
    total = torch.cuda.get_device_properties(0).total_memory
    trial = _run_graph_trial("nothing", chosen["nothing"]["accum_steps"])
    chosen["nothing"]["graph_trial"] = trial
    if "peak" not in trial or total - trial["peak"] < HEADROOM_BYTES:
        chosen["nothing"]["accum_steps"] *= 2
    emit({"phase": "srn128_train_accum", "chosen": chosen})
    runs = {"nothing": _run_srn128_trainer(
        "nothing", chosen["nothing"]["accum_steps"], SRN128_STEPS, True)}
    if not runs["nothing"]["headroom_ok"]:
        raise AssertionError(f"srn128_train: peak "
                             f"{runs['nothing']['max_memory_allocated']} "
                             "leaves less than 8 GiB of the card")
    sampled = _srn128_sample_cli()
    runs["dots"] = _run_srn128_trainer(
        "dots", chosen["dots"]["accum_steps"], SRN128_DOTS_STEPS, False)
    shutil.rmtree(SRN128_WORKDIR, ignore_errors=True)
    out = {"config": "srn128", "global_batch": TRAIN_BATCH, "runs": runs,
           "sample_cli": sampled}
    emit(dict(phase="srn128_train", **out))
    return runs["nothing"]


def _srn128_probe(cfg, weights, policy, batch_size):
    """Peak bytes of an eager bf16 srn128 train step at ``batch_size``
    under ``policy``: the second step of a fresh state, so Adam's moments
    exist beside the parameters, their gradients and the EMA, as in the
    Trainer."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import create_train_state, make_train_step

    c = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=True,
                                       remat_policy=policy),
        train=dataclasses.replace(cfg.train, global_batch=batch_size,
                                  accum_steps=1, warmup_examples=1280))
    model = XUNet(c.model).cuda()
    model.load_state_dict(weights)
    state = create_train_state(model.train(), c.train)
    batch = train_batch(c, batch_size, 0, scenes=True)
    step = make_train_step(c)
    step(state, batch)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def write_srn_object(root, views):
    """``views`` as an SRN object directory (``rgb/`` pngs, ``pose/`` flat
    4x4 world-from-camera, ``intrinsics/`` flat K): ``sample_cli
    --target``."""
    from PIL import Image

    from diff3d_tpu_torch.sampling.runtime import to_uint8

    for sub in ("rgb", "pose", "intrinsics"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for v in range(views["imgs"].shape[0]):
        name = f"{v:06d}"
        Image.fromarray(to_uint8(views["imgs"][v])).save(
            os.path.join(root, "rgb", name + ".png"))
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = views["R"][v], views["T"][v]
        np.savetxt(os.path.join(root, "pose", name + ".txt"),
                   pose.reshape(1, 16))
        np.savetxt(os.path.join(root, "intrinsics", name + ".txt"),
                   np.asarray(views["K"], np.float64).reshape(1, 9))
    return root


def _srn128_sample_cli():
    """``sample_cli --config srn128`` on the srn128 Trainer's checkpoint
    (its EMA weights), one view of a synthetic scene on a
    ``SRN128_SAMPLE_STEPS``-step schedule: finite views (the sampler's
    return value, read through a wrapper), PNGs written."""
    import torch

    from diff3d_tpu_torch.cli import sample_cli
    from diff3d_tpu_torch.data import SyntheticScenesDataset
    from diff3d_tpu_torch.sampling import Sampler

    obj = write_srn_object(os.path.join(SRN128_WORKDIR, "object"),
                           SyntheticScenesDataset(
                               num_objects=1, num_views=3,
                               imgsize=128, seed=1).all_views(0))
    out_dir = os.path.join(SRN128_WORKDIR, "sampling")
    got = []
    real = Sampler.synthesize

    def keep(self, *a, **k):
        got.append(real(self, *a, **k))
        return got[-1]

    Sampler.synthesize = keep
    t0 = time.perf_counter()
    try:
        sample_cli.main(["--config", "srn128", "--model",
                         os.path.join(SRN128_WORKDIR, "checkpoints"),
                         "--target", obj, "--out", out_dir, "--max_views",
                         "2", "--steps", str(SRN128_SAMPLE_STEPS)])
    finally:
        Sampler.synthesize = real
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    pngs = sorted(os.listdir(os.path.join(out_dir, "1")))
    if len(got) != 1 or got[0].shape[:2] != (1, 8) \
            or not np.isfinite(got[0]).all() or len(pngs) != 9:
        raise AssertionError(f"srn128 sample_cli: outputs {len(got)}, "
                             f"pngs {pngs}")
    return {"steps": SRN128_SAMPLE_STEPS, "seconds": round(seconds, 3),
            "views": int(got[0].shape[0]), "finite": True,
            "out_abs_max": float(np.abs(got[0]).max()), "pngs": len(pngs)}


def meta_sites(cfg, B: int):
    """``record_sites`` of ``cfg``'s X-UNet at batch ``B`` on the meta
    device: the shapes without memory or kernels."""
    import torch

    from diff3d_tpu_torch.models import XUNet

    with torch.device("meta"):
        model = XUNet(cfg.model).eval()
    H = cfg.model.H
    shapes = dict(x=(B, H, H, 3), z=(B, H, H, 3), logsnr=(B, 2),
                  R=(B, 2, 3, 3), t=(B, 2, 3), K=(B, 3, 3))
    batch = {k: torch.zeros(v, device="meta") for k, v in shapes.items()}
    return record_sites(model, batch,
                        torch.zeros(B, dtype=torch.bool, device="meta"))


def phase_srn128_sites(cfg, accum, train_launches_per_step):
    """Every GroupNorm and attention site of a srn128 sampler step (2B =
    16) and of one srn128 training microbatch (128 / accum): each kernel
    against its plain version at the srn64 tolerances (f32 on the first
    16 samples of a training site, bf16 on all), the forward's cluster
    plans fit the card (the backward's launch), and per site and per step
    the kernel's time, bound, plain version and library call.  The train
    step's forward rows are scaled by the forward launches per site that
    the rematerialised srn128 Trainer ran (its recompute runs every
    block's forward again)."""
    sample_gn, sample_attn = meta_sites(
        cfg, 2 * len(cfg.diffusion.guidance_weights))
    mb = TRAIN_BATCH // accum
    train_gn, train_attn = meta_sites(cfg, mb)
    gn = phase_groupnorm(sample_gn, phase="srn128_groupnorm",
                         odd_shapes=False)
    attn = phase_attention(sample_attn, phase="srn128_attention",
                           extra_shapes=False)
    gn_fwd, gn_bwd = phase_groupnorm_backward(
        train_gn, accum, phase="srn128_groupnorm_backward", edges=False,
        f32_max_n=16)
    attn_rows = phase_attention_backward(
        train_attn, accum, phase="srn128_attention_backward",
        extra_shapes=False, f32_max_n=16)
    factor = {
        "fused_groupnorm": train_launches_per_step["fused_groupnorm"]
        / (accum * sum(train_gn.values())),
        "flash_attention": train_launches_per_step["flash_attention"]
        / (accum * sum(train_attn.values()))}
    for row, f in ((gn_fwd, factor["fused_groupnorm"]),
                   (attn_rows["lse"], factor["flash_attention"])):
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            row[k] *= f
        row["remat_forward_factor"] = f
    emit({"phase": "srn128_sites",
          "sampler_sites": {"groupnorm": sum(sample_gn.values()),
                            "attention": sum(sample_attn.values())},
          "train_microbatch": mb, "accum_steps": accum,
          "train_sites": {"groupnorm": sum(train_gn.values()),
                          "attention": sum(train_attn.values())},
          "per_sampler_step": {"fused_groupnorm": gn,
                               "flash_attention": attn},
          "per_train_step": {"fused_groupnorm[save_stats]": gn_fwd,
                             "groupnorm_backward": gn_bwd,
                             **{f"attention[{k}]": v
                                for k, v in attn_rows.items()}},
          "remat_forward_factor": factor,
          "note": "forward rows of the train step count each site "
                  "remat_forward_factor times (the recompute)"})
    return gn, attn, gn_fwd, gn_bwd, attn_rows


def phase_eval():
    """``cli/eval_cli.py`` on the srn64 train phase's checkpoint (EMA) on
    synthetic scenes: 2 objects, 3 views, a 32-step grid, DDIM at 4 steps, one
    guidance-selection object, a matched-seed oracle object and a 4-frame
    orbit; finite metrics per w, the parity and orbit fields; s per
    object.  Then the same command again: no object re-synthesised, the
    same JSON line."""
    import contextlib
    import io

    import torch

    from diff3d_tpu_torch.cli import eval_cli

    out = os.path.join(WORKDIR, "eval.jsonl")
    # A 32-step dense grid (the parity oracle's; cut from 256) and 4 DDIM
    # steps (cut from 32).
    argv = ["--model", os.path.join(WORKDIR, "checkpoints"), "--config",
            "srn64", "--synthetic_scenes", "--objects", "2", "--max_views",
            "3", "--steps", "32", "--sampler", "ddim", "--sampler_steps",
            "4", "--w_select", "1", "--parity_objects", "1", "--orbit",
            "4", "--out", out]
    lines, seconds, stamps = [], [], []
    objdir = out + ".objdir"
    for _ in range(2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            eval_cli.main(argv)
        seconds.append(time.perf_counter() - t0)
        lines.append(buf.getvalue().strip().splitlines()[-1])
        stamps.append({f: os.path.getmtime(os.path.join(objdir, f))
                       for f in sorted(os.listdir(objdir))
                       if f.endswith(".npz")})
    rec = json.loads(lines[0])
    progress = open(os.path.join(objdir, "progress.jsonl")).read()
    n_objects = len(rec["per_object"]) + len(rec["w_select_objects"])
    gc.collect()
    torch.cuda.empty_cache()
    finite = all(math.isfinite(rec[k]) for k in ("psnr", "ssim",
                                                  "fid_randfeat"))
    finite &= all(math.isfinite(v) for v in rec["psnr_per_w"])
    fields = ("sampler_parity" in rec and "orbit_consistency" in rec
              and rec["orbit_consistency"]["frames"] == 4)
    out = {"config": "srn64", "checkpoint_step": rec["checkpoint_step"],
           "objects": rec["objects"], "views": rec["views"],
           "psnr": rec["psnr"], "ssim": rec["ssim"],
           "fid_randfeat": rec["fid_randfeat"],
           "psnr_per_w": rec["psnr_per_w"], "w_selected": rec["w_selected"],
           "sampler_parity": rec["sampler_parity"],
           "orbit_consistency_l1": rec["orbit_consistency"]["consistency_l1"],
           "orbit_consistency_psnr":
               rec["orbit_consistency"]["consistency_psnr"],
           "seconds": [round(t, 3) for t in seconds],
           "s_per_object_first_run": round(seconds[0] / n_objects, 3),
           "objects_synthesised": len(progress.splitlines()),
           "records_rewritten_by_rerun": stamps[0] != stamps[1],
           "rerun_line_identical": lines[0] == lines[1],
           "finite": finite, "parity_and_orbit_fields": fields}
    emit(dict(phase="eval", **out))
    if not (finite and fields and lines[0] == lines[1]
            and stamps[0] == stamps[1]
            and len(progress.splitlines()) == n_objects):
        raise AssertionError(f"eval: {out}")
    return out


# ---- data parallelism: the replicated and fsdp Trainers, ring / Ulysses --

PARALLEL_WORKDIR = WORKDIR + "_parallel"
PARALLEL_STEPS = 3              # (a): the first eager, then replays
FSDP_STEPS = 2                  # (b): eager steps
# srn128's L = 1024 attention site (level 2: 32 x 32 tokens, C = 512,
# 4 heads of 128) at the sampler's N = 2B * F = 32 rows, bf16.
RING_SHAPE = (32, 1024, 4, 128)
RING_WORLD = 2


def _parallel_argv(workdir, steps, *extra):
    """``phase_train_graph``'s trainer (its graph run is (a)'s trainer
    without a group)."""
    return ["--synthetic", "--config", "srn64", "--batch", str(TRAIN_BATCH),
            "--accum", str(TRAIN_ACCUM), "--steps", str(steps),
            "--warmup_examples",
            str(10 * TRAIN_BATCH), "--ckpt_every", "0", "--num_workers",
            "8", "--workdir", workdir, *extra]


def _dp_run(argv, steps, snapshot_at=None):
    """A ``Trainer`` built by ``train_cli`` (on the mesh of whatever
    process group is up) stepped ``steps`` times: per-step seconds,
    losses, the state after the last step (and after ``snapshot_at``) on
    the host, its step and mesh."""
    import torch

    from diff3d_tpu_torch.cli import train_cli

    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv))
    step = trainer.step_fn
    times, losses, snap = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(trainer.state, next(trainer.loader))
        losses.append(float(m["loss"]))            # waits for the card
        times.append(time.perf_counter() - t0)
        if snapshot_at == i + 1:
            snap = {k: v.cpu() for k, v in
                    _state_tensors(trainer.state).items()}
    out = {"step_s": times, "losses": losses,
           "tensors": {k: v.cpu() for k, v in
                       _state_tensors(trainer.state).items()},
           "snapshot": snap, "graphs": step.graphs is not None,
           "topology": trainer.env.topology_summary(),
           "grouped": trainer.env.group is not None,
           "sharded_leaves": sum(hasattr(p, "full_tensor") for p in
                                 trainer.state.model.parameters())}
    if step.graphs is not None:
        out["graph_summary"] = _graph_summary(step.graphs)
    sync = getattr(step, "_sync", None)
    if sync is not None:
        # The step's one collective, alone, on its bucket (eager).
        import torch.distributed as dist

        out["allreduce_ms"] = cuda_ms(
            lambda: dist.all_reduce(sync.flat, group=sync.group), iters=10)
        out["bucket_bytes"] = sync.flat.numel() * 4
    trainer.loader.close()
    step.release()
    del trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ring_rank(rank: int, world: int) -> dict:
    """One rank of (c), on the card with the other rank over gloo: ring
    attention and Ulysses at ``RING_SHAPE`` (the tokens split over the
    ranks), the path run once with the launch counts from 0, then held
    against the unsharded kernel and the plain version and timed."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops import cuda_attention as ca
    from diff3d_tpu_torch.parallel import ring_sdpa, ulysses_sdpa

    torch.cuda.set_device(0)
    group = dist.group.WORLD
    B, L, H, D = RING_SHAPE
    gen = torch.Generator().manual_seed(11)
    q, k, v, w = (torch.randn(B, L, H, D, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(4))
    n = L // world
    mine = slice(rank * n, (rank + 1) * n)

    def local(t, grad=False):
        t = t[:, mine].detach().contiguous()
        return t.requires_grad_() if grad else t

    def ring(impl, grad=True):
        ql, kl, vl = (local(t, grad) for t in (q, k, v))
        o = ring_sdpa(ql, kl, vl, group, impl=impl)
        return o, (ql, kl, vl)

    # The path: forward and backward through the ring (rows 4, 5, 6 on
    # every block), then Ulysses' forward (row 3 on the local heads).
    _launch_counts(reset=True)
    o, ins = ring("cuda")
    (o.float() * local(w).float()).sum().backward()
    ring_launches = _launch_counts()
    _launch_counts(reset=True)
    with torch.no_grad():
        ou = ulysses_sdpa(local(q), local(k), local(v), group)
    torch.cuda.synchronize()
    ulysses_launches = _launch_counts()
    got = {"out": o.detach(), "dq": ins[0].grad, "dk": ins[1].grad,
           "dv": ins[2].grad, "ulysses": ou}

    # The references over the whole sequence: the unsharded kernel (its
    # forward with the lse, its backward) and the plain version.
    refs = {}
    for name, fn in (("kernel", ca.flash_attention),
                     ("plain", ca.attention_reference)):
        qf, kf, vf = (t.detach().clone().requires_grad_() for t in (q, k, v))
        of = fn(qf, kf, vf)
        (of.float() * w.float()).sum().backward()
        with torch.no_grad():
            oi = fn(q, k, v)
        refs[name] = {"out": of[:, mine], "dq": qf.grad[:, mine],
                      "dk": kf.grad[:, mine], "dv": vf.grad[:, mine],
                      "ulysses": oi[:, mine]}
    errs, ok = {}, True
    for ref_name, ref in refs.items():
        for key, t in got.items():
            e = float((t.float() - ref[key].float()).abs().max())
            tol = _tol(ref[key], torch.bfloat16)
            errs[f"{key}_vs_{ref_name}"] = {"max_abs_err": e, "tol": tol}
            ok &= e <= tol

    # Times (this rank's share; the transfers staged through the host on
    # gloo are inside them).
    qa, ka, va = (local(t) for t in (q, k, v))
    qh, kh, vh = (t.transpose(1, 2) for t in (qa, k, v))     # [B, H, L, D]

    def fwd(impl):
        with torch.no_grad():
            ring_sdpa(qa, ka, va, group, impl=impl)

    def bwd_of(impl):
        o, ins = ring(impl)
        loss = (o.float() * local(w).float()).sum()
        return lambda: torch.autograd.grad(loss, ins, retain_graph=True)

    def lib_bwd():
        qq, kk, vv = (t.detach().clone().requires_grad_()
                      for t in (qh, kh, vh))
        o = F.scaled_dot_product_attention(qq, kk, vv)
        return lambda: torch.autograd.grad(o, (qq, kk, vv), o,
                                           retain_graph=True)

    def uly(impl):
        with torch.no_grad():
            ulysses_sdpa(qa, ka, va, group, impl=impl)

    Hn = H // world
    ul = tuple(t[:, :, :Hn].contiguous().transpose(1, 2)
               for t in (q, k, v))            # one rank's heads, all tokens
    times = {
        "ring_fwd_ms": cuda_ms(lambda: fwd("cuda"), iters=5),
        "ring_fwd_plain_ms": cuda_ms(lambda: fwd("einsum"), iters=5),
        "ring_fwd_library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5),
        "ring_bwd_ms": cuda_ms(bwd_of("cuda"), iters=5),
        "ring_bwd_plain_ms": cuda_ms(bwd_of("einsum"), iters=5),
        "ring_bwd_library_ms": cuda_ms(lib_bwd(), iters=5),
        "ulysses_ms": cuda_ms(lambda: uly("cuda"), iters=5),
        "ulysses_plain_ms": cuda_ms(lambda: uly("torch"), iters=5),
        "ulysses_library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(*ul), iters=5)}
    # The block kernels alone, with no transfer in the window: rows 4-6 on
    # this rank's q against one ring block of n keys (the shape every ring
    # step gives them, the backward with a non-zero lse cotangent), and
    # row 3 on Ulysses' local heads over every token.
    with torch.no_grad():
        bo, blse = ca.flash_attention_lse(qa, ka, va)
        blse = blse.transpose(1, 2).contiguous()          # [B, H, n]
        gen_c = torch.Generator(device="cuda").manual_seed(12)
        bdo = torch.randn(bo.shape, generator=gen_c, device="cuda",
                          dtype=bo.dtype)
        bglse = 0.1 * torch.randn(blse.shape, generator=gen_c,
                                  device="cuda")
        kb, vb = (t.transpose(1, 2) for t in (ka, va))    # [B, H, n, D]

    uln = tuple(t.transpose(1, 2) for t in ul)            # [B, L, H/n, D]

    def blk_lib_bwd():
        qq, kk, vv = (t.detach().clone().requires_grad_()
                      for t in (qh, kb, vb))
        o = F.scaled_dot_product_attention(qq, kk, vv)
        g = bdo.transpose(1, 2)
        return lambda: torch.autograd.grad(o, (qq, kk, vv), g,
                                           retain_graph=True)

    def kernel_times():
        with torch.no_grad():
            got = {
                "block_fwd_ms": cuda_ms(
                    lambda: ca.flash_attention_lse(qa, ka, va), iters=10),
                "block_fwd_plain_ms": cuda_ms(
                    lambda: ca.attention_lse_reference(qa, ka, va),
                    iters=10),
                "block_fwd_library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kb, vb),
                    iters=10),
                "block_bwd_ms": cuda_ms(
                    lambda: ca.attention_backward(qa, ka, va, bo, blse, bdo,
                                                  bglse), iters=10),
                "block_bwd_plain_ms": cuda_ms(
                    lambda: ca.attention_backward_reference(
                        qa, ka, va, bo, blse, bdo, bglse), iters=10),
                "heads_fwd_ms": cuda_ms(lambda: ca.flash_attention(*uln),
                                        iters=10),
                "heads_fwd_plain_ms": cuda_ms(
                    lambda: ca.attention_reference(*uln), iters=10),
                "heads_fwd_library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(*ul), iters=10)}
        got["block_bwd_library_ms"] = cuda_ms(blk_lib_bwd(), iters=10)
        return got

    # One rank at a time, so that the other rank's work does not share
    # the card inside the window.
    for turn in range(world):
        dist.barrier(group)
        if turn == rank:
            times.update(kernel_times())
        torch.cuda.synchronize()
    dist.barrier(group)
    return {"rank": rank, "ring_launches": ring_launches,
            "ulysses_launches": ulysses_launches, "errors": errs,
            "within_tol": bool(ok), "times": times,
            "backend": dist.get_backend(group)}


def _ring_stats(ranks, kernel_key, call_key, errs_keys, flops, nbytes):
    """One ``kernels`` row's stats from the ranks' readings, the slowest
    rank's times and the worst error: ``ms`` / ``plain_ms`` /
    ``library_ms`` are the kernel alone (``<kernel_key>_ms`` ...), with
    ``bound_ms`` from ``flops`` / ``nbytes``, the same work; ``call_*``
    are the whole sequence-parallel call, transfers included
    (``<call_key>_ms`` ...)."""
    bound_f = flops / BF16_FLOPS * 1e3
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3

    def slowest(key):
        return max(r["times"][key] for r in ranks)

    return {"ms": slowest(f"{kernel_key}_ms"),
            "plain_ms": slowest(f"{kernel_key}_plain_ms"),
            "library_ms": slowest(f"{kernel_key}_library_ms"),
            "max_abs_err": max(r["errors"][k]["max_abs_err"]
                               for r in ranks for k in errs_keys),
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "call_ms": slowest(f"{call_key}_ms"),
            "call_plain_ms": slowest(f"{call_key}_plain_ms"),
            "call_library_ms": slowest(f"{call_key}_library_ms")}


def phase_parallel(graph_run):
    """Data parallelism on the card (see the module docstring, 11a), the
    graph run of ``phase_train_graph`` standing for the trainer without a
    process group:
    (a) the replicated Trainer at world size 1 over NCCL, the step as CUDA
    graphs with the gradient all-reduce captured, bit-identical to the
    same Trainer without a process group; (b) the ``fsdp`` Trainer at
    world size 1, eager, against (a); (c) ring and Ulysses attention over
    2 processes sharing the card (gloo); (d) ``torchrun train_cli
    --param_sharding fsdp`` and ``eval_cli --mesh`` on its checkpoint.
    (c) runs after (d), and its two processes then run phase
    ``tensor_parallel``'s ranks: ``(out, tp_run)``, ``tp_run`` for
    :func:`phase_tensor_parallel`."""
    import torch

    from diff3d_tpu_torch.parallel import (maybe_initialize_distributed,
                                           shutdown_distributed)
    from diff3d_tpu_torch.testing.distributed import spawn

    shutil.rmtree(PARALLEL_WORKDIR, ignore_errors=True)
    wd = {k: os.path.join(PARALLEL_WORKDIR, k)
          for k in ("group", "fsdp", "torchrun")}
    # (a) Over NCCL at world size 1, against the same Trainer without a
    # group (phase_train_graph's graph run: the same argv and seeds).
    if TRAIN_GRAPH_STEPS != PARALLEL_STEPS:
        raise AssertionError("parallel: (a) repeats train_graph's steps")
    plain = {"tensors": graph_run["graph_tensors"],
             "losses": [m[0] for m in graph_run["loss_grad_norm"]],
             "step_s": graph_run["graph_step_s"]}
    port = _free_port()
    if not maybe_initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                        backend="nccl"):
        raise AssertionError("parallel: no NCCL group came up")
    try:
        grouped = _dp_run(_parallel_argv(wd["group"], PARALLEL_STEPS),
                          PARALLEL_STEPS, snapshot_at=FSDP_STEPS)
        # (b) fsdp over the same group, eager.
        fsdp = _dp_run(_parallel_argv(wd["fsdp"], FSDP_STEPS,
                                      "--param_sharding", "fsdp"),
                       FSDP_STEPS)
    finally:
        shutdown_distributed()
    differ = [k for k in plain["tensors"]
              if not torch.equal(plain["tensors"][k], grouped["tensors"][k])]
    same = not differ and plain["losses"] == grouped["losses"]
    ref = grouped["snapshot"]
    fsdp_rel = max(float((fsdp["tensors"][k].float() - ref[k].float()).norm()
                         / max(float(ref[k].float().norm()), 1e-30))
                   for k in ref)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                   zip(fsdp["losses"], grouped["losses"][:FSDP_STEPS]))
    step_ms = {k: 1e3 * float(np.mean(r["step_s"][1:]))
               for k, r in (("nogroup", plain), ("group", grouped))}
    fsdp_s = float(np.mean(fsdp["step_s"][1:]))

    # (d) The entry points under one torchrun launch: train_cli.main,
    # then eval_cli.main on its checkpoint, in the group torchrun's
    # environment names (one launch: its start-up paid once).
    ckpts = os.path.join(wd["torchrun"], "checkpoints")
    train_argv = _parallel_argv(wd["torchrun"], FSDP_STEPS,
                                "--param_sharding", "fsdp")
    eval_argv = ["--mesh", "--model", ckpts, "--synthetic_scenes",
                 "--objects", "1", "--max_views", "3", "--sampler", "ddim",
                 "--sampler_steps", "4"]
    serve_argv = ["--mesh", "--replicas", "2", "--model", ckpts,
                  "--sampler_steps", str(SERVE_STEPS), "--max_batch", "2",
                  "--max_wait_ms", "0", "--drain_s", "5"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__),
           "--torchrun-entry-points", *train_argv, "--then-eval",
           *eval_argv, "--then-serve", *serve_argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    entry = {"train_cli": {"rc": proc.returncode,
                           "wall_s": round(time.perf_counter() - t0, 3)}}
    if proc.returncode:
        raise AssertionError(f"parallel: torchrun train_cli + eval_cli + "
                             f"serve_cli exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    marks = json.loads(lines[-1])
    entry["eval_cli"] = {"rc": 0, "wall_s": marks["eval_s"],
                         "line": json.loads(lines[-2])}
    entry["serve_cli"] = {"rc": 0, "wall_s": marks["serve_s"],
                          "answers": marks["serve_answers"]}
    with open(os.path.join(wd["torchrun"], "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    entry["train_cli"]["train_wall_s"] = recs[-1]["wall_s"]
    entry["train_cli"]["startup_s"] = round(
        entry["train_cli"]["wall_s"] - marks["eval_s"] - marks["serve_s"]
        - recs[-1]["wall_s"], 3)
    saved = torch.load(os.path.join(ckpts, f"ckpt_{FSDP_STEPS}.pt"),
                       map_location="cpu", weights_only=True)
    manifest_mesh = saved.get("mesh")
    del saved
    shutil.rmtree(PARALLEL_WORKDIR, ignore_errors=True)
    evalrec = entry["eval_cli"]["line"]
    eval_ok = all(math.isfinite(evalrec[k]) for k in ("psnr", "ssim"))
    served = entry["serve_cli"]["answers"]
    serve_ok = len(served) == 2 and all(
        a["status"] == 200 and a["finite"] and a["shape"][0] == 2
        and a["shape"][2:] == [64, 64, 3] for a in served)

    # (c) Two processes on the card over gloo: ring and Ulysses, then, in
    # the same processes, phase tensor_parallel's ranks (its one-rank
    # references first, on this process).
    gc.collect()
    torch.cuda.empty_cache()
    tp_prep = tp_prepare()
    t0 = time.perf_counter()
    both = spawn("chip_smoke:gloo_rank", RING_WORLD, tp_prep["workdir"],
                 tp_prep["cp_workdir"], timeout_s=900)
    ranks = [b["ring"] for b in both]
    ring_s = max(b["ring_s"] for b in both)
    cp_s = max(b["cp_s"] for b in both)
    mesh_s = max(b["mesh_s"] for b in both)
    tp_run = (tp_prep, [b["tp"] for b in both],
              time.perf_counter() - t0 - ring_s - cp_s - mesh_s)
    cp_run = (tp_prep, [b["cp"] for b in both], cp_s)
    mesh_run = ([b["mesh"] for b in both], mesh_s)
    launched = all(r["ring_launches"]["flash_attention"] > 0
                   and r["ring_launches"]["attention_backward_dkdv"] > 0
                   and r["ring_launches"]["attention_backward_dq"] > 0
                   and r["ulysses_launches"]["flash_attention"] > 0
                   for r in ranks)

    out = {"config": "srn64", "global_batch": TRAIN_BATCH,
           "replicated_world1_nccl": {
               "steps": PARALLEL_STEPS, "losses": grouped["losses"],
               "graphs_captured": grouped["graphs"],
               "graph_summary": grouped.get("graph_summary"),
               "topology": grouped["topology"],
               "bit_identical_to_no_group": same,
               "tensors_compared": len(plain["tensors"]),
               "tensors_differing": len(differ),
               "ms_per_step_group": step_ms["group"],
               "ms_per_step_no_group": step_ms["nogroup"],
               "allreduce_ms": grouped.get("allreduce_ms"),
               "allreduce_share": (grouped["allreduce_ms"]
                                   / step_ms["group"]
                                   if "allreduce_ms" in grouped else None),
               "bucket_bytes": grouped.get("bucket_bytes")},
           "fsdp_world1": {
               "steps": FSDP_STEPS, "eager": not fsdp["graphs"],
               "losses": fsdp["losses"],
               "sharded_leaves": fsdp["sharded_leaves"],
               "s_per_step": fsdp_s,
               "replicated_graph_s_per_step": step_ms["group"] / 1e3,
               "max_rel_l2_vs_replicated": fsdp_rel,
               "loss_rel_vs_replicated": loss_rel,
               "tolerance": BF16_STEP_GRAD_TOL},
           "ring_ulysses": {
               "backend": "gloo, 2 ranks on one card",
               "transport": "CUDA tensors staged through pinned host "
                            "memory on the gloo group (the attention runs "
                            "on the card)",
               "shape": list(RING_SHAPE), "dtype": "bfloat16",
               "ranks": [{k: r[k] for k in ("ring_launches",
                                            "ulysses_launches", "errors",
                                            "times", "backend")}
                         for r in ranks],
               "within_tol": all(r["within_tol"] for r in ranks),
               "rows_4_5_6_launched_on_each_rank": launched,
               "ranks_s": round(ring_s, 3)},
           "torchrun": {k: {kk: vv for kk, vv in v.items() if kk != "line"}
                        for k, v in entry.items()},
           "manifest_mesh": manifest_mesh,
           "eval_psnr": evalrec.get("psnr"), "eval_ok": eval_ok}
    emit(dict(phase="parallel", **out))
    if not (same and grouped["graphs"] and grouped["grouped"]
            and "allreduce_ms" in grouped):
        raise AssertionError(f"parallel: the NCCL trainer differs from the "
                             f"one without a group ({len(differ)} tensors, "
                             f"e.g. {differ[:3]})")
    if not (fsdp_rel <= BF16_STEP_GRAD_TOL and loss_rel <= BF16_STEP_LOSS_TOL
            and not fsdp["graphs"]):
        raise AssertionError(f"parallel: fsdp off the replicated trainer: "
                             f"{fsdp_rel}, {loss_rel}")
    if not (out["ring_ulysses"]["within_tol"] and launched):
        raise AssertionError(f"parallel: ring / Ulysses: {ranks}")
    if not (manifest_mesh and manifest_mesh.get("param_sharding") == "fsdp"
            and eval_ok and serve_ok):
        raise AssertionError(f"parallel: torchrun: {manifest_mesh}, "
                             f"{evalrec}, serve_cli --mesh {served}")
    # The bounds of the work the kernel rows time: one ring block (q of
    # n rows against n keys; the lse and its cotangent in f32) and
    # Ulysses' local heads over all L tokens.
    B, L, H, D = RING_SHAPE
    n = L // RING_WORLD
    itm = 2
    fwd_flops = 4.0 * B * H * n * n * D
    fwd_bytes = itm * B * H * D * 4 * n + 4 * B * H * n
    bwd_flops = 10.0 * B * H * n * n * D
    bwd_bytes = itm * B * H * D * 8 * n + 2 * 4 * B * H * n
    Hn = H // RING_WORLD
    uly_flops = 4.0 * B * Hn * L * L * D
    uly_bytes = itm * B * Hn * D * 4 * L
    out["kernel_stats"] = {
        "flash_attention_lse@ring": _ring_stats(
            ranks, "block_fwd", "ring_fwd",
            ("out_vs_kernel", "out_vs_plain"), fwd_flops, fwd_bytes),
        "attention_backward@ring": _ring_stats(
            ranks, "block_bwd", "ring_bwd",
            tuple(f"{g}_vs_{r}" for g in ("dq", "dk", "dv")
                  for r in ("kernel", "plain")), bwd_flops, bwd_bytes),
        "flash_attention@ulysses": _ring_stats(
            ranks, "heads_fwd", "ulysses",
            ("ulysses_vs_kernel", "ulysses_vs_plain"), uly_flops,
            uly_bytes)}
    out["kernel_launches"] = {
        "flash_attention_lse@ring": ranks[0]["ring_launches"][
            "flash_attention"],
        "attention_backward@ring": (
            ranks[0]["ring_launches"]["attention_backward_dkdv"]
            + ranks[0]["ring_launches"]["attention_backward_dq"]),
        "flash_attention@ulysses": ranks[0]["ulysses_launches"][
            "flash_attention"]}
    return out, tp_run, cp_run, mesh_run


# ---- tensor parallelism: the model axis over 2 ranks on the card ------------

TP_WORKDIR = WORKDIR + "_tp"
TP_WORLD = 2
TP_BATCH = 8                    # (c)'s global batch
TP_STEPS = 1                    # (c)'s eager steps (cut from 2)
TP_SAMPLER_STEPS = 1            # (b): DDIM steps of one view (cut from 2)
CP_STEPS = 2                    # the context phase's (c) eager steps
CP_SAMPLER_STEPS = 1            # the context phase's (d) DDIM steps (cut
                                # from 2 in PR 18)
TP_TOL = 3e-2                   # (a), (b): the model gate, rel. L2
# (c)'s limits; PERF.md section 6 (PR 14) gives the readings: losses and
# norms 2.1e-5, the worst update beyond the floor 0.0158, the floor's
# worst excess 3.8e-9; the control fails 467 of 767 leaves.
TP_LOSS_TOL = 1e-3              # (c): losses, gradient norms, lrs (rel.)
TP_UPDATE_TOL = 3e-2            # (c): each parameter's update, rel. L2
TP_UPDATE_FLOOR = 1e-8          # (c): an update at bf16 noise, max abs
TP_UPDATE_ULPS = 2              # (c): float32 spacings of p, one a step
TP_CONTROL_REF = os.path.join(TP_WORKDIR, "control_ref.pt")


def _tp_f32(cfg, model):
    """``(cfg, model)`` computing in float32, in place (the weights are
    float32 already; each Dense / Conv casts to its compute dtype): (b)'s
    guidance up to w = 7 multiplies a denoiser's error by up to 15, so
    bf16's summation-order noise alone would fill the gate after a few
    steps (TF32 convolutions are turned off around (b) for the same
    reason)."""
    import torch

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    model.cfg = cfg.model
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    return cfg, model


class _NoTF32:
    """cuDNN convolutions in full float32 while entered."""

    def __enter__(self):
        import torch

        self._was = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32 = self._was



def _tp_argv(workdir, *extra):
    """The Trainer of (c): srn64 at global batch ``TP_BATCH``, eager,
    resuming from the checkpoint in ``workdir``."""
    return ["--synthetic", "--config", "srn64", "--batch", str(TP_BATCH),
            "--steps", "1000", "--warmup_examples", str(10 * TRAIN_BATCH),
            "--ckpt_every", "0", "--num_workers", "0", "--eager",
            "--transfer", "--workdir", workdir, *extra]


def _tp_trainer(argv):
    """(c)'s Trainer, its lr put on its own schedule at the restored step
    (the checkpoint's lr is the batch-128 run's, 16x this run's)."""
    from diff3d_tpu_torch.cli import train_cli
    from diff3d_tpu_torch.train.state import set_schedule_step

    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv))
    set_schedule_step(trainer.state, trainer.state.step)
    return trainer


def _tp_steps(trainer, n, batches=None):
    """``n`` steps of ``trainer`` on ``batches`` (default: its loader's
    next ones): losses, gradient norms, the lr each update took and the
    batches."""
    losses, norms, lrs, used = [], [], [], []
    for i in range(n):
        lrs.append(float(trainer.state.optimizer.param_groups[0]["lr"]))
        batch = next(trainer.loader) if batches is None else batches[i]
        m = trainer.step_fn(trainer.state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        used.append(batch)
    return losses, norms, lrs, used


def _rewind_point(trainer):
    """``(step, copies)``: the step and a copy on the card of every tensor
    of ``trainer``'s state, for :func:`_rewind`."""
    from diff3d_tpu_torch.train.checkpoint import state_leaves

    return trainer.state.step, {n: t.detach().clone()
                                for n, t in state_leaves(trainer.state)}


def _rewind(trainer, point) -> None:
    """Put ``trainer``'s state back to ``point`` (:func:`_rewind_point`)
    in place: the parameters, the EMA, Adam's moments and counts, the
    step and the schedule, as a restore of the checkpoint it was built
    from leaves them (a device copy instead of reading the file again)."""
    import torch

    from diff3d_tpu_torch.train.checkpoint import state_leaves
    from diff3d_tpu_torch.train.state import set_schedule_step

    step, saved = point
    with torch.no_grad():
        for n, t in state_leaves(trainer.state):
            t.copy_(saved[n])
    trainer.state.step = step
    set_schedule_step(trainer.state, step)


def _tp_params(trainer):
    """``{name: float32 copy}`` of ``trainer``'s parameters, on the
    card."""
    return {n: p.detach().float().clone()
            for n, p in trainer.state.model.named_parameters()}


def _update_sums(got, ref, start):
    """One leaf's (or block's) terms of (c)'s gate, from parameters after
    the steps (``got``, ``ref``) and before them (``start``): the sums of
    squares of the updates' difference, of the reference update and of
    the reference parameter, the difference's largest element, and its
    largest excess over ``TP_UPDATE_ULPS`` float32 spacings of the
    parameter (each step rounds ``p + u`` to float32: a leaf that barely
    moves differs by that rounding alone)."""
    import torch

    d = got.double() - ref.double()
    u = ref.double() - start.double()
    a = ref.float().abs()
    ulp = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    excess = d.abs() - TP_UPDATE_ULPS * ulp.double()
    return [float(d.square().sum()), float(u.square().sum()),
            float(ref.double().square().sum()), float(d.abs().max()),
            float(excess.max())]


def _summed(rank_sums):
    """One leaf's :func:`_update_sums` terms over the ranks' blocks: the
    sums of squares added, the maxima taken."""
    out = {}
    for sums in rank_sums:
        for n, v in sums.items():
            acc = out.setdefault(n, [0.0, 0.0, 0.0, -math.inf, -math.inf])
            acc[:3] = [a + b for a, b in zip(acc[:3], v[:3])]
            acc[3:] = [max(a, b) for a, b in zip(acc[3:], v[3:])]
    return out


def _scaled(row, n):
    """A kernel-stats row for ``n`` calls of its site set: every time
    ``n`` times."""
    return dict(row, **{k: n * row[k] for k in (
        "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")
        if row.get(k) is not None})


def _update_gate(sums):
    """(c)'s gate over ``{leaf: [ss_diff, ss_update, ss_param, max_diff,
    max_excess]}`` (:func:`_update_sums`, summed over the ranks' blocks
    where a leaf is split; a whole leaf's terms are the same on every
    rank, so its ratios are too): rows ``(update_rel, leaf, max_diff,
    max_excess, param_rel, passed)``, the worst first.  A leaf passes when
    its update is within ``TP_UPDATE_TOL`` rel. L2 of the reference's, or
    when no element of the two updates differs by more than
    ``TP_UPDATE_ULPS`` float32 spacings of the parameter plus
    ``TP_UPDATE_FLOOR`` (the k_proj biases: their exact gradient is zero,
    softmax ignoring a constant added to every key, so their updates are
    bf16's summation noise)."""
    rows = []
    for n, (sd, su, sp, dmax, excess) in sums.items():
        rel = math.sqrt(sd / su) if su > 0 else (0.0 if sd == 0
                                                 else math.inf)
        prel = math.sqrt(sd / sp) if sp > 0 else 0.0
        rows.append((rel, n, dmax, excess, prel,
                     rel <= TP_UPDATE_TOL or excess <= TP_UPDATE_FLOOR))
    return sorted(rows, reverse=True)


class _CopyNotSummed:
    """The control of (c): while entered, the model axis's ``copy`` hands
    back each rank's own share of its input's gradient, unsummed."""

    def __enter__(self):
        from diff3d_tpu_torch.parallel import tensor

        self._orig = tensor._Copy.backward
        tensor._Copy.backward = staticmethod(lambda ctx, g: (g, None))

    def __exit__(self, *exc):
        from diff3d_tpu_torch.parallel import tensor

        tensor._Copy.backward = self._orig


class _Sites:
    """The shapes the kernels are called at, counted, while it is entered:
    ``gn[(N, L, C, G, film, silu)]`` and ``attn[(B, Lq, Lk, H, D)]`` (the
    keys of ``record_sites``), read at the dispatch, after the model
    axis's layout moves (so a rank's blocks); ``calls[(op, grad)]``, the
    dispatches with and without autograd recording (a distill step's
    student and teacher), and ``plain``, those that ran a plain version
    (asked for, or a tensor off the card)."""

    def __init__(self):
        self.gn, self.attn, self.calls, self.plain = {}, {}, {}, 0

    def __enter__(self):
        import torch

        from diff3d_tpu_torch.ops import dispatch

        self._orig = orig = dispatch.dispatch

        def recording(op, requested, x, *args, **kwargs):
            key = (op, torch.is_grad_enabled())
            self.calls[key] = self.calls.get(key, 0) + 1
            self.plain += requested != "cuda" or not x.is_cuda
            if op == "groupnorm":
                N, L, C = x.shape
                key = (N, L, C, kwargs["num_groups"],
                       kwargs.get("scale") is not None,
                       bool(kwargs.get("silu", False)))
                self.gn[key] = self.gn.get(key, 0) + 1
            elif op == "sdpa":
                k = args[0]
                key = (x.shape[0], x.shape[1], k.shape[1], x.shape[2],
                       x.shape[3])
                self.attn[key] = self.attn.get(key, 0) + 1
            return orig(op, requested, x, *args, **kwargs)

        dispatch.dispatch = recording
        return self

    def __exit__(self, *exc):
        from diff3d_tpu_torch.ops import dispatch

        dispatch.dispatch = self._orig


def _sha1(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()
                        ).hexdigest()


def _tp_leaves(state):
    """``{name: tensor}`` of a train state: parameters (``model.``), EMA
    (``ema.``) and Adam's moments (``adam.<param>.<key>``)."""
    from diff3d_tpu_torch.train.checkpoint import state_leaves

    return {n: t for n, t in state_leaves(state)
            if not n.endswith(".step")}


# ---- distillation over the model axis: the tp and cp phases' legs ----------

DISTILL_LEG_K = 8               # the legs' student steps
DISTILL_LEG_STEPS = 1           # the legs' eager steps (cut from 2)
DISTILL_LEG_TOL = 1e-2          # losses, gradient norms, lrs (rel.): bf16
DISTILL_LEG_DIR = os.path.join(TP_WORKDIR, "distill")
DISTILL_LEG_TEACHER = os.path.join(TP_WORKDIR, "distill_teacher.pt")
# One rank's update over the legs' steps, and over the first (the
# controls' reference).
DISTILL_LEG_REF = os.path.join(TP_WORKDIR, "distill_ref.pt")
DISTILL_LEG_CONTROL_REF = os.path.join(TP_WORKDIR, "distill_control_ref.pt")


def _leg_cfg():
    """srn64 at global batch ``TP_BATCH``, its peak lr from the first
    step (no warmup): the legs' updates stay above the gate's floor."""
    cfg = _distill_cfg(TP_BATCH)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, warmup_examples=TP_BATCH))


def _leg_batches(cfg):
    return [train_batch(cfg, TP_BATCH, s)
            for s in range(1, 1 + DISTILL_LEG_STEPS)]


def distill_leg_prepare():
    """The distill legs' one-rank half (before the ranks).  The legs'
    mid-round start: the train checkpoint's EMA as teacher and student,
    one eager distill step at global batch ``TP_BATCH`` and k =
    ``DISTILL_LEG_K``, then Adam's state put where each update is linear
    in its gradient: the first moments 0, the second ``(2 max(g_leaf,
    1e-3 g_all))^2``, the count 1000 (no bias correction to speak of),
    with ``g_leaf`` the leaf's largest gradient element over the legs'
    steps (taken from this state first) and ``g_all`` the largest of all.
    Adam's own moments would not do: where they hold few gradients its
    update of an element is about ``lr * sign(g)``, and the distill
    loss's i = k samples (alpha_t ~ 4.5e-5) amplify eps^'s rounding into
    gradient elements whose sign is noise; under these the update's error
    is the gradient's (a leaf a thousandth of the largest moves less than
    the floor).  That state is written as a world-1 ``full`` checkpoint,
    the teacher's weights beside it; then ``DISTILL_LEG_STEPS`` steps from
    it, whose updates (the first, and all of them) the ranks' gates
    read."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import (CheckpointManager,
                                        create_train_state,
                                        make_distill_step)
    from diff3d_tpu_torch.train.checkpoint import state_leaves
    from diff3d_tpu_torch.train.state import set_schedule_step

    t0 = time.perf_counter()
    cfg = _leg_cfg()
    teacher_step, teacher = _teacher_ema(cfg)
    torch.save({k: v.cpu() for k, v in teacher.items()},
               DISTILL_LEG_TEACHER)
    student = XUNet(cfg.model).cuda()
    t_model = XUNet(cfg.model).cuda().eval().requires_grad_(False)
    with torch.no_grad():
        for m in (student, t_model):
            for name, p in m.named_parameters():
                p.copy_(teacher[name])
    del teacher
    state = create_train_state(student.eval(), cfg.train, capturable=False)
    step = make_distill_step(cfg)
    step(state, t_model, train_batch(cfg, TP_BATCH, 0), DISTILL_LEG_K)
    start_step = state.step
    saved = {n: t.detach().clone() for n, t in state_leaves(state)}
    gmax = {n: 0.0 for n, _ in student.named_parameters()}
    for batch in _leg_batches(cfg):
        step(state, t_model, batch, DISTILL_LEG_K)
        for n, p in student.named_parameters():
            gmax[n] = max(gmax[n], float(p.grad.abs().max()))
    g_all = max(gmax.values())
    with torch.no_grad():
        for n, t in state_leaves(state):
            t.copy_(saved[n])
        for n, p in student.named_parameters():
            st = state.optimizer.state[p]
            st["exp_avg"].zero_()
            st["exp_avg_sq"].fill_((2 * max(gmax[n], 1e-3 * g_all)) ** 2)
            st["step"].fill_(1000.0)
    set_schedule_step(state, start_step)
    state.step = start_step
    del saved
    CheckpointManager(DISTILL_LEG_DIR).save(state)
    start = {n: p.detach().float().clone()
             for n, p in student.named_parameters()}
    out = {"teacher_step": teacher_step, "start_step": start_step,
           "grad_max": g_all, "grad_max_by_leaf": gmax, "losses": [],
           "grad_norms": [], "lrs": [], "step_s": []}
    for i, batch in enumerate(_leg_batches(cfg)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = step(state, t_model, batch, DISTILL_LEG_K)
        out["losses"].append(float(m["distill_loss"]))
        out["step_s"].append(time.perf_counter() - t1)
        out["grad_norms"].append(float(m["grad_norm"]))
        out["lrs"].append(float(m["lr"]))
        if i == 0:
            torch.save({n: (p.detach().float() - start[n]).cpu()
                        for n, p in student.named_parameters()},
                       DISTILL_LEG_CONTROL_REF)
    torch.save({n: (p.detach().float() - start[n]).cpu()
                for n, p in student.named_parameters()}, DISTILL_LEG_REF)
    del state, student, t_model, start
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def _leg_sums(env, model, start, ref_path):
    """:func:`_update_sums` of every parameter of ``model`` (this rank's
    blocks) against one rank's update in ``ref_path`` (its blocks of
    it)."""
    import torch

    from diff3d_tpu_torch.parallel.mesh import block_of

    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)
    sums = {}
    for n, p in model.named_parameters():
        d = env._model_dims.get(n)
        r = ref[n] if d is None else block_of(
            ref[n], d, env.model_rank, env.model_size, n in env._halved)
        sums[n] = _update_sums(p.detach(), start[n] + r.to("cuda"),
                               start[n])
    return sums


def distill_leg(env, control) -> dict:
    """One rank's distill leg of phase ``tensor_parallel`` or
    ``context_parallel`` over ``env``: the teacher and the student placed
    by ``env.params`` (the student restored from the world-1 mid-round
    checkpoint through ``CheckpointManager``, the teacher's whole weights
    copied in as this rank's blocks), ``DISTILL_LEG_STEPS`` eager distill
    steps at k = ``DISTILL_LEG_K`` on the one-rank run's batches (the
    launch counts set to 0 before, read after; the dispatches recorded),
    each parameter's update against one rank's; then back to the start in
    place, and the first step retaken inside ``control`` (a mutation that
    the gate must refuse, which leaves the loss as it was)."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import (CheckpointManager,
                                        create_train_state,
                                        make_distill_step)
    from diff3d_tpu_torch.train.checkpoint import state_leaves
    from diff3d_tpu_torch.train.distill import _load_teacher
    from diff3d_tpu_torch.train.state import set_schedule_step

    marks = {"start": time.perf_counter()}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the control's loss
    cfg = _leg_cfg()
    t_model = env.params(XUNet(cfg.model).cuda().eval()
                         .requires_grad_(False))
    _load_teacher(t_model, torch.load(DISTILL_LEG_TEACHER,
                                      map_location="cpu", mmap=True,
                                      weights_only=True), env)
    state = create_train_state(env.params(XUNet(cfg.model).cuda()).eval(),
                               cfg.train, capturable=False)
    mgr = CheckpointManager(DISTILL_LEG_DIR)
    mgr.mesh_info = env.topology_summary()
    if env.tensor_parallel:
        mgr.placement = env
    start_step = mgr.restore(state)
    saved = {n: t.detach().clone() for n, t in state_leaves(state)}
    start = {n: p.detach().float().clone()
             for n, p in state.model.named_parameters()}
    step = make_distill_step(cfg, env=env)
    batches = _leg_batches(cfg)
    marks["build"] = time.perf_counter()
    out = {"start_step": start_step, "losses": [], "grad_norms": [],
           "lrs": [], "step_s": [], "eager": not step.cuda_graphs}
    sites = _Sites()
    _launch_counts(reset=True, split=True)
    with sites:
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, t_model, batch, DISTILL_LEG_K)
            out["losses"].append(float(m["distill_loss"]))
            out["step_s"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(m["grad_norm"]))
            out["lrs"].append(float(m["lr"]))
    out["launches"] = _launch_counts(split=True)
    out["sites"] = {"gn": sites.gn, "attn": sites.attn}
    out["calls"] = {f"{op}{'' if grad else '@no_grad'}": n
                    for (op, grad), n in sites.calls.items()}
    out["plain_calls"] = sites.plain
    marks["steps"] = time.perf_counter()
    out["sums"] = _leg_sums(env, state.model, start, DISTILL_LEG_REF)
    marks["gate"] = time.perf_counter()
    with torch.no_grad():
        for n, t in state_leaves(state):
            t.copy_(saved[n])
    set_schedule_step(state, start_step)
    state.step = start_step
    del saved
    with control:
        m = step(state, t_model, batches[0], DISTILL_LEG_K)
    out["control"] = {
        "loss": float(m["distill_loss"]), "grad_norm": float(m["grad_norm"]),
        "sums": _leg_sums(env, state.model, start, DISTILL_LEG_CONTROL_REF)}
    marks["control"] = time.perf_counter()
    del state, t_model, start, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = was
    names = list(marks)
    out["marks_s"] = {n: round(marks[n] - marks[p], 3)
                      for p, n in zip(names, names[1:])}
    return out


def _leg_summary(leg_ranks, one, sums_of):
    """The legs' gates over the ranks' results: the losses, norms and lrs
    against one rank's (``DISTILL_LEG_TOL``), the update gate
    (``sums_of``: the ranks' sums -> a leaf's), its control's, and the
    control's loss against the sound first step's."""
    rel = max(abs(a - b) / max(abs(b), 1e-30) for r in leg_ranks
              for k in ("losses", "grad_norms", "lrs")
              for a, b in zip(r[k], one[k]))
    gate = _update_gate(sums_of([r["sums"] for r in leg_ranks]))
    ctl = _update_gate(sums_of([r["control"]["sums"] for r in leg_ranks]))
    return {"k": DISTILL_LEG_K, "steps": DISTILL_LEG_STEPS,
            "global_batch": TP_BATCH, "from_step": leg_ranks[0]["start_step"],
            "teacher": f"the train checkpoint's EMA (step "
                       f"{one['teacher_step']})",
            "eager": all(r["eager"] for r in leg_ranks),
            "losses": [r["losses"] for r in leg_ranks],
            "one_rank_losses": one["losses"],
            "grad_norms": [r["grad_norms"] for r in leg_ranks],
            "one_rank_grad_norms": one["grad_norms"],
            "lrs": [r["lrs"] for r in leg_ranks], "one_rank_lrs": one["lrs"],
            "loss_rel": rel, "loss_tolerance": DISTILL_LEG_TOL,
            "update_gate": _gate_summary(gate),
            "control": {"loss": [r["control"]["loss"] for r in leg_ranks],
                        "grad_norm": [r["control"]["grad_norm"]
                                      for r in leg_ranks],
                        "loss_equals_sound_step": all(
                            r["control"]["loss"] == r["losses"][0]
                            for r in leg_ranks),
                        "leaves_failed": sum(not row[5] for row in ctl),
                        "update_gate": _gate_summary(ctl)},
            "s_per_step": [r["step_s"] for r in leg_ranks],
            "one_rank_s_per_step": one["step_s"],
            "calls": [r["calls"] for r in leg_ranks],
            "plain_calls": [r["plain_calls"] for r in leg_ranks],
            "launches": [r["launches"] for r in leg_ranks],
            "rank_marks_s": [r["marks_s"] for r in leg_ranks]}


def _check_leg(phase, leg, rows, zero=()):
    """Raise unless the leg held: its gates, its control refused with the
    loss unchanged, every kernel of ``rows`` launched on each rank, those
    of ``zero`` and every plain version never."""
    gate = leg["update_gate"]
    if not (leg["loss_rel"] <= DISTILL_LEG_TOL and not gate["failed"]
            and leg["eager"]):
        raise AssertionError(f"{phase}: the distill leg off one rank: "
                             f"losses and norms {leg['loss_rel']}, "
                             f"{gate['failed']} updates, e.g. "
                             f"{gate['failed_leaves'][:3]}")
    ctl = leg["control"]
    if ctl["leaves_failed"] == 0 or not ctl["loss_equals_sound_step"]:
        raise AssertionError(f"{phase}: the distill leg's control: "
                             f"{ctl['leaves_failed']} leaves refused, "
                             f"losses {ctl['loss']} vs {leg['losses']}")
    if any(r[k] == 0 for r in leg["launches"] for k in rows) or any(
            r[k] for r in leg["launches"] for k in zero) or any(
            leg["plain_calls"]) or any(
            not (c.get("groupnorm") and c.get("groupnorm@no_grad")
                 and c.get("sdpa") and c.get("sdpa@no_grad"))
            for c in leg["calls"]):
        raise AssertionError(f"{phase}: the distill leg's launches "
                             f"{leg['launches']}, calls {leg['calls']}, "
                             f"plain {leg['plain_calls']}")


def tp_rank(rank: int, world: int, workdir: str) -> dict:
    """One rank of phase ``tensor_parallel`` (see the module docstring,
    11a'), on the card with the other rank over gloo."""
    import torch
    import torch.distributed as dist

    from diff3d_tpu_torch.config import MeshConfig, srn64_config
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.parallel.mesh import block_of
    from diff3d_tpu_torch.sampling import Sampler

    marks = {"start": time.perf_counter()}
    torch.cuda.set_device(0)
    group = dist.group.WORLD
    cfg = srn64_config()
    tp = MeshConfig(model_parallel=world, param_sharding="tp")
    env = make_mesh(tp)
    model = env.params(random_model(cfg))
    marks["model"] = time.perf_counter()
    axis = env.model_axis
    batch, cond_mask = model_batch(cfg, 2 * len(cfg.diffusion.guidance_weights),
                                   seed=5)
    out = {"rank": rank, "model_rank": env.model_rank,
           "backend": dist.get_backend(group), "gloo": axis.gloo}

    # The sampling path: (a) one forward, (b) one Sampler(mesh) view.
    _launch_counts(reset=True)
    sample_sites = _Sites()
    with torch.inference_mode():
        axis.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sample_sites:
            fwd = model(batch, cond_mask)
        torch.cuda.synchronize()
    out["ms_per_forward"] = 1e3 * (time.perf_counter() - t0)
    out["forward"] = fwd.float().cpu()
    out["collectives_per_forward"] = dict(axis.stats)
    marks["a_forward"] = time.perf_counter()
    cfg32, f32 = _tp_f32(cfg, model)
    sampler = Sampler(f32, cfg32, device="cuda", mesh=env,
                      sampler_kind="ddim", steps=TP_SAMPLER_STEPS)
    views = orbit_views(2, cfg.model.H, seed=3)
    t0 = time.perf_counter()
    with _NoTF32():
        out["views"] = sampler.synthesize(views, torch.Generator(
            "cuda").manual_seed(0))
    out["sampler_s"] = time.perf_counter() - t0
    out["sampler_graphs"] = sampler.cuda_graphs
    out["launches_sampling"] = _launch_counts()
    marks["b_sampler"] = time.perf_counter()
    del sampler, f32, model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The Trainer under tp, TP_STEPS eager steps from the train
    # checkpoint.
    trainer = _tp_trainer(_tp_argv(workdir, "--param_sharding", "tp",
                                   "--model_parallel", str(world)))
    tenv = trainer.env
    out["restored_step"] = trainer.state.step
    out["eager"] = not trainer.step_fn.cuda_graphs
    point = _rewind_point(trainer)
    train_sites = _Sites()
    step_s, coll, got = [], [], ([], [], [], [])
    marks["c_build"] = time.perf_counter()
    _launch_counts(reset=True)
    for i in range(TP_STEPS):
        tenv.model_axis.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with train_sites:
                one = _tp_steps(trainer, 1)
        else:
            one = _tp_steps(trainer, 1)
        for acc, v in zip(got, one):
            acc += v
        step_s.append(time.perf_counter() - t0)
        coll.append(dict(tenv.model_axis.stats))
    out["launches_training"] = _launch_counts()
    out["losses"], out["grad_norms"], out["lrs"], batches = got
    out["step_s"], out["collectives_per_step"] = step_s, coll
    marks["c_steps"] = time.perf_counter()
    trainer.ckpt.save(trainer.state, force=True)
    marks["c_save"] = time.perf_counter()
    out["saved_step"] = trainer.state.step
    out["hashes"] = {n: _sha1(t) for n, t in
                     _tp_leaves(trainer.state).items()}
    out["model_dims"] = dict(tenv._model_dims)
    out["halved"] = sorted(tenv._halved)
    marks["d_hash"] = time.perf_counter()

    # (c) The control: back to the checkpoint's state, the first step
    # retaken on its batch with ``copy``'s gradient unsummed; this rank's
    # terms of the gate against one rank's first update
    # (``TP_CONTROL_REF``).
    _rewind(trainer, point)
    del point
    marks["c_restore"] = time.perf_counter()
    start = _tp_params(trainer)
    with _CopyNotSummed():
        ctl = _tp_steps(trainer, 1, batches)
    ref = torch.load(TP_CONTROL_REF, map_location="cpu", mmap=True,
                     weights_only=True)
    sums = {}
    for n, p in trainer.state.model.named_parameters():
        d = tenv._model_dims.get(n)
        r = ref[n] if d is None else block_of(
            ref[n], d, tenv.model_rank, world, n in tenv._halved)
        sums[n] = _update_sums(p.detach(), start[n] + r.to("cuda"),
                               start[n])
    out["control"] = {"loss": ctl[0][0], "grad_norm": ctl[1][0],
                      "lr": ctl[2][0], "sums": sums}
    del start, ref, batches
    trainer.loader.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    marks["c_control"] = time.perf_counter()

    # (f) The distill leg; its control: copy's backward unsummed.
    out["distill"] = distill_leg(env, _CopyNotSummed())
    marks["f_distill"] = time.perf_counter()

    # (e) Rows 1-6 at a rank's sites (and rows 1 and 3 without statistics
    # at the train sites: the distill teacher's), on rank 0 while rank 1
    # waits: the ranks' sites are the same shapes (equal blocks), and the
    # inputs are seeded by shape, so a pass on rank 1 would repeat rank
    # 0's.
    out["sample_sites"] = {"gn": sample_sites.gn, "attn": sample_sites.attn}
    out["train_sites"] = {"gn": train_sites.gn, "attn": train_sites.attn}
    dist.barrier(group)
    if rank == 0:
        t0 = time.perf_counter()
        out["gn"] = phase_groupnorm(sample_sites.gn,
                                    phase="tp_groupnorm",
                                    odd_shapes=False)
        out["attn"] = phase_attention(sample_sites.attn,
                                      phase="tp_attention",
                                      extra_shapes=False)
        out["gn_fwd"], out["gn_bwd"] = phase_groupnorm_backward(
            train_sites.gn, 1, phase="tp_groupnorm_backward",
            edges=False, f32_max_n=2)
        out["attn_rows"] = phase_attention_backward(
            train_sites.attn, 1, phase="tp_attention_backward",
            extra_shapes=False, f32_max_n=2)
        out["distill_gn"] = phase_groupnorm(
            train_sites.gn, phase="tp_distill_groupnorm",
            odd_shapes=False)
        out["distill_attn"] = phase_attention(
            train_sites.attn, phase="tp_distill_attention",
            extra_shapes=False)
        out["sites_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    dist.barrier(group)
    marks["e_sites"] = time.perf_counter()
    names = list(marks)
    out["marks_s"] = {n: round(marks[n] - marks[p], 3)
                      for p, n in zip(names, names[1:])}
    return out


def gloo_rank(rank: int, world: int, tp_workdir: str,
              cp_workdir: str) -> dict:
    """One of phase ``parallel`` (c)'s two processes: its ring and
    Ulysses rank, then phase ``tensor_parallel``'s rank, phase
    ``context_parallel``'s, then phase ``serve_mesh``'s."""
    t0 = time.perf_counter()
    ring = ring_rank(rank, world)
    t1 = time.perf_counter()
    tp = tp_rank(rank, world, tp_workdir)
    t2 = time.perf_counter()
    cp = cp_rank(rank, world, cp_workdir)
    t3 = time.perf_counter()
    mesh = serve_mesh_rank(rank, world)
    return {"ring": ring, "ring_s": t1 - t0, "tp": tp, "tp_s": t2 - t1,
            "cp": cp, "cp_s": t3 - t2, "mesh": mesh,
            "mesh_s": time.perf_counter() - t3}


def tp_prepare():
    """Phase ``tensor_parallel``'s start, before its ranks: the workdirs
    with the train phase's latest checkpoint, and the one-rank references
    of (a)-(c) on this process."""
    import torch

    from diff3d_tpu_torch.config import srn64_config

    t0 = time.perf_counter()
    cfg = srn64_config()
    shutil.rmtree(TP_WORKDIR, ignore_errors=True)
    src = os.path.join(WORKDIR, "checkpoints")
    step0 = max(int(m.group(1)) for m in map(
        re.compile(r"^ckpt_(\d+)\.pt$").match, os.listdir(src)) if m)
    wd = {}
    for k in ("one", "tp", "cp"):
        wd[k] = os.path.join(TP_WORKDIR, k)
        os.makedirs(os.path.join(wd[k], "checkpoints"))
        os.link(os.path.join(src, f"ckpt_{step0}.pt"),
                os.path.join(wd[k], "checkpoints", f"ckpt_{step0}.pt"))
    one = _tp_one_rank(cfg, wd["one"])
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    return {"workdir": wd["tp"], "cp_workdir": wd["cp"], "one": one,
            "distill": distill_leg_prepare(), "one_rank_s": one_s}


def _tp_one_rank(cfg, workdir):
    """The one-rank references of (a)-(c) on the card (the trainer of (c)
    is returned alive: (d) restores into it)."""
    import torch

    from diff3d_tpu_torch.sampling import Sampler

    model = random_model(cfg)
    batch, cond_mask = model_batch(cfg, 2 * len(cfg.diffusion.guidance_weights),
                                   seed=5)
    with torch.inference_mode():
        fwd = model(batch, cond_mask).float().cpu()
        ms = cuda_ms(lambda: model(batch, cond_mask), iters=3, warmup=1)
    cfg32, f32 = _tp_f32(cfg, model)
    views = {}
    for steps in sorted({TP_SAMPLER_STEPS, CP_SAMPLER_STEPS}):
        sampler = Sampler(f32, cfg32, device="cuda", sampler_kind="ddim",
                          steps=steps, cuda_graphs=False)
        with _NoTF32():
            views[steps] = sampler.synthesize(
                orbit_views(2, cfg.model.H, seed=3),
                torch.Generator("cuda").manual_seed(0))
    del sampler, f32, model
    trainer = _tp_trainer(_tp_argv(workdir))
    start = _tp_params(trainer)
    losses, norms, lrs, _ = _tp_steps(trainer, 1)
    params = {1: _tp_params(trainer)}
    # The controls' reference: one rank's first update.
    torch.save({n: (p - start[n]).cpu() for n, p in params[1].items()},
               TP_CONTROL_REF)
    # The context phase's (e): the last step's peak above what it starts
    # with (the state, the gradient bucket, whatever else is resident).
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    more = _tp_steps(trainer, CP_STEPS - 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    trainer.loader.close()
    params[CP_STEPS] = _tp_params(trainer)
    # The context phase's (c) reference, read by its ranks.
    torch.save({n: p.cpu() for n, p in params[CP_STEPS].items()}, CP_REF)
    return {"forward": fwd, "ms_per_forward": ms, "views": views,
            "losses": losses + more[0], "grad_norms": norms + more[1],
            "lrs": lrs + more[2], "start": start, "params": params,
            "step_peak_above_state": peak, "trainer": trainer}


def _gate_summary(rows):
    """What the kernels line's reader needs of :func:`_update_gate`'s
    rows: the counts, the worst leaves by update and by parameter, and
    the leaves passed by the floor alone."""
    floor = [r for r in rows if r[0] > TP_UPDATE_TOL and r[5]]
    beyond = [r for r in rows if r[3] > TP_UPDATE_FLOOR]
    return {"leaves": len(rows), "failed": sum(not r[5] for r in rows),
            "row": "update rel, leaf, max diff, max excess over the "
                   "spacings, param rel",
            "tolerance": TP_UPDATE_TOL, "floor_abs": TP_UPDATE_FLOOR,
            "floor_ulps": TP_UPDATE_ULPS,
            "worst_update_rel": [r[:5] for r in rows[:5]],
            "beyond_floor": {"count": len(beyond),
                             "worst": [r[:5] for r in beyond[:5]]},
            "worst_param_rel": [r[:5] for r in sorted(
                rows, key=lambda r: r[4], reverse=True)[:3]],
            "passed_by_floor": {
                "count": len(floor),
                "k_proj_biases": sum(r[1].endswith("k_proj.bias")
                                     for r in floor),
                "max_diff": max((r[2] for r in floor), default=0.0),
                "max_excess": max((r[3] for r in floor), default=0.0),
                "worst": [r[:5] for r in floor[:5]]},
            "failed_leaves": [r[:5] for r in rows if not r[5]][:8]}


def phase_tensor_parallel(prep, ranks, ranks_s):
    """Tensor parallelism on the card (see the module docstring, 11a'):
    ``prep`` is :func:`tp_prepare`'s, ``ranks`` the ranks' results of
    :func:`tp_rank` (run by phase ``parallel``'s processes, ``ranks_s``
    seconds)."""
    import torch

    from diff3d_tpu_torch.parallel.mesh import block_of
    from diff3d_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    one, one_s = prep["one"], prep["one_rank_s"]
    wd = {"tp": prep["workdir"]}

    # (a) and (b) against one rank.
    fwd_rel = max(_rel_l2(r["forward"], one["forward"]) for r in ranks)
    view_rel = max(_rel_l2(r["views"], one["views"][TP_SAMPLER_STEPS])
                   for r in ranks)
    finite = all(torch.isfinite(r["forward"]).all()
                 and np.isfinite(r["views"]).all() for r in ranks)
    # (d) The tp checkpoint (gathered, written by rank 0) restored at
    # world 1, into the one-rank trainer: each rank's blocks of every
    # restored tensor bit for bit the rank's own.
    r0 = ranks[0]
    saved_step = r0["saved_step"]
    trainer = one.pop("trainer")
    mgr = CheckpointManager(os.path.join(wd["tp"], "checkpoints"))
    mgr.mesh_info = trainer.env.topology_summary()
    restored_step = mgr.restore(trainer.state)
    reshard = mgr.last_restore_reshard
    mesh_stamp = None if reshard is None else reshard["from"]
    leaves = _tp_leaves(trainer.state)
    # (c) The losses, the gradient norms and the lrs against one rank's,
    # and each parameter's update over the steps against one rank's
    # (:func:`_update_gate`); the control must fail that gate.
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for r in ranks
                   for k in ("losses", "grad_norms", "lrs")
                   for a, b in zip(r[k], one[k]))
    gate = _update_gate({
        n: _update_sums(leaves[f"model.{n}"], p, one["start"][n])
        for n, p in one["params"][TP_STEPS].items()})
    ctl_gate = _update_gate(_summed([r["control"]["sums"] for r in ranks]))
    differ = []
    for r in ranks:
        dims, halved = r["model_dims"], set(r["halved"])
        for n, t in leaves.items():
            pname = n.split(".", 1)[1]
            if n.startswith("adam."):
                pname = pname.rsplit(".", 1)[0]
            d = dims.get(pname)
            mine = t if d is None else block_of(
                t, d, r["model_rank"], TP_WORLD, pname in halved)
            if _sha1(mine) != r["hashes"][n]:
                differ.append((r["rank"], n))
    del trainer, leaves
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TP_WORKDIR, ignore_errors=True)

    sample_rows = ("fused_groupnorm", "flash_attention")
    train_rows = ("fused_groupnorm", "groupnorm_backward", "flash_attention",
                  "attention_backward_dkdv", "attention_backward_dq")
    launched = all(r["launches_sampling"][k] > 0 for r in ranks
                   for k in sample_rows) and all(
        r["launches_training"][k] > 0 for r in ranks for k in train_rows)
    # (f) The distill leg against one rank, each leaf's terms summed over
    # the ranks' blocks.
    leg = _leg_summary([r["distill"] for r in ranks], prep["distill"],
                       _summed)
    leg["at_train_sites"] = all(
        set(r["distill"]["sites"][k]) == set(r["train_sites"][k])
        for r in ranks for k in ("gn", "attn"))

    def per(r, key):
        c = r[key]
        return {"calls": c["calls"], "bytes": c["bytes"],
                "ms": round(1e3 * c["seconds"], 3)}

    out = {"config": "srn64", "mesh": "dp1 x mp2, tp",
           "transport": "gloo, 2 ranks on one card: each collective's CUDA "
                        "tensors staged through pinned host memory "
                        "(one broadcast per rank's block)",
           "backend": r0["backend"], "gloo": r0["gloo"],
           "forward": {"batch": int(one["forward"].shape[0]),
                       "rel_l2_vs_one_rank": fwd_rel, "tolerance": TP_TOL,
                       "ms_per_forward": [round(r["ms_per_forward"], 3)
                                          for r in ranks],
                       "one_rank_ms_per_forward": one["ms_per_forward"],
                       "collectives_per_forward": [
                           per(r, "collectives_per_forward")
                           for r in ranks]},
           "sampler": {"views": 1, "ddim_steps": TP_SAMPLER_STEPS,
                       "dtype": "float32",
                       "rel_l2_vs_one_rank": view_rel, "tolerance": TP_TOL,
                       "s": [round(r["sampler_s"], 3) for r in ranks],
                       "graphs": [r["sampler_graphs"] for r in ranks]},
           "train": {"from_step": r0["restored_step"],
                     "global_batch": TP_BATCH, "steps": TP_STEPS,
                     "eager": all(r["eager"] for r in ranks),
                     "losses": [r["losses"] for r in ranks],
                     "one_rank_losses": one["losses"],
                     "grad_norms": [r["grad_norms"] for r in ranks],
                     "one_rank_grad_norms": one["grad_norms"],
                     "lrs": [r["lrs"] for r in ranks],
                     "one_rank_lrs": one["lrs"],
                     "loss_rel": loss_rel, "loss_tolerance": TP_LOSS_TOL,
                     "update_gate": _gate_summary(gate),
                     "control": {
                         "what": "the first step retaken from the "
                                 "checkpoint with copy's backward not "
                                 "summed over the model axis",
                         "loss": [r["control"]["loss"] for r in ranks],
                         "grad_norm": [r["control"]["grad_norm"]
                                       for r in ranks],
                         "one_rank_loss": one["losses"][0],
                         "one_rank_grad_norm": one["grad_norms"][0],
                         "update_gate": _gate_summary(ctl_gate)},
                     "s_per_step": [r["step_s"] for r in ranks],
                     "collectives_per_step": [
                         [{"calls": c["calls"], "bytes": c["bytes"],
                           "ms": round(1e3 * c["seconds"], 3)}
                          for c in r["collectives_per_step"]]
                         for r in ranks]},
           "checkpoint": {"saved_step": saved_step,
                          "restored_at_world_1_step": restored_step,
                          "mesh": mesh_stamp, "reshard": reshard,
                          "tensors_compared": len(r0["hashes"]) * TP_WORLD,
                          "blocks_differing": len(differ)},
           "launches_sampling": [{k: r["launches_sampling"][k]
                                  for k in sample_rows} for r in ranks],
           "launches_training": [{k: r["launches_training"][k]
                                  for k in train_rows} for r in ranks],
           "sites": {"sampling": {k: {str(kk): v for kk, v in
                                      r0["sample_sites"][k].items()}
                                  for k in ("gn", "attn")},
                     "training": {k: {str(kk): v for kk, v in
                                      r0["train_sites"][k].items()}
                                  for k in ("gn", "attn")}},
           "sites_s": [round(r["sites_s"], 3) for r in ranks
                       if "sites_s" in r],
           "rank_marks_s": [r["marks_s"] for r in ranks],
           "distill": leg,
           "one_rank_s": round(one_s, 3), "ranks_s": round(ranks_s, 3),
           "distill_one_rank_s": round(prep["distill"]["s"], 3),
           "phase_s": round(one_s + prep["distill"]["s"] + ranks_s
                            + time.perf_counter() - t_phase, 3)}
    emit(dict(phase="tensor_parallel", **out))
    if not (finite and fwd_rel <= TP_TOL and view_rel <= TP_TOL):
        raise AssertionError(f"tensor_parallel: forward {fwd_rel}, views "
                             f"{view_rel}, finite {finite}")
    failed = [row[:5] for row in gate if not row[5]]
    if not (loss_rel <= TP_LOSS_TOL and not failed
            and out["train"]["eager"]):
        raise AssertionError(f"tensor_parallel: training off one rank: "
                             f"losses and norms {loss_rel}, "
                             f"{len(failed)} updates, e.g. {failed[:3]}")
    if all(row[5] for row in ctl_gate):
        raise AssertionError("tensor_parallel: the update gate passed the "
                             "control (copy's gradient unsummed)")
    if differ or restored_step != saved_step or not reshard:
        raise AssertionError(f"tensor_parallel: the checkpoint round trip: "
                             f"{len(differ)} blocks differ, e.g. "
                             f"{differ[:3]}; step {restored_step}")
    if not launched:
        raise AssertionError(f"tensor_parallel: a row was not launched: "
                             f"{out['launches_sampling']}, "
                             f"{out['launches_training']}")
    _check_leg("tensor_parallel", leg, train_rows)
    if not leg["at_train_sites"]:
        raise AssertionError("tensor_parallel: the distill leg's sites are "
                             "not the train step's")

    # The kernels line: the times and errors of the rank that timed the
    # sites (rank 0), rank 0's launches.
    def slowest(key, sub=None):
        rows = [r[key] if sub is None else r[key][sub] for r in ranks
                if key in r]
        got = dict(rows[0])
        for k in ("ms", "device_ms", "plain_ms", "library_ms"):
            if k in got:
                got[k] = max(r[k] for r in rows)
        got["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return got

    out["kernel_stats"] = {
        "fused_groupnorm@tp": slowest("gn"),
        "fused_groupnorm[save_stats]@tp": slowest("gn_fwd"),
        "groupnorm_backward@tp": slowest("gn_bwd"),
        "flash_attention@tp": slowest("attn"),
        "flash_attention[save_lse]@tp": slowest("attn_rows", "lse"),
        "attention_backward_dkdv@tp": slowest("attn_rows", "dkdv"),
        "attention_backward_dq@tp": slowest("attn_rows", "dq"),
        # The distill leg: the student's rows at the train step's sites
        # (the same shapes), the teacher's two forwards.
        "fused_groupnorm@tp_distill": _scaled(slowest("distill_gn"), 2),
        "fused_groupnorm[save_stats]@tp_distill": slowest("gn_fwd"),
        "groupnorm_backward@tp_distill": slowest("gn_bwd"),
        "flash_attention@tp_distill": _scaled(slowest("distill_attn"), 2),
        "flash_attention[save_lse]@tp_distill": slowest("attn_rows", "lse"),
        "attention_backward_dkdv@tp_distill": slowest("attn_rows", "dkdv"),
        "attention_backward_dq@tp_distill": slowest("attn_rows", "dq")}
    ld = r0["distill"]["launches"]
    out["kernel_launches"] = {
        f"{k}@tp_distill": ld[k.split("[")[0]] for k in (
            "fused_groupnorm", "fused_groupnorm[save_stats]",
            "groupnorm_backward", "flash_attention",
            "flash_attention[save_lse]", "attention_backward_dkdv",
            "attention_backward_dq")}
    ls, lt = r0["launches_sampling"], r0["launches_training"]
    out["kernel_launches"].update({
        "fused_groupnorm@tp": ls["fused_groupnorm"],
        "fused_groupnorm[save_stats]@tp": lt["fused_groupnorm"],
        "groupnorm_backward@tp": lt["groupnorm_backward"],
        "flash_attention@tp": ls["flash_attention"],
        "flash_attention[save_lse]@tp": lt["flash_attention"],
        "attention_backward_dkdv@tp": lt["attention_backward_dkdv"],
        "attention_backward_dq@tp": lt["attention_backward_dq"]})
    return out


# ---- context parallelism: the image rows over 2 ranks on the card -----------

CP_MEMORY_RATIO = 0.75          # (e): a rank's activation peak over one's
# (c)'s reference: one rank's parameters after its CP_STEPS steps (the
# one-rank trainer of tp_prepare, from the same checkpoint and batches).
CP_REF = os.path.join(TP_WORKDIR, "one_params.pt")
SPLIT_SUM_TOL = 1e-9            # (b): the f64 sums, relative to 1 + max|ref|
CP_TP_STATE_RATIO = 0.6         # (g): a cp + tp rank's state bytes over cp's


class _HaloNotAdded:
    """The control of the context phase (c): while entered, the halo's
    backward drops the gradient its neighbours send back for a rank's edge
    rows (the add removed), keeping only the rank's own."""

    def __enter__(self):
        from diff3d_tpu_torch.parallel import context

        self._orig = context._Halo.backward

        def backward(ctx, g):
            import torch

            k = ctx.k
            # The same collective as the sound backward, its result unused.
            ctx.rows.parts(torch.stack([g[:, :k], g[:, -k:]]).contiguous())
            return g[:, k:-k].clone(), None, None

        context._Halo.backward = staticmethod(backward)

    def __exit__(self, *exc):
        from diff3d_tpu_torch.parallel import context

        context._Halo.backward = self._orig


def split_gn_work(N, L, C, G, film, silu, itemsize=2):
    """``{entry: (f32 flops, bytes)}`` of the four split-statistics entry
    points at one site, for their bounds: each input read once, each
    output written once ((a) x in, [2, N, G] f64 out; (b) x, scale, shift
    in, the output and the f32 statistics out; (c) x, g, scale (and shift
    under SiLU) in, the [2, N, G] sums and [N, C] partials out; (d) the
    same in, dx (and dscale, dshift) out)."""
    e = N * L * C
    films = (2 if film else 0)
    bwd_in = 2 + (1 if film else 0) + (1 if film and silu else 0)
    return {
        "groupnorm_partial_sums": (3.0 * e, itemsize * e + 16 * N * G),
        "groupnorm_apply_sums": (10.0 * e, itemsize * e * (2 + films)
                                 + 8 * C + 16 * N * G + 8 * N * G),
        "groupnorm_backward_partial_sums": (
            30.0 * e, itemsize * e * bwd_in + 8 * C + 8 * N * G
            + 8 * N * G + 8 * N * C),
        "groupnorm_backward_apply_sums": (
            30.0 * e, itemsize * e * (bwd_in + 1 + films) + 8 * C
            + 16 * N * G)}


def phase_split_groupnorm(gn_sites, phase="cp_groupnorm"):
    """The split-statistics GroupNorm (``cuda_film``'s entry points (a)-(d))
    at the sites one rank of the context phase gives them (its rows of
    each sample): each against its plain version on the same inputs, in
    bf16 and f32, the sums and statistics bit-identical over two runs;
    then each timed in bf16 beside its bound and plain version, and the
    forward pair and the backward pair beside ``F.group_norm`` + FiLM /
    SiLU (forward, and its autograd backward) on the same rows.  Per
    forward / train step: every site once (no remat)."""
    import torch
    import torch.nn.functional as F

    from diff3d_tpu_torch.ops import cuda_film as f

    names = ("groupnorm_partial_sums", "groupnorm_apply_sums",
             "groupnorm_backward_partial_sums",
             "groupnorm_backward_apply_sums")
    acc = {n: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
           for n in names}
    lib_fwd, lib_bwd = 0.0, 0.0
    worst, checked, sites = 0.0, 0, []
    for si, ((N, L, C, G, film, silu), count) in enumerate(
            sorted(gn_sites.items())):
        for dtype in (torch.bfloat16, torch.float32):
            x, gamma, beta, kw = gn_inputs((N, L, C, G), dtype, film,
                                           90 + si)
            sc, sh = kw.get("scale"), kw.get("shift")
            gen = torch.Generator("cuda").manual_seed(95 + si)
            g = torch.randn(N, L, C, generator=gen, device="cuda").to(dtype)
            length = 2 * L            # a rank of two: its rows and the other's

            def run():
                s = f.groupnorm_partial_sums(x, num_groups=G)
                out, st = f.groupnorm_apply_sums(
                    x, gamma, beta, sc, sh, 2 * s, length=length,
                    num_groups=G, silu=silu)
                bs, dg, db = f.groupnorm_backward_partial_sums(
                    x, g, gamma, beta, sc, sh, st, num_groups=G, silu=silu)
                d = f.groupnorm_backward_apply_sums(
                    x, g, gamma, beta, sc, sh, st, 2 * bs, length=length,
                    num_groups=G, silu=silu)
                return [s, out, st, bs, dg, db, *d]

            got, again = run(), run()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(got, again)):
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"{phase}: output {i} at "
                                         f"{(N, L, C, G)} differs run to run")
            s, out, st, bs, dg, db, dx, dsc, dsh = got
            want_s = f.groupnorm_partial_sums_reference(x, G)
            want_out, want_st = f.groupnorm_apply_sums_reference(
                x, gamma, beta, sc, sh, 2 * s, length=length, num_groups=G,
                silu=silu)
            want_b = f.groupnorm_backward_partial_sums_reference(
                x, g, gamma, beta, sc, sh, st, num_groups=G, silu=silu)
            want_d = f.groupnorm_backward_apply_sums_reference(
                x, g, gamma, beta, sc, sh, st, 2 * bs, length=length,
                num_groups=G, silu=silu)
            el = F32_TOL if dtype == torch.float32 else BF16_TOL
            pairs = [("groupnorm_partial_sums", s, want_s, SPLIT_SUM_TOL),
                     ("groupnorm_apply_sums", out, want_out, el),
                     ("groupnorm_apply_sums", st, want_st, F32_TOL),
                     ("groupnorm_backward_partial_sums", bs, want_b[0],
                      SUM_TOL),
                     ("groupnorm_backward_partial_sums", dg, want_b[1],
                      SUM_TOL),
                     ("groupnorm_backward_partial_sums", db, want_b[2],
                      SUM_TOL)]
            pairs += [("groupnorm_backward_apply_sums", a, b, el)
                      for a, b in zip((dx, dsc, dsh), want_d)
                      if b is not None]
            for name, a, b, tol in pairs:
                err, ratio = _err_over_tol(a, b, tol)
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"{phase}: {name} at {(N, L, C, G)} {dtype} film="
                        f"{film} silu={silu}: max abs err {err}")
                worst = max(worst, ratio)
                checked += 1
                if dtype == torch.bfloat16:
                    acc[name]["max_abs_err"] = max(acc[name]["max_abs_err"],
                                                   err)
        # Times in bf16 (the model's dtype), x etc. of the last bf16 run.
        x, gamma, beta, kw = gn_inputs((N, L, C, G), torch.bfloat16, film,
                                       90 + si)
        sc, sh = kw.get("scale"), kw.get("shift")
        g = torch.randn(N, L, C, generator=torch.Generator(
            "cuda").manual_seed(95 + si), device="cuda").to(x.dtype)
        s = 2 * f.groupnorm_partial_sums(x, num_groups=G)
        _, st = f.groupnorm_apply_sums(x, gamma, beta, sc, sh, s,
                                       length=2 * L, num_groups=G, silu=silu)
        bs = 2 * f.groupnorm_backward_partial_sums(
            x, g, gamma, beta, sc, sh, st, num_groups=G, silu=silu)[0]
        calls = {
            "groupnorm_partial_sums": (
                lambda: f.groupnorm_partial_sums(x, num_groups=G),
                lambda: f.groupnorm_partial_sums_reference(x, G)),
            "groupnorm_apply_sums": (
                lambda: f.groupnorm_apply_sums(
                    x, gamma, beta, sc, sh, s, length=2 * L, num_groups=G,
                    silu=silu),
                lambda: f.groupnorm_apply_sums_reference(
                    x, gamma, beta, sc, sh, s, length=2 * L, num_groups=G,
                    silu=silu)),
            "groupnorm_backward_partial_sums": (
                lambda: f.groupnorm_backward_partial_sums(
                    x, g, gamma, beta, sc, sh, st, num_groups=G, silu=silu),
                lambda: f.groupnorm_backward_partial_sums_reference(
                    x, g, gamma, beta, sc, sh, st, num_groups=G,
                    silu=silu)),
            "groupnorm_backward_apply_sums": (
                lambda: f.groupnorm_backward_apply_sums(
                    x, g, gamma, beta, sc, sh, st, bs, length=2 * L,
                    num_groups=G, silu=silu),
                lambda: f.groupnorm_backward_apply_sums_reference(
                    x, g, gamma, beta, sc, sh, st, bs, length=2 * L,
                    num_groups=G, silu=silu))}
        work = split_gn_work(N, L, C, G, film, silu)
        row = {"N": N, "L": L, "C": C, "G": G, "film": film, "silu": silu,
               "per_forward": count}
        for name, (kernel, plain) in calls.items():
            ms, pms = cuda_ms(kernel), cuda_ms(plain, iters=5, warmup=1)
            flops, nbytes = work[name]
            bound = _bound(acc[name], count, flops, F32_FLOPS, nbytes)
            acc[name]["ms"] += count * ms
            acc[name]["plain_ms"] += count * pms
            row[name] = {"us": round(ms * 1e3, 2),
                         "plain_us": round(pms * 1e3, 2),
                         "bound_us": round(bound * 1e3, 3)}
        # The library: F.group_norm + FiLM (+ SiLU) on the same rows, and
        # its autograd backward (a rank of two holds W / 2 rows of a W x W
        # level).
        W = math.isqrt(2 * L)

        def nchw(t):
            return t.reshape(N, L // W, W, C).permute(0, 3, 1, 2)

        x4 = nchw(x)
        gb, bb = gamma.to(x.dtype), beta.to(x.dtype)
        sc4, sh4 = (nchw(sc), nchw(sh)) if film else (None, None)

        def library(inp):
            y = F.group_norm(inp, G, gb, bb, 1e-5)
            if film:
                y = y * (1.0 + sc4) + sh4
            return F.silu(y) if silu else y

        lf = cuda_ms(lambda: library(x4))
        xl = x4.detach().clone().requires_grad_()
        yl = library(xl)
        gl = nchw(g)
        lb = cuda_ms(lambda: torch.autograd.grad(yl, xl, gl,
                                                 retain_graph=True))
        lib_fwd += count * lf
        lib_bwd += count * lb
        row["library_forward_us"] = round(lf * 1e3, 2)
        row["library_backward_us"] = round(lb * 1e3, 2)
        sites.append(row)
    stats = {}
    for name in names:
        st = _finish(acc[name])
        st["library_ms"] = (lib_fwd if name == "groupnorm_apply_sums" else
                            lib_bwd if name == "groupnorm_backward_apply_sums"
                            else None)
        stats[name] = st
    emit({"phase": phase, "checked": checked,
          "worst_err_over_tol": round(worst, 4),
          "tolerance": "sums f64 1e-9, f32 1e-4; elements f32 1e-5, bf16 "
                       "2^-7; statistics f32 1e-5; each *(1+max|ref|)",
          "bit_identical_run_to_run": True,
          "library": "F.group_norm + FiLM (+ SiLU) on the same rows "
                     "(apply_sums: the forward; backward_apply_sums: its "
                     "autograd backward)",
          "sites": sites, "per_forward": stats})
    return stats


def _state_bytes(state) -> dict:
    """The bytes this rank holds for ``state``'s parameters, Adam's
    moments and the EMA (local blocks and shards)."""
    import torch

    def nbytes(ts):
        ts = [getattr(t, "to_local", lambda: t)() for t in ts]
        return sum(t.numel() * t.element_size() for t in ts)

    adam = [t for st in state.optimizer.state.values() for t in st.values()
            if torch.is_tensor(t) and t.dim() > 0]
    return {"params": nbytes(state.model.parameters()), "adam": nbytes(adam),
            "ema": nbytes(state.ema.values())}


def _cp_tp_forward(cfg, world, batch, cond_mask, want) -> dict:
    """(g) one bf16 forward at 2B = 16 of :func:`random_model` placed
    under cp + ``tp``: each layer gathers its split leaves whole and runs
    on this rank's rows, so the output must be the cp forward's ``want``
    bit for bit; the leaf gathers' calls, bytes and host ms."""
    import torch

    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.parallel import make_mesh

    env = make_mesh(MeshConfig(model_parallel=world, context_parallel=True,
                               param_sharding="tp"), model=cfg.model)
    model = env.params(random_model(cfg))
    axis = env.model_axis
    _launch_counts(reset=True, split=True)
    axis.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = model(batch, cond_mask)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    got = got.float().cpu()
    out = {"ms_per_forward": ms,
           "bit_identical": bool(torch.equal(got, want)),
           "max_abs_diff": float((got - want).abs().max()),
           "split_leaves": len(env._model_dims),
           "collectives_per_forward": dict(axis.stats),
           "gathers_per_forward": dict(axis.leaf_stats),
           "launches": _launch_counts(split=True)}
    del model
    return out


def _cp_tp_train(workdir, world, batch) -> dict:
    """(g) the ``Trainer`` of ``train_cli --context_parallel
    --model_parallel 2 --param_sharding tp`` from the train checkpoint,
    one eager step on the cp leg's first batch: this rank's blocks' terms
    of the update gate against one rank's first update
    (``TP_CONTROL_REF``: ``CP_REF`` holds one rank's parameters after
    ``CP_STEPS`` steps), its s/step, the bytes it holds for the state and
    the step's peak above what it starts with (the step's first-use
    allocations included: the bucket, Adam's temporaries)."""
    import torch

    from diff3d_tpu_torch.parallel.mesh import block_of

    trainer = _tp_trainer(_tp_argv(workdir, "--context_parallel",
                                   "--model_parallel", str(world),
                                   "--param_sharding", "tp"))
    env = trainer.env
    axis = env.model_axis
    out = {"eager": not trainer.step_fn.cuda_graphs,
           "state_bytes": _state_bytes(trainer.state)}
    start = _tp_params(trainer)
    _launch_counts(reset=True, split=True)
    axis.reset_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, norms, lrs, _ = _tp_steps(trainer, 1, [batch])
    torch.cuda.synchronize()
    out["step_peak_above_state"] = torch.cuda.max_memory_allocated() - base
    out["step_s"] = [time.perf_counter() - t0]
    out["collectives_per_step"] = [{"all": dict(axis.stats),
                                    "gathers": dict(axis.leaf_stats)}]
    out["launches"] = _launch_counts(split=True)
    out["losses"], out["grad_norms"], out["lrs"] = losses, norms, lrs
    ref = torch.load(TP_CONTROL_REF, map_location="cpu", mmap=True,
                     weights_only=True)
    sums = {}
    for n, p in trainer.state.model.named_parameters():
        d = env._model_dims.get(n)
        r = ref[n] if d is None else block_of(
            ref[n], d, env.model_rank, world, n in env._halved)
        sums[n] = _update_sums(p.detach(), start[n] + r.to("cuda"),
                               start[n])
    out["sums"] = sums
    out["split_leaves"] = len(env._model_dims)
    trainer.loader.close()
    del trainer, start, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cp_rank(rank: int, world: int, workdir: str) -> dict:
    """One rank of phase ``context_parallel`` (see the module docstring,
    11a''), on the card with the other rank over gloo."""
    import torch
    import torch.distributed as dist

    from diff3d_tpu_torch.config import MeshConfig, srn64_config
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.sampling import Sampler

    marks = {"start": time.perf_counter()}
    torch.cuda.set_device(0)
    group = dist.group.WORLD
    cfg = srn64_config()
    env = make_mesh(MeshConfig(model_parallel=world, context_parallel=True),
                    model=cfg.model)
    model = env.params(random_model(cfg))
    rows = env.context_axis
    marks["model"] = time.perf_counter()
    batch, cond_mask = model_batch(
        cfg, 2 * len(cfg.diffusion.guidance_weights), seed=5)
    out = {"rank": rank, "model_rank": env.model_rank,
           "backend": dist.get_backend(group), "gloo": rows.axis.gloo,
           "rows": rows.rows(cfg.model.H)}

    # (a) one forward (timed after a first one), (d) one Sampler(mesh)
    # view (the single-object path).
    _launch_counts(reset=True, split=True)
    sample_sites = _Sites()
    with torch.inference_mode():
        model(batch, cond_mask)
        rows.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sample_sites:
            fwd = model(batch, cond_mask)
        torch.cuda.synchronize()
    out["ms_per_forward"] = 1e3 * (time.perf_counter() - t0)
    out["forward"] = fwd.float().cpu()
    out["collectives_per_forward"] = dict(rows.stats)
    marks["a_forward"] = time.perf_counter()
    # (g) the same weights under cp + tp, one forward.
    out["cp_tp"] = {"forward": _cp_tp_forward(cfg, world, batch, cond_mask,
                                              out["forward"])}
    gc.collect()
    torch.cuda.empty_cache()
    marks["g_forward"] = time.perf_counter()
    cfg32, f32 = _tp_f32(cfg, model)
    sampler = Sampler(f32, cfg32, device="cuda", mesh=env,
                      sampler_kind="ddim", steps=CP_SAMPLER_STEPS)
    t0 = time.perf_counter()
    with _NoTF32():
        out["views"] = sampler.synthesize(orbit_views(2, cfg.model.H,
                                                      seed=3),
                                          torch.Generator("cuda").manual_seed(
                                              0))
    out["sampler_s"] = time.perf_counter() - t0
    out["sampler_graphs"] = sampler.cuda_graphs
    out["launches_sampling"] = _launch_counts(split=True)
    marks["d_sampler"] = time.perf_counter()
    del sampler, f32, model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The Trainer under cp, CP_STEPS eager steps from the train
    # checkpoint;
    # (e) the second step's peak above what it started with.
    trainer = _tp_trainer(_tp_argv(workdir, "--context_parallel",
                                   "--model_parallel", str(world)))
    rows = trainer.env.context_axis         # the trainer's own mesh
    out["restored_step"] = trainer.state.step
    out["eager"] = not trainer.step_fn.cuda_graphs
    start = _tp_params(trainer)
    point = _rewind_point(trainer)
    train_sites = _Sites()
    step_s, coll, got = [], [], ([], [], [], [])
    marks["c_build"] = time.perf_counter()
    _launch_counts(reset=True, split=True)
    for i in range(CP_STEPS):
        rows.reset_stats()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if i == 0:
            with train_sites:
                one = _tp_steps(trainer, 1)
        else:
            one = _tp_steps(trainer, 1)
        torch.cuda.synchronize()
        out["step_peak_above_state"] = (torch.cuda.max_memory_allocated()
                                        - base)
        for acc, v in zip(got, one):
            acc += v
        step_s.append(time.perf_counter() - t0)
        coll.append(dict(rows.stats))
    out["launches_training"] = _launch_counts(split=True)
    out["losses"], out["grad_norms"], out["lrs"], batches = got
    out["step_s"], out["collectives_per_step"] = step_s, coll
    out["state_bytes"] = base
    out["state_split_bytes"] = _state_bytes(trainer.state)
    marks["c_steps"] = time.perf_counter()
    ref = torch.load(CP_REF, map_location="cpu", mmap=True,
                     weights_only=True)
    out["sums"] = {n: _update_sums(p.detach(), ref[n].to("cuda"), start[n])
                   for n, p in trainer.state.model.named_parameters()}
    marks["c_gate"] = time.perf_counter()

    # (c) The control: back to the checkpoint's state, the first step
    # retaken on its batch with the halo's backward not adding the
    # neighbours' share.
    _rewind(trainer, point)
    del point
    with _HaloNotAdded():
        ctl = _tp_steps(trainer, 1, batches)
    ref = torch.load(TP_CONTROL_REF, map_location="cpu", mmap=True,
                     weights_only=True)
    out["control"] = {
        "loss": ctl[0][0], "grad_norm": ctl[1][0], "lr": ctl[2][0],
        "sums": {n: _update_sums(p.detach(), start[n] + ref[n].to("cuda"),
                                 start[n])
                 for n, p in trainer.state.model.named_parameters()}}
    del start, ref
    trainer.loader.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    marks["c_control"] = time.perf_counter()

    # (g) the Trainer under cp + tp on (c)'s batches.
    out["cp_tp"]["train"] = _cp_tp_train(workdir, world, batches[0])
    del batches
    marks["g_train"] = time.perf_counter()

    # (f) The distill leg; its control: the halo's backward add removed.
    out["distill"] = distill_leg(env, _HaloNotAdded())
    marks["f_distill"] = time.perf_counter()

    # (b) The kernels at a rank's sites (and row 3 at the train sites: the
    # distill teacher's), on rank 0 while rank 1 waits: the ranks' rows
    # are the same shapes and the inputs are seeded by shape, so a pass on
    # rank 1 would repeat rank 0's.
    out["sample_sites"] = {"gn": sample_sites.gn, "attn": sample_sites.attn}
    out["train_sites"] = {"gn": train_sites.gn, "attn": train_sites.attn}
    dist.barrier(group)
    if rank == 0:
        t0 = time.perf_counter()
        out["gn"] = phase_split_groupnorm(train_sites.gn)
        out["attn"] = phase_attention(sample_sites.attn,
                                      phase="cp_attention",
                                      extra_shapes=False)
        out["attn_rows"] = phase_attention_backward(
            train_sites.attn, 1, phase="cp_attention_backward",
            extra_shapes=False, f32_max_n=2)
        out["distill_attn"] = phase_attention(
            train_sites.attn, phase="cp_distill_attention",
            extra_shapes=False)
        out["sites_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    dist.barrier(group)
    marks["b_sites"] = time.perf_counter()
    names = list(marks)
    out["marks_s"] = {n: round(marks[n] - marks[p], 3)
                      for p, n in zip(names, names[1:])}
    return out


def phase_context_parallel(prep, ranks, ranks_s):
    """Context parallelism on the card (see the module docstring, 11a''):
    ``prep`` is :func:`tp_prepare`'s (the one-rank references are the tp
    phase's), ``ranks`` the ranks' results of :func:`cp_rank` (run by
    phase ``parallel``'s processes, ``ranks_s`` seconds)."""
    import torch

    t_phase = time.perf_counter()
    one = prep["one"]
    fwd_rel = max(_rel_l2(r["forward"], one["forward"]) for r in ranks)
    view_rel = max(_rel_l2(r["views"], one["views"][CP_SAMPLER_STEPS])
                   for r in ranks)
    finite = all(torch.isfinite(r["forward"]).all()
                 and np.isfinite(r["views"]).all() for r in ranks)
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for r in ranks
                   for k in ("losses", "grad_norms", "lrs")
                   for a, b in zip(r[k], one[k]))
    r0 = ranks[0]
    gate = _update_gate(r0["sums"])
    ctl_gate = _update_gate(r0["control"]["sums"])
    same_state = all(r["sums"] == r0["sums"] for r in ranks)
    # (f) The distill leg against one rank: every parameter whole on each
    # rank, rank 0's terms (both ranks the same update).
    leg = _leg_summary([r["distill"] for r in ranks], prep["distill"],
                       lambda sums: sums[0])
    leg["ranks_hold_the_same_update"] = all(
        r["distill"]["sums"] == r0["distill"]["sums"] for r in ranks)
    leg_unsplit = {k: [r["distill"]["launches"][k] for r in ranks]
                   for k in ("fused_groupnorm", "groupnorm_backward")}
    ctl_failed = sum(not row[5] for row in ctl_gate)
    mem = {"rank_peak_above_state": [r["step_peak_above_state"]
                                     for r in ranks],
           "one_process_peak_above_state": one["step_peak_above_state"],
           "what": "the second train step's peak allocated bytes above "
                   "the bytes allocated before it (parameters, gradients, "
                   "Adam's moments, the EMA), one rank of the cp mesh vs "
                   "one process, both at global batch 8"}
    mem["ratio"] = (max(mem["rank_peak_above_state"])
                    / mem["one_process_peak_above_state"])
    mem["limit"] = CP_MEMORY_RATIO
    split_rows = ("groupnorm_partial_sums", "groupnorm_apply_sums")
    train_rows = ("groupnorm_partial_sums", "groupnorm_apply_sums",
                  "groupnorm_backward_partial_sums",
                  "groupnorm_backward_apply_sums", "flash_attention",
                  "attention_backward_dkdv", "attention_backward_dq")
    launched = all(r["launches_sampling"][k] > 0 for r in ranks
                   for k in split_rows + ("flash_attention",)) and all(
        r["launches_training"][k] > 0 for r in ranks for k in train_rows)
    unsplit = {k: [r[w][k] for r in ranks
                   for w in ("launches_sampling", "launches_training")]
               for k in ("fused_groupnorm", "groupnorm_backward")}

    def per(c):
        return {"calls": c["calls"], "bytes": c["bytes"],
                "ms": round(1e3 * c["seconds"], 3)}

    # (g) cp + tp: the forward bit for bit cp's, every leaf's update
    # (blocks summed over the ranks) against one rank's, the state bytes
    # and the step peak.
    g_fwd = [r["cp_tp"]["forward"] for r in ranks]
    g_train = [r["cp_tp"]["train"] for r in ranks]
    g_gate = _update_gate(_summed([t["sums"] for t in g_train]))
    g_failed = [row[:5] for row in g_gate if not row[5]]
    g_loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for t in g_train
                     for k in ("losses", "grad_norms", "lrs")
                     for a, b in zip(t[k], one[k]))
    g_bytes = [{k: t["state_bytes"][k] / r["state_split_bytes"][k]
                for k in ("params", "adam", "ema")}
               for t, r in zip(g_train, ranks)]
    g_peak = (max(t["step_peak_above_state"] for t in g_train)
              / one["step_peak_above_state"])
    g_launched = all(f["launches"][k] > 0 for f in g_fwd
                     for k in split_rows + ("flash_attention",)) and all(
        t["launches"][k] > 0 for t in g_train for k in train_rows)
    g_unsplit = [x["launches"][k] for x in g_fwd + g_train
                 for k in ("fused_groupnorm", "groupnorm_backward")]
    cp_tp = {
        "mesh": "dp1 x mp2, context_parallel, tp: split leaves held as "
                "blocks, gathered whole in each layer's forward",
        "forward": {"bit_identical_to_cp": [f["bit_identical"]
                                            for f in g_fwd],
                    "max_abs_diff": [f["max_abs_diff"] for f in g_fwd],
                    "ms_per_forward": [round(f["ms_per_forward"], 3)
                                       for f in g_fwd],
                    "cp_ms_per_forward": [round(r["ms_per_forward"], 3)
                                          for r in ranks],
                    "split_leaves": g_fwd[0]["split_leaves"],
                    "gathers": [per(f["gathers_per_forward"])
                                for f in g_fwd],
                    "collectives": [per(f["collectives_per_forward"])
                                    for f in g_fwd]},
        "train": {"steps": 1, "batch": "(c)'s first",
                  "reference": "one rank's first update (TP_CONTROL_REF)",
                  "eager": all(t["eager"] for t in g_train),
                  "losses": [t["losses"] for t in g_train],
                  "grad_norms": [t["grad_norms"] for t in g_train],
                  "loss_rel": g_loss_rel, "loss_tolerance": TP_LOSS_TOL,
                  "update_gate": _gate_summary(g_gate),
                  "s_per_step": [t["step_s"] for t in g_train],
                  "cp_s_per_step": [r["step_s"] for r in ranks],
                  "collectives_per_step": [
                      [{k: per(v) for k, v in c.items()}
                       for c in t["collectives_per_step"]]
                      for t in g_train]},
        "state_bytes": [t["state_bytes"] for t in g_train],
        "cp_state_bytes": [r["state_split_bytes"] for r in ranks],
        "state_ratio": g_bytes, "state_limit": CP_TP_STATE_RATIO,
        "memory": {"rank_peak_above_state": [t["step_peak_above_state"]
                                             for t in g_train],
                   "what": "the cp + tp step's peak allocated bytes above "
                           "those allocated before it (its first step: the "
                           "bucket's first allocation included), over one "
                           "process's second step's",
                   "ratio": g_peak, "limit": CP_MEMORY_RATIO},
        "launches_forward": [{k: f["launches"][k] for k in split_rows
                              + ("flash_attention",)} for f in g_fwd],
        "launches_training": [{k: t["launches"][k] for k in train_rows}
                              for t in g_train],
        "unsplit_groupnorm_launches": g_unsplit}

    out = {"config": "srn64", "mesh": "dp1 x mp2, context_parallel, "
                                      "replicated",
           "transport": "gloo, 2 ranks on one card: each collective's CUDA "
                        "tensors staged through pinned host memory",
           "backend": r0["backend"], "gloo": r0["gloo"],
           "rows": [r["rows"] for r in ranks],
           "forward": {"batch": int(one["forward"].shape[0]),
                       "rel_l2_vs_one_rank": fwd_rel, "tolerance": TP_TOL,
                       "ms_per_forward": [round(r["ms_per_forward"], 3)
                                          for r in ranks],
                       "one_rank_ms_per_forward": one["ms_per_forward"],
                       "collectives_per_forward": [
                           per(r["collectives_per_forward"])
                           for r in ranks]},
           "sampler": {"views": 1, "ddim_steps": CP_SAMPLER_STEPS,
                       "dtype": "float32", "path": "single-object (step)",
                       "rel_l2_vs_one_rank": view_rel, "tolerance": TP_TOL,
                       "s": [round(r["sampler_s"], 3) for r in ranks],
                       "graphs": [r["sampler_graphs"] for r in ranks]},
           "train": {"from_step": r0["restored_step"],
                     "global_batch": TP_BATCH, "steps": CP_STEPS,
                     "eager": all(r["eager"] for r in ranks),
                     "losses": [r["losses"] for r in ranks],
                     "one_rank_losses": one["losses"],
                     "grad_norms": [r["grad_norms"] for r in ranks],
                     "one_rank_grad_norms": one["grad_norms"],
                     "lrs": [r["lrs"] for r in ranks],
                     "loss_rel": loss_rel, "loss_tolerance": TP_LOSS_TOL,
                     "ranks_hold_the_same_update": same_state,
                     "update_gate": _gate_summary(gate),
                     "control": {
                         "what": "the first step retaken from the "
                                 "checkpoint with the halo's backward not "
                                 "adding the neighbours' share to the edge "
                                 "rows",
                         "loss": [r["control"]["loss"] for r in ranks],
                         "grad_norm": [r["control"]["grad_norm"]
                                       for r in ranks],
                         "one_rank_loss": one["losses"][0],
                         "sound_loss": r0["losses"][0],
                         "loss_equals_sound_step": all(
                             r["control"]["loss"] == r["losses"][0]
                             for r in ranks),
                         "leaves_failed": ctl_failed,
                         "update_gate": _gate_summary(ctl_gate)},
                     "s_per_step": [r["step_s"] for r in ranks],
                     "collectives_per_step": [
                         [per(c) for c in r["collectives_per_step"]]
                         for r in ranks]},
           "memory": mem,
           "launches_sampling": [{k: r["launches_sampling"][k]
                                  for k in split_rows + ("flash_attention",)}
                                 for r in ranks],
           "launches_training": [{k: r["launches_training"][k]
                                  for k in train_rows} for r in ranks],
           "unsplit_groupnorm_launches": unsplit,
           "sites": {"sampling": {k: {str(kk): v for kk, v in
                                      r0["sample_sites"][k].items()}
                                  for k in ("gn", "attn")},
                     "training": {k: {str(kk): v for kk, v in
                                      r0["train_sites"][k].items()}
                                  for k in ("gn", "attn")}},
           "sites_s": [round(r["sites_s"], 3) for r in ranks
                       if "sites_s" in r],
           "rank_marks_s": [r["marks_s"] for r in ranks],
           "distill": dict(leg, unsplit_groupnorm_launches=leg_unsplit),
           "cp_tp": cp_tp,
           "ranks_s": round(ranks_s, 3),
           "phase_s": round(ranks_s + time.perf_counter() - t_phase, 3)}
    emit(dict(phase="context_parallel", **out))
    if not (finite and fwd_rel <= TP_TOL and view_rel <= TP_TOL):
        raise AssertionError(f"context_parallel: forward {fwd_rel}, views "
                             f"{view_rel}, finite {finite}")
    failed = [row[:5] for row in gate if not row[5]]
    if not (loss_rel <= TP_LOSS_TOL and not failed and same_state
            and out["train"]["eager"]):
        raise AssertionError(f"context_parallel: training off one rank: "
                             f"losses and norms {loss_rel}, "
                             f"{len(failed)} updates, e.g. {failed[:3]}; "
                             f"ranks alike {same_state}")
    if ctl_failed == 0:
        raise AssertionError("context_parallel: the update gate passed the "
                             "control (the halo's backward add removed)")
    if not mem["ratio"] <= CP_MEMORY_RATIO:
        raise AssertionError(f"context_parallel: a rank's activation peak "
                             f"{mem['ratio']:.3f} of one process's")
    if not launched or any(n for v in unsplit.values() for n in v):
        raise AssertionError(f"context_parallel: launches: "
                             f"{out['launches_sampling']}, "
                             f"{out['launches_training']}, unsplit "
                             f"{unsplit}")
    if not all(f["bit_identical"] for f in g_fwd):
        raise AssertionError(f"context_parallel: the cp + tp forward off "
                             f"cp's: {cp_tp['forward']['max_abs_diff']}")
    if g_failed or not g_loss_rel <= TP_LOSS_TOL \
            or not cp_tp["train"]["eager"]:
        raise AssertionError(f"context_parallel: cp + tp training off one "
                             f"rank: losses and norms {g_loss_rel}, "
                             f"{len(g_failed)} updates, e.g. "
                             f"{g_failed[:3]}")
    if not all(v <= CP_TP_STATE_RATIO for b in g_bytes for v in b.values()):
        raise AssertionError(f"context_parallel: cp + tp state bytes "
                             f"{g_bytes} of cp's")
    if not g_peak <= CP_MEMORY_RATIO:
        raise AssertionError(f"context_parallel: a cp + tp rank's step "
                             f"peak {g_peak:.3f} of one process's")
    if not g_launched or any(g_unsplit):
        raise AssertionError(f"context_parallel: cp + tp launches "
                             f"{cp_tp['launches_forward']}, "
                             f"{cp_tp['launches_training']}, unsplit "
                             f"{g_unsplit}")
    _check_leg("context_parallel", leg, train_rows,
               zero=("fused_groupnorm", "groupnorm_backward"))
    if not leg["ranks_hold_the_same_update"]:
        raise AssertionError("context_parallel: the distill leg's ranks "
                             "hold different updates")

    def slowest(key, sub=None):
        rows = [r[key] if sub is None else r[key][sub] for r in ranks
                if key in r]
        got = dict(rows[0])
        for k in ("ms", "device_ms", "plain_ms", "library_ms"):
            if got.get(k) is not None:
                got[k] = max(r[k] for r in rows)
        got["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return got

    out["kernel_stats"] = {
        **{f"{k}@cp": slowest("gn", k) for k in (
            "groupnorm_partial_sums", "groupnorm_apply_sums",
            "groupnorm_backward_partial_sums",
            "groupnorm_backward_apply_sums")},
        "flash_attention@cp": slowest("attn"),
        "flash_attention[save_lse]@cp": slowest("attn_rows", "lse"),
        "attention_backward_dkdv@cp": slowest("attn_rows", "dkdv"),
        "attention_backward_dq@cp": slowest("attn_rows", "dq"),
        # The distill leg, at the train step's sites: (a) and (b) in the
        # teacher's two forwards and the student's, (c) and (d) in its
        # backward; row 3 in the teacher's forwards, rows 4-6 the
        # student's.
        **{f"{k}@cp_distill": _scaled(slowest("gn", k), n) for k, n in (
            ("groupnorm_partial_sums", 3), ("groupnorm_apply_sums", 3),
            ("groupnorm_backward_partial_sums", 1),
            ("groupnorm_backward_apply_sums", 1))},
        "flash_attention@cp_distill": _scaled(slowest("distill_attn"), 2),
        "flash_attention[save_lse]@cp_distill": slowest("attn_rows", "lse"),
        "attention_backward_dkdv@cp_distill": slowest("attn_rows", "dkdv"),
        "attention_backward_dq@cp_distill": slowest("attn_rows", "dq")}
    ls, lt = r0["launches_sampling"], r0["launches_training"]
    ld = r0["distill"]["launches"]
    out["kernel_launches"] = {
        **{f"{k}@cp_distill": ld[k.split("[")[0]] for k in train_rows + (
            "flash_attention[save_lse]",)},
        "groupnorm_partial_sums@cp": ls["groupnorm_partial_sums"],
        "groupnorm_apply_sums@cp": ls["groupnorm_apply_sums"],
        "groupnorm_backward_partial_sums@cp":
            lt["groupnorm_backward_partial_sums"],
        "groupnorm_backward_apply_sums@cp":
            lt["groupnorm_backward_apply_sums"],
        "flash_attention@cp": ls["flash_attention"],
        "flash_attention[save_lse]@cp": lt["flash_attention"],
        "attention_backward_dkdv@cp": lt["attention_backward_dkdv"],
        "attention_backward_dq@cp": lt["attention_backward_dq"]}
    return out


# ---- serving over a data=2 mesh: 2 ranks on the card -------------------------

MESH_LANES = (2, 4)             # the lane counts warmed and served
MESH_VIEWS = 3                  # views a request (2 view steps)
MESH_F32_TOL = 1e-4             # the float32 copy's views, rel. L2
MESH_F32_LANES = 2              # the float32 leg's max_batch (1 a rank)
MESH_F32_STEPS = 2              # the float32 leg's steps a view
MESH_ROW_CALLS = {"fused_groupnorm": 101, "flash_attention": 30}
MESH_WAIT_S = 120.0             # every request's wait
MESH_FLEET_SEEDS = (90, 91)     # the fleet leg's pair on each replica, and
                                # the bf16 service's tail (its reference)
MESH_FLEET_WEIGHTS = os.path.join(WORKDIR + "_mesh", "weights.pt")
MESH_KILL_EXIT_S = 5.0          # a killed replica's follower loop ends
MESH_ROWS = ("fused_groupnorm", "flash_attention")


def _mesh_cfg(max_batch=max(MESH_LANES)):
    """srn64 at full width, served at ``SERVE_STEPS`` ancestral steps a
    view, ``max_batch`` lanes at most."""
    from diff3d_tpu_torch.config import srn64_config

    cfg = srn64_config()
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, port=0, max_batch=max_batch, max_views=4,
        max_wait_ms=500.0))


def _mesh_service(cfg, model, mesh=None, ranks=None, steps=SERVE_STEPS):
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving import ServingService

    return ServingService(Sampler(model, cfg, device="cuda", mesh=mesh,
                                  steps=steps), cfg, ranks=ranks)


def _mesh_swap(model):
    """The swap's weights: every floating-point tensor x 1.01 (the serve
    phase's + 0.05 drives one lane's bf16 view to NaN at 2 lanes a call,
    on one process as on the mesh: PERF.md section 7)."""
    return {k: (v * 1.01 if v.is_floating_point() else v.clone())
            for k, v in model.state_dict().items()}


def _mesh_traffic(svc, swap_state=None, tail=()):
    """Three requests at once; after the first view step (on the engine
    thread, so both land at the second) a fourth request and the swap
    (``swap_state``, if any); once they are done, the ``tail`` payloads
    at once.  Returns the results in order and each view step's wall
    seconds and lanes (the leader's, or one process's)."""
    import torch

    from diff3d_tpu_torch.serving import lane_count

    eng = svc.engine
    inner, log, late = eng._run_view_step, [], []

    def timed(active):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(active)
        log.append({"lanes": lane_count(len(active), eng.max_batch,
                                        eng.lane_multiple),
                    "live": len(active), "s": time.perf_counter() - t0})
        if len(log) == 1:
            if swap_state is not None:
                eng.registry.swap(swap_state, version="swapped")
            late.append(svc.submit(_serve_payload(
                orbit_views(MESH_VIEWS, 64, 73), 73)))

    eng._run_view_step = timed
    svc.start(serve_http=False)
    reqs = [svc.submit(_serve_payload(orbit_views(MESH_VIEWS, 64, 70 + i),
                                      70 + i)) for i in range(3)]
    out = [r.result(timeout=MESH_WAIT_S) for r in reqs]
    out += [late[0].result(timeout=MESH_WAIT_S)]
    reqs = [svc.submit(p) for p in tail]
    out += [r.result(timeout=MESH_WAIT_S) for r in reqs]
    svc.stop()
    return out, log


def _mesh_bucket(cfg):
    from diff3d_tpu_torch.sampling import record_capacity
    from diff3d_tpu_torch.serving import Bucket

    return Bucket(cfg.model.H, cfg.model.W,
                  record_capacity(cfg.serving.max_views), SERVE_STEPS,
                  "ancestral")


def _mesh_recorder(eng):
    """Every view step the engine's program cache runs on this rank:
    lanes, the weights generation, whether it served requests (a warm-up
    passes no generation), the returned views (every lane's)."""
    steps, inner = [], eng.programs.step_many

    def step_many(bucket, lanes, *args, **kw):
        got = inner(bucket, lanes, *args, **kw)
        steps.append({"lanes": int(lanes),
                      "generation": kw.get("generation", 0),
                      "served": "generation" in kw,
                      "views": got[0].float().cpu()})
        return got

    eng.programs.step_many = step_many
    return steps


def serve_mesh_rank(rank: int, world: int) -> dict:
    """One rank of phase ``serve_mesh`` (see the module docstring), on
    the card with the other rank over gloo: rank 0 leads."""
    import torch
    import torch.distributed as dist

    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.parallel import make_mesh
    from diff3d_tpu_torch.serving.ranks import RankChannel

    marks = {"start": time.perf_counter()}
    torch.cuda.set_device(0)
    group = dist.group.WORLD
    cfg = _mesh_cfg()
    env = make_mesh(MeshConfig())
    ranks = RankChannel(env)
    model = random_model(cfg)
    out = {"rank": rank, "backend": dist.get_backend(group),
           "digest": ranks.sync_weights(model)}
    marks["model"] = time.perf_counter()

    # The bf16 service: the launch counts set to 0 before, read after.
    sites = _Sites()
    _launch_counts(reset=True)
    with sites:
        svc = _mesh_service(cfg, model, env, ranks)
        eng = svc.engine
        sampler = eng.sampler
        steps = _mesh_recorder(eng)
        plans, make_plan = [], eng._plan

        def plan_of(active):        # the leader's plans, kept
            plans.append(make_plan(active))
            return plans[-1]

        eng._plan = plan_of
        if rank:
            svc.engine.follow()
        else:
            t0 = time.perf_counter()
            for lanes in MESH_LANES:
                eng.warmup(_mesh_bucket(cfg), lanes)
            out["warmup_s"] = time.perf_counter() - t0
            out["results"], out["step_log"] = _mesh_traffic(
                svc, _mesh_swap(model), tail=_fleet_payloads())
    out["launches"] = _launch_counts(graphs=list(sampler.graphs.values()))
    out["plain_calls"] = sites.plain
    out["steps"] = steps
    out["plans"] = plans
    out["model_calls"] = SERVE_STEPS * len(steps)
    out["gather"] = dict(sampler.gather_stats)
    out["counts"] = dict(ranks.counts)
    marks["bf16"] = time.perf_counter()
    del svc, eng, sampler

    # serve_cli's service with --mesh --replicas 2 over the same ranks and
    # weights (every rank's model now holds the swapped ones).
    out["fleet"] = _mesh_fleet_leg(rank, model)
    marks["fleet"] = time.perf_counter()

    # The same weights computing in float32 (after the swap, as every
    # rank holds them; TF32 off): the bf16 service's traffic without its
    # swap, one lane a rank (a call of the shape one process runs at
    # max_batch 1), so rank 1's requests are held end to end.
    cfg32, f32 = _tp_f32(_mesh_cfg(MESH_F32_LANES), model)
    svc = _mesh_service(cfg32, f32, env, RankChannel(env),
                        steps=MESH_F32_STEPS)
    steps32 = _mesh_recorder(svc.engine)
    with _NoTF32():
        if rank:
            svc.engine.follow()
        else:
            out["f32"], out["f32_log"] = _mesh_traffic(svc)
    out["steps_f32"] = steps32
    del svc, f32
    gc.collect()
    torch.cuda.empty_cache()
    marks["f32"] = time.perf_counter()

    # The worker over the same two ranks, both on cuda:0: one session
    # through its socket.
    out["worker"] = _mesh_worker(rank, cfg)
    marks["worker"] = time.perf_counter()

    # Rows 1 and 3 at a rank's sites (2 of 4 lanes; the sites' shapes,
    # read from a forward of the float32 copy).
    B = len(cfg.diffusion.guidance_weights)
    gn_sites, attn_sites = record_sites(
        model, *model_batch(cfg, 2 * 2 * B, seed=7))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # On rank 0 while rank 1 waits: both ranks recorded the same sites
    # from the same model and batch, and the inputs are seeded by shape,
    # so a pass on rank 1 would repeat rank 0's.
    dist.barrier(group)
    if rank == 0:
        out["gn"] = phase_groupnorm(gn_sites, phase="mesh_groupnorm",
                                    odd_shapes=False)
        out["attn"] = phase_attention(attn_sites, phase="mesh_attention",
                                      extra_shapes=False)
    torch.cuda.synchronize()
    dist.barrier(group)
    marks["sites"] = time.perf_counter()
    names = list(marks)
    out["marks_s"] = {n: round(marks[n] - marks[p], 3)
                      for p, n in zip(names, names[1:])}
    return out


def _fleet_payloads(sids=(None, None), seeds=MESH_FLEET_SEEDS):
    """The fleet leg's requests (``MESH_VIEWS`` views each), one a seed,
    each in its session of ``sids`` (None: none)."""
    return [_serve_payload(orbit_views(MESH_VIEWS, 64, seed), seed,
                           **({} if sid is None else {"session_id": sid}))
            for seed, sid in zip(seeds, sids)]


def _replica_graphs(eng):
    return [g for s in eng.samplers.values() for g in s.graphs.values()]


def _mesh_fleet_leg(rank: int, model) -> dict:
    """Phase ``serve_mesh``'s fleet leg on one rank: ``serve_cli``'s
    ``build_service`` with ``--mesh --replicas 2 --warmup`` over the
    group, from ``model``'s weights (saved by rank 0); the launch counts
    set to 0 before, read after.  Rank 0 serves two sessions on each
    replica at once (2 lanes, one a rank), rolls out ``x 1.01`` on
    replica 1 alone, serves one more request on replica 1, kills it
    (its session's next request must be lost), then stops.  Rank 1 follows
    both replicas, recording when each loop ended."""
    import torch
    import torch.distributed as dist

    from diff3d_tpu_torch.cli import serve_cli
    from diff3d_tpu_torch.graphs import graph_launches
    from diff3d_tpu_torch.serving.engine import follow_all
    from diff3d_tpu_torch.serving.scheduler import SessionLost

    marks = {"start": time.perf_counter()}
    if rank == 0:
        os.makedirs(os.path.dirname(MESH_FLEET_WEIGHTS), exist_ok=True)
        torch.save(model.state_dict(), MESH_FLEET_WEIGHTS)
    dist.barrier()
    argv = ["--mesh", "--replicas", "2", "--model", MESH_FLEET_WEIGHTS,
            "--config", "srn64", "--sampler_steps", str(SERVE_STEPS),
            "--max_batch", "2", "--max_views", str(MESH_VIEWS),
            "--max_wait_ms", "500", "--port", "0", "--warmup"]
    out, sites = {}, _Sites()
    _launch_counts(reset=True)
    with sites:
        svc = serve_cli.build_service(serve_cli.build_parser().parse_args(
            argv))
        engines = serve_cli._local_engines(svc)
        steps = [_mesh_recorder(eng) for eng in engines]
        marks["boot"] = time.perf_counter()
        if rank == 0:           # both ranks loaded it before the sync
            shutil.rmtree(os.path.dirname(MESH_FLEET_WEIGHTS),
                          ignore_errors=True)
        if rank:
            ended = {}
            for i, eng in enumerate(engines):
                def follow(i=i, inner=eng.follow):
                    try:
                        inner()
                    finally:
                        ended[i] = time.time()
                eng.follow = follow
            follow_all(engines)
            out["ended"] = ended
        else:
            log = []
            for rep in svc.replicas:
                _log_view_steps(rep.name, rep.engine, log)
            r1 = svc.replicas[1]
            up = _mesh_swap(r1.engine.sampler.model)
            by = _sessions_by_owner(svc.replicas, 2)
            svc.start(serve_http=False)
            reqs = {name: [svc.submit(p) for p in _fleet_payloads(sids)]
                    for name, sids in by.items()}
            out["views"] = {name: [r.result(timeout=MESH_WAIT_S)
                                   for r in rs]
                            for name, rs in reqs.items()}
            out["rollout"] = svc.rollout(up, version="x1.01",
                                         replicas=["r1"])
            del up
            req = svc.submit(_fleet_payloads(by["r1"][:1], seeds=(92,))[0])
            out["after_rollout"] = {"r1": req.result(timeout=MESH_WAIT_S)}
            out["fleet_snapshot"] = svc.fleet_snapshot()
            out["killed_at"] = time.time()
            r1.kill()
            try:
                svc.submit(_fleet_payloads(by["r1"][:1], seeds=(93,))[0])
                out["lost"] = None
            except SessionLost as e:
                out["lost"] = type(e).__name__
            svc.stop()
            out["step_log"] = log
    marks["served"] = time.perf_counter()
    graphs = [_replica_graphs(eng) for eng in engines]
    out["launches"] = _launch_counts(graphs=[g for gs in graphs for g in gs])
    out["replica_launches"] = [{k: graph_launches(gs).get(k, 0)
                                for k in MESH_ROWS} for gs in graphs]
    out["plain_calls"] = sites.plain
    out["steps"] = steps
    out["counts"] = [dict(eng.ranks.counts) for eng in engines]
    out["gather"] = [dict(eng.sampler.gather_stats) for eng in engines]
    del svc, engines, graphs
    gc.collect()
    torch.cuda.empty_cache()
    names = list(marks)
    out["marks_s"] = {n: round(marks[n] - marks[p], 3)
                      for p, n in zip(names, names[1:])}
    return out


def _mesh_worker(rank, cfg):
    """``boot_worker`` over the group (both ranks on ``cuda:0``): rank 0's
    boot seconds and one session's views through its socket."""
    from diff3d_tpu_torch.serving.server import build_request
    from diff3d_tpu_torch.serving.transport import RemoteReplica
    from diff3d_tpu_torch.serving.worker import boot_worker

    t0 = time.perf_counter()
    worker = boot_worker(cfg, name="mesh", devices=[0, 1],
                         rank_devices=["cuda:0", "cuda:0"],
                         steps=SERVE_STEPS)
    if worker is None:                      # a follower, now stopped
        return {"followed": True}
    boot_s = time.perf_counter() - t0
    worker.start()
    remote = None
    try:
        remote = RemoteReplica("127.0.0.1", worker.port).start()
        req = build_request(dict(_serve_payload(orbit_views(
            MESH_VIEWS, 64, 80), 80), session_id="mesh-session"), cfg)
        remote.submit(req)
        views = req.result(timeout=MESH_WAIT_S)
    finally:
        if remote is not None:
            remote.stop()
        worker.stop()
    return {"boot_s": boot_s, "rank_programs": worker.rank_programs,
            "views": views}


def _mesh_reference(plans, steps):
    """The one-process references of phase ``serve_mesh``, after its
    ranks: (1) each served view step again, each rank's share of the
    leader's plan (its records, lengths, intrinsics and every lane's
    generator state; the weights of the plan's generation) through a
    one-process ``Sampler`` at the rank's shape; per step, the gathered
    views' rel. L2 to it, whether they are bit-identical, and their NaNs;
    (2) one process's engine at one lane a call (a rank's shape in the
    float32 leg) on the float32 copy of the swapped weights (TF32 off)
    and the float32 traffic: its results."""
    import torch

    from diff3d_tpu_torch.diffusion import Draws
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.serving.ranks import lane_generators

    cfg = _mesh_cfg()
    model = random_model(cfg)
    weights = [{k: v.clone() for k, v in model.state_dict().items()},
               _mesh_swap(model)]
    sampler = Sampler(model, cfg, device="cuda", steps=SERVE_STEPS)
    rows = []
    for plan, got in zip(plans, steps):
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(weights[plan.generation][k])
        draws = [Draws(g) for g in lane_generators(plan.gen_states,
                                                   sampler.device)]
        draws += [Draws(torch.Generator("cuda").manual_seed(plan.pad_seed))
                  for _ in range(plan.lanes - plan.n)]
        m = plan.lanes // RING_WORLD          # a rank's lanes
        outs = []
        for r in range(RING_WORLD):
            sl = slice(r * m, (r + 1) * m)

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a[sl])).cuda()

            out, _, _ = sampler.step_many(
                t(plan.record_imgs), t(plan.record_R), t(plan.record_T),
                plan.steps[sl], t(plan.K), draws[sl])
            outs.append(out.float().cpu())
        want, view = torch.cat(outs), got["views"]
        rows.append({
            "lanes": plan.lanes, "generation": plan.generation,
            "rel_l2": _rel_l2(view, want),
            "bit_identical": bool((view.view(torch.int32)
                                   == want.view(torch.int32)).all()),
            "nan_served": int(torch.isnan(view).sum()),
            "nan_one_process": int(torch.isnan(want).sum())})
    del sampler
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(weights[1][k])
    del weights
    cfg32, f32 = _tp_f32(_mesh_cfg(MESH_F32_LANES // RING_WORLD), model)
    with _NoTF32():
        views32, log32 = _mesh_traffic(_mesh_service(
            cfg32, f32, steps=MESH_F32_STEPS))
    del f32, model
    gc.collect()
    torch.cuda.empty_cache()
    return rows, views32, log32


def phase_serve_mesh(ranks, ranks_s, one_process_s):
    """Serving over the data=2 mesh (see the module docstring): ``ranks``
    the ranks' results of :func:`serve_mesh_rank` (run by phase
    ``parallel``'s processes, ``ranks_s`` seconds), ``one_process_s`` the
    serve phase's s per view step by lanes (one process, the same
    config)."""
    import torch

    r0, r1 = ranks

    # Each rank's steps: the warm-ups, then the served view steps.
    def bits(a, b):
        return bool(a.shape == b.shape and (a.view(torch.int32)
                                            == b.view(torch.int32)).all())

    same = (len(r0["steps"]) == len(r1["steps"]) > len(MESH_LANES)
            and all(a["lanes"] == b["lanes"]
                    and a["generation"] == b["generation"]
                    and bits(a["views"], b["views"])
                    for a, b in zip(r0["steps"], r1["steps"])))
    same32 = (len(r0["steps_f32"]) == len(r1["steps_f32"]) > 0
              and all(a["lanes"] == b["lanes"] and bits(a["views"],
                                                        b["views"])
                      for a, b in zip(r0["steps_f32"], r1["steps_f32"])))
    t0 = time.perf_counter()
    per_step, views32, log32 = _mesh_reference(
        r0["plans"], r0["steps"][len(MESH_LANES):])
    reference_s = time.perf_counter() - t0
    step_bits = all(row["bit_identical"] for row in per_step)
    f32_rel = [_rel_l2(a, b) for a, b in zip(r0["f32"], views32)]
    fleet = _fleet_summary(ranks, r0["steps"][-len(MESH_FLEET_SEEDS):],
                           bits)
    generations = [s["generation"] for s in r1["steps"][len(MESH_LANES):]]
    finite = all(np.isfinite(v).all() for v in r0["results"] + r0["f32"]) \
        and np.isfinite(r0["worker"]["views"]).all()

    def per_lanes(log):
        by = {}
        for row in log:
            by.setdefault(row["lanes"], []).append(row["s"])
        return {str(k): v for k, v in sorted(by.items())}

    launches = [{k: r["launches"][k] for k in MESH_ROW_CALLS}
                for r in ranks]
    launched = all(
        r["launches"][k] == n * r["model_calls"] and r["model_calls"] > 0
        for r in ranks for k, n in MESH_ROW_CALLS.items())
    plain = [r["plain_calls"] for r in ranks]
    out = {"config": "srn64", "steps_per_view": SERVE_STEPS,
           "backend": "gloo, 2 ranks on one card (lanes split over the "
                      "data axis; plans over a gloo group of their own; "
                      "the views' gather staged through pinned memory)",
           "digests_equal": r0["digest"] == r1["digest"],
           "views_bit_identical_across_ranks": same and same32,
           "weights_generation_by_step": generations,
           "bf16_per_step_vs_one_process": per_step,
           "f32_rel_l2_vs_one_process_engine": f32_rel,
           "lanes_a_call": {
               "mesh_rank": [row["lanes"] // RING_WORLD
                             for row in r0["f32_log"]],
               "one_process": [row["lanes"] for row in log32]},
           "tolerance": {"bf16_per_step": "bit-identical",
                         "f32": MESH_F32_TOL,
                         "fleet_leg": "bit-identical"},
           "s_per_view_step": {"mesh_leader": per_lanes(r0["step_log"]),
                               "one_process_serve_phase": one_process_s,
                               "f32_mesh_leader": per_lanes(r0["f32_log"]),
                               "f32_one_process": per_lanes(log32)},
           "warmup_s": r0["warmup_s"],
           "gather": [r["gather"] for r in ranks],
           "messages": [r["counts"] for r in ranks],
           "launches": launches,
           "model_calls": [r["model_calls"] for r in ranks],
           "plain_calls": plain,
           "worker": {"boot_s": r0["worker"]["boot_s"],
                      "rank_programs": r0["worker"]["rank_programs"],
                      "session_shape": list(r0["worker"]["views"].shape)},
           "rank_marks_s": [r["marks_s"] for r in ranks],
           "fleet_leg": fleet,
           "reference_s": round(reference_s, 3),
           "ranks_s": round(ranks_s, 3)}
    emit(dict(phase="serve_mesh", **out))
    if not (out["digests_equal"] and same and same32 and finite):
        raise AssertionError(f"serve_mesh: ranks differ or not finite: "
                             f"{out['digests_equal']}, {same}, {same32}, "
                             f"{finite}")
    if generations[:1] != [0] or set(generations[1:]) != {1}:
        raise AssertionError(f"serve_mesh: the swap landed at "
                             f"{generations}")
    if not (step_bits and len(f32_rel) == 4
            and max(f32_rel) <= MESH_F32_TOL):
        raise AssertionError(f"serve_mesh: off one process: bf16 per "
                             f"step {per_step}, f32 {f32_rel}")
    if not launched or any(plain):
        raise AssertionError(f"serve_mesh: launches {launches} for "
                             f"{out['model_calls']} model calls, plain "
                             f"{plain}")
    if r0["worker"]["rank_programs"] != [len(MESH_LANES)] * 2:
        raise AssertionError(f"serve_mesh: the worker's ranks warmed "
                             f"{r0['worker']['rank_programs']}")
    if not fleet["ok"]:
        raise AssertionError(f"serve_mesh: the fleet leg: {fleet}")

    def slowest(key):
        rows = [r[key] for r in ranks if key in r]
        got = dict(rows[0])
        for k in ("ms", "device_ms", "plain_ms", "library_ms"):
            if got.get(k) is not None:
                got[k] = max(r[k] for r in rows)
        got["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        return got

    out["kernel_stats"] = {"fused_groupnorm@serve_mesh": slowest("gn"),
                           "flash_attention@serve_mesh": slowest("attn")}
    out["kernel_launches"] = {
        "fused_groupnorm@serve_mesh": r0["launches"]["fused_groupnorm"],
        "flash_attention@serve_mesh": r0["launches"]["flash_attention"],
        "fused_groupnorm@serve_mesh_replicas":
            r0["fleet"]["launches"]["fused_groupnorm"],
        "flash_attention@serve_mesh_replicas":
            r0["fleet"]["launches"]["flash_attention"]}
    return out


def _fleet_summary(ranks, reference, bits) -> dict:
    """The fleet leg's results over both ranks (``ranks``' ``fleet``),
    ``reference`` the one-replica service's view steps of the same pair
    (its tail, at the same lanes, draws and weights), ``bits`` the
    bit-identity of two view tensors; ``ok`` unless a check failed.  The
    served view steps are compared (a follower also records the warm-ups
    it follows, which rank 0 ran inside ``build_service``)."""
    f0, f1 = ({**r["fleet"], "steps": [[s for s in steps if s["served"]]
                                        for steps in r["fleet"]["steps"]]}
              for r in ranks)
    names = ("r0", "r1")
    across = [len(a) == len(b) > 0 and all(
        x["lanes"] == y["lanes"] and x["generation"] == y["generation"]
        and bits(x["views"], y["views"]) for x, y in zip(a, b))
        for a, b in zip(f0["steps"], f1["steps"])]
    to_ref = [all(len(f["steps"][i]) >= len(reference) and all(
        x["lanes"] == y["lanes"] == 2 and bits(x["views"], y["views"])
        for x, y in zip(f["steps"][i], reference)) for f in (f0, f1))
        for i in range(2)]
    gens = [[s["generation"] for s in f["steps"][i]]
            for f in (f0, f1) for i in range(2)]
    ended = f1["ended"]
    exit_s = ended.get(1, math.inf) - f0["killed_at"]
    launched = [[all(f["replica_launches"][i][k] > 0 for k in MESH_ROWS)
                 for i in range(2)] for f in (f0, f1)]
    log = f0["step_log"]
    snap = f0["fleet_snapshot"]["replicas"]
    finite = all(np.isfinite(v).all() for vs in f0["views"].values()
                 for v in vs) and all(
        np.isfinite(v).all() for v in f0["after_rollout"].values())
    out = {
        "argv": "serve_cli --mesh --replicas 2 --warmup --max_batch 2 "
                f"--max_views {MESH_VIEWS} --sampler_steps {SERVE_STEPS}",
        "bit_identical_across_ranks": across,
        "bit_identical_to_one_replica": to_ref,
        "generations": {"rank0": gens[:2], "rank1": gens[2:]},
        "rollout": f0["rollout"],
        "lost_session": f0["lost"],
        "killed_follower_exit_s": round(exit_s, 3),
        "follower_loops_ended_in_order": ended.get(0, 0) > ended.get(1, 0),
        "replica_launches": {"rank0": f0["replica_launches"],
                             "rank1": f1["replica_launches"]},
        "launches": [f["launches"] for f in (f0, f1)],
        "plain_calls": [f["plain_calls"] for f in (f0, f1)],
        "s_per_view_step_leader": {
            n: {"wall": _steady(log, "s", replica=n, lanes=2),
                "held": _steady(log, "held_s", replica=n, lanes=2),
                "steps": [round(r["s"], 4) for r in log
                          if r["replica"] == n]} for n in names},
        "messages": {"rank0": f0["counts"], "rank1": f1["counts"]},
        "snapshot_channels": {n: snap[n]["channel"] for n in names},
        "gather": [f["gather"] for f in (f0, f1)],
        "rank_marks_s": [f["marks_s"] for f in (f0, f1)]}
    out["ok"] = bool(
        all(across) and all(to_ref) and finite
        and all(g == [0] * len(g) for g in gens[0::2])
        and all(g[:2] == [0, 0] and set(g[2:]) == {1} for g in gens[1::2])
        and f0["rollout"]["ok"] and f0["lost"] == "SessionLost"
        and 0 <= exit_s < MESH_KILL_EXIT_S
        and out["follower_loops_ended_in_order"]
        and all(all(r) for r in launched)
        and not any(out["plain_calls"]))
    return out


# ---- distillation, conversion, 64^2 -> 128^2 transfer --------------------

DISTILL_BATCH = 128             # the reference's batch, one microbatch
DISTILL_START, DISTILL_FINAL, DISTILL_ROUND_STEPS = 8, 2, 2
DISTILL_WORKDIR = WORKDIR + "_distill"
CONVERT_WORKDIR = WORKDIR + "_convert"
CONVERT_STEP = 100_000
INIT_WORKDIR = WORKDIR + "_srn128_init"


def _distill_cfg(B):
    from diff3d_tpu_torch.config import srn64_config

    cfg = srn64_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=B, warmup_examples=10 * B))


def _teacher_ema(cfg):
    """The srn64 ``Trainer`` checkpoint's EMA (phase ``train``), by
    parameter name, on the card."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import CheckpointManager

    src = XUNet(cfg.model)
    step = CheckpointManager(os.path.join(WORKDIR, "checkpoints")) \
        .restore_ema(dict(src.named_parameters()))
    return step, {k: v.detach().to("cuda") for k, v in
                  src.named_parameters()}


def _distill_run(cfg, teacher, graphs, start_step=0, start_steps=None,
                 workdir=None):
    """``distill()`` from ``teacher`` over the port's loader (synthetic
    dataset, seeked to ``start_step``), ``DISTILL_ROUND_STEPS`` steps per
    round, through a timing wrapper around the step (one sync per step).
    Returns the final EMA, the history, the per-step records, the last
    state (on the card), the step object, and the launch counts (eager +
    the graph's captured x replays) and peak of the run."""
    import torch

    from diff3d_tpu_torch.data import (InfiniteLoader, SyntheticDataset,
                                       prefetch_to_device)
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import distill, make_distill_step

    B = cfg.train.global_batch
    loader = prefetch_to_device(InfiniteLoader(
        SyntheticDataset(num_objects=64, num_views=32, imgsize=cfg.model.H),
        B, seed=cfg.train.seed, num_workers=8, start_step=start_step),
        "cuda")
    inner = make_distill_step(cfg, cuda_graphs=graphs)
    rec, last = [], {}

    def timed(state, teacher_model, batch, k):
        t_in = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = inner(state, teacher_model, batch, k)
        end.record()
        float(m["distill_loss"])                 # one sync per step
        rec.append({"t_in": t_in, "t": time.perf_counter(), "k": k,
                    "event_ms": start.elapsed_time(end),
                    "loss": m["distill_loss"].clone(),
                    "grad_norm": m["grad_norm"].clone(), "lr": m["lr"]})
        last["state"] = state
        return m

    student = XUNet(cfg.model).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    try:
        final, history = distill(
            student, cfg, teacher, loader,
            start_steps=DISTILL_START if start_steps is None
            else start_steps, final_steps=DISTILL_FINAL,
            round_steps=DISTILL_ROUND_STEPS, workdir=workdir, log_every=0,
            step_fn=timed)
    finally:
        loader.close()
    eager = _launch_counts()
    launches = _launch_counts(graphs=[inner.graph])
    peak = torch.cuda.max_memory_allocated()
    # A step's wall time runs from the end of the one before: the batch's
    # fetch included, as in the train phases.  The first step of each
    # round also carries the previous round's checkpoint and reset.
    times = np.diff([t0] + [r["t"] for r in rec])
    return {"final": final, "history": history, "rec": rec,
            "state": last["state"], "step": inner, "launches": launches,
            "eager_launches": eager, "peak": peak,
            "step_s": [float(t) for t in times],
            "call_s": [r["t"] - r["t_in"] for r in rec],
            "event_ms": [r["event_ms"] for r in rec]}


def _distill_tensors(state):
    return {k: v.detach().cpu() for k, v in _state_tensors(state).items()}


def _distill_kernel_vs_plain(cfg, teacher):
    """One eager distill step at ``STEP_BATCH`` (k = ``DISTILL_FINAL``,
    the same draws) with the student and the teacher through the kernels
    and through the plain versions: ``(loss relative error, gradients'
    relative L2, launches of the kernel step)``."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.models.layers import set_kernels
    from diff3d_tpu_torch.train import (DistillDraws, create_train_state,
                                        make_distill_step)

    c = _distill_cfg(STEP_BATCH)
    batch = train_batch(c, STEP_BATCH, 0)
    runs = {}
    for impl in ("cuda", "torch"):
        student = XUNet(c.model).cuda()
        t_model = XUNet(c.model).cuda().eval().requires_grad_(False)
        with torch.no_grad():
            for m in (student, t_model):
                for name, p in m.named_parameters():
                    p.copy_(teacher[name])
        set_kernels(student, impl)
        set_kernels(t_model, impl)
        state = create_train_state(student, c.train)
        _launch_counts(reset=True)
        m = make_distill_step(c)(
            state, t_model, batch, DISTILL_FINAL,
            draws=DistillDraws(torch.Generator("cuda").manual_seed(7)))
        torch.cuda.synchronize()
        runs[impl] = (float(m["distill_loss"]),
                      [p.grad.detach().float().clone()
                       for p in student.parameters()], _launch_counts())
        del student, t_model, state
        gc.collect()
        torch.cuda.empty_cache()
    (lk, gk, launches), (lp, gp, _) = runs["cuda"], runs["torch"]
    num = sum(float((a - b).norm() ** 2) for a, b in zip(gk, gp))
    rel = (num / sum(float(b.norm() ** 2) for b in gp)) ** 0.5
    return abs(lk - lp) / abs(lp), rel, lk, lp, launches


def phase_distill():
    """Progressive distillation at srn64 full width: the teacher is the
    train phase's checkpoint EMA.  The main path: ``distill(start_steps=8,
    final_steps=2, round_steps=2)`` on the 256-step grid (rounds k = 4 and
    2) at batch ``DISTILL_BATCH`` as one CUDA graph for every round, the
    launch counts set to 0 before and read after; every round's
    ``full_sliced`` checkpoint.  Then: the same run eagerly (per-step
    losses, gradient norms and the final state bit-identical); the last
    round's checkpoint restored against the final state, bit for bit;
    round 2 rerun from round 1's restored checkpoint against the main
    run's (bit for bit); one step at batch 16 kernels vs plain versions
    (loss and gradients, 1e-2); a 2-step DDIM view of the distilled EMA,
    finite."""
    import torch

    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.sampling import Sampler
    from diff3d_tpu_torch.train import CheckpointManager, create_train_state

    torch.backends.cudnn.deterministic = True
    cfg = _distill_cfg(DISTILL_BATCH)
    teacher_step, teacher = _teacher_ema(cfg)
    shutil.rmtree(DISTILL_WORKDIR, ignore_errors=True)
    run = _distill_run(cfg, teacher, True, workdir=DISTILL_WORKDIR)
    graph, launches = run["step"].graph, run["launches"]
    n_steps = len(run["rec"])
    rounds = [h["student_steps"] for h in run["history"]]
    if rounds != [DISTILL_START // 2, DISTILL_FINAL] \
            or n_steps != 2 * DISTILL_ROUND_STEPS:
        raise AssertionError(f"distill: rounds {rounds}, steps {n_steps}")
    if graph is None or graph.replays != n_steps - 1 or any(
            graph.captured.get(k, 0) == 0 for k in launches) or any(
            n == 0 for n in launches.values()):
        raise AssertionError(f"distill: one graph for every round did not "
                             f"run every kernel: {_graph_summary([graph])}, "
                             f"{launches}")
    graph_summary = _graph_summary([graph])
    main = {"metrics": [(r["loss"].cpu(), r["grad_norm"].cpu(), r["lr"])
                        for r in run["rec"]],
            "tensors": _distill_tensors(run["state"]),
            "final": {k: v.cpu() for k, v in run["final"].items()}}
    # Steady state: replays that start no round (a round's first step
    # waits for the previous round's checkpoint).
    firsts = {i * DISTILL_ROUND_STEPS for i in range(len(rounds))}
    replay_s = [t for i, t in enumerate(run["step_s"]) if i not in firsts]
    out = {"config": "srn64", "batch": DISTILL_BATCH, "teacher": (
        f"srn64 Trainer checkpoint step {teacher_step}, EMA"),
        "start_steps": DISTILL_START, "final_steps": DISTILL_FINAL,
        "round_steps": DISTILL_ROUND_STEPS, "rounds": rounds,
        "timesteps": cfg.diffusion.timesteps,
        "step_s": run["step_s"], "s_per_step": float(np.mean(replay_s)),
        "step_call_s": run["call_s"], "step_event_ms": run["event_ms"],
        "round_start_s": [run["step_s"][i] for i in sorted(firsts)],
        "first_step_s": run["step_s"][0],
        "examples_per_s": DISTILL_BATCH / float(np.mean(replay_s)),
        "max_memory_allocated": run["peak"],
        "loss": [float(m[0]) for m in main["metrics"]],
        "grad_norm": [float(m[1]) for m in main["metrics"]],
        "history": run["history"], "launches": launches,
        "eager_launches": run["eager_launches"],
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "graphs": graph_summary}
    run["step"].release()
    del run, graph
    gc.collect()
    torch.cuda.empty_cache()

    # The last round's checkpoint against the final state.
    ckpt_state = create_train_state(XUNet(cfg.model).cuda().eval(),
                                    cfg.train)
    last_dir = os.path.join(DISTILL_WORKDIR, f"steps_{DISTILL_FINAL}")
    got_step = CheckpointManager(last_dir).restore(ckpt_state)
    restored = _distill_tensors(ckpt_state)
    ckpt_differ = [k for k in main["tensors"]
                   if not torch.equal(main["tensors"][k], restored[k])]
    del ckpt_state, restored
    # Graph against eager, every step of both rounds.
    eager = _distill_run(cfg, teacher, False)
    eager_metrics = [(r["loss"].cpu(), r["grad_norm"].cpu(), r["lr"])
                     for r in eager["rec"]]
    eager_tensors = _distill_tensors(eager["state"])
    out["eager_s_per_step"] = float(np.mean(
        [t for i, t in enumerate(eager["step_s"]) if i not in firsts]))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    same_metrics = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       and a[2] == b[2]
                       for a, b in zip(main["metrics"], eager_metrics))
    ge_differ = [k for k in main["tensors"]
                 if not torch.equal(main["tensors"][k], eager_tensors[k])]
    del eager_tensors
    # Round 2 again, from round 1's checkpoint (its EMA is the teacher).
    first_state = create_train_state(XUNet(cfg.model).cuda().eval(),
                                     cfg.train)
    CheckpointManager(os.path.join(
        DISTILL_WORKDIR, f"steps_{DISTILL_START // 2}")).restore(first_state)
    round1_ema = {k: v.clone() for k, v in first_state.ema.items()}
    del first_state
    rerun = _distill_run(cfg, round1_ema, False,
                         start_step=DISTILL_ROUND_STEPS,
                         start_steps=DISTILL_START // 2)
    rerun_same = all(torch.equal(rerun["final"][k].cpu(), main["final"][k])
                     for k in main["final"])
    del rerun, round1_ema
    gc.collect()
    torch.cuda.empty_cache()
    loss_err, grad_rel, lk, lp, kp_launches = _distill_kernel_vs_plain(
        cfg, teacher)
    # The distilled EMA drives a k = 2 DDIM sampler.
    view_model = XUNet(cfg.model).cuda()
    with torch.no_grad():
        params = dict(view_model.named_parameters())
        for k, v in main["final"].items():
            params[k].copy_(v)
    sampler = Sampler(view_model, cfg, sampler_kind="ddim",
                      steps=DISTILL_FINAL)
    t0 = time.perf_counter()
    view = sampler.synthesize(orbit_views(3, cfg.model.H, seed=4),
                              torch.Generator("cuda").manual_seed(0),
                              max_views=2)
    view_s = time.perf_counter() - t0
    del teacher, main, sampler, view_model, params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(DISTILL_WORKDIR, ignore_errors=True)
    out.update({
        "checkpoint_step": got_step,
        "checkpoint_restore_bit_exact": not ckpt_differ,
        "graph_vs_eager_bit_identical": same_metrics and not ge_differ,
        "graph_vs_eager_tensors_differing": len(ge_differ),
        "round2_rerun_from_round1_checkpoint_bit_identical": rerun_same,
        "kernel_vs_plain": {"batch": STEP_BATCH, "student_steps":
                            DISTILL_FINAL, "loss_kernel": lk,
                            "loss_plain": lp, "loss_rel_err": loss_err,
                            "grad_rel_l2": grad_rel,
                            "launches": kp_launches},
        "ddim_view": {"steps": DISTILL_FINAL, "seconds": round(view_s, 3),
                      "shape": list(view.shape),
                      "finite": bool(np.isfinite(view).all())},
        "tolerance": f"graph vs eager, checkpoints: bit-identical (cuDNN "
                     f"deterministic); kernel vs plain (bf16): loss "
                     f"{BF16_STEP_LOSS_TOL} relative, gradients "
                     f"{BF16_STEP_GRAD_TOL} relative L2"})
    emit(dict(phase="distill", **out))
    if ckpt_differ or got_step != DISTILL_ROUND_STEPS:
        raise AssertionError(f"distill: the last round's checkpoint "
                             f"(step {got_step}) differs: {ckpt_differ[:3]}")
    if not (same_metrics and not ge_differ):
        raise AssertionError(f"distill: graph and eager differ "
                             f"({len(ge_differ)} tensors, e.g. "
                             f"{ge_differ[:3]})")
    if not rerun_same:
        raise AssertionError("distill: round 2 from round 1's checkpoint "
                             "differs")
    if not (loss_err <= BF16_STEP_LOSS_TOL and grad_rel <= BF16_STEP_GRAD_TOL
            and all(math.isfinite(x) for x in out["loss"])):
        raise AssertionError(f"distill: kernel vs plain "
                             f"{out['kernel_vs_plain']}, losses "
                             f"{out['loss']}")
    if not out["ddim_view"]["finite"]:
        raise AssertionError("distill: the DDIM view is not finite")
    return out


def _expect_exit(fn, argv):
    """``fn(argv)`` must exit with a non-zero status; returns its
    message."""
    try:
        fn(argv)
    except SystemExit as e:
        if e.code in (0, None):
            raise AssertionError(f"{argv}: exit status {e.code}")
        return str(e.code)[:300]
    raise AssertionError(f"{argv}: returned instead of exiting non-zero")


def phase_convert():
    """A reference ``.pt`` at srn64 and at srn128 full width, seeded random
    weights in the reference's key scheme (``expected_torch_state``):
    ``convert_cli --verify``, then ``convert_cli`` (step kept, the
    schedule at it, zero Adam moments, EMA = weights); key counts against
    the port's parameters; a file with a key dropped and one with a shape
    changed exit non-zero; ``sample_cli --sampler ddim --steps 8`` on the
    converted srn64 checkpoint: a finite view."""
    import torch

    from diff3d_tpu_torch import config as config_lib
    from diff3d_tpu_torch.cli import convert_cli, sample_cli
    from diff3d_tpu_torch.convert import expected_torch_state
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.sampling import Sampler

    shutil.rmtree(CONVERT_WORKDIR, ignore_errors=True)
    os.makedirs(CONVERT_WORKDIR)
    out = {}
    for config in ("srn64", "srn128"):
        cfg = getattr(config_lib, f"{config}_config")()
        expected = expected_torch_state(cfg.model)
        g = torch.Generator().manual_seed(3)
        sd = {k: 0.02 * torch.randn(shape, generator=g)
              for k, shape in expected.items()}
        pt = os.path.join(CONVERT_WORKDIR, f"{config}.pt")
        torch.save({"model": sd, "optim": {}, "step": CONVERT_STEP}, pt)
        dst = os.path.join(CONVERT_WORKDIR, f"{config}_ckpt")
        base = ["--torch_ckpt", pt, "--out", dst, "--config", config]
        t0 = time.perf_counter()
        convert_cli.main(base + ["--verify"])
        verify_s = time.perf_counter() - t0
        if os.path.exists(dst):
            raise AssertionError("convert: --verify wrote a checkpoint")
        t0 = time.perf_counter()
        convert_cli.main(base)
        convert_s = time.perf_counter() - t0
        saved = torch.load(os.path.join(dst, f"ckpt_{CONVERT_STEP}.pt"),
                           map_location="cpu", weights_only=True)
        with torch.device("meta"):
            n_params = len(list(XUNet(cfg.model).parameters()))
        attn = sum(1 for k in expected if k.endswith("in_proj_weight"))
        ok = (saved["step"] == CONVERT_STEP
              and saved["sched"]["last_epoch"] == CONVERT_STEP
              and saved["optim"]["state"] == {}
              and len(saved["model"]) == n_params == len(sd) + 4 * attn
              and all(torch.equal(saved["model"][k], saved["ema"][k])
                      for k in saved["model"]))
        out[config] = {"reference_keys": len(sd), "port_parameters":
                       n_params, "attention_layers": attn,
                       "converted_tensors": len(saved["model"]),
                       "bytes_pt": os.path.getsize(pt),
                       "verify_s": round(verify_s, 3),
                       "convert_s": round(convert_s, 3), "ok": ok}
        del saved, sd
        gc.collect()
        if not ok:
            raise AssertionError(f"convert {config}: {out[config]}")
        if config == "srn64":
            keys = sorted(expected)
            bad = torch.load(pt, weights_only=True)
            bad["model"].pop(keys[0])
            dropped = os.path.join(CONVERT_WORKDIR, "dropped.pt")
            torch.save(bad, dropped)
            bad = torch.load(pt, weights_only=True)
            bad["model"][keys[1]] = torch.zeros(3)
            reshaped = os.path.join(CONVERT_WORKDIR, "reshaped.pt")
            torch.save(bad, reshaped)
            del bad
            out["mutated"] = {
                name: _expect_exit(convert_cli.main, [
                    "--torch_ckpt", path, "--out",
                    os.path.join(CONVERT_WORKDIR, "never"), "--config",
                    "srn64"])
                for name, path in (("key_dropped", dropped),
                                   ("shape_changed", reshaped))}
            if os.path.exists(os.path.join(CONVERT_WORKDIR, "never")):
                raise AssertionError("convert: a mutated file was written")
            # sample_cli on the converted checkpoint, 8 DDIM steps.
            obj = write_srn_object(os.path.join(CONVERT_WORKDIR, "object"),
                                   orbit_views(3, cfg.model.H, seed=6))
            got, real = [], Sampler.synthesize

            def keep(self, *a, **k):
                got.append(real(self, *a, **k))
                return got[-1]

            Sampler.synthesize = keep
            t0 = time.perf_counter()
            try:
                sample_cli.main(["--config", "srn64", "--model", dst,
                                 "--target", obj, "--out",
                                 os.path.join(CONVERT_WORKDIR, "sampling"),
                                 "--max_views", "2", "--sampler", "ddim",
                                 "--steps", "8"])
            finally:
                Sampler.synthesize = real
            out["sample_cli"] = {
                "steps": 8, "sampler": "ddim",
                "seconds": round(time.perf_counter() - t0, 3),
                "views": int(got[0].shape[0]) if got else 0,
                "finite": bool(got and np.isfinite(got[0]).all())}
            if not out["sample_cli"]["finite"]:
                raise AssertionError(f"convert: sample_cli {out}")
        shutil.rmtree(dst, ignore_errors=True)
        os.remove(pt)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(CONVERT_WORKDIR, ignore_errors=True)
    emit(dict(phase="convert", **out))
    return out


def phase_srn128_init_from(accum):
    """``train_cli --config srn128 --ch 128 --init_from <the srn64 train
    phase's checkpoint> --init_res 64 --synthetic_scenes --accum <accum>``
    (srn64's width: a transfer keeps every width, only H and W change) at
    global batch 128 for 2 steps on the graph path (checkpoint mode
    ``ema_bf16``): before the first step every parameter and EMA tensor
    but ``pos_emb`` equals the srn64 source's EMA, and ``pos_emb`` is 128
    x 128; finite losses; s/step."""
    import torch

    from diff3d_tpu_torch.cli import train_cli
    from diff3d_tpu_torch.config import srn64_config
    from diff3d_tpu_torch.models import XUNet
    from diff3d_tpu_torch.train import CheckpointManager

    src_dir = os.path.join(WORKDIR, "checkpoints")
    src = XUNet(srn64_config().model)
    src_step = CheckpointManager(src_dir).restore_ema(
        dict(src.named_parameters()))
    want = {k: v.detach() for k, v in src.named_parameters()}
    shutil.rmtree(INIT_WORKDIR, ignore_errors=True)
    argv = ["--config", "srn128", "--ch", str(src.cfg.ch),
            "--synthetic_scenes", "--batch",
            str(TRAIN_BATCH), "--accum", str(accum), "--steps", "2",
            "--warmup_examples", str(10 * TRAIN_BATCH), "--num_workers",
            "8", "--ckpt_mode", "ema_bf16", "--workdir", INIT_WORKDIR,
            "--init_from", src_dir, "--init_res", "64"]
    t0 = time.perf_counter()
    trainer = train_cli.build_trainer(train_cli.build_parser().parse_args(
        argv))
    build_s = time.perf_counter() - t0
    state = trainer.state
    differ, pos_shape = [], None
    for name, p in state.model.named_parameters():
        if name.endswith("pos_emb"):
            pos_shape = tuple(p.shape)
            continue
        if not (torch.equal(p.detach().cpu(), want[name])
                and torch.equal(state.ema[name].cpu(), want[name])):
            differ.append(name)
    inner = trainer.step_fn
    rec = []

    def timed(st, batch, draws=None):
        m = inner(st, batch, draws)
        rec.append({"t": time.perf_counter(), "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
        return m

    trainer.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer.train()
    finally:
        trainer.loader.close()
    times = np.diff([t0] + [r["t"] for r in rec])
    marker = json.load(open(os.path.join(INIT_WORKDIR, "checkpoints",
                                         "ckpt_format.json")))
    out = {"config": "srn128 at srn64's width (--ch 128)",
           "source": f"srn64 step {src_step} (EMA)",
           "init_res": 64, "accum_steps": accum,
           "global_batch": TRAIN_BATCH, "tensors_differing": len(differ),
           "pos_emb_shape": list(pos_shape or ()),
           "build_s": round(build_s, 3),
           "step_s": [float(t) for t in times],
           "s_per_step": float(times[-1]),
           "loss": [r["loss"] for r in rec],
           "grad_norm": [r["grad_norm"] for r in rec],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "checkpoint_mode": marker["mode"]}
    inner.release()
    del trainer, inner, state
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(INIT_WORKDIR, ignore_errors=True)
    emit(dict(phase="srn128_init_from", **out))
    if differ or pos_shape != (128, 128, 144):
        raise AssertionError(f"srn128_init_from: {len(differ)} tensors "
                             f"differ from the source (e.g. {differ[:3]}), "
                             f"pos_emb {pos_shape}")
    if len(rec) != 2 or not all(math.isfinite(r["loss"]) for r in rec):
        raise AssertionError(f"srn128_init_from: steps {rec}")
    return out


def kernel_entries(rows, design):
    """The ``kernels`` line's entries: ``rows`` of ``(name, source,
    replaces, launches, stats, per)``."""
    return [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n,
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
        "library_ms": stats["library_ms"], "per": per,
        **{k: stats[k] for k in ("call_ms", "call_plain_ms",
                                 "call_library_ms") if k in stats},
        "launches_counted": "eager launches + captured x replays of "
                            "the path's CUDA graphs",
        "design": design[name.split("@")[0]]}
        for name, source, replaces, n, stats, per in rows]


def main() -> None:
    import torch

    phase_device()
    ptxas = phase_build()
    phase_native()
    cfg, model = srn64_model()
    batch, cond_mask = model_batch(cfg, 2 * len(cfg.diffusion.guidance_weights),
                                   seed=5)
    gn_sites, attn_sites = record_sites(model, batch, cond_mask)
    gn = phase_groupnorm(gn_sites)
    attn = phase_attention(attn_sites)
    emit(phase_model(cfg, model, batch, cond_mask))
    launches, steps = phase_sampler(cfg, model)
    phase_sampler_graph(cfg, model)
    phase_sampler_many(cfg, model)
    gc.collect()
    torch.cuda.empty_cache()

    # The single-engine service (serve_cli over HTTP), then rows 1 and 3
    # at its 4-lane view step's sites.
    serve = phase_serve(cfg, model)
    lanes4 = 4 * 2 * len(cfg.diffusion.guidance_weights)
    gn_serve_sites, attn_serve_sites = record_sites(
        model, *model_batch(cfg, lanes4, seed=7))
    gn_serve = phase_groupnorm(gn_serve_sites, phase="serve_groupnorm",
                               odd_shapes=False)
    attn_serve = phase_attention(attn_serve_sites, phase="serve_attention",
                                 extra_shapes=False)
    gc.collect()
    torch.cuda.empty_cache()

    # The fleet: two replicas behind the router, then worker processes
    # fronted remote-only; rows 1 and 3 at the 2-lane view step's sites.
    fleet = phase_serve_fleet(cfg, model)
    workers = phase_serve_workers(cfg, model)
    lanes2 = 2 * 2 * len(cfg.diffusion.guidance_weights)
    gn_fleet_sites, attn_fleet_sites = record_sites(
        model, *model_batch(cfg, lanes2, seed=8))
    gn_fleet = phase_groupnorm(gn_fleet_sites, phase="serve_fleet_groupnorm",
                               odd_shapes=False)
    attn_fleet = phase_attention(attn_fleet_sites,
                                 phase="serve_fleet_attention",
                                 extra_shapes=False)
    gc.collect()
    torch.cuda.empty_cache()

    # The training sites: one microbatch of the train phase.
    mb = TRAIN_BATCH // TRAIN_ACCUM
    gn_train, attn_train = record_sites(model, *model_batch(cfg, mb, seed=6))
    gn_fwd, gn_bwd = phase_groupnorm_backward(gn_train, TRAIN_ACCUM)
    attn_rows = phase_attention_backward(attn_train, TRAIN_ACCUM)
    phase_train_step(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    graph_run = phase_train_graph(TRAIN_ACCUM)
    train = phase_train(TRAIN_ACCUM)
    tl = train["launches"]
    vl = {k: sum(e["launches"][k]
                 for e in train["preemption_and_eval"]["evals"])
          for k in ("fused_groupnorm", "flash_attention")}
    phase_eval()
    par, tp_run, cp_run, mesh_run = phase_parallel(graph_run)
    del graph_run
    tpar = phase_tensor_parallel(*tp_run)
    cpar = phase_context_parallel(*cp_run)
    mpar = phase_serve_mesh(*mesh_run, serve["s_per_view_step"])
    del tp_run, cp_run, mesh_run
    gc.collect()
    torch.cuda.empty_cache()

    # Distillation from the train phase's checkpoint (its student step is
    # one training microbatch's work; the teacher's two forwards run rows
    # 1 and 3 at the same sites), then reference-checkpoint conversion.
    if DISTILL_BATCH != mb:
        raise AssertionError("distill: its sites are the train phase's")
    distilled = phase_distill()
    dl = distilled["launches"]
    gn_teacher = phase_groupnorm(gn_train, phase="distill_groupnorm",
                                 odd_shapes=False)
    attn_teacher = phase_attention(attn_train, phase="distill_attention",
                                   extra_shapes=False)
    phase_convert()

    # srn128: the model, its sampling path, its training path (the
    # Trainer's run decides accum_steps), then its kernel sites.
    cfg128, model128 = phase_srn128_model(ptxas)
    l128, _ = phase_srn128_sampler(cfg128, model128)
    # The served cascade (a 64^2 draft at srn128 widths, a truncated
    # 128^2 refine), then rows 1 and 3 at its draft's and refine's sites.
    cascade, csites = phase_serve_cascade(cfg128, model128)
    gn_casc = {p: phase_groupnorm(csites[p][0],
                                  phase="serve_cascade_groupnorm",
                                  odd_shapes=False, site=p)
               for p in ("draft", "refine")}
    attn_casc = {p: phase_attention(csites[p][1],
                                    phase="serve_cascade_attention",
                                    extra_shapes=False, site=p)
                 for p in ("draft", "refine")}
    gc.collect()
    torch.cuda.empty_cache()
    t128 = phase_srn128_train(cfg128, model128)
    del model128
    gc.collect()
    torch.cuda.empty_cache()
    accum128 = t128["accum_steps"]
    gn128, attn128, gn_fwd128, gn_bwd128, attn128_rows = phase_srn128_sites(
        cfg128, accum128, t128["launches_per_step"])
    tl128 = t128["launches"]
    phase_srn128_init_from(accum128)
    shutil.rmtree(WORKDIR, ignore_errors=True)

    film, att = ("diff3d_tpu_torch/ops/csrc/film.cu",
                 "diff3d_tpu_torch/ops/csrc/attention.cu")
    gn_fwd_at, gn_bwd_at = ("diff3d_tpu/ops/pallas_film.py:277",
                            "diff3d_tpu/ops/pallas_film.py:414")
    fa_at, dkdv_at, dq_at = ("diff3d_tpu/ops/pallas_attention.py:185",
                             "diff3d_tpu/ops/pallas_attention.py:287",
                             "diff3d_tpu/ops/pallas_attention.py:306")
    sample_per = "one denoise step (2B=16) at srn64, summed over sites"
    train_per = (f"one train step (global batch {TRAIN_BATCH}, accum_steps "
                 f"{TRAIN_ACCUM}) at srn64, summed over sites")
    sample128 = "one denoise step (2B=16) at srn128, summed over sites"
    serve_per = (f"one denoise step of a served view step at 4 lanes "
                 f"(N*2B = {lanes4}) at srn64, summed over sites; "
                 "launches: the serve phase's (warm-up captures, every "
                 "served view step)")
    fleet_per = (f"one denoise step of a served view step at 2 lanes "
                 f"(N*2B = {lanes2}) at srn64, summed over sites; launches: "
                 "the serve_fleet phase's (both replicas: warm-up captures, "
                 "every served view step)")
    workers_per = (f"one denoise step of a served view step at 2 lanes "
                   f"(N*2B = {lanes2}) at srn64, summed over sites (the "
                   "worker's warm-up runs 1 and 2 lanes); launches: the "
                   "first worker process's (warm-up captures, the served "
                   "request), read over the wire")
    mesh_per = (f"one denoise step of a served view step at 4 lanes on "
                f"one rank of the data=2 mesh (2 ranks on one card over "
                f"gloo): the rank's 2 lanes (N*2B = {lanes2}) at srn64, "
                "summed over sites; rank 0's times; launches: "
                "rank 0's serve_mesh service (warm-up captures at 2 and 4 "
                "lanes, every served view step)")
    mesh_fleet_per = ("one denoise step of a served view step at 2 lanes "
                      "on one rank of the data=2 mesh under serve_cli "
                      "--mesh --replicas 2 (2 gloo ranks on one card): the "
                      "rank's 1 lane (N*2B = 16) at srn64, summed over "
                      "sites, which are the sampler's (timed in phases "
                      "groupnorm and attention); launches: rank 0's fleet "
                      "leg, both replicas (warm-up captures, every served "
                      "view step)")
    casc_lanes = 2 * 2 * len(cfg128.diffusion.guidance_weights)
    casc_per = {p: (f"one denoise step of the served cascade's {p} phase at "
                    f"2 lanes (N*2B = {casc_lanes}, {res}^2, srn128 "
                    "widths), summed over sites; launches: the "
                    f"serve_cascade phase's {p} phase (1 and 2 lanes)")
                for p, res in (("draft", 64), ("refine", 128))}
    train128 = (f"one train step (global batch {TRAIN_BATCH}, accum_steps "
                f"{accum128}, remat 'nothing': the forward kernels run "
                "again in each block's recompute) at srn128, summed over "
                "sites")
    teacher_per = (f"one distill step (batch {DISTILL_BATCH}) at srn64: "
                   "the teacher's two forwards, summed over sites; "
                   "launches: every forward launch of the wrapper (teacher "
                   "and student)")
    val_per = (f"one val forward of the Trainer's --eval_every (batch "
               f"{TRAIN_BATCH}, EMA weights, no grad) at srn64: the train "
               "sites without statistics, summed over sites; launches: the "
               f"{len(train['preemption_and_eval']['evals'])} evals of "
               "the train phase's run with --eval_every")
    rb, rl, rh, rd = RING_SHAPE
    ring_per = (f"one ring block at 2 ranks on one card (gloo) at srn128's "
                f"L = {rl} site, {list(RING_SHAPE)} bf16: a rank's q "
                f"[{rb}, {rl // RING_WORLD}, {rh}, {rd}] against one block "
                f"of {rl // RING_WORLD} keys, the kernel alone, the slowest "
                "rank; call_*: one rank's whole ring call, the transfers "
                "staged through host memory included; launches: rank 0's "
                "over one forward and backward")
    ulysses_per = (f"Ulysses' core at 2 ranks on one card (gloo), "
                   f"{list(RING_SHAPE)} bf16: one rank's {rh // RING_WORLD} "
                   f"heads over all {rl} tokens, the kernel alone, the "
                   "slowest rank; call_*: one rank's whole Ulysses "
                   "forward, the all-to-alls included; launches: rank 0's")
    tp_sample = ("one srn64 forward at 2B=16 on one rank of the tp mesh "
                 "(dp1 x mp2, 2 ranks on one card over gloo): the rank's "
                 "blocks (C/2 channels, G/2 groups, 2 of 4 heads), summed "
                 "over sites; rank 0's times; launches: rank 0's "
                 f"bf16 forward and {TP_SAMPLER_STEPS}-step float32 "
                 "Sampler(mesh) view")
    tp_train = (f"one srn64 train step at global batch {TP_BATCH} on one "
                "rank of the tp mesh (dp1 x mp2, 2 ranks on one card over "
                "gloo): the rank's blocks, summed over sites; rank 0's "
                f"times; launches: rank 0's {TP_STEPS} eager steps")
    cp_sample = ("one srn64 forward at 2B=16 on one rank of the context-"
                 "parallel mesh (dp1 x mp2, 2 ranks on one card over gloo): "
                 "the rank's 32 of 64 rows at every level (attention: its "
                 "queries against all keys), summed over sites; rank 0's "
                 "times; launches: rank 0's bf16 forward and "
                 f"{CP_SAMPLER_STEPS}-step float32 Sampler(mesh) view")
    cp_train = (f"one srn64 train step at global batch {TP_BATCH} on one "
                "rank of the context-parallel mesh (dp1 x mp2, 2 ranks on "
                "one card over gloo): the rank's rows, summed over sites; "
                f"rank 0's times; launches: rank 0's {CP_STEPS} "
                "eager steps")
    leg_per = {m: (f"one srn64 distill step (k = {DISTILL_LEG_K}) at global "
                   f"batch {TP_BATCH} on one rank of the {mesh} (dp1 x mp2, 2 "
                   "ranks on one card over gloo), at the train step's sites "
                   f"(the rank's {part}): {{}}; rank 0's times; "
                   f"launches: rank 0's {DISTILL_LEG_STEPS} eager steps, the "
                   "wrapper's (teacher and student)")
               for m, mesh, part in (("tp", "tp mesh", "blocks"),
                                     ("cp", "context-parallel mesh",
                                      "rows"))}
    student_per = (f"one distill step (batch {DISTILL_BATCH}) at srn64: "
                   "the student's forward and backward (a train step's "
                   "sites), summed over sites; launches of the wrapper")

    cluster = "one thread-block cluster per sample, DSMEM exchange"
    design = {"fused_groupnorm": cluster,
              "fused_groupnorm[save_stats]": cluster,
              "flash_attention": "mma.sync bf16",
              "flash_attention[save_lse]": "mma.sync bf16",
              "attention_backward_dkdv": "mma.sync bf16",
              "attention_backward_dq": "mma.sync bf16",
              "groupnorm_backward": cluster,
              "flash_attention_lse": "mma.sync bf16 (row 4) per ring "
                                     "block, blocks merged by log-sum-exp",
              "attention_backward": "mma.sync bf16 dK/dV and dQ (rows 5 "
                                    "and 6) per ring block, with the "
                                    "merge's lse cotangent",
              "groupnorm_partial_sums": "one block per (sample, group), "
                                        "f64 sums folded in a fixed tree",
              "groupnorm_apply_sums": "grid-stride element loop, the "
                                      "statistics from the summed f64 sums",
              "groupnorm_backward_partial_sums": "one block per (sample, "
                                                 "group), f32 sums in a "
                                                 "fixed tree, then the "
                                                 "[N, C] fold over N",
              "groupnorm_backward_apply_sums": "grid-stride element loop "
                                               "from the summed sums"}
    kernels = kernel_entries([
        ("fused_groupnorm", film, gn_fwd_at, launches["fused_groupnorm"], gn,
         sample_per),
        ("fused_groupnorm[save_stats]", film, gn_fwd_at,
         tl["fused_groupnorm"], gn_fwd, train_per),
        ("groupnorm_backward", film, gn_bwd_at, tl["groupnorm_backward"],
         gn_bwd, train_per),
        ("flash_attention", att, fa_at, launches["flash_attention"], attn,
         sample_per),
        ("flash_attention[save_lse]", att, fa_at, tl["flash_attention"],
         attn_rows["lse"], train_per),
        ("attention_backward_dkdv", att, dkdv_at,
         tl["attention_backward_dkdv"], attn_rows["dkdv"], train_per),
        ("attention_backward_dq", att, dq_at, tl["attention_backward_dq"],
         attn_rows["dq"], train_per),
        ("fused_groupnorm@serve", film, gn_fwd_at,
         serve["launches"]["fused_groupnorm"], gn_serve, serve_per),
        ("flash_attention@serve", att, fa_at,
         serve["launches"]["flash_attention"], attn_serve, serve_per),
        ("fused_groupnorm@serve_fleet", film, gn_fwd_at,
         fleet["launches"]["fused_groupnorm"], gn_fleet, fleet_per),
        ("flash_attention@serve_fleet", att, fa_at,
         fleet["launches"]["flash_attention"], attn_fleet, fleet_per),
        ("fused_groupnorm@serve_workers", film, gn_fwd_at,
         workers["launches"]["fused_groupnorm"], gn_fleet, workers_per),
        ("flash_attention@serve_workers", att, fa_at,
         workers["launches"]["flash_attention"], attn_fleet, workers_per),
        ("fused_groupnorm@serve_mesh", film, gn_fwd_at,
         mpar["kernel_launches"]["fused_groupnorm@serve_mesh"],
         mpar["kernel_stats"]["fused_groupnorm@serve_mesh"], mesh_per),
        ("flash_attention@serve_mesh", att, fa_at,
         mpar["kernel_launches"]["flash_attention@serve_mesh"],
         mpar["kernel_stats"]["flash_attention@serve_mesh"], mesh_per),
        ("fused_groupnorm@serve_mesh_replicas", film, gn_fwd_at,
         mpar["kernel_launches"]["fused_groupnorm@serve_mesh_replicas"], gn,
         mesh_fleet_per),
        ("flash_attention@serve_mesh_replicas", att, fa_at,
         mpar["kernel_launches"]["flash_attention@serve_mesh_replicas"],
         attn, mesh_fleet_per)]
        + [(f"{k}@cascade_{p}", src, at,
            cascade["launches_by_phase"][p][k], stats[p], casc_per[p])
           for k, src, at, stats in (
               ("fused_groupnorm", film, gn_fwd_at, gn_casc),
               ("flash_attention", att, fa_at, attn_casc))
           for p in ("draft", "refine")] + [
        ("fused_groupnorm@srn128", film, gn_fwd_at,
         l128["fused_groupnorm"], gn128, sample128),
        ("fused_groupnorm[save_stats]@srn128", film, gn_fwd_at,
         tl128["fused_groupnorm"], gn_fwd128, train128),
        ("groupnorm_backward@srn128", film, gn_bwd_at,
         tl128["groupnorm_backward"], gn_bwd128, train128),
        ("flash_attention@srn128", att, fa_at, l128["flash_attention"],
         attn128, sample128),
        ("flash_attention[save_lse]@srn128", att, fa_at,
         tl128["flash_attention"], attn128_rows["lse"], train128),
        ("attention_backward_dkdv@srn128", att, dkdv_at,
         tl128["attention_backward_dkdv"], attn128_rows["dkdv"], train128),
        ("attention_backward_dq@srn128", att, dq_at,
         tl128["attention_backward_dq"], attn128_rows["dq"], train128),
        ("fused_groupnorm@distill", film, gn_fwd_at, dl["fused_groupnorm"],
         _scaled(gn_teacher, 2), teacher_per),
        ("fused_groupnorm[save_stats]@distill", film, gn_fwd_at,
         dl["fused_groupnorm"], gn_fwd, student_per),
        ("groupnorm_backward@distill", film, gn_bwd_at,
         dl["groupnorm_backward"], gn_bwd, student_per),
        ("flash_attention@distill", att, fa_at, dl["flash_attention"],
         _scaled(attn_teacher, 2), teacher_per),
        ("flash_attention[save_lse]@distill", att, fa_at,
         dl["flash_attention"], attn_rows["lse"], student_per),
        ("attention_backward_dkdv@distill", att, dkdv_at,
         dl["attention_backward_dkdv"], attn_rows["dkdv"], student_per),
        ("attention_backward_dq@distill", att, dq_at,
         dl["attention_backward_dq"], attn_rows["dq"], student_per),
        ("fused_groupnorm@val", film, gn_fwd_at, vl["fused_groupnorm"],
         gn_teacher, val_per),
        ("flash_attention@val", att, fa_at, vl["flash_attention"],
         attn_teacher, val_per)]
        + [(name, att, at, par["kernel_launches"][name],
            par["kernel_stats"][name], per)
           for name, at, per in (
               ("flash_attention_lse@ring", fa_at, ring_per),
               ("attention_backward@ring", f"{dkdv_at}, {dq_at}",
                ring_per + " (the backward: rows 5 and 6)"),
               ("flash_attention@ulysses", fa_at, ulysses_per))]
        + [(name, src, at, tpar["kernel_launches"][name],
            tpar["kernel_stats"][name], per)
           for name, src, at, per in (
               ("fused_groupnorm@tp", film, gn_fwd_at, tp_sample),
               ("fused_groupnorm[save_stats]@tp", film, gn_fwd_at,
                tp_train),
               ("groupnorm_backward@tp", film, gn_bwd_at, tp_train),
               ("flash_attention@tp", att, fa_at, tp_sample),
               ("flash_attention[save_lse]@tp", att, fa_at, tp_train),
               ("attention_backward_dkdv@tp", att, dkdv_at, tp_train),
               ("attention_backward_dq@tp", att, dq_at, tp_train))]
        + [(name, src, at, cpar["kernel_launches"][name],
            cpar["kernel_stats"][name], per)
           for name, src, at, per in (
               ("groupnorm_partial_sums@cp", film, gn_fwd_at, cp_sample),
               ("groupnorm_apply_sums@cp", film, gn_fwd_at, cp_sample),
               ("groupnorm_backward_partial_sums@cp", film, gn_bwd_at,
                cp_train),
               ("groupnorm_backward_apply_sums@cp", film, gn_bwd_at,
                cp_train),
               ("flash_attention@cp", att, fa_at, cp_sample),
               ("flash_attention[save_lse]@cp", att, fa_at, cp_train),
               ("attention_backward_dkdv@cp", att, dkdv_at, cp_train),
               ("attention_backward_dq@cp", att, dq_at, cp_train))]
        + [(name, src, at, par_["kernel_launches"][name],
            par_["kernel_stats"][name], leg_per[m].format(what))
           for m, par_, rows in (
               ("tp", tpar, (
                   ("fused_groupnorm", film, gn_fwd_at,
                    "the teacher's two forwards"),
                   ("fused_groupnorm[save_stats]", film, gn_fwd_at,
                    "the student's forward"),
                   ("groupnorm_backward", film, gn_bwd_at,
                    "the student's backward"),
                   ("flash_attention", att, fa_at,
                    "the teacher's two forwards"),
                   ("flash_attention[save_lse]", att, fa_at,
                    "the student's forward"),
                   ("attention_backward_dkdv", att, dkdv_at,
                    "the student's backward"),
                   ("attention_backward_dq", att, dq_at,
                    "the student's backward"))),
               ("cp", cpar, (
                   ("groupnorm_partial_sums", film, gn_fwd_at,
                    "the teacher's two forwards and the student's"),
                   ("groupnorm_apply_sums", film, gn_fwd_at,
                    "the teacher's two forwards and the student's"),
                   ("groupnorm_backward_partial_sums", film, gn_bwd_at,
                    "the student's backward"),
                   ("groupnorm_backward_apply_sums", film, gn_bwd_at,
                    "the student's backward"),
                   ("flash_attention", att, fa_at,
                    "the teacher's two forwards"),
                   ("flash_attention[save_lse]", att, fa_at,
                    "the student's forward"),
                   ("attention_backward_dkdv", att, dkdv_at,
                    "the student's backward"),
                   ("attention_backward_dq", att, dq_at,
                    "the student's backward"))))
           for k, src, at, what in rows
           for name in [f"{k}@{m}_distill"]],
        design)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def torchrun_entry_points(argv) -> None:
    """Phase ``parallel`` (d) under torchrun: ``train_cli.main`` on the
    argv before ``--then-eval``, ``eval_cli.main`` on the argv up to
    ``--then-serve``, then ``serve_cli.main --mesh`` on the rest (a
    client thread posts two requests to it, then SIGTERMs this process),
    in the one group torchrun's environment names (each CLI uses a group
    its caller made and leaves it up).  The eval's line is printed second
    to last; last, the seconds of eval and serve and the two answers."""
    import threading

    from diff3d_tpu_torch.cli import eval_cli, serve_cli, train_cli
    from diff3d_tpu_torch.parallel import (maybe_initialize_distributed,
                                           shutdown_distributed)

    cut, serve_at = argv.index("--then-eval"), argv.index("--then-serve")
    if not maybe_initialize_distributed():
        raise SystemExit("--torchrun-entry-points: no group (run it under "
                         "torchrun)")
    port = _free_port()
    answers = []

    def client():
        deadline = time.monotonic() + SERVE_WAIT_S
        while True:
            try:
                _serve_http(port, "/healthz")
                break
            except OSError:
                if time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        try:
            for seed in (61, 62):
                status, body = _serve_http(port, "/synthesize",
                                           _serve_payload(orbit_views(
                                               3, 64, seed), seed))
                views = _views_of(json.loads(body))
                answers.append({"status": status,
                                "shape": list(views.shape),
                                "finite": bool(np.isfinite(views).all())})
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        train_cli.main(argv[:cut])
        t0 = time.perf_counter()
        eval_cli.main(argv[cut + 1:serve_at])
        eval_s = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        threading.Thread(target=client, daemon=True).start()
        serve_cli.main(argv[serve_at + 1:] + ["--port", str(port)])
        serve_s = round(time.perf_counter() - t0, 3)
    finally:
        shutdown_distributed()
    sys.stdout.flush()
    print(json.dumps({"eval_s": eval_s, "serve_s": serve_s,
                      "serve_answers": answers}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--srn128-graph-trial"]:
        graph_trial(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--torchrun-entry-points"]:
        torchrun_entry_points(sys.argv[2:])
    else:
        main()
