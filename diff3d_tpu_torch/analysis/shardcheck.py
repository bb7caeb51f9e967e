"""The program registry and the communication check (counterpart:
``diff3d_tpu/analysis/shardcheck.py``).

:data:`REGISTRY` names the programs the port ships, the JAX registry's
eight, each built at the JAX registry's tiny configuration over the fake
world's data axis (:data:`~diff3d_tpu_torch.analysis.ir.MESH_DEVICES`
ranks, ``fsdp`` where the JAX registry has it) and traced on fake
tensors (:mod:`~diff3d_tpu_torch.analysis.ir`):

  * ``train_step`` / ``distill_step``: ``test_config(imgsize=16, ch=8,
    shallow=True)`` under FSDP2 (its all-gathers and reduce-scatters
    are traced through ``make_fx`` as ``c10d`` nodes), one rank's
    microbatch of the global batch 8;
  * ``step_many``, ``step_many_ddim`` (2 steps) and ``serving_warmup``
    (through ``ProgramCache.lower``): ``test_config(imgsize=8, ch=8)``,
    8 lanes, record capacity 4;
  * ``step_many_pallas``: the JAX registry's ``kernels="pallas"`` program
    has no separate counterpart (every port program holds its kernels);
    its place is ``step_many`` with ``set_kernels("torch")``, the plain
    versions -- the program the card check holds the kernels against;
  * ``step_many_cascade_draft`` / ``_refine``: the cascade
    ``draft=8:ddim:2,refine=16:ancestral:2@t0.5`` over
    ``test_config(imgsize=16, ch=8)``.

Programs are built once per process and device and shared by the four
checks.  The comms check reads each program's
:class:`~diff3d_tpu_torch.analysis.ir.ProgramReport` against its
manifest under ``runs/torch_shardcheck/``: collectives (count and bytes
per kind), dtype upcasts, f64 values, host syncs and transfers, pinned
staging, the kernel nodes by op, and the parameter placement against the
mesh's policy (rules SC2xx; SC001-003 are the manifest contract's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from diff3d_tpu_torch.analysis import ir
from diff3d_tpu_torch.analysis.manifests import Finding

TOOL = "torch_shardcheck"
PREFIX = "SC"
MANIFEST_DIR = "runs/torch_shardcheck"


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    name: str
    description: str
    build: Callable[[str], ir.Program]
    tier1: bool = False


def _fsdp_mesh(device: str):
    """The registry's mesh: the fake world's ranks on the data axis under
    ``fsdp``, its devices those of the fake tensors."""
    from diff3d_tpu_torch.config import MeshConfig
    from diff3d_tpu_torch.parallel import make_mesh

    ir.fake_world()
    return make_mesh(MeshConfig(data_parallel=ir.MESH_DEVICES,
                                model_parallel=1, param_sharding="fsdp"),
                     device_type=torch.device(device).type)


def _train_cfg():
    from diff3d_tpu_torch.config import test_config

    return test_config(imgsize=16, ch=8, shallow=True)


def _train_state(device: str):
    """A fake train state under FSDP2 at the registry's config, and a fake
    batch of one rank's rows."""
    from diff3d_tpu_torch.models.xunet import XUNet
    from diff3d_tpu_torch.train import create_train_state

    cfg = _train_cfg()
    env = _fsdp_mesh(device)
    tr = ir.Tracer(device)
    B = cfg.train.global_batch // env.data_size
    H = cfg.model.H
    with tr.mode, tr.device:
        model = XUNet(cfg.model)
        env.params(model)
        state = create_train_state(model, cfg.train, capturable=False)
    batch = {"imgs": tr.empty((B, 2, H, H, 3), torch.uint8),
             "R": tr.empty((B, 2, 3, 3)), "T": tr.empty((B, 2, 3)),
             "K": tr.empty((B, 3, 3))}
    return cfg, env, tr, state, batch


def _state_inputs(state, batch) -> Dict[str, torch.Tensor]:
    """The tensors a train step reads, by name: parameters (local shards),
    Adam's state, the EMA and the batch."""
    from diff3d_tpu_torch.train.step import _local

    out = {}
    for n, p in state.model.named_parameters():
        out[f"params.{n}"] = _local(p)
        for k, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[f"adam.{k}.{n}"] = _local(v)
    out.update({f"ema.{n}": _local(t) for n, t in state.ema.items()})
    out.update({f"batch.{k}": t for k, t in batch.items()})
    return out


def _train_program(name: str, state, env, parts, inputs) -> ir.Program:
    model = state.model
    return ir.Program(
        name=name, device=str(next(iter(inputs.values())).device),
        parts=parts, inputs=inputs,
        donated=tuple(k for k in inputs if k.startswith(
            ("params.", "adam.", "ema."))),
        placement=ir.placement_table(model),
        expected_placement=ir.policy_table(env, model),
        config={"imgsize": model.cfg.H, "ch": model.cfg.ch,
                "shallow": True, "global_batch": 8,
                "world": env.data_size, "placement": "fsdp"})


def build_train_step(device: str) -> ir.Program:
    from diff3d_tpu_torch.train.step import TrainStep

    cfg, env, tr, state, batch = _train_state(device)
    step = TrainStep(cfg, env=env)
    gen = torch.Generator(tr.device)
    with tr.mode:
        step(state, batch)               # Adam's state, FSDP2's lazy init
    inputs = _state_inputs(state, batch)
    graph = tr.trace(lambda: step._eager(state, batch, None, gen=gen))
    return _train_program("train_step", state, env,
                          [ir.Part("step", graph)], inputs)


def build_distill_step(device: str) -> ir.Program:
    from diff3d_tpu_torch.models.xunet import XUNet
    from diff3d_tpu_torch.train.distill import DistillStep

    cfg, env, tr, state, batch = _train_state(device)
    with tr.mode, tr.device:
        teacher = XUNet(cfg.model).eval()
        env.params(teacher)
    step = DistillStep(cfg, env=env)
    with tr.mode:
        step(state, teacher, batch, 2)
    inputs = _state_inputs(state, batch)
    inputs.update({f"teacher.{n}": getattr(p, "to_local", lambda: p)()
                   for n, p in teacher.named_parameters()})

    def run():
        with torch.enable_grad():
            return step(state, teacher, batch, 2)

    return _train_program("distill_step", state, env,
                          [ir.Part("step", tr.trace(run))], inputs)


def _sampler(device: str, sampler_kind: str = "ancestral",
             steps: Optional[int] = None, kernels: Optional[str] = None):
    from diff3d_tpu_torch.config import test_config
    from diff3d_tpu_torch.models import build_model
    from diff3d_tpu_torch.models.layers import set_kernels
    from diff3d_tpu_torch.sampling import Sampler

    cfg = test_config(imgsize=8, ch=8)
    env = _fsdp_mesh(device)
    model = build_model(cfg.model, device)
    if kernels is not None:
        set_kernels(model, kernels)
    return Sampler(model, cfg, device=device, sampler_kind=sampler_kind,
                   steps=steps, mesh=env, cuda_graphs=False)


def _named(program: ir.Program, name: str) -> ir.Program:
    return dataclasses.replace(program, name=name)


def build_step_many(device: str) -> ir.Program:
    return _named(_sampler(device).lower_step_many(ir.MESH_DEVICES, 4),
                  "step_many")


def build_step_many_pallas(device: str) -> ir.Program:
    return _named(_sampler(device, kernels="torch").lower_step_many(
        ir.MESH_DEVICES, 4), "step_many_pallas")


def build_step_many_ddim(device: str) -> ir.Program:
    return _named(_sampler(device, "ddim", steps=2).lower_step_many(
        ir.MESH_DEVICES, 4), "step_many_ddim")


def build_serving_warmup(device: str) -> ir.Program:
    from diff3d_tpu_torch.serving.cache import ProgramCache
    from diff3d_tpu_torch.serving.scheduler import Bucket

    sampler = _sampler(device)
    H = sampler.cfg.model.H
    return _named(ProgramCache(sampler).lower(Bucket(H, H, 4),
                                              ir.MESH_DEVICES),
                  "serving_warmup")


def _cascade(device: str):
    from diff3d_tpu_torch.cascade import CascadePlan, CascadeSampler
    from diff3d_tpu_torch.config import test_config
    from diff3d_tpu_torch.models import build_model

    cfg = test_config(imgsize=16, ch=8)
    env = _fsdp_mesh(device)
    model = build_model(cfg.model, device)
    plan = CascadePlan.parse("draft=8:ddim:2,refine=16:ancestral:2@t0.5")
    return CascadeSampler(model, cfg, plan, device=device, mesh=env,
                          cuda_graphs=False)


def build_cascade_draft(device: str) -> ir.Program:
    return _named(_cascade(device).draft.lower_step_many(ir.MESH_DEVICES, 4),
                  "step_many_cascade_draft")


def build_cascade_refine(device: str) -> ir.Program:
    return _named(_cascade(device).refine.lower_step_many(ir.MESH_DEVICES,
                                                          4),
                  "step_many_cascade_refine")


REGISTRY: Dict[str, ProgramSpec] = {s.name: s for s in (
    ProgramSpec("train_step", "train step under FSDP2 (tiny shallow "
                "config, fake world of 8)", build_train_step, tier1=True),
    ProgramSpec("step_many", "sampler step_many, ancestral full grid "
                "(8 lanes over the data axis, capacity 4)", build_step_many,
                tier1=True),
    ProgramSpec("step_many_pallas", "step_many with the plain versions "
                "(set_kernels('torch')): the port's counterpart of the "
                "JAX registry's Pallas program", build_step_many_pallas),
    ProgramSpec("distill_step", "progressive-distillation step under "
                "FSDP2", build_distill_step),
    ProgramSpec("step_many_ddim", "sampler step_many, DDIM 2 steps",
                build_step_many_ddim),
    ProgramSpec("serving_warmup", "the view-step program ProgramCache "
                "warms up (ProgramCache.lower)", build_serving_warmup),
    ProgramSpec("step_many_cascade_draft", "cascade draft phase "
                "(8x8 student, DDIM 2)", build_cascade_draft, tier1=True),
    ProgramSpec("step_many_cascade_refine", "cascade refine phase "
                "(16x16, truncated at t0.5, the drafts operand)",
                build_cascade_refine, tier1=True),
)}
TIER1_PROGRAMS = tuple(s.name for s in REGISTRY.values() if s.tier1)

_PROGRAMS: Dict[tuple, ir.Program] = {}


def build_program(name: str, device: str = "cpu") -> ir.Program:
    """The registered program ``name`` traced on fake ``device`` tensors
    (built once per process)."""
    spec = REGISTRY[name]
    key = (name, str(device), spec.build)
    if key not in _PROGRAMS:
        _PROGRAMS[key] = spec.build(device)
    return _PROGRAMS[key]


# ---- the comms check -------------------------------------------------------


def observe(program: ir.Program) -> tuple:
    """``(budgets, observed)`` of a program for its manifest."""
    rep = ir.analyze(program)
    observed = {
        "collectives": rep.collectives, "upcasts": rep.upcasts,
        "f64_values": rep.f64_values, "host": rep.host,
        "kernels": rep.kernels, "launches": rep.launches,
        "parts": rep.parts,
        "random_ops": _count(e["op"] for e in rep.random),
        "placement": program.placement,
        "placement_mismatches": rep.placement_mismatches,
        "config": program.config}
    budgets = {"collectives": rep.collectives,
               "upcasts": sum(rep.upcasts.values()),
               "f64_values": rep.f64_values,
               "host_syncs": rep.host["local_scalar_dense"]
               + rep.host["to_host"],
               "pinned": rep.host["pinned"], "kernels": rep.kernels}
    return budgets, observed


def _count(items) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for x in items:
        out[x] = out.get(x, 0) + 1
    return out


def check(program: ir.Program, manifest: dict) -> List[Finding]:
    name = program.name
    budgets, obs = observe(program)
    pin = manifest.get("budgets", {})
    out: List[Finding] = []
    for kind, got in budgets["collectives"].items():
        want = pin.get("collectives", {}).get(kind, {"count": 0,
                                                     "bytes": 0})
        if got["count"] > want["count"] or got["bytes"] > want["bytes"]:
            out.append(Finding(
                "SC201", name, kind,
                f"{got['count']} {kind} moving {got['bytes']} bytes a run, "
                f"pinned {want['count']} / {want['bytes']}"))
    for rule, field, what in (("SC202", "upcasts", "bf16/f16 -> f32 "
                               "upcasts"),
                              ("SC203", "f64_values", "float64 values"),
                              ("SC204", "host_syncs", "host syncs or "
                               "device-to-host copies"),
                              ("SC204", "pinned", "pinned host staging "
                               "buffers")):
        if budgets[field] > pin.get(field, 0):
            out.append(Finding(rule, name, field,
                               f"{budgets[field]} {what} a run, pinned "
                               f"{pin.get(field, 0)}"))
    want_k = pin.get("kernels", {})
    for op in sorted(set(want_k) | set(budgets["kernels"])):
        got = budgets["kernels"].get(op, 0)
        if got != want_k.get(op, 0):
            out.append(Finding("SC205", name, op,
                               f"{got} kernel nodes a run, pinned "
                               f"{want_k.get(op, 0)}"))
    for m in obs["placement_mismatches"]:
        out.append(Finding("SC206", name, m.split(":")[0],
                           f"parameter placement {m}"))
    return out
