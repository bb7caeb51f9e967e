"""The fake-world half of ``tests/test_torch_port_analysis.py``, run in a
process of its own (``python tests/_torch_port_analysis_worker.py
OUT.json``): the fake process group of 8 ranks is opened once per process.
Imports no JAX.

It checks the tier-1 programs against the committed manifests (all four
checks, one trace per program), runs each check's seeded mutation of a
live program (wrapped copies patched in this process; the package is not
edited), traces a forward and a context-parallel forward for their
kernel nodes, and reports the port's side of the argument-bytes and
draw-stream comparisons.  Everything lands in one JSON file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from diff3d_tpu_torch.analysis import (__main__ as cli, ir,  # noqa: E402
                                       manifests, memcheck, rngcheck,
                                       shardcheck)

DEVICE = "cpu"


def _findings(fs):
    return [dataclasses.asdict(f) for f in fs if not f.suppressed]


@contextlib.contextmanager
def patched(obj, name, value):
    old = inspect.getattr_static(obj, name)       # a staticmethod as it is
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _mutant(tool, build, *patches):
    """``tool``'s findings on the registry's ``step_many`` built under
    ``patches`` (``(obj, name, value)``), against its committed
    manifest."""
    mod = cli.TOOLS[tool]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(patched(*p))
        program = build(DEVICE)
    path = manifests.manifest_path(
        "step_many", os.path.join(ROOT, mod.MANIFEST_DIR))
    return _findings(mod.check(program, manifests.load(path, mod.TOOL)))


def controls() -> dict:
    import torch.distributed as dist

    from diff3d_tpu_torch.diffusion import core
    from diff3d_tpu_torch.sampling.runtime import Sampler

    build = shardcheck.build_step_many
    out = {}

    gather = Sampler._gather_views

    def twice(self, views, world):          # an extra all-gather
        extra = torch.empty((world,) + tuple(views.shape), dtype=views.dtype,
                            device=views.device)
        dist.all_gather_into_tensor(extra, views)
        return gather(self, views, world)

    out["extra_gather"] = _mutant("shardcheck", build,
                                  (Sampler, "_gather_views", twice))

    step = core.ReverseLoop.step

    def upcast(self):                       # an f32 upcast of a bf16 copy
        step(self)
        self.img.copy_(self.img.to(torch.bfloat16).float())

    out["upcast"] = _mutant("shardcheck", build,
                            (core.ReverseLoop, "step", upcast))

    def copied(out_views, record_imgs, lens):   # the write goes to a copy
        record_imgs = record_imgs.clone()
        at = torch.arange(len(lens), device=record_imgs.device)
        record_imgs[at, torch.tensor(lens, device=record_imgs.device)] = \
            out_views.to(record_imgs.dtype)
        return out_views, record_imgs, [s + 1 for s in lens]

    out["record_copy"] = _mutant("memcheck", build,
                                 (Sampler, "_commit", staticmethod(copied)))

    cfg_x0 = core._cfg_x0

    def clip_changed(eps_cond, eps_uncond, z, alpha, sigma, w, clip_x0):
        eps, z_start = cfg_x0(eps_cond, eps_uncond, z, alpha, sigma, w,
                              False)
        return eps, torch.clamp(z_start, -1.0, 0.5)   # one op changed

    out["changed_op"] = _mutant("equivcheck", build,
                                (core, "_cfg_x0", clip_changed))

    prepare = core.sample_loop_prepare

    class Swapped:                          # cond_idx drawn before the noise
        def __init__(self, draws):
            self.d = draws

        def init_noise(self, shape, device):
            self.idx = self.d.cond_idx(self.n, self.len, device)
            return self.d.init_noise(shape, device)

        def cond_idx(self, n_steps, record_len, device):
            return self.idx

    def reordered(**kw):
        d = Swapped(kw["draws"])
        d.n = core.sample_schedule_ts(
            kw.get("steps"), timesteps=kw["timesteps"],
            start_t=kw.get("start_t")).shape[0] - 1
        d.len = kw["record_len"]
        kw["draws"] = d
        return prepare(**kw)

    import diff3d_tpu_torch.sampling.runtime as runtime

    out["reordered_draw"] = _mutant(
        "rngcheck", build, (runtime, "sample_loop_prepare", reordered))
    src = open(os.path.join(ROOT, "diff3d_tpu_torch/diffusion/core.py"),
               encoding="utf-8").read()
    mutated = src.replace(
        "return torch.randn(tuple(shape), generator=self.generator,",
        "return torch.randn(tuple(shape),", 1)
    out["no_generator"] = _findings(rngcheck.lint_source(mutated,
                                                         "core.py"))
    out["no_generator_unmutated"] = _findings(rngcheck.lint_source(
        src, "core.py"))
    return out


def kernel_nodes() -> dict:
    """Kernel nodes of a traced forward (kernels and plain versions) and
    of a context-parallel forward, beside the model's sites."""
    from diff3d_tpu_torch.config import MeshConfig, test_config
    from diff3d_tpu_torch.models.layers import (AttnLayer, FrameGroupNorm,
                                                set_kernels)
    from diff3d_tpu_torch.models.xunet import XUNet
    from diff3d_tpu_torch.parallel import make_mesh

    def forward(cfg, place=None, kernels="cuda"):
        tr = ir.Tracer(DEVICE)
        with tr.mode:
            model = XUNet(cfg.model).eval()
            set_kernels(model, kernels)
            if place is not None:
                place(model)
        B, H = 4, cfg.model.H
        batch = {"x": tr.empty((B, H, H, 3)), "z": tr.empty((B, H, H, 3)),
                 "logsnr": tr.empty((B, 2)), "R": tr.empty((B, 2, 3, 3)),
                 "t": tr.empty((B, 2, 3)), "K": tr.empty((B, 3, 3))}
        mask = tr.empty((B,), torch.bool)

        def run():
            with torch.inference_mode():
                return model(batch, mask)

        gm = tr.trace(run)
        ops = {}
        for n in gm.graph.nodes:
            if n.op == "call_function":
                k = ir.op_key(n.target)
                ops[k] = ops.get(k, 0) + 1
        sites = {"groupnorm": sum(isinstance(m, FrameGroupNorm)
                                  for m in model.modules()),
                 "attention": sum(isinstance(m, AttnLayer)
                                  for m in model.modules())}
        return {"ops": ops, "sites": sites}

    cfg = test_config(imgsize=8, ch=8)
    out = {"forward": forward(cfg), "plain": forward(cfg, kernels="torch")}
    cp_cfg = test_config(imgsize=16, ch=8, shallow=True)
    env = make_mesh(MeshConfig(data_parallel=4, model_parallel=2,
                               context_parallel=True), model=cp_cfg.model,
                    device_type=DEVICE)
    out["cp"] = forward(cp_cfg, place=env.place_context_axis)
    return out


def port_side() -> dict:
    """The port's argument bytes (global shapes) and draw stream."""
    step_many = shardcheck.build_program("step_many", DEVICE)
    args = {k: v[2] for k, v in step_many.args_info.items()}
    train = shardcheck.build_program("train_step", DEVICE)
    groups = {}
    for k, t in train.inputs.items():
        g = k.split(".")[0]
        if g == "adam":
            g = "adam." + k.split(".")[1]
        groups.setdefault(g, 0)
        groups[g] += t.numel() * t.element_size()
    world = ir.MESH_DEVICES
    full_params = {n: p.numel() * p.element_size()
                   for n, p in _train_model_params(train)}
    return {"step_many_args": args,
            "step_many_draws": ir.random_events(step_many),
            "train_local": groups,
            "train_params_global": sum(full_params.values()),
            "train_batch_global": groups["batch"] * world,
            "train_adam_step_leaves": sum(
                1 for k in train.inputs if k.startswith("adam.step.")),
            "train_placement": train.placement}


def _train_model_params(program):
    """``(name, global-shaped tensor)`` of the train program's
    parameters, from the placement table and the local shards."""
    for k, t in program.inputs.items():
        if not k.startswith("params."):
            continue
        name = k[len("params."):]
        spec = program.placement[name]
        if spec.startswith("shard("):
            d = int(spec[6:-1])
            shape = list(t.shape)
            shape[d] *= ir.MESH_DEVICES
            yield name, t.new_empty(()).expand(shape)
        else:
            yield name, t


def main() -> None:
    ir.fake_world()
    result = {}
    for tool in cli.TOOLS:
        found, _ = cli.check(tool, shardcheck.TIER1_PROGRAMS, DEVICE,
                             os.path.join(ROOT, cli.TOOLS[tool].MANIFEST_DIR))
        result[f"clean.{tool}"] = _findings(found)
    result["controls"] = controls()
    result["kernels"] = kernel_nodes()
    result["port"] = port_side()
    mc = manifests.load(os.path.join(ROOT, memcheck.MANIFEST_DIR,
                                     "step_many.json"), memcheck.TOOL)
    result["step_many_peak"] = mc["budgets"]["peak_bytes"]
    with open(sys.argv[1], "w", encoding="utf-8") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
