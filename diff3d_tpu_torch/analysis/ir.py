"""The port's programs as traced FX graphs, and what is read off them
(counterpart: ``diff3d_tpu/analysis/ir.py``, which reads StableHLO).

A :class:`Program` is what one entry point runs on the card, traced on
fake tensors (``make_fx`` under a ``FakeTensorMode``): nothing is
allocated on a device and nothing executes.  Every tensor the program
reads -- parameters, records, a loop's static buffers, Adam's moments --
is a fake tensor that exists before the trace and enters the graph as a
constant; :attr:`Program.inputs` names them.  That is how a CUDA graph
sees its inputs (fixed addresses), and how the registry's JAX programs
see their abstract arguments.  A program is a few **parts**, each one
graph with a replay count: a sampler view is its prologue (the draws and
the loop's loads), the reverse step (the body ``StepGraph`` captures)
replayed once per step, and the commit (with the views' gather on a
mesh); a train step is one part.

The kernels are dispatcher ops (``ops/library.py``), so each kernel call
is one node, ``torch.ops.diff3d_tpu_torch.<op>``, whatever the device.
A host sync (``.item()``) or a data-dependent branch in a traced body
fails the trace with the op named: the counterpart of the JAX package's
tracer-hygiene lint has nothing left to check.

:func:`analyze` reads a :class:`ProgramReport` off a program:

  * collectives by kind (``c10d`` ops and functional collectives), with
    count and bytes per run;
  * dtype upcasts (``_to_copy`` from bf16 / f16 to f32) and f64 values;
  * host transfers and syncs (``_local_scalar_dense``, copies to the CPU
    from another device, pinned staging);
  * kernel nodes by op, per run;
  * random ops, in order, with shape, dtype and generator;
  * the parameter-placement table against the mesh's policy.

The fake world (:func:`fake_world`): a process group of backend ``fake``
at world :data:`MESH_DEVICES` stands for NCCL on several cards, so a
traced program takes the NCCL paths (gloo's host staging shows up as a
finding).  It is opened once per process (:mod:`~diff3d_tpu_torch.
analysis.__main__` and the tests' helper open it in a process of their
own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from diff3d_tpu_torch.ops import library

#: World size of the fake process group the registry's mesh spans (the
#: JAX registry's virtual device count).
MESH_DEVICES = 8

_UPCAST_FROM = (torch.bfloat16, torch.float16)
_RANDOM = {"rand", "randn", "randint", "randperm", "bernoulli", "normal",
           "multinomial", "uniform", "random", "exponential",
           "native_dropout", "rand_like", "randn_like", "randint_like",
           "normal_", "uniform_", "bernoulli_", "random_", "exponential_"}
_COMMUTATIVE = {"add.Tensor", "mul.Tensor", "maximum.default",
                "minimum.default", "eq.Tensor", "ne.Tensor",
                "logical_and.default", "logical_or.default",
                "bitwise_and.Tensor", "bitwise_or.Tensor",
                "bitwise_xor.Tensor"}
_VIEWS = {"view.default", "_unsafe_view.default", "reshape.default",
          "expand.default", "alias.default", "detach.default"}


def fake_world(world: int = MESH_DEVICES) -> None:
    """Open a fake process group of ``world`` ranks as rank 0 (nothing is
    sent anywhere); a fake group already open is kept, another group
    raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"fake_world({world}): a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks is already open")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@dataclasses.dataclass
class Part:
    """One traced graph of a program, run ``replays`` times a run."""

    name: str
    graph: torch.fx.GraphModule
    replays: int = 1


@dataclasses.dataclass
class Program:
    """A traced program: its parts and the fake tensors it reads, by
    name (``params.<leaf>`` for parameters).  ``donated`` names the
    inputs the program is meant to update in place (the JAX program's
    donated arguments); ``placement`` / ``expected_placement`` map each
    parameter leaf to its placement (``"replicated"`` or ``"shard(d)"``)
    and to the mesh policy's; ``config`` is what the program was traced
    at."""

    name: str
    device: str
    parts: List[Part]
    inputs: Dict[str, torch.Tensor]
    donated: Tuple[str, ...] = ()
    placement: Dict[str, str] = dataclasses.field(default_factory=dict)
    expected_placement: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)

    def part(self, name: str) -> Part:
        return next(p for p in self.parts if p.name == name)

    @property
    def args_info(self) -> Dict[str, Tuple[tuple, str, int]]:
        """``{input name: (shape, dtype, bytes)}`` (local shards of placed
        tensors)."""
        return {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""),
                    t.numel() * t.element_size())
                for k, t in self.inputs.items()}


class Tracer:
    """Fake tensors on ``device`` and traces over them: everything a
    program reads is made under :attr:`mode` before :meth:`trace`."""

    def __init__(self, device="cpu"):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.device = torch.device(device)
        self.mode = FakeTensorMode(allow_non_fake_inputs=False)

    def empty(self, shape, dtype=torch.float32) -> torch.Tensor:
        with self.mode:
            return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def params(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """A fake tensor like each parameter of ``model`` (its shape and
        dtype, on :attr:`device`)."""
        return {n: self.empty(p.shape, p.dtype)
                for n, p in model.named_parameters()}

    def trace(self, fn: Callable[[], object]) -> torch.fx.GraphModule:
        """``fn`` (no arguments; it reads fake tensors made by this
        tracer) as an FX graph of aten ops and the port's kernel ops.  The
        generator each draw names is kept beside the graph
        (``draw_generators``, one per random node in graph order), not in
        it: ``make_fx`` of some torch versions cannot record a generator
        argument."""
        from torch.fx.experimental.proxy_tensor import make_fx

        log = _GeneratorLog()

        def run():
            with log:
                return fn()

        with self.mode:
            gm = make_fx(run)()
        gm.draw_generators = log.generators
        n = sum(1 for node in gm.graph.nodes
                if node.op == "call_function" and is_random(node))
        if n != len(log.generators):
            raise RuntimeError(f"trace: {n} random nodes for "
                               f"{len(log.generators)} draws")
        return gm


#: Torch calls that draw, each one random node.
_DRAW_CALLS = {"rand", "randn", "randint", "randperm", "bernoulli",
               "normal", "multinomial", "rand_like", "randn_like",
               "randint_like", "normal_", "uniform_", "bernoulli_",
               "random_", "exponential_"}


class _GeneratorLog(torch.overrides.TorchFunctionMode):
    """Takes each draw's ``generator=`` out of the call and logs it (None
    for a draw from the default generator), in call order."""

    def __init__(self):
        super().__init__()
        self.generators: List[object] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if getattr(func, "__name__", "") in _DRAW_CALLS:
            self.generators.append(kwargs.pop("generator", None))
        return func(*args, **kwargs)


# ---- reading nodes ---------------------------------------------------------


def op_key(target) -> str:
    """``"<op>.<overload>"`` of an aten / c10d / port op, else ``""``."""
    name = getattr(target, "name", None)
    if not callable(name):
        return ""
    ns, _, rest = name().partition("::")
    if "." not in rest:
        rest += ".default"
    return rest if ns == "aten" else f"{ns}::{rest}"


def _vals(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _vals(x)]
    return []


def node_tensors(gm: torch.fx.GraphModule, node) -> List[torch.Tensor]:
    """The tensors a node stands for (a get_attr's constant, a call's
    outputs)."""
    if node.op == "get_attr":
        return _vals(getattr(gm, node.target))
    return _vals(node.meta.get("val"))


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


def _arg_nodes(node) -> List[torch.fx.Node]:
    out: List[torch.fx.Node] = []
    torch.fx.node.map_arg((node.args, node.kwargs), out.append)
    return out


def is_mutating(node) -> bool:
    schema = getattr(node.target, "_schema", None)
    return bool(schema is not None and schema.is_mutable)


def is_random(node) -> bool:
    key = op_key(node.target).split("::")[-1].split(".")[0]
    return key in _RANDOM


def is_collective(node) -> bool:
    key = op_key(node.target)
    return key.startswith(("c10d::", "_c10d_functional::",
                           "c10d_functional::"))


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shape(t: torch.Tensor) -> List[int]:
    return [int(s) for s in t.shape]


def input_names(program: Program) -> Dict[int, str]:
    """Storage key -> the program input's name (the first one named)."""
    names: Dict[int, str] = {}
    for name, t in program.inputs.items():
        names.setdefault(storage_key(t), name)
    return names


# ---- the report ------------------------------------------------------------


@dataclasses.dataclass
class ProgramReport:
    """What :func:`analyze` reads off a :class:`Program` (per run: each
    part's count times its replays)."""

    name: str
    device: str
    collectives: Dict[str, Dict[str, int]]
    upcasts: Dict[str, int]
    f64_values: int
    host: Dict[str, int]
    kernels: Dict[str, int]
    launches: Dict[str, int]
    random: List[dict]
    placement_mismatches: List[str]
    parts: Dict[str, dict]


def _collective(node, gm, out: Dict[str, Dict[str, int]], k: int) -> None:
    key = op_key(node.target)
    kind = key.split("::")[1].split(".")[0].strip("_")
    b = sum(t.numel() * t.element_size()
            for a in _arg_nodes(node) for t in node_tensors(gm, a))
    e = out.setdefault(kind, {"count": 0, "bytes": 0})
    e["count"] += k
    e["bytes"] += k * b


def random_events(program: Program) -> List[dict]:
    """The ordered draws of one run: ``{part, op, shape, dtype,
    generator}``, ``generator`` ``g<k>`` by the generator's first draw
    over the program's parts (``"default"`` where none is named); a part
    replayed k times draws its events k times."""
    labels: Dict[int, str] = {}
    events: List[dict] = []
    for part in program.parts:
        gens = iter(part.graph.draw_generators)
        mine = []
        for node in part.graph.graph.nodes:
            if node.op != "call_function" or not is_random(node):
                continue
            g = next(gens)
            gen = "default"
            if g is not None:
                gen = labels.setdefault(id(g), f"g{len(labels)}")
            t = node_tensors(part.graph, node)
            mine.append({"part": part.name,
                         "op": op_key(node.target),
                         "shape": _shape(t[0]) if t else [],
                         "dtype": dtype_name(t[0].dtype) if t else "",
                         "generator": gen})
        events += mine * part.replays
    return events


def analyze(program: Program) -> ProgramReport:
    """Read a :class:`ProgramReport` off ``program``."""
    coll: Dict[str, Dict[str, int]] = {}
    upcasts: Dict[str, int] = {}
    host = {"local_scalar_dense": 0, "to_host": 0, "pinned": 0}
    kernels: Dict[str, int] = {}
    f64 = 0
    parts = {}
    for part in program.parts:
        gm, k = part.graph, part.replays
        static: Dict[str, int] = {}
        n_nodes = 0
        for node in gm.graph.nodes:
            if node.op != "call_function":
                continue
            n_nodes += 1
            key = op_key(node.target)
            name = library.op_name(node.target)
            if name:
                kernels[name] = kernels.get(name, 0) + k
                static[name] = static.get(name, 0) + 1
            if is_collective(node):
                _collective(node, gm, coll, k)
            outs = node_tensors(gm, node)
            if any(t.dtype == torch.float64 for t in outs):
                f64 += k
            if key in ("_to_copy.default", "to.dtype",
                       "to.dtype_layout") and outs:
                src = node_tensors(gm, node.args[0])
                if src and src[0].dtype in _UPCAST_FROM \
                        and outs[0].dtype == torch.float32:
                    pair = f"{dtype_name(src[0].dtype)}->float32"
                    upcasts[pair] = upcasts.get(pair, 0) + k
                if src and outs[0].device.type == "cpu" \
                        and src[0].device.type != "cpu":
                    host["to_host"] += k
            if key == "_local_scalar_dense.default":
                host["local_scalar_dense"] += k
            if node.kwargs.get("pin_memory"):
                host["pinned"] += k
        parts[part.name] = {"replays": k, "nodes": n_nodes,
                            "kernels": static}
    launches: Dict[str, int] = {}
    for op, n in kernels.items():
        w = library.WRAPPER.get(op, op)
        launches[w] = launches.get(w, 0) + n
    mismatches = sorted(
        f"{leaf}: {program.placement.get(leaf)} (policy {want})"
        for leaf, want in program.expected_placement.items()
        if program.placement.get(leaf) != want)
    return ProgramReport(
        name=program.name, device=program.device, collectives=coll,
        upcasts=upcasts, f64_values=f64, host=host, kernels=kernels,
        launches=launches, random=random_events(program),
        placement_mismatches=mismatches, parts=parts)


# ---- placement ---------------------------------------------------------------


def placement_of(t: torch.Tensor) -> str:
    """``"replicated"`` or ``"shard(d)"`` of a parameter (a DTensor's
    first shard placement)."""
    for p in getattr(t, "placements", ()):
        if hasattr(p, "dim") and p.is_shard():
            return f"shard({p.dim})"
    return "replicated"


def placement_table(model: torch.nn.Module) -> Dict[str, str]:
    return {n: placement_of(p) for n, p in model.named_parameters()}


def policy_table(env, model: torch.nn.Module,
                 shards: bool = True) -> Dict[str, str]:
    """The mesh policy's placement of each leaf (``env.placement``;
    ``shards`` False: the policy of a program that keeps every leaf
    whole, as the sampler does)."""
    out = {}
    for n, p in model.named_parameters():
        d = env.placement(n, tuple(p.shape)) if shards else None
        out[n] = "replicated" if d is None else f"shard({d})"
    return out


def describe(node) -> str:
    """A node as one line for a finding: its name and op."""
    op = op_key(node.target) or getattr(node.target, "__name__",
                                        str(node.target))
    return f"{node.name} = {op}"
