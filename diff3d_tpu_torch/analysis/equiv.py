"""A canonical form of a traced program and its semantic fingerprint
(counterpart: ``diff3d_tpu/analysis/equiv.py``, which canonicalises
StableHLO).

Each part's graph becomes one line per node, in graph order:

  * names alpha-renamed: a call is ``%<k>`` by its position among the
    part's lines; an input is its name in :attr:`Program.inputs`
    (``params.<leaf>``, ``record_imgs``, ``loop.img``, ...), another
    constant ``const<k>[shape:dtype]``, a process group ``group`` (the
    draws' generators are rngcheck's);
  * the operands of commutative ops sorted;
  * no-op views folded (a ``view`` / ``reshape`` / ``expand`` / ``alias``
    / ``detach`` whose result has its input's shape and strides is its
    input);
  * the device normalised: device arguments dropped, and a copy that
    changes only the device folded into its input (a host-to-device copy
    on the card is no node on the CPU), so a trace on fake CPU tensors
    and one on fake CUDA tensors of the same program give the same lines
    where the program does the same work;
  * each line ends in its value's dtype and shape.

The fingerprint is the sha256 of the lines; a manifest pins it and each
line's short hash, so a changed program names its first divergent node.
**Dead nodes**: pure calls whose value nothing uses.  **Duplicates**:
Merkle value numbering (a call's number hashes its op and its operands'
numbers; in-place writes, draws and collectives are unique): a pure call
that repeats another's number recomputes it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import torch

from diff3d_tpu_torch.analysis import ir
from diff3d_tpu_torch.analysis.mem import node_flops


#: Ops folded into their input where they change neither shape nor
#: dtype: the no-op views, and copies that change only the device (a
#: host-to-device copy on the card is no node on the CPU).
_FOLDED = ir._VIEWS | {"_to_copy.default"}


def line_hash(line: str) -> str:
    return hashlib.sha256(line.encode()).hexdigest()[:12]


class _Namer:
    def __init__(self, program: ir.Program):
        self.inputs = ir.input_names(program)
        self.consts: Dict[int, str] = {}

    def obj(self, o) -> str:
        if isinstance(o, torch.Tensor):
            k = ir.storage_key(o)
            if k in self.inputs:
                view = "" if o.untyped_storage().nbytes() == \
                    o.numel() * o.element_size() else \
                    f"@{list(o.shape)}"
                return self.inputs[k] + view
            if k not in self.consts:
                self.consts[k] = (f"const{len(self.consts)}"
                                  f"[{list(o.shape)}:"
                                  f"{ir.dtype_name(o.dtype)}]")
            return self.consts[k]
        return "group"


def _literal(v) -> str:
    if isinstance(v, torch.device):
        return "dev"
    if isinstance(v, torch.dtype):
        return ir.dtype_name(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_literal(x) for x in v) + "]"
    return str(v)


def canonical_lines(program: ir.Program) -> List[str]:
    """The canonical form: ``<part>: <line>`` per node, parts in order
    (each part's replay count on its first line)."""
    namer = _Namer(program)
    lines: List[str] = []
    for part in program.parts:
        gm = part.graph
        names: Dict[torch.fx.Node, str] = {}
        k = 0
        lines.append(f"{part.name}: x{part.replays}")

        def arg(a):
            if isinstance(a, torch.fx.Node):
                return names.get(a, "?")
            if isinstance(a, (list, tuple)):
                return "[" + ", ".join(arg(x) for x in a) + "]"
            return _literal(a)

        for node in gm.graph.nodes:
            if node.op == "placeholder":
                names[node] = f"in{len(names)}"
            elif node.op == "get_attr":
                names[node] = namer.obj(getattr(gm, node.target))
            elif node.op == "call_function":
                key = ir.op_key(node.target) or getattr(
                    node.target, "__name__", str(node.target))
                outs = ir.node_tensors(gm, node)
                if key in _FOLDED and outs:
                    src = ir.node_tensors(gm, node.args[0])
                    if src and tuple(src[0].shape) == tuple(outs[0].shape) \
                            and src[0].dtype == outs[0].dtype \
                            and (key == "_to_copy.default"
                                 or src[0].stride() == outs[0].stride()):
                        names[node] = names[node.args[0]]
                        continue
                if key == "getitem":
                    names[node] = f"{arg(node.args[0])}[{node.args[1]}]"
                    continue
                args = [arg(a) for a in node.args]
                if key in ir._COMMUTATIVE and len(args) == 2:
                    args.sort()
                kw = [f"{n}={arg(v)}" for n, v in sorted(node.kwargs.items())
                      if n != "device"]
                val = ", ".join(
                    f"{ir.dtype_name(t.dtype)}{list(t.shape)}" for t in outs)
                names[node] = f"%{k}"
                lines.append(f"{part.name}: %{k} = {key}("
                             f"{', '.join(args + kw)}) -> {val}")
                k += 1
            elif node.op == "output":
                lines.append(f"{part.name}: return {arg(node.args[0])}")
    return lines


@dataclasses.dataclass
class EquivReport:
    name: str
    fingerprint: str
    n_lines: int
    line_hashes: List[str]
    lines: List[str]
    dead: List[str]
    duplicates: int
    duplicate_flops: int

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("lines")
        return d


def _value_numbers(gm) -> tuple:
    """``(dead node lines, duplicate count, duplicate FLOPs)`` of one
    graph."""
    num: Dict[torch.fx.Node, str] = {}
    seen: Dict[str, torch.fx.Node] = {}
    dead, dups, dup_flops = [], 0, 0
    for node in gm.graph.nodes:
        if node.op != "call_function":
            num[node] = f"{node.op}:{node.name}"
            continue
        key = ir.op_key(node.target) or getattr(node.target, "__name__",
                                                str(node.target))
        side = ir.is_mutating(node) or ir.is_random(node) \
            or ir.is_collective(node)
        if side:
            num[node] = f"unique:{node.name}"
            continue
        ops = []
        torch.fx.node.map_arg(
            (node.args, node.kwargs),
            lambda a: ops.append(num.get(a, a.name)) or a)
        lit = repr([a for a in node.args
                    if not isinstance(a, (torch.fx.Node, list, tuple))])
        h = hashlib.sha256(f"{key}|{ops}|{lit}|{sorted(node.kwargs)}"
                           .encode()).hexdigest()
        num[node] = h
        if h in seen and key not in ir._VIEWS and key != "getitem":
            dups += 1
            dup_flops += node_flops(gm, node)
        seen.setdefault(h, node)
        if not node.users and key != "getitem":
            dead.append(ir.describe(node))
    return dead, dups, dup_flops


def analyze_equiv(program: ir.Program) -> EquivReport:
    lines = canonical_lines(program)
    dead: List[str] = []
    dups = dup_flops = 0
    for part in program.parts:
        d, n, f = _value_numbers(part.graph)
        dead += [f"{part.name}: {x}" for x in d]
        dups += n
        dup_flops += f * part.replays
    return EquivReport(
        name=program.name,
        fingerprint=hashlib.sha256("\n".join(lines).encode()).hexdigest(),
        n_lines=len(lines), line_hashes=[line_hash(x) for x in lines],
        lines=lines, dead=dead, duplicates=dups, duplicate_flops=dup_flops)
