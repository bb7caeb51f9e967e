"""Memory and FLOPs of a traced program (counterpart:
``diff3d_tpu/analysis/mem.py``, which reads XLA's buffer assignment and
the scan bodies of StableHLO).

Over a :class:`~diff3d_tpu_torch.analysis.ir.Program`:

  * **peak bytes by liveness.**  The program's inputs (every tensor it
    reads that exists before it runs: parameters, records, a loop's
    static buffers, Adam's moments) are live throughout; each part adds
    its temporaries, walked in graph order: a node's output takes new
    storage unless it is a view of, or an in-place write into, a storage
    already live (a view shares its base's storage; an in-place write
    into an input counts once, as the input), and a storage is freed
    after its last use unless the part returns it.  The peak is the
    inputs' bytes plus the largest part's temporaries at their peak.
  * **the donation counterpart**: the inputs a program writes in place.
    The JAX program donates the records and updates them in place; here
    the records are written by ``index_put_``.  A program that copies a
    record it should update (the in-place write replaced by a copy) no
    longer writes it, which :mod:`~diff3d_tpu_torch.analysis.memcheck`
    reports.
  * **step-invariant FLOPs**: in a part replayed more than once (the
    reverse step), the matmul-class FLOPs of nodes that read nothing the
    part writes in place and draw nothing -- work that gives the same
    result at every step (what the parameters, the target pose and the
    intrinsics alone determine).  Pinned, not hoisted.

FLOPs count matrix products and convolutions (2 per multiply-add) and
the attention kernels (their matrix products); elementwise work is left
out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import torch

from diff3d_tpu_torch.analysis import ir
from diff3d_tpu_torch.ops import library


def node_flops(gm, node) -> int:
    """Matmul-class FLOPs of one node (0 for the rest)."""
    if node.op != "call_function":
        return 0
    key = ir.op_key(node.target)
    ins = [ir.node_tensors(gm, a) if isinstance(a, torch.fx.Node) else []
           for a in node.args]

    def shape(i):
        return tuple(ins[i][0].shape) if i < len(ins) and ins[i] else ()

    def prod(s):
        n = 1
        for d in s:
            n *= int(d)
        return n

    if key in ("mm.default", "addmm.default", "bmm.default",
               "baddbmm.default"):
        a, b = (shape(0), shape(1)) if key in ("mm.default",
                                                 "bmm.default") \
            else (shape(1), shape(2))
        if not a or not b:
            return 0
        return 2 * prod(a) * int(b[-1])
    if key == "convolution.default":
        out = ir.node_tensors(gm, node)
        w = shape(1)
        if not out or not w:
            return 0
        return 2 * out[0].numel() * prod(w[1:])
    if key == "convolution_backward.default":
        w = shape(2)
        g = shape(0)
        mask = node.args[-1] if isinstance(node.args[-1], (list, tuple)) \
            else (True, True, False)
        per = 2 * prod(g) * prod(w[1:]) if g and w else 0
        return per * sum(1 for m in mask[:2] if m)
    name = library.op_name(node.target)
    if name.startswith("flash"):
        q, k = shape(0), shape(1)
        if not q or not k:
            return 0
        B, Lq, H, D = q
        mult = {"flash_forward": 4, "flash_forward_lse": 4,
                "flash_backward_dkdv": 8, "flash_backward_dq": 6}[name]
        return mult * B * H * Lq * int(k[1]) * D
    return 0


@dataclasses.dataclass
class MemReport:
    """Bytes and FLOPs of one program (see the module docstring)."""

    name: str
    argument_bytes: int
    peak_bytes: int
    temp_bytes: int
    output_bytes: int
    written_inputs: List[str]
    donated: List[str]
    flops: int
    step_flops: int
    step_invariant_flops: int
    top_invariant: List[dict]
    parts: Dict[str, dict]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _part_memory(gm, inputs: Set[int]) -> dict:
    """Temporaries' peak of one graph by liveness, its outputs' bytes and
    the input storages it writes in place."""
    nodes = list(gm.graph.nodes)
    last: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        for a in ir._arg_nodes(node):
            for t in ir.node_tensors(gm, a):
                last[ir.storage_key(t)] = i
    out_node = nodes[-1]
    kept = {ir.storage_key(t) for a in ir._arg_nodes(out_node)
            for t in ir.node_tensors(gm, a)}
    live: Dict[int, int] = {}
    written: Set[int] = set()
    cur = peak = 0
    for i, node in enumerate(nodes):
        if node.op == "call_function":
            if ir.is_mutating(node):
                for t in ir.node_tensors(gm, node.args[0]) \
                        if isinstance(node.args[0], torch.fx.Node) else []:
                    written.add(ir.storage_key(t))
            for t in ir.node_tensors(gm, node):
                k = ir.storage_key(t)
                if k in inputs or k in live:
                    continue
                live[k] = ir._nbytes(t)
                cur += live[k]
        elif node.op == "get_attr":
            for t in ir.node_tensors(gm, node):
                k = ir.storage_key(t)
                if k not in inputs and k not in live:   # carried from a part
                    live[k] = ir._nbytes(t)
                    cur += live[k]
        peak = max(peak, cur)
        for k in [k for k in live if last.get(k, -1) <= i
                  and k not in kept]:
            cur -= live.pop(k)
    outputs = sum(ir._nbytes(t) for a in ir._arg_nodes(out_node)
                  for t in ir.node_tensors(gm, a)
                  if ir.storage_key(t) not in inputs)
    return {"temp_peak_bytes": peak, "output_bytes": outputs,
            "written": written}


def _invariant(gm) -> tuple:
    """``(flops, invariant flops, top invariant nodes)`` of one graph."""
    written = set()
    for node in gm.graph.nodes:
        if node.op == "call_function" and ir.is_mutating(node) \
                and isinstance(node.args[0], torch.fx.Node):
            written |= {ir.storage_key(t)
                        for t in ir.node_tensors(gm, node.args[0])}
    variant: Set[torch.fx.Node] = set()
    flops = inv = 0
    top = []
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            if any(ir.storage_key(t) in written
                   for t in ir.node_tensors(gm, node)):
                variant.add(node)
            continue
        if node.op != "call_function":
            continue
        if ir.is_random(node) or ir.is_mutating(node) \
                or any(a in variant for a in ir._arg_nodes(node)):
            variant.add(node)
        f = node_flops(gm, node)
        flops += f
        if node not in variant and f:
            inv += f
            top.append({"node": ir.describe(node), "flops": f})
    top.sort(key=lambda e: -e["flops"])
    return flops, inv, top[:5]


def analyze_memory(program: ir.Program) -> MemReport:
    names = ir.input_names(program)
    seen: Dict[int, int] = {}
    for t in program.inputs.values():
        seen.setdefault(ir.storage_key(t), ir._nbytes(t))
    inputs = set(seen)
    arg_bytes = sum(seen.values())
    parts = {}
    temp = out_bytes = flops = step_flops = inv = 0
    top: List[dict] = []
    written: Set[int] = set()
    for part in program.parts:
        m = _part_memory(part.graph, inputs)
        written |= m.pop("written")
        f, i, t = _invariant(part.graph)
        m.update(flops=f, invariant_flops=i if part.replays > 1 else 0)
        parts[part.name] = m
        temp = max(temp, m["temp_peak_bytes"])
        out_bytes += m["output_bytes"]
        flops += f * part.replays
        if part.replays > 1:
            step_flops += f
            inv += i
            top += t
    return MemReport(
        name=program.name, argument_bytes=arg_bytes,
        peak_bytes=arg_bytes + temp, temp_bytes=temp,
        output_bytes=out_bytes,
        written_inputs=sorted(names[k] for k in written if k in names),
        donated=list(program.donated), flops=flops, step_flops=step_flops,
        step_invariant_flops=inv,
        top_invariant=sorted(top, key=lambda e: -e["flops"])[:5],
        parts=parts)
