"""The process mesh and the parameter placement (counterpart:
``diff3d_tpu/parallel/mesh.py``).

One ``torch.distributed`` :class:`~torch.distributed.device_mesh.
DeviceMesh` over ``(data, model)`` axes, one rank per card.  In the JAX
package ``jit`` with ``NamedSharding`` compiles the gradient all-reduce
into the step; here the data-parallel step all-reduces the summed
gradients itself (:mod:`diff3d_tpu_torch.train.step`).

Parameter placement (``MeshConfig.param_sharding``):

  * ``'replicated'`` -- every rank holds the whole state (parameters,
    Adam's moments, the EMA); the gradients are all-reduced over the data
    axis, as DDP does.
  * ``'fsdp'`` -- FSDP2 (``fully_shard``) on the X-UNet's blocks and on
    the root.  Each leaf is placed by the JAX package's rule
    (``mesh.py:254-267``): its largest dim divisible by the data size is
    sharded, and a leaf of fewer than ``n * 128`` elements, or with no
    divisible dim, stays replicated.  The rule is taken on the leaf's
    Flax layout and mapped through the port's kernel permutation (a conv
    kernel ``[kh, kw, cin, cout]`` is ``[cout, cin, kh, kw]`` here, a Dense
    kernel ``[in, out]`` is ``[out, in]``), so the same axis is sharded.
    Replicated leaves are left out of FSDP (``ignored_params``) and their
    gradients all-reduced with the replicated policy's bucket.  Adam's
    moments and the EMA take their parameter's placement.

The model axis (``tp`` / ``fsdp+tp``, context parallelism) waits for
ROADMAP A10b: :meth:`MeshConfig.validate` refuses it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch import nn

from diff3d_tpu_torch.config import MeshConfig

log = logging.getLogger(__name__)

#: The last mesh :func:`make_mesh` built: ``ring:<axis>`` /
#: ``ulysses:<axis>`` attention resolves its axis name here.
_CURRENT: Optional["MeshEnv"] = None


def flax_dims(name: str, shape: Sequence[int]) -> List[int]:
    """For each dim of the Flax leaf of port parameter ``name`` (shape
    ``shape``), the port dim it is: a conv kernel ``[kh, kw, cin, cout]``
    is the port's ``[cout, cin, kh, kw]``, a Dense kernel ``[in, out]`` the
    port's ``[out, in]`` (``convert/from_jax.py``); anything else keeps its
    layout."""
    if name.endswith("weight") and len(shape) == 4:
        return [2, 3, 1, 0]
    if name.endswith("weight") and len(shape) == 2:
        return [1, 0]
    return list(range(len(shape)))


def fsdp_dim(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The port dim of parameter ``name`` that the ``fsdp`` policy shards
    over ``n`` ranks, or None (replicated): the JAX package's
    ``param_sharding`` rule on the Flax layout (the largest dim divisible
    by ``n``, the first such in Flax order; none for ``n == 1`` or fewer
    than ``n * 128`` elements), mapped to the port's layout."""
    shape = tuple(int(s) for s in shape)
    if n == 1 or not shape or int(np.prod(shape)) < n * 128:
        return None
    dims = flax_dims(name, shape)
    flax_shape = [shape[d] for d in dims]
    candidates = [i for i, s in enumerate(flax_shape) if s % n == 0]
    if not candidates:
        return None
    axis = max(candidates, key=lambda i: flax_shape[i])
    return dims[axis]


def _spec(ndim: int, dim: Optional[int], axis: str) -> str:
    if dim is None:
        return "()"
    spec = [None] * ndim
    spec[dim] = axis
    return str(tuple(spec))


def _is_block(name: str) -> bool:
    return name == "middle" or name.startswith(("down_", "up_"))


@dataclasses.dataclass
class MeshEnv:
    """A ``(data, model)`` process mesh plus the placement rules of its
    config.  ``device_mesh`` is None in a one-process run without a group
    (every axis of size 1)."""

    cfg: MeshConfig
    device_mesh: Optional[object] = None
    _cpu_group: Optional[object] = None

    @property
    def data_axis(self) -> str:
        return self.cfg.data_axis

    @property
    def data_size(self) -> int:
        """Ranks on the data axis: the quantum of any leading dim split
        over it (the trainer's batch, the sampler's object axis)."""
        if self.device_mesh is None:
            return 1
        return int(self.device_mesh.size(0))

    @property
    def data_rank(self) -> int:
        """This process's index on the data axis."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(self.cfg.data_axis))

    @property
    def group(self):
        """The data axis's process group (None without a mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(self.cfg.data_axis)

    def axis_group(self, axis: str):
        """The process group of mesh dim ``axis``."""
        if axis not in (self.cfg.data_axis, self.cfg.model_axis):
            raise KeyError(f"no mesh axis {axis!r}: the mesh has "
                           f"{(self.cfg.data_axis, self.cfg.model_axis)}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    @property
    def cpu_group(self):
        """A gloo group over the data axis's ranks, for host-side
        agreements (the trainer's stop flag): an all-reduce there is a host
        op, with no device synchronisation.  None without a mesh."""
        if self.device_mesh is None:
            return None
        if self._cpu_group is None:
            g = self.group
            if dist.get_backend(g) == "gloo":
                self._cpu_group = g
            else:
                self._cpu_group = dist.new_group(
                    dist.get_process_group_ranks(g), backend="gloo")
        return self._cpu_group

    def topology_summary(self) -> dict:
        """JSON-able description of the mesh, with the JAX package's keys:
        stamped into checkpoints, so a restore into another topology is a
        recognised reshard."""
        n = 1 if self.device_mesh is None else int(self.device_mesh.size())
        mp = max(1, self.cfg.model_parallel)
        return {
            "axes": {self.cfg.data_axis: self.data_size,
                     self.cfg.model_axis: mp},
            "n_devices": n,
            "n_processes": (dist.get_world_size() if dist.is_initialized()
                            else 1),
            "param_sharding": self.cfg.param_sharding,
        }

    def placement(self, name: str, shape: Sequence[int]) -> Optional[int]:
        """The dim of parameter ``name`` sharded over the data axis under
        this policy, or None (replicated)."""
        if self.cfg.param_sharding == "replicated":
            return None
        return fsdp_dim(name, shape, self.data_size)

    def param_spec_table(self, named) -> Dict[str, str]:
        """``{parameter name: spec}`` of the policy's placement, the spec
        written as the JAX package's ``str(tuple(PartitionSpec))`` in the
        port's layout (``"()"`` replicated).  ``named``: a module or
        ``(name, tensor)`` pairs; only shapes are read."""
        if isinstance(named, nn.Module):
            named = named.named_parameters()
        return {n: _spec(len(p.shape), self.placement(n, p.shape),
                         self.cfg.data_axis) for n, p in named}

    def params(self, model: nn.Module) -> nn.Module:
        """Place ``model``'s parameters by the policy, in place, before
        the optimizer and the EMA are made from them: ``replicated``
        leaves them whole; ``fsdp`` applies ``fully_shard`` to each block
        and then the root (each sharded leaf on its :meth:`placement`,
        the replicated ones ignored)."""
        if self.cfg.param_sharding == "replicated" or self.data_size == 1:
            return model
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {p: self.placement(n, p.shape)
                for n, p in model.named_parameters()}
        ignored = {p for p, d in dims.items() if d is None}
        mesh = self.device_mesh[self.cfg.data_axis]

        def placement_fn(p):
            return Shard(dims[p])

        kw = dict(mesh=mesh, shard_placement_fn=placement_fn,
                  ignored_params=ignored, reshard_after_forward=True)
        for name, child in model.named_children():
            if _is_block(name) and any(
                    dims[p] is not None for p in child.parameters()):
                fully_shard(child, **kw)
        fully_shard(model, **kw)
        return model

    def sharded(self, model: nn.Module) -> bool:
        """Whether ``model`` holds FSDP-sharded parameters."""
        return any(_is_dtensor(p) for p in model.parameters())


def _is_dtensor(t) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover - torch without DTensor
        return False
    return isinstance(t, DTensor)


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence[int]] = None) -> MeshEnv:
    """The ``(data, model)`` mesh over the process group's ranks
    (``devices``: the ranks, default all), the JAX package's
    ``make_mesh``: ``data_parallel == -1`` takes every rank the model axis
    leaves, and a mesh of more ranks than there are is refused.  A rank
    runs only within its mesh here, so a mesh that leaves ranks out is
    refused too.  Without a process group this is the one-process mesh (no
    ``DeviceMesh``).  The mesh's devices are the card on an NCCL group and
    the CPU on a gloo one."""
    global _CURRENT
    cfg.validate()
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else list(devices)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel
    if dp == -1:
        dp = len(ranks) // mp
    if dp * mp > len(ranks):
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have "
                         f"{len(ranks)}")
    if dp * mp != world or sorted(ranks) != list(range(world)):
        raise ValueError(f"mesh {dp}x{mp} over ranks {ranks}: a mesh spans "
                         f"every rank of the group (world size {world})")
    if not dist.is_initialized():
        env = MeshEnv(cfg=cfg)
    else:
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
        mesh = init_device_mesh(device_type, (dp, mp),
                                mesh_dim_names=(cfg.data_axis,
                                                cfg.model_axis))
        env = MeshEnv(cfg=cfg, device_mesh=mesh)
    _CURRENT = env
    return env


def axis_group(axis: str):
    """The process group of mesh axis ``axis`` on the last mesh
    :func:`make_mesh` built."""
    if _CURRENT is None:
        raise RuntimeError(f"no mesh: build one with make_mesh() before "
                           f"naming axis {axis!r}")
    return _CURRENT.axis_group(axis)

