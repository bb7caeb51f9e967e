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

  * ``'tp'`` -- Megatron-style tensor parallelism over the model axis,
    leaf for leaf the JAX package's ``tp_param_sharding``
    (``mesh.py:194-251``, taken on the Flax names and layout): q/k/v
    kernels and biases column-parallel, the ``out_proj`` kernel
    row-parallel (its bias replicated), every other conv and Dense kernel
    and bias sharded on its output channels where they split over the
    axis and number more than 4 (``last_conv``'s 3 stay whole), norm
    scales and biases and the pose embeddings replicated.  Each rank holds
    its block of a sharded leaf as a plain tensor (``model_placement``);
    the layers gather and reduce around the kernels
    (:mod:`diff3d_tpu_torch.parallel.tensor`).  One difference from the
    JAX layout: a FiLM Dense's ``[scale | shift]`` output block of rank
    ``r`` holds ``scale`` and ``shift`` of the rank's channel block
    (``halves``), so the rank modulates its own channels; the placement
    table still reports the JAX spec and a gathered leaf is in the JAX
    order.
  * ``'fsdp+tp'`` -- ``tp`` first, then the largest dim the model axis
    left whole that divides over the data axis (and a leaf of at least
    ``n * 128`` elements) is sharded over the data axis by FSDP2, as
    ``fsdp`` does.

``context_parallel`` (with ``'replicated'`` and a model axis of more than
one rank): every parameter stays whole on every rank, and the
activations' image rows are split over the model axis instead
(:meth:`MeshEnv.place_context_axis`; the collectives are
:mod:`diff3d_tpu_torch.parallel.context`'s).  Its combinations with
``fsdp``, ``tp`` and ``fsdp+tp`` wait for ROADMAP A10b:
:meth:`MeshConfig.validate` refuses them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from diff3d_tpu_torch.config import MeshConfig
from diff3d_tpu_torch.parallel.context import (RowAxis, check_rows,
                                               place_rows)
from diff3d_tpu_torch.parallel.tensor import ModelAxis, model_axis_of

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


def flax_path(name: str) -> List[str]:
    """The Flax path of port parameter ``name``, the inverse of the
    converter's naming (``convert/from_jax.py``): a ``FrameGroupNorm``'s
    ``weight`` / ``bias`` are ``GroupNorm_0/scale`` / ``bias``, any other
    ``weight`` is a ``kernel``."""
    parts = name.split(".")
    leaf, module = parts[-1], parts[:-1]
    if leaf in ("weight", "bias") and module and (
            module[-1].startswith("FrameGroupNorm")
            or module[-1] == "last_gn"):
        return module + ["GroupNorm_0",
                         "scale" if leaf == "weight" else "bias"]
    if leaf == "weight":
        return module + ["kernel"]
    return parts


def _tp_flax_spec(names: Sequence[str], shape: Sequence[int],
                  mp: int) -> List[bool]:
    """Per Flax dim, whether the JAX package's ``tp_param_sharding`` shards
    it over a model axis of ``mp`` ranks (``diff3d_tpu/parallel/
    mesh.py:223-245``, its own copy)."""
    spec = [False] * len(shape)

    def shardable(dim: int) -> bool:
        return len(shape) > dim and shape[dim] % mp == 0 \
            and shape[dim] >= mp

    if mp > 1 and names and names[-1] == "kernel":
        if any(n in ("q_proj", "k_proj", "v_proj") for n in names):
            if shardable(len(shape) - 1):
                spec[-1] = True
        elif "out_proj" in names:
            if shardable(0):
                spec[0] = True
        elif shardable(len(shape) - 1) and shape[-1] > 4:
            spec[-1] = True                # conv / Dense output channels
    elif mp > 1 and names and names[-1] == "bias":
        parent = names[-2] if len(names) >= 2 else ""
        column = (parent in ("q_proj", "k_proj", "v_proj")
                  or "conv" in parent or parent.startswith("Dense")
                  or parent == "skip_proj")
        if column and shardable(0) and shape[0] > 4:
            spec[0] = True
    return spec


def tp_dims(name: str, shape: Sequence[int], mp: int,
            dp: Optional[int] = None) -> Tuple[Optional[int], Optional[int]]:
    """``(model dim, data dim)`` of parameter ``name`` (whole shape
    ``shape``, the port's layout) under ``tp`` (``dp`` None) or
    ``fsdp+tp`` over a ``dp x mp`` mesh: the JAX package's
    ``tp_param_sharding`` on the Flax path and layout, mapped to the port's
    dims (None: not sharded over that axis).  As in the JAX rule, the data
    dim is named even at ``dp == 1`` (a no-op there)."""
    shape = tuple(int(s) for s in shape)
    dims = flax_dims(name, shape)
    fshape = [shape[d] for d in dims]
    spec = _tp_flax_spec(flax_path(name), fshape, mp)
    model = next((i for i, on in enumerate(spec) if on), None)
    data = None
    if dp is not None:
        free = [i for i, s in enumerate(fshape)
                if not spec[i] and s % dp == 0 and s >= dp]
        if free and int(np.prod(fshape)) >= dp * 128:
            data = max(free, key=lambda i: fshape[i])
    return (None if model is None else dims[model],
            None if data is None else dims[data])


def _spec(ndim: int, placed: Dict[int, str]) -> str:
    if not placed:
        return "()"
    spec = [None] * ndim
    for dim, axis in placed.items():
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
    _cpu_world: Optional[object] = None
    _model_axis: Optional[ModelAxis] = None
    _row_axis: Optional[RowAxis] = None
    #: The port dim the model axis split of every parameter it placed
    #: (:meth:`place_model_axis`; keyed by name: one architecture per
    #: mesh).
    _model_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: The FiLM Dense leaves whose blocks are taken per half.
    _halved: set = dataclasses.field(default_factory=set)

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
    def model_size(self) -> int:
        """Ranks on the model axis."""
        if self.device_mesh is None:
            return 1
        return int(self.device_mesh.size(1))

    @property
    def model_rank(self) -> int:
        """This process's index on the model axis."""
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(self.cfg.model_axis))

    @property
    def model_group(self):
        """The model axis's process group (None without a mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(self.cfg.model_axis)

    @property
    def tensor_parallel(self) -> bool:
        """Whether the parameters are split over a model axis of more than
        one rank (``tp`` / ``fsdp+tp``)."""
        return (self.cfg.param_sharding in ("tp", "fsdp+tp")
                and self.model_size > 1)

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The model axis's collectives (None unless
        :attr:`tensor_parallel`)."""
        if not self.tensor_parallel:
            return None
        return self._axis()

    def _axis(self) -> ModelAxis:
        if self._model_axis is None:
            self._model_axis = ModelAxis(self.model_group, self.model_rank,
                                         self.model_size)
        return self._model_axis

    @property
    def context_parallel(self) -> bool:
        """Whether the activations' image rows are split over a model axis
        of more than one rank."""
        return self.cfg.context_parallel and self.model_size > 1

    @property
    def context_axis(self) -> Optional[RowAxis]:
        """The row split's collectives over the model axis (None unless
        :attr:`context_parallel`)."""
        if not self.context_parallel:
            return None
        if self._row_axis is None:
            self._row_axis = RowAxis(self._axis())
        return self._row_axis

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
    def cpu_world_group(self):
        """A gloo group over every rank of the mesh, for host-side
        agreements (the trainer's stop flag, which spans both axes): an
        all-reduce there is a host op, with no device synchronisation.
        None without a mesh."""
        if self.device_mesh is None:
            return None
        if self._cpu_world is None:
            world = dist.group.WORLD
            self._cpu_world = (world if dist.get_backend(world) == "gloo"
                               else dist.new_group(backend="gloo"))
        return self._cpu_world

    def topology_summary(self) -> dict:
        """JSON-able description of the mesh, with the JAX package's keys:
        stamped into checkpoints, so a restore into another topology is a
        recognised reshard."""
        n = 1 if self.device_mesh is None else int(self.device_mesh.size())
        return {
            "axes": {self.cfg.data_axis: self.data_size,
                     self.cfg.model_axis: self.model_size},
            "n_devices": n,
            "n_processes": (dist.get_world_size() if dist.is_initialized()
                            else 1),
            "param_sharding": self.cfg.param_sharding,
        }

    def placement(self, name: str, shape: Sequence[int]) -> Optional[int]:
        """The dim of parameter ``name`` (whole shape ``shape``) sharded
        over the data axis under this policy, or None."""
        policy = self.cfg.param_sharding
        if policy == "fsdp":
            return fsdp_dim(name, shape, self.data_size)
        if policy == "fsdp+tp":
            return tp_dims(name, shape, self.model_size, self.data_size)[1]
        return None

    def model_placement(self, name: str, shape: Sequence[int]
                        ) -> Optional[int]:
        """The dim of parameter ``name`` (whole shape ``shape``) split over
        the model axis under this policy, or None."""
        if self.cfg.param_sharding not in ("tp", "fsdp+tp"):
            return None
        return tp_dims(name, shape, self.model_size)[0]

    def whole_shape(self, name: str, shape: Sequence[int]) -> tuple:
        """The whole shape of parameter ``name`` (or of a tensor placed
        like it) held here at ``shape``."""
        d = self._model_dims.get(name)
        shape = tuple(int(s) for s in shape)
        if d is None:
            return shape
        return shape[:d] + (shape[d] * self.model_size,) + shape[d + 1:]

    def param_spec_table(self, named) -> Dict[str, str]:
        """``{parameter name: spec}`` of the policy's placement, the spec
        written as the JAX package's ``str(tuple(PartitionSpec))`` in the
        port's layout (``"()"`` replicated).  ``named``: a module or
        ``(name, tensor)`` pairs; only shapes are read (a model placed over
        the model axis is read at its whole shapes)."""
        if isinstance(named, nn.Module):
            named = named.named_parameters()
        table = {}
        for n, p in named:
            shape = self.whole_shape(n, p.shape)
            placed = {}
            d = self.model_placement(n, shape)
            if d is not None:
                placed[d] = self.cfg.model_axis
            d = self.placement(n, shape)
            if d is not None:
                placed[d] = self.cfg.data_axis
            table[n] = _spec(len(shape), placed)
        return table

    def params(self, model: nn.Module) -> nn.Module:
        """Place ``model``'s parameters by the policy, in place, before
        the optimizer and the EMA are made from them: ``replicated``
        leaves them whole; ``tp`` splits them over the model axis
        (:meth:`place_model_axis`); ``fsdp`` applies ``fully_shard`` to
        each block and then the root (each sharded leaf on its
        :meth:`placement`, the replicated ones ignored); ``fsdp+tp`` does
        both, in that order."""
        self.place_model_axis(model)
        self.place_context_axis(model)
        if self.cfg.param_sharding not in ("fsdp", "fsdp+tp") \
                or self.data_size == 1:
            return model
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dims = {p: self.placement(n, self.whole_shape(n, p.shape))
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

    def place_model_axis(self, model: nn.Module) -> nn.Module:
        """Split ``model``'s (whole, identical on every rank) parameters
        over the model axis, in place: each sharded leaf becomes this
        rank's block, and every layer learns the axis and its mode
        (column-parallel, row-parallel or replicated).  A no-op unless
        :attr:`tensor_parallel`, or for a model already placed."""
        axis = self.model_axis
        if axis is None or model_axis_of(model) is not None:
            return model
        params = dict(model.named_parameters())
        prefix = {m: f"{n}." if n else "" for n, m in model.named_modules()}
        for m, pre in prefix.items():
            # FiLM's [scale | shift] Dense: each rank its channels of both
            # halves, where its channels split over the ranks.
            if hasattr(m, "halves") and m.features % axis.size == 0:
                for leaf in ("weight", "bias"):
                    name = f"{pre}Dense_0.{leaf}"
                    if self.model_placement(name, params[name].shape) == 0:
                        self._halved.add(name)
        # Only Dense / Conv leaves split (the rule reads names: a norm at
        # the root would read as a kernel).
        layered = {f"{pre}{leaf}" for m, pre in prefix.items()
                   if hasattr(m, "tp_mode") for leaf in ("weight", "bias")}
        with torch.no_grad():
            for name, p in params.items():
                d = self.model_placement(name, p.shape)
                if d is None or name not in layered:
                    continue
                self._model_dims[name] = d
                p.data = self.local_of(name, p.detach())
        for m, pre in prefix.items():
            if not hasattr(m, "tp"):
                continue
            m.tp = axis
            if hasattr(m, "tp_mode"):
                d = self._model_dims.get(f"{pre}weight")
                m.tp_mode = {0: "column", 1: "row", None: None}[d]
            if hasattr(m, "halves"):
                m.halves = f"{pre}Dense_0.weight" in self._halved
        log.info("model axis: %d of %d parameters split over %d ranks",
                 len(self._model_dims),
                 sum(1 for _ in model.parameters()), axis.size)
        return model

    def place_context_axis(self, model: nn.Module) -> nn.Module:
        """Split ``model``'s activations by image rows over the model axis:
        every layer that takes the row split (a ``cp`` attribute) learns
        the axis; the parameters stay whole.  Refuses a model whose rows
        do not split at every level (:func:`~diff3d_tpu_torch.parallel.
        context.check_rows`).  A no-op unless :attr:`context_parallel`."""
        axis = self.context_axis
        if axis is None:
            return model
        cfg = getattr(model, "cfg", None)
        if cfg is not None:
            check_rows(cfg, axis.size)
        return place_rows(model, axis)

    def local_of(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor placed like parameter
        ``name`` (the tensor itself where the model axis does not split
        it; the data axis's chunk is FSDP's)."""
        d = self._model_dims.get(name)
        if d is None:
            return whole
        return block_of(whole, d, self.model_rank, self.model_size,
                        name in self._halved)

    def full_of(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of ``t``, placed like parameter ``name``: the
        data axis's chunks (FSDP) and the model axis's blocks gathered, in
        the JAX package's order.  A collective: every rank calls it."""
        if _is_dtensor(t):
            t = t.full_tensor()
        d = self._model_dims.get(name)
        if d is None or t.dim() == 0:     # whole, or Adam's step count
            return t
        g = self.model_axis.all_gather(t.movedim(d, -1)).movedim(-1, d)
        if name not in self._halved:
            return g
        parts = g.chunk(self.model_size, dim=d)
        halves = [p.chunk(2, dim=d) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim=d)

    def is_split(self, name: str) -> bool:
        """Whether the model axis split parameter ``name``."""
        return name in self._model_dims

    def sharded(self, model: nn.Module) -> bool:
        """Whether ``model`` holds FSDP-sharded parameters."""
        return any(_is_dtensor(p) for p in model.parameters())

    @property
    def eager_only(self) -> bool:
        """Whether the train step runs eagerly under this placement: FSDP2
        gathers on side streams, and the model axis's collectives (tensor
        and context parallelism's) are not captured (over gloo they wait
        for the host)."""
        return (self.cfg.param_sharding in ("fsdp", "fsdp+tp")
                or self.tensor_parallel or self.context_parallel)


def block_of(whole: torch.Tensor, dim: int, rank: int, size: int,
             halves: bool = False) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s block of ``whole`` along ``dim`` (a
    copy); ``halves``: the block of each half (``[scale | shift]``), the
    two joined."""
    if halves:
        F = whole.shape[dim] // 2
        f = F // size
        idx = torch.cat([torch.arange(rank * f, (rank + 1) * f),
                         torch.arange(F + rank * f, F + (rank + 1) * f)])
        return whole.index_select(dim, idx.to(whole.device)).contiguous()
    n = whole.shape[dim] // size
    return whole.narrow(dim, rank * n, n).contiguous().clone()


def _is_dtensor(t) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # pragma: no cover - torch without DTensor
        return False
    return isinstance(t, DTensor)


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence[int]] = None,
              model=None) -> MeshEnv:
    """The ``(data, model)`` mesh over the process group's ranks
    (``devices``: the ranks, default all), the JAX package's
    ``make_mesh``: ``data_parallel == -1`` takes every rank the model axis
    leaves, and a mesh of more ranks than there are is refused.  A rank
    runs only within its mesh here, so a mesh that leaves ranks out is
    refused too.  Without a process group this is the one-process mesh (no
    ``DeviceMesh``).  The mesh's devices are the card on an NCCL group and
    the CPU on a gloo one.  ``model`` (a ``ModelConfig``): under
    ``context_parallel``, a model whose rows do not split over the model
    axis at every level is refused here, naming the level."""
    global _CURRENT
    cfg.validate()
    if cfg.context_parallel and model is not None:
        check_rows(model, max(1, cfg.model_parallel))
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

