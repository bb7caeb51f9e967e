"""The parallel layer (counterpart: ``diff3d_tpu/parallel/``): the process
mesh and its parameter placement (:mod:`.mesh`), multi-process bring-up
(:mod:`.multihost`), sequence-parallel attention (:mod:`.ring_attention`)
and tensor parallelism's collectives over the model axis
(:mod:`.tensor`).  The JAX package's ``shard_map`` wrapper has no
counterpart: a torch rank runs its own program on its own shard."""

from diff3d_tpu_torch.parallel.mesh import (MeshEnv, axis_group, fsdp_dim,
                                            make_mesh, tp_dims)
from diff3d_tpu_torch.parallel.multihost import (is_primary,
                                                 maybe_initialize_distributed,
                                                 reinitialize_distributed,
                                                 shutdown_distributed)
from diff3d_tpu_torch.parallel.ring_attention import ring_sdpa, ulysses_sdpa
from diff3d_tpu_torch.parallel.tensor import ModelAxis

__all__ = [
    "MeshEnv", "make_mesh", "axis_group", "fsdp_dim", "tp_dims", "ModelAxis",
    "maybe_initialize_distributed", "reinitialize_distributed",
    "shutdown_distributed", "is_primary", "ring_sdpa", "ulysses_sdpa",
]
