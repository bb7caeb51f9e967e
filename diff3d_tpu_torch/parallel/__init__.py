"""The parallel layer (counterpart: ``diff3d_tpu/parallel/``): the process
mesh and its parameter placement (:mod:`.mesh`), multi-process bring-up
(:mod:`.multihost`) and sequence-parallel attention
(:mod:`.ring_attention`).  The JAX package's ``shard_map`` wrapper has no
counterpart: a torch rank runs its own program on its own shard."""

from diff3d_tpu_torch.parallel.mesh import (MeshEnv, axis_group, fsdp_dim,
                                            make_mesh)
from diff3d_tpu_torch.parallel.multihost import (is_primary,
                                                 maybe_initialize_distributed,
                                                 reinitialize_distributed,
                                                 shutdown_distributed)
from diff3d_tpu_torch.parallel.ring_attention import ring_sdpa, ulysses_sdpa

__all__ = [
    "MeshEnv", "make_mesh", "axis_group", "fsdp_dim",
    "maybe_initialize_distributed", "reinitialize_distributed",
    "shutdown_distributed", "is_primary", "ring_sdpa", "ulysses_sdpa",
]
