from diff3d_tpu_torch.convert.from_jax import (convert_params,
                                               load_flax_params,
                                               load_flax_train_state,
                                               load_npz)

__all__ = ["convert_params", "load_flax_params", "load_flax_train_state",
           "load_npz"]
