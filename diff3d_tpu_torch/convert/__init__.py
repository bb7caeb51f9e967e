from diff3d_tpu_torch.convert.from_jax import (convert_params,
                                               load_flax_params,
                                               load_flax_train_state,
                                               load_npz)
from diff3d_tpu_torch.convert.progressive import (
    adapt_params_resolution, check_resolution_compatible,
    init_student_from_teacher)
from diff3d_tpu_torch.convert.torch_ckpt import (convert_state_dict,
                                                 expected_torch_state,
                                                 load_torch_checkpoint,
                                                 verify_state_dict)

__all__ = ["adapt_params_resolution", "check_resolution_compatible",
           "convert_params", "convert_state_dict", "expected_torch_state",
           "init_student_from_teacher", "load_flax_params",
           "load_flax_train_state", "load_npz", "load_torch_checkpoint",
           "verify_state_dict"]
