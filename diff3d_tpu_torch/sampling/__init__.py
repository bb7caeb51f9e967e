from diff3d_tpu_torch.sampling.runtime import (Sampler, record_capacity,
                                               save_image)

__all__ = ["Sampler", "record_capacity", "save_image"]
