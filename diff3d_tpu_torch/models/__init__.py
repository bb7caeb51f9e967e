from diff3d_tpu_torch.models.xunet import XUNet, build_model, init_params

__all__ = ["XUNet", "build_model", "init_params"]
