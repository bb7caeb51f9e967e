from diff3d_tpu_torch.utils.profiling import StepTimer

__all__ = ["StepTimer"]
