from diff3d_tpu_torch.data.srn import (load_intrinsics, load_object_views,
                                       load_pose)

__all__ = ["load_intrinsics", "load_object_views", "load_pose"]
