from diff3d_tpu_torch.data.images import dequantize, quantize_uint8
from diff3d_tpu_torch.data.loader import InfiniteLoader, prefetch_to_device
from diff3d_tpu_torch.data.srn import (SRNDataset, build_index,
                                       load_intrinsics, load_object_views,
                                       load_pose, split_ids)
from diff3d_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["InfiniteLoader", "SRNDataset", "SyntheticDataset", "build_index",
           "dequantize", "load_intrinsics", "load_object_views", "load_pose",
           "prefetch_to_device", "quantize_uint8", "split_ids"]
