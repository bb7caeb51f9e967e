from diff3d_tpu_torch.ops import cuda_film  # noqa: F401 - registers 'groupnorm'
from diff3d_tpu_torch.ops.attention import multi_head_attention

__all__ = ["multi_head_attention"]
