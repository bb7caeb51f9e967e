from typing import Dict

from diff3d_tpu_torch.ops import cuda_film  # noqa: F401 - registers 'groupnorm'
from diff3d_tpu_torch.ops.attention import multi_head_attention
from diff3d_tpu_torch.ops.cuda_attention import (attention_backward_dkdv,
                                                 attention_backward_dq,
                                                 flash_attention)

# Every kernel wrapper, by name; each counts its launches in ``.launches``.
KERNEL_WRAPPERS = {"fused_groupnorm": cuda_film.fused_groupnorm,
                   "groupnorm_backward": cuda_film.groupnorm_backward,
                   "flash_attention": flash_attention,
                   "attention_backward_dkdv": attention_backward_dkdv,
                   "attention_backward_dq": attention_backward_dq}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the wrappers' launch counts at ``counts``."""
    for name, n in counts.items():
        KERNEL_WRAPPERS[name].launches = n


__all__ = ["KERNEL_WRAPPERS", "launch_counts", "multi_head_attention",
           "set_launch_counts"]
