"""Evaluation: image metrics, FID, matched-seed parity and multi-view
consistency (counterpart: ``diff3d_tpu/evaluation``)."""

from diff3d_tpu_torch.evaluation.metrics import psnr, ssim
from diff3d_tpu_torch.evaluation.fid import (FIDStats, default_feature_fn,
                                             fid_from_stats,
                                             frechet_distance,
                                             gaussian_stats)
from diff3d_tpu_torch.evaluation.parity import (PSNR_CAP, cascade_parity,
                                                matched_seed_parity,
                                                resize_bilinear)
from diff3d_tpu_torch.evaluation.consistency import (
    plane_homography, reprojection_consistency, warp_frame)

__all__ = ["psnr", "ssim", "FIDStats", "default_feature_fn",
           "fid_from_stats", "gaussian_stats", "frechet_distance",
           "PSNR_CAP", "cascade_parity", "matched_seed_parity",
           "resize_bilinear", "plane_homography",
           "reprojection_consistency", "warp_frame"]
