"""Camera trajectories: path generators for orbit videos (counterpart:
``diff3d_tpu/trajectory``); ``cli/eval_cli.py --orbit`` renders them and
scores the frames with ``evaluation/consistency.py``."""

from diff3d_tpu_torch.trajectory.paths import (PATH_KINDS, keyframe_path,
                                               look_at, orbit_path,
                                               path_from_spec, spiral_path,
                                               trajectory_views)

__all__ = ["PATH_KINDS", "look_at", "orbit_path", "spiral_path",
           "keyframe_path", "path_from_spec", "trajectory_views"]
