from diff3d_tpu_torch.geometry.posenc import posenc_ddpm, posenc_nerf
from diff3d_tpu_torch.geometry.rays import (pinhole_rays, pinhole_rays_cam,
                                            pinhole_rays_world)

__all__ = ["posenc_ddpm", "posenc_nerf", "pinhole_rays",
           "pinhole_rays_cam", "pinhole_rays_world"]
