"""Pinhole-camera rays (counterpart: ``diff3d_tpu/geometry/rays.py``).

Conventions (visu3d's ``Camera(spec, world_from_cam).rays()``): pixel
(row i, col j) maps to ``(u, v) = (j + 0.5, i + 0.5)``; the camera-space
direction is ``K^-1 @ [u, v, 1]``; the world direction ``R @ dir_cam``,
L2-normalised; the ray origin is the camera position ``t``.

The two stages stay split: the intrinsics-only half depends on nothing
that changes between denoise steps, so the sampler computes it once per
trajectory (``diffusion/core.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pinhole_rays_cam(K: torch.Tensor, H: int, W: int,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Camera-space ray directions ``K^-1 @ [u, v, 1]`` per pixel,
    ``[..., H, W, 3]`` for ``K [..., 3, 3]``."""
    dtype = K.dtype if dtype is None else dtype
    u = torch.arange(W, dtype=dtype, device=K.device) + 0.5
    v = torch.arange(H, dtype=dtype, device=K.device) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")          # each [H, W]
    px = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # [H, W, 3]
    # inv_ex: the same inverse without inv's singularity check, which
    # waits for the device (not allowed inside a captured CUDA graph).
    K_inv = torch.linalg.inv_ex(K.to(dtype))[0]
    return torch.einsum("...ij,hwj->...hwi", K_inv, px)


def pinhole_rays_world(R: torch.Tensor, t: torch.Tensor,
                       dir_cam: torch.Tensor, normalize: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pose-dependent half: rotate camera-space directions into the world
    frame (``R [..., 3, 3]`` broadcast against ``dir_cam [..., H, W, 3]``)
    and broadcast the ray origins ``t [..., 3]``."""
    dir_world = (R[..., None, None, :, :] @ dir_cam[..., None])[..., 0]
    if normalize:
        dir_world = dir_world / torch.linalg.norm(dir_world, dim=-1,
                                                  keepdim=True)
    pos = torch.broadcast_to(t[..., None, None, :], dir_world.shape)
    return pos, dir_world


def pinhole_rays(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
                 H: int, W: int, normalize: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions, ``(pos, dir)`` each
    ``[..., H, W, 3]``: the composition of the two stages."""
    dir_cam = pinhole_rays_cam(K, H, W, dtype=R.dtype)
    return pinhole_rays_world(R, t, dir_cam, normalize=normalize)
