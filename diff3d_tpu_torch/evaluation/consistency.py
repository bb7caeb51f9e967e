"""Multi-view 3D-consistency metric: reprojection error across views
(counterpart: ``diff3d_tpu/evaluation/consistency.py``, an own copy).

A geometrically consistent frame sequence (an orbit turntable) must
agree with itself: warping frame ``j`` into frame ``i``'s viewpoint
through the scene geometry should reproduce frame ``i`` where the views
overlap.  Full geometry is unknown when scoring, so the
warp uses the classic *plane-induced homography*: the scene is
approximated by the fronto-parallel plane through the look-at target
(normal = camera ``i``'s optical axis).  For the small angular steps of
an orbit/spiral path the approximation is tight near the object, and —
crucially — it is *ranking-faithful*: sequences whose frames do not
share one 3D scene (shuffled frames, per-frame identity drift) score
strictly worse than consistent ones.

Math (world-from-camera ``R``, camera position ``T``, shared ``K``; the
``geometry/rays.py`` convention): a point ``X_i`` in camera-``i``
coordinates maps to camera ``j`` as ``X_j = R_rel X_i + t_rel`` with
``R_rel = R_j^T R_i`` and ``t_rel = R_j^T (T_i - T_j)``.  On the plane
``n^T X_i = d`` (``n = (0,0,1)``, ``d`` = target depth in camera ``i``)
this collapses to the homography

    H_{j<-i} = K (R_rel + t_rel n^T / d) K^{-1}

mapping pixel-center homogeneous coordinates of image ``i`` to image
``j``.  Pure host-side float64 numpy — scoring never touches a device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["plane_homography", "warp_frame", "reprojection_consistency"]

#: Pairs whose valid-overlap fraction falls below this contribute no
#: error term (warping through a nearly-perpendicular plane or a
#: behind-the-camera target is noise, not signal).
MIN_VALID_FRAC = 0.05


def plane_homography(K: np.ndarray, R_i: np.ndarray, T_i: np.ndarray,
                     R_j: np.ndarray, T_j: np.ndarray,
                     target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """``H_{j<-i}``: maps homogeneous pixel coords of view ``i`` to view
    ``j`` through the fronto-parallel plane at ``target``'s depth."""
    K = np.asarray(K, np.float64)
    R_i = np.asarray(R_i, np.float64)
    R_j = np.asarray(R_j, np.float64)
    T_i = np.asarray(T_i, np.float64)
    T_j = np.asarray(T_j, np.float64)
    target = np.asarray(target, np.float64)
    d = float((R_i.T @ (target - T_i))[2])   # target depth in camera i
    if d <= 1e-9:
        raise ValueError(
            f"target is behind (or on) camera i: depth {d:.3g}")
    R_rel = R_j.T @ R_i
    t_rel = R_j.T @ (T_i - T_j)
    n = np.array([0.0, 0.0, 1.0])
    return K @ (R_rel + np.outer(t_rel, n) / d) @ np.linalg.inv(K)


def _bilinear(img: np.ndarray, x: np.ndarray,
              y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``img [H, W, C]`` at float array coords ``(y, x)``;
    returns ``(samples, in_bounds_mask)``."""
    H, W = img.shape[:2]
    valid = (x >= 0.0) & (x <= W - 1.0) & (y >= 0.0) & (y <= H - 1.0)
    x = np.clip(x, 0.0, W - 1.0)
    y = np.clip(y, 0.0, H - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    out = ((1 - wy) * ((1 - wx) * img[y0, x0] + wx * img[y0, x1])
           + wy * ((1 - wx) * img[y1, x0] + wx * img[y1, x1]))
    return out, valid


def warp_frame(frame_j: np.ndarray, H_ji: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Predict view ``i`` from ``frame_j``: for every pixel of the
    target grid, project through ``H_{j<-i}`` and sample ``frame_j``
    bilinearly.  Returns ``(warped [H, W, C], valid [H, W])`` — valid
    means the projection landed in front of the camera and inside
    ``frame_j``."""
    frame_j = np.asarray(frame_j, np.float64)
    H, W = frame_j.shape[:2]
    u = np.arange(W, dtype=np.float64) + 0.5
    v = np.arange(H, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, v)
    px = np.stack([uu, vv, np.ones_like(uu)], axis=-1)      # [H, W, 3]
    proj = np.einsum("ij,hwj->hwi", np.asarray(H_ji, np.float64), px)
    w = proj[..., 2]
    front = w > 1e-9
    w_safe = np.where(front, w, 1.0)
    xj = proj[..., 0] / w_safe - 0.5
    yj = proj[..., 1] / w_safe - 0.5
    warped, in_bounds = _bilinear(frame_j, xj, yj)
    return warped, front & in_bounds


def reprojection_consistency(frames: np.ndarray, R: np.ndarray,
                             T: np.ndarray, K: np.ndarray,
                             target=(0.0, 0.0, 0.0),
                             pairs: Optional[Sequence[Tuple[int, int]]]
                             = None) -> dict:
    """Score the 3D consistency of an ordered frame sequence.

    ``frames [N, H, W, 3]`` in [-1, 1] (a guidance axis
    ``[N, B, H, W, 3]`` is accepted; lane 0 is scored), with per-frame
    poses ``R [N, 3, 3]`` / ``T [N, 3]`` and shared ``K``.  ``pairs``
    defaults to adjacent ``(i, i+1)`` — the small-baseline pairs where
    the plane approximation is tightest.  For each pair, frame ``j`` is
    warped into frame ``i``'s viewpoint and compared over the valid
    overlap; the headline numbers are means over pairs clearing
    :data:`MIN_VALID_FRAC`.

    Returns ``{"consistency_l1", "consistency_psnr", "valid_frac",
    "num_pairs", "pairs": [...]}`` — lower L1 / higher PSNR = more
    consistent.
    """
    frames = np.asarray(frames, np.float64)
    if frames.ndim == 5:
        frames = frames[:, 0]
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"frames must be [N, H, W, 3] (or [N, B, H, W, 3]), got "
            f"{frames.shape}")
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    N = frames.shape[0]
    if R.shape[0] != N or T.shape[0] != N:
        raise ValueError(
            f"{N} frames but {R.shape[0]} R / {T.shape[0]} T poses")
    if N < 2:
        raise ValueError("need at least 2 frames to score consistency")
    if pairs is None:
        pairs = [(i, i + 1) for i in range(N - 1)]
    per_pair: List[dict] = []
    l1s, psnrs, fracs = [], [], []
    for i, j in pairs:
        H_ji = plane_homography(K, R[i], T[i], R[j], T[j], target)
        warped, valid = warp_frame(frames[j], H_ji)
        frac = float(valid.mean())
        entry = {"i": int(i), "j": int(j), "valid_frac": frac}
        if frac >= MIN_VALID_FRAC:
            diff = (warped - frames[i])[valid]
            l1 = float(np.abs(diff).mean())
            mse = float((diff ** 2).mean())
            # Data range is 2.0 ([-1, 1]); cap like evaluation.psnr.
            psnr = float(10.0 * np.log10(4.0 / max(mse, 1e-10)))
            entry.update({"l1": l1, "psnr": psnr})
            l1s.append(l1)
            psnrs.append(psnr)
            fracs.append(frac)
        else:
            entry.update({"l1": None, "psnr": None})
        per_pair.append(entry)
    return {
        "consistency_l1": float(np.mean(l1s)) if l1s else None,
        "consistency_psnr": float(np.mean(psnrs)) if psnrs else None,
        "valid_frac": float(np.mean(fracs)) if fracs else 0.0,
        "num_pairs": len(l1s),
        "pairs": per_pair,
    }
